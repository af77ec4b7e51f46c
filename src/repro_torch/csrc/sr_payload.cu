// The two kernels of the pipelined single-reduce Arnoldi step:
//
//   payload   p = [mask * (V [z, v_j]); z.z, v_j.v_j]        (m1 + 1, 2)
//             mask = rows 0..j, v_j = row j of V widened to float
//   update    w' = w - h^T V                                   (n,)
//
// Replaces repro/kernels/cgs2.py::gs_project_norm_partial (the Pallas
// payload kernel: a sequential grid over column tiles accumulating the
// stacked block in VMEM) and repro/kernels/cgs2.py::gs_update (a grid of
// independent column tiles).  JAX stacks [z, v_j] into an (n, 2) array
// first; here the payload kernel reads v_j straight from row j of V, so
// that 8 MB copy at n = 2^20 never exists.
//
// Bound: bytes.  The payload must read rows 0..j of V and z once:
// ((j + 1) s_V + 4) n bytes (s_V the storage size of V; v_j is one of the
// rows), 68 MiB at n = 2^20, j = 15, f32: 0.021 ms at 3.35 TB/s (bf16 V:
// 0.011).  The update reads the rows it is given, w, and writes w':
// ((j + 1) s_V + 8) n bytes, 0.0225 ms at the same shape.  4 and 2 flops
// per element of V, far below the card's rate.  At n = 10^4 both are
// launch-bound (microseconds).
//
// Design.  The payload's h needs all of n, and Hopper's blocks run in no
// order, so it is two launches on the stream: a plain grid writes one
// partial per block and entry, [entry][block], and a second tiny launch
// (common.cuh's reduce_partials_kernel) sums each entry over the blocks in
// one fixed order, one warp per entry.  No float atomics: the payload has
// the same bits every run.  No cooperative launch and no grid sync are
// needed either, so the grid is not bound to the co-resident blocks, and
// the second launch costs about what a grid sync would.  Block b owns the
// column slice [b * cols, b * cols + len): it stages its slices of z and
// v_j in shared memory (summing their squares on the way), then walks the
// valid rows eight at a time, each thread keeping 8 rows x 2 columns of
// sums with eight loads of V in flight, coalesced across the warp.  Rows
// past j are never read.
//
// The update replaces repro/kernels/cgs2.py::gs_update (a grid of
// independent column tiles).  Bound: bytes, ((j + 1) s_V + 8) n: the rows
// it is given, w and w' once, 0.0225 ms at n = 2^20, 16 rows, f32 (bf16
// V: 0.0125); at n = 10^4 a launch and one round trip to memory.  Its
// first design (a thread per column, h staged in shared memory behind a
// barrier, rows eight at a time in 4-byte loads) took 0.0417 ms (0.0371
// bf16) cold on an H100 80GB HBM3 at 700 W: nearly the same in both
// types, so latency, not bytes, set its time.
// Design: a thread owns 16-byte pieces (4 f32 or 8 bf16 columns); it
// issues the loads of w and of up to 16 rows of the piece at once, with
// h read by broadcast loads beside them, then runs each column's chain
// u = fmaf(h[r], V[r, c], u) in row order from 0 and writes w - u in
// 16 bytes.  No shared memory, no barrier.  The chain is the first
// design's, so the bits are too: a row whose h is 0 adds exactly 0, so
// the pipelined cycle passes the row prefix V[:j+1] and gets the bits of
// the full call.  A misaligned w or row stride takes the scalar route
// (pieces = 0), counted by the wrapper; the grid is
// tuning.gemv_stream_shape's (a thread a piece, or a persistent grid
// taking two pieces at once).  Measured in turn with the first design
// (chip_smoke.py --in-turn; L2 emptied by a 256 MB rewrite; H100 80GB
// HBM3, 700 W): 0.0335 ms f32 (0.0197-0.0200 bf16) at n = 2^20, 16
// rows, against 0.0443-0.0444 (0.0390) and torch.addmv's 0.0414-0.0416;
// 0.0036 (0.0030) at n = 10^4, against 0.0087 (0.0085) and addmv's
// 0.0047-0.0048.
//
// The split-phase projection of the row-sharded CGS2 step:
//
//   partial   h = mask * (V w)                                 (m1,)
//
// replaces repro/kernels/cgs2.py::gs_project_partial (its Pallas kernel
// accumulates mask * (V_local w_local) over a sequential grid of column
// tiles; the caller all-reduces it across the shards, then runs gs_update).
// Bound: bytes, ((j + 1) s_V + 4) n: rows 0..j of V and w once, 0.021 ms
// at n = 2^20, j = 15, f32 (0.011 bf16).  Its first design staged w's
// slice in shared memory, then walked the rows eight at a time, each
// chunk ending in two barriers: 0.0415 ms (0.0409 bf16) on the same
// card, latency-bound as the update.
// Design: the update's 16-byte pieces, w's piece loaded once into
// registers for all the rows; one sweep over the columns holds a sum per
// valid row in registers (a bucket of 8, 16 or 32 rows, the kernel
// templated on it; more rows loop buckets), all the piece's row loads in
// flight together, two pieces at once in the 8- and 16-row buckets.  At
// the end each row's sum goes through a warp shuffle, the warps in order
// and one barrier to part[row][block]; reduce_partials_kernel then sums
// the blocks in one fixed order.  That second launch was 4% of the first
// design's call at n = 2^20, too little to fold into the first.  A short
// basis (at most tuning.PARTIAL_ROW_MAX_ITEMS pieces a row, n = 10^4)
// takes a block a row instead: one launch, no partials.  No float
// atomics: the same bits every run.  Rows past j are never read (written
// as zeros).  Measured as the
// update: 0.0357-0.0358 ms f32 (0.0233 bf16) at n = 2^20, j = 15, against
// 0.0477 (0.0464) and cuBLAS's GEMV (torch.mv) 0.0351-0.0353; 0.0026
// (0.0027) at n = 10^4, against 0.0084-0.0085 (0.0093-0.0094) and
// torch.mv's 0.0041-0.0042.
#include "common.cuh"

namespace repro {

// Dynamic shared memory: zs[cols], vjs[cols], red[kWarps * 2 * kRowChunk].
template <typename TV>
__global__ void __launch_bounds__(kThreads)
    sr_payload_kernel(const TV* __restrict__ v, const float* __restrict__ z,
                      float* __restrict__ part, int m1, int n, int j,
                      int cols) {
  extern __shared__ float smem[];
  float* zs = smem;
  float* vjs = zs + cols;
  float* red = vjs + cols;
  const int nb = gridDim.x;
  const int c0 = blockIdx.x * cols;
  const int len = max(0, min(cols, n - c0));
  const int rows = j + 1;
  const TV* vj = v + (size_t)j * n + c0;

  // the slices of z and v_j, and their squared norms (payload row m1)
  float nrm[2] = {0.f, 0.f};
  for (int c = threadIdx.x; c < len; c += blockDim.x) {
    const float zc = z[c0 + c], vc = to_f(vj[c]);
    zs[c] = zc;
    vjs[c] = vc;
    nrm[0] = fmaf(zc, zc, nrm[0]);
    nrm[1] = fmaf(vc, vc, nrm[1]);
  }
  block_partials<2>(nrm, red, part, 2 * m1, 2, nb);

  // rows 0..j against [z, v_j], eight rows at a time
  for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
    const int nr = rows - r0 < kRowChunk ? rows - r0 : kRowChunk;
    float acc[2 * kRowChunk];
#pragma unroll
    for (int i = 0; i < 2 * kRowChunk; ++i) acc[i] = 0.f;
    const TV* vr = v + (size_t)r0 * n + c0;
    for (int c = threadIdx.x; c < len; c += blockDim.x) {
      float vv[kRowChunk];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
        vv[r] = r < nr ? to_f(vr[(size_t)r * n + c]) : 0.f;
      const float zc = zs[c], vc = vjs[c];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) {
        acc[2 * r] = fmaf(vv[r], zc, acc[2 * r]);
        acc[2 * r + 1] = fmaf(vv[r], vc, acc[2 * r + 1]);
      }
    }
    block_partials<2 * kRowChunk>(acc, red, part, 2 * r0, 2 * nr, nb);
  }
}

// ---------------------------------------------------------------------------
// The streaming GEMV pair (gs_update, gs_project_partial): 16-byte pieces,
// every row of a piece in flight, no staging barrier.  The launch shape
// (threads, blocks, unroll, pieces) is tuning.gemv_stream_shape's.  A
// thread takes the 16-byte pieces p = t, t + G, ... (G the grid's
// threads; U pieces at once, p and p + G), then the scalar columns
// [pieces * VEC, n) one by one: the ragged tail of an aligned call, every
// column of a misaligned one (pieces = 0).
// ---------------------------------------------------------------------------
constexpr int kStreamRows = 16;   // the update's rows in flight per piece

// out = w - h^T V over `rows` rows.  The chain of each column is
// stream_update's: u = fmaf(h[r], V[r, c], u) in row order from 0, then
// w - u, so the bits are that kernel's at every shape.
template <typename TV, int U>
__global__ void __launch_bounds__(kThreads)
    gs_update_stream_kernel(const TV* __restrict__ v,
                            const float* __restrict__ w,
                            const float* __restrict__ h,
                            float* __restrict__ out, int rows, int n,
                            int pieces) {
  constexpr int VEC = Vec16<TV>::N;   // columns of a 16-byte piece
  const int G = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  for (int p0 = t; p0 < pieces; p0 += U * G) {
    bool ok[U];
    float u[U][VEC], wv[U][VEC];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      ok[k] = p0 + k * G < pieces;
#pragma unroll
      for (int c = 0; c < VEC; ++c) u[k][c] = 0.f;
      if (ok[k]) load_floats<float, VEC>(w + (size_t)(p0 + k * G) * VEC,
                                         wv[k]);
    }
    for (int r0 = 0; r0 < rows; r0 += kStreamRows) {
      const int nr = min(kStreamRows, rows - r0);
      // every load of the chunk first: h by broadcast, V in 16 bytes
      float hr[kStreamRows];
      uint4 raw[U][kStreamRows];
#pragma unroll
      for (int r = 0; r < kStreamRows; ++r) {
        if (r < nr) {
          hr[r] = __ldg(h + r0 + r);
          const TV* row = v + (size_t)(r0 + r) * n;
#pragma unroll
          for (int k = 0; k < U; ++k)
            raw[k][r] = ok[k] ? __ldg(reinterpret_cast<const uint4*>(
                                    row + (size_t)(p0 + k * G) * VEC))
                              : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int r = 0; r < kStreamRows; ++r) {
        if (r < nr) {
#pragma unroll
          for (int k = 0; k < U; ++k) {
            float f[VEC];
            Vec16<TV>::unpack(raw[k][r], f);
#pragma unroll
            for (int c = 0; c < VEC; ++c) u[k][c] = fmaf(hr[r], f[c], u[k][c]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (!ok[k]) continue;
      float4* o = reinterpret_cast<float4*>(out + (size_t)(p0 + k * G) * VEC);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        o[q] = make_float4(wv[k][4 * q] - u[k][4 * q],
                           wv[k][4 * q + 1] - u[k][4 * q + 1],
                           wv[k][4 * q + 2] - u[k][4 * q + 2],
                           wv[k][4 * q + 3] - u[k][4 * q + 3]);
    }
  }
  for (int c = pieces * VEC + t; c < n; c += G) {
    float u = 0.f;
    for (int r0 = 0; r0 < rows; r0 += kStreamRows) {
      const int nr = min(kStreamRows, rows - r0);
      float hr[kStreamRows], vv[kStreamRows];
#pragma unroll
      for (int r = 0; r < kStreamRows; ++r) {
        if (r < nr) {
          hr[r] = __ldg(h + r0 + r);
          vv[r] = to_f(v[(size_t)(r0 + r) * n + c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kStreamRows; ++r)
        if (r < nr) u = fmaf(hr[r], vv[r], u);
    }
    out[c] = w[c] - u;
  }
}

// The projection's column sweep (V w over rows 0..rows-1).  Block b
// sums V[r, c] w[c] over its columns for every valid row, in buckets of R
// rows: one sweep over the columns per bucket, each thread's R sums in
// registers, w's piece loaded once for the bucket's rows, U pieces at once
// (the 32-row bucket takes one: its 32 loads in flight fill the
// registers).  Per row a warp shuffle and the warp's sum to shared memory
// (red[warp][row], no barrier between buckets); at the end one barrier,
// the warps summed in order into part[row][block]; reduce_partials_kernel
// then sums the blocks in one fixed order.  No float atomics: the same
// bits every run.
template <typename TV, int R, int U>
__global__ void __launch_bounds__(kThreads)
    gs_partial_stream_kernel(const TV* __restrict__ v,
                             const float* __restrict__ w,
                             float* __restrict__ part, int rows, int n,
                             int pieces) {
  constexpr int VEC = Vec16<TV>::N;
  extern __shared__ float red[];   // [warps][rows]
  const int nb = gridDim.x;
  const int G = nb * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int r0 = 0; r0 < rows; r0 += R) {
    const int nr = min(R, rows - r0);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int p0 = t; p0 < pieces; p0 += U * G) {
      bool ok[U];
      float wv[U][VEC];
      uint4 raw[U][R];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        ok[k] = p0 + k * G < pieces;
        if (ok[k])
          load_floats<float, VEC>(w + (size_t)(p0 + k * G) * VEC, wv[k]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          const TV* row = v + (size_t)(r0 + r) * n;
#pragma unroll
          for (int k = 0; k < U; ++k)
            if (ok[k])
              raw[k][r] = __ldg(reinterpret_cast<const uint4*>(
                  row + (size_t)(p0 + k * G) * VEC));
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (!ok[k]) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nr) {
            float f[VEC];
            Vec16<TV>::unpack(raw[k][r], f);
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[r] = fmaf(f[c], wv[k][c], acc[r]);
          }
        }
      }
    }
    for (int c = pieces * VEC + t; c < n; c += G) {
      const float wc = w[c];
      float vv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) vv[r] = to_f(v[(size_t)(r0 + r) * n + c]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) acc[r] = fmaf(vv[r], wc, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {                  // uniform across the warp
        const float s = warp_sum(acc[r]);
        if (lane == 0) red[warp * rows + r0 + r] = s;
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < warps; ++q) s += red[q * rows + r];
    part[(size_t)r * nb + blockIdx.x] = s;
  }
}

// The projection of a short basis (few pieces a row): block r sums row r
// alone, kRowPieces pieces of each thread's stride in flight at once (a
// row of 4,096 pieces in one round trip), and writes h[r] after a block
// sum in a fixed order; block 0 also writes the masked rows' zeros.  One
// launch and no step across blocks.
constexpr int kRowPieces = 16;

template <typename TV>
__global__ void __launch_bounds__(kThreads)
    gs_partial_rows_kernel(const TV* __restrict__ v,
                           const float* __restrict__ w,
                           float* __restrict__ out, int m1, int rows, int n,
                           int pieces) {
  constexpr int VEC = Vec16<TV>::N;
  __shared__ float red[kWarps];
  const TV* row = v + (size_t)blockIdx.x * n;
  float acc = 0.f;
  for (int p0 = threadIdx.x; p0 < pieces; p0 += kRowPieces * kThreads) {
    uint4 raw[kRowPieces];
    float wv[kRowPieces][VEC];
#pragma unroll
    for (int k = 0; k < kRowPieces; ++k) {
      const int p = p0 + k * kThreads;
      if (p < pieces) {
        raw[k] = __ldg(reinterpret_cast<const uint4*>(row + (size_t)p * VEC));
        load_floats<float, VEC>(w + (size_t)p * VEC, wv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowPieces; ++k) {
      if (p0 + k * kThreads < pieces) {
        float f[VEC];
        Vec16<TV>::unpack(raw[k], f);
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc = fmaf(f[c], wv[k][c], acc);
      }
    }
  }
  for (int c = pieces * VEC + threadIdx.x; c < n; c += kThreads)
    acc = fmaf(to_f(row[c]), w[c], acc);
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
  if (blockIdx.x == 0)
    for (int r = rows + threadIdx.x; r < m1; r += kThreads) out[r] = 0.f;
}

template <typename TV>
static cudaError_t launch_sr_payload(const void* v, const float* z,
                                     float* out, float* part, int grid,
                                     int m1, int n, int j,
                                     cudaStream_t stream) {
  if (m1 <= 0 || n <= 0 || j < 0 || j >= m1 || grid < 1 || grid > n)
    return cudaErrorInvalidValue;
  auto kernel = sr_payload_kernel<TV>;
  const int cols = (n + grid - 1) / grid;
  const size_t smem =
      sizeof(float) * (2 * (size_t)cols + kWarps * 2 * kRowChunk);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const TV*>(v), z,
                                           part, m1, n, j, cols);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // rows j+1..m1-1 of the payload are masked to zero
  return launch_reduce_partials(part, grid, 2 * (m1 + 1), 2 * (j + 1),
                                2 * m1, out, stream);
}

// A launch shape the stream kernels take: whole warps, at most kThreads,
// and every piece inside [0, n).
template <typename TV>
static bool stream_shape_ok(int n, int threads, int blocks, int pieces) {
  return threads >= 32 && threads <= kThreads && threads % 32 == 0 &&
         blocks >= 1 && pieces >= 0 &&
         (long long)pieces * Vec16<TV>::N <= (long long)n;
}

// The column sweep, then the fixed-order sum of its partials (rows past
// rows - 1 written as zeros).
template <typename TV, int R, int U>
static cudaError_t launch_gs_partial_bucket(const TV* v, const float* w,
                                            float* part, float* out, int m1,
                                            int rows, int n, int threads,
                                            int blocks, int pieces,
                                            cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(threads / 32) * rows;
  auto kernel = gs_partial_stream_kernel<TV, R, U>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, smem, stream>>>(v, w, part, rows, n, pieces);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(part, blocks, m1, rows, m1, out, stream);
}

template <typename TV>
static cudaError_t launch_gs_partial(const void* v, const float* w,
                                     float* out, float* part, int m1, int n,
                                     int j, int by_row, int threads,
                                     int blocks, int unroll, int pieces,
                                     cudaStream_t stream) {
  if (m1 <= 0 || n <= 0 || j < 0 || j >= m1) return cudaErrorInvalidValue;
  const TV* vt = static_cast<const TV*>(v);
  const int rows = j + 1;
  if (by_row) {                      // a block of kThreads a row
    if (blocks != rows ||
        !stream_shape_ok<TV>(n, kThreads, blocks, pieces))
      return cudaErrorInvalidValue;
    gs_partial_rows_kernel<TV><<<rows, kThreads, 0, stream>>>(
        vt, w, out, m1, rows, n, pieces);
    return cudaGetLastError();
  }
  if ((unroll != 1 && unroll != 2) ||
      !stream_shape_ok<TV>(n, threads, blocks, pieces))
    return cudaErrorInvalidValue;
  // the row bucket: the fewest accumulators that hold the valid rows
  if (rows <= 8)
    return unroll == 2
               ? launch_gs_partial_bucket<TV, 8, 2>(vt, w, part, out, m1,
                                                    rows, n, threads, blocks,
                                                    pieces, stream)
               : launch_gs_partial_bucket<TV, 8, 1>(vt, w, part, out, m1,
                                                    rows, n, threads, blocks,
                                                    pieces, stream);
  if (rows <= 16)
    return unroll == 2
               ? launch_gs_partial_bucket<TV, 16, 2>(vt, w, part, out, m1,
                                                     rows, n, threads,
                                                     blocks, pieces, stream)
               : launch_gs_partial_bucket<TV, 16, 1>(vt, w, part, out, m1,
                                                     rows, n, threads,
                                                     blocks, pieces, stream);
  return launch_gs_partial_bucket<TV, 32, 1>(vt, w, part, out, m1, rows, n,
                                             threads, blocks, pieces, stream);
}

template <typename TV>
static cudaError_t launch_gs_update(const void* v, const float* w,
                                    const float* h, float* out, int m1, int n,
                                    int threads, int blocks, int unroll,
                                    int pieces, cudaStream_t stream) {
  if (m1 <= 0 || n <= 0 || (unroll != 1 && unroll != 2) ||
      !stream_shape_ok<TV>(n, threads, blocks, pieces))
    return cudaErrorInvalidValue;
  const TV* vt = static_cast<const TV*>(v);
  if (unroll == 2)
    gs_update_stream_kernel<TV, 2><<<blocks, threads, 0, stream>>>(
        vt, w, h, out, m1, n, pieces);
  else
    gs_update_stream_kernel<TV, 1><<<blocks, threads, 0, stream>>>(
        vt, w, h, out, m1, n, pieces);
  return cudaGetLastError();
}

}  // namespace repro

// v (m1, n) f32 or bf16, row-major; z (n,) f32; out (m1 + 1, 2) f32;
// part holds 2 (m1 + 1) grid floats; rows 0..j valid.
extern "C" int repro_sr_payload(const void* v, int v_bf16, const float* z,
                                float* out, float* part, int grid, int m1,
                                int n, int j, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_sr_payload<repro::bf16>(v, z, out, part, grid,
                                                        m1, n, j, s)
                : repro::launch_sr_payload<float>(v, z, out, part, grid, m1,
                                                  n, j, s);
}

// v (m1, n) f32 or bf16, row-major; w (n,), h (m1,) (any 4-byte offset),
// out (n,) f32; the launch shape of tuning.gemv_stream_shape (pieces > 0:
// v, w, out and the row stride 16-byte aligned).
extern "C" int repro_gs_update(const void* v, int v_bf16, const float* w,
                               const float* h, float* out, int m1, int n,
                               int threads, int blocks, int unroll,
                               int pieces, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_gs_update<repro::bf16>(
                      v, w, h, out, m1, n, threads, blocks, unroll, pieces, s)
                : repro::launch_gs_update<float>(v, w, h, out, m1, n, threads,
                                                 blocks, unroll, pieces, s);
}

// v (m1, n) f32 or bf16, row-major; w (n,) f32; out (m1,) f32; part holds
// m1 blocks floats; rows 0..j valid; the launch shape of
// tuning.gemv_stream_shape (pieces > 0: v, w and, past one row, the row
// stride 16-byte aligned), or with by_row a block of kThreads a valid row
// (blocks = j + 1; threads, unroll and part unused).
extern "C" int repro_gs_project_partial(const void* v, int v_bf16,
                                        const float* w, float* out,
                                        float* part, int m1, int n, int j,
                                        int by_row, int threads, int blocks,
                                        int unroll, int pieces,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_gs_partial<repro::bf16>(
                      v, w, out, part, m1, n, j, by_row, threads, blocks,
                      unroll, pieces, s)
                : repro::launch_gs_partial<float>(v, w, out, part, m1, n, j,
                                                  by_row, threads, blocks,
                                                  unroll, pieces, s);
}
