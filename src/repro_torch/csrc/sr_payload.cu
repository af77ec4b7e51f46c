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
// the same bits every run.  Its first design staged a block's slices of
// z and v_j in shared memory with 4-byte loads, then walked the valid
// rows eight at a time, each chunk a 4-byte column loop and a
// block_partials with its barriers: 0.0507 ms f32 (0.0364 bf16) cold at
// n = 2^20, j = 15, against a 0.0213 bound, the design the GEMV pair had
// before its 16-byte redesign.  Now it is the projection's column sweep
// below with two right-hand columns (K = 2): z's 16-byte piece loaded
// once into registers, v_j's piece row j's own load, the two sums of
// every row 0..j-1 and v_j.z, v_j.v_j, z.z in one sweep; a short basis
// takes the projection's block a row.  Rows past j are never read.
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

// ---------------------------------------------------------------------------
// The streaming GEMV kernels (gs_update, gs_project_partial, the payload):
// 16-byte pieces, every row of a piece in flight, no staging barrier.  The
// launch shape (threads, blocks, unroll, pieces) is
// tuning.gemv_stream_shape's.  A
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

// The projection's column sweep.  K = 1 (gs_project_partial): V w over
// rows 0..rows-1.  K = 2 (the payload): V [z, v_j] over rows 0..rows-1
// with v_j = row `rows` of V (rows = j), and v_j.z, v_j.v_j, z.z: all of
// p in one sweep over rows 0..j.  Block b sums V[r, c] w[c] over its
// columns for every summed row, in buckets of R rows: one sweep over the
// columns per bucket, each thread's R x K sums in registers, w's piece
// (and v_j's: the payload's second column is v_j's own load, z and v_j
// are never staged) loaded once for the bucket's rows, U pieces at once
// (the 32-row bucket takes one: its 32 loads in flight fill the
// registers); the payload's three extra sums ride the first bucket.  Per
// sum a warp shuffle and the warp's sum to shared memory (red[warp][entry],
// no barrier between buckets); at the end one barrier, the warps summed in
// order into part[entry][block] (the payload's entries 2 r + c, its norms
// at 2 m1 and 2 m1 + 1, v_j.v_j also at 2 j + 1); reduce_partials_kernel
// then sums the blocks in one fixed order.  No float atomics: the same
// bits every run.
template <typename TV, int R, int U, int K>
__global__ void __launch_bounds__(kThreads)
    gs_partial_stream_kernel(const TV* __restrict__ v,
                             const float* __restrict__ w,
                             float* __restrict__ part, int rows, int n,
                             int pieces, int m1) {
  static_assert(K == 1 || K == 2, "one or two right-hand columns");
  constexpr int VEC = Vec16<TV>::N;
  constexpr int X = K == 2 ? 3 : 0;   // the payload's v_j.z, v_j.v_j, z.z
  extern __shared__ float red[];   // [warps][entries]
  const int entries = K * rows + X;
  const TV* vj = v + (size_t)rows * n;   // the payload's v_j
  const int nb = gridDim.x;
  const int G = nb * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int sweep_rows = K == 2 && rows == 0 ? 1 : rows;
  for (int r0 = 0; r0 < sweep_rows; r0 += R) {
    const int nr = min(R, rows - r0);
    const bool first = r0 == 0;
    float acc[R][K], ex[X > 0 ? X : 1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < K; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int e = 0; e < X; ++e) ex[e] = 0.f;
    for (int p0 = t; p0 < pieces; p0 += U * G) {
      bool ok[U];
      float wv[U][VEC], jv[U][K == 2 ? VEC : 1];
      uint4 raw[U][R];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        ok[k] = p0 + k * G < pieces;
        if (ok[k]) {
          load_floats<float, VEC>(w + (size_t)(p0 + k * G) * VEC, wv[k]);
          if constexpr (K == 2)
            load_floats<TV, VEC>(vj + (size_t)(p0 + k * G) * VEC, jv[k]);
        }
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
            for (int c = 0; c < VEC; ++c) {
              acc[r][0] = fmaf(f[c], wv[k][c], acc[r][0]);
              if constexpr (K == 2)
                acc[r][1] = fmaf(f[c], jv[k][c], acc[r][1]);
            }
          }
        }
        if constexpr (K == 2) {
          if (first) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              ex[0] = fmaf(jv[k][c], wv[k][c], ex[0]);
              ex[1] = fmaf(jv[k][c], jv[k][c], ex[1]);
              ex[2] = fmaf(wv[k][c], wv[k][c], ex[2]);
            }
          }
        }
      }
    }
    for (int c = pieces * VEC + t; c < n; c += G) {
      const float wc = w[c];
      const float jc = K == 2 ? to_f(vj[c]) : 0.f;
      float vv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) vv[r] = to_f(v[(size_t)(r0 + r) * n + c]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          acc[r][0] = fmaf(vv[r], wc, acc[r][0]);
          if constexpr (K == 2) acc[r][1] = fmaf(vv[r], jc, acc[r][1]);
        }
      }
      if constexpr (K == 2) {
        if (first) {
          ex[0] = fmaf(jc, wc, ex[0]);
          ex[1] = fmaf(jc, jc, ex[1]);
          ex[2] = fmaf(wc, wc, ex[2]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {                  // uniform across the warp
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const float s = warp_sum(acc[r][c]);
          if (lane == 0) red[warp * entries + K * (r0 + r) + c] = s;
        }
      }
    }
    if constexpr (K == 2) {
      if (first) {
#pragma unroll
        for (int e = 0; e < X; ++e) {
          const float s = warp_sum(ex[e]);
          if (lane == 0) red[warp * entries + K * rows + e] = s;
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < warps; ++q) s += red[q * entries + e];
    if (K == 2 && e == entries - 1) {   // z.z
      part[(size_t)(2 * m1) * nb + blockIdx.x] = s;
    } else {
      part[(size_t)e * nb + blockIdx.x] = s;
      if (K == 2 && e == entries - 2)   // v_j.v_j, also the norm row's
        part[(size_t)(2 * m1 + 1) * nb + blockIdx.x] = s;
    }
  }
}

// The projection of a short basis (few pieces a row): block r sums row r
// alone, kRowPieces pieces of each thread's stride in flight at once (a
// row of 4,096 pieces in one round trip), and writes h[r] after a block
// sum in a fixed order; block 0 also writes the masked rows' zeros.  One
// launch and no step across blocks.  K = 2 (the payload, rows = j + 1
// blocks): block r < j sums row r against z and v_j, half as many pieces
// in flight (three loads a piece); block j, whose row is v_j, sums v_j.z,
// v_j.v_j and z.z and writes the norm row too.
constexpr int kRowPieces = 16;

template <typename TV, int K>
__global__ void __launch_bounds__(kThreads)
    gs_partial_rows_kernel(const TV* __restrict__ v,
                           const float* __restrict__ w,
                           float* __restrict__ out, int m1, int rows, int n,
                           int pieces) {
  static_assert(K == 1 || K == 2, "one or two right-hand columns");
  constexpr int VEC = Vec16<TV>::N;
  constexpr int RP = kRowPieces / K;
  __shared__ float red[kWarps];
  const TV* row = v + (size_t)blockIdx.x * n;
  const TV* vj = v + (size_t)(rows - 1) * n;   // the payload's v_j
  const bool last = K == 2 && (int)blockIdx.x == rows - 1;   // row j = v_j
  float acc[K + 1] = {};
  for (int p0 = threadIdx.x; p0 < pieces; p0 += RP * kThreads) {
    uint4 raw[RP], jraw[K == 2 ? RP : 1];
    float wv[RP][VEC];
#pragma unroll
    for (int k = 0; k < RP; ++k) {
      const int p = p0 + k * kThreads;
      if (p < pieces) {
        raw[k] = __ldg(reinterpret_cast<const uint4*>(row + (size_t)p * VEC));
        load_floats<float, VEC>(w + (size_t)p * VEC, wv[k]);
        if constexpr (K == 2)
          if (!last)
            jraw[k] = __ldg(
                reinterpret_cast<const uint4*>(vj + (size_t)p * VEC));
      }
    }
#pragma unroll
    for (int k = 0; k < RP; ++k) {
      if (p0 + k * kThreads < pieces) {
        float f[VEC];
        Vec16<TV>::unpack(raw[k], f);
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[0] = fmaf(f[c], wv[k][c], acc[0]);
        if constexpr (K == 2) {
          if (last) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              acc[1] = fmaf(f[c], f[c], acc[1]);
              acc[2] = fmaf(wv[k][c], wv[k][c], acc[2]);
            }
          } else {
            float g[VEC];
            Vec16<TV>::unpack(jraw[k], g);
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[1] = fmaf(f[c], g[c], acc[1]);
          }
        }
      }
    }
  }
  for (int c = pieces * VEC + threadIdx.x; c < n; c += kThreads) {
    const float fc = to_f(row[c]), wc = w[c];
    acc[0] = fmaf(fc, wc, acc[0]);
    if constexpr (K == 2) {
      if (last) {
        acc[1] = fmaf(fc, fc, acc[1]);
        acc[2] = fmaf(wc, wc, acc[2]);
      } else {
        acc[1] = fmaf(fc, to_f(vj[c]), acc[1]);
      }
    }
  }
  const float s = block_sum(acc[0], red);
  if constexpr (K == 1) {
    if (threadIdx.x == 0) out[blockIdx.x] = s;
    if (blockIdx.x == 0)
      for (int r = rows + threadIdx.x; r < m1; r += kThreads) out[r] = 0.f;
  } else {
    const float s1 = block_sum(acc[1], red);
    const float s2 = last ? block_sum(acc[2], red) : 0.f;   // uniform
    if (threadIdx.x == 0) {
      out[2 * blockIdx.x] = s;
      out[2 * blockIdx.x + 1] = s1;
      if (last) {
        out[2 * m1] = s2;
        out[2 * m1 + 1] = s1;
      }
    }
    if (blockIdx.x == 0)
      for (int e = 2 * rows + threadIdx.x; e < 2 * m1; e += kThreads)
        out[e] = 0.f;
  }
}

// A launch shape the stream kernels take: whole warps, at most kThreads,
// and every piece inside [0, n).
template <typename TV>
static bool stream_shape_ok(int n, int threads, int blocks, int pieces) {
  return threads >= 32 && threads <= kThreads && threads % 32 == 0 &&
         blocks >= 1 && pieces >= 0 &&
         (long long)pieces * Vec16<TV>::N <= (long long)n;
}

// The column sweep, then the fixed-order sum of its partials: K = 1, m1
// entries (rows past rows - 1 written as zeros); K = 2, the payload's
// 2 (m1 + 1) (rows j + 1 .. m1 - 1 written as zeros).
template <typename TV, int R, int U, int K>
static cudaError_t launch_gs_partial_bucket(const TV* v, const float* w,
                                            float* part, float* out, int m1,
                                            int rows, int n, int threads,
                                            int blocks, int pieces,
                                            cudaStream_t stream) {
  const int entries = K * rows + (K == 2 ? 3 : 0);
  const size_t smem = sizeof(float) * (size_t)(threads / 32) * entries;
  auto kernel = gs_partial_stream_kernel<TV, R, U, K>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, smem, stream>>>(v, w, part, rows, n, pieces, m1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return K == 1 ? launch_reduce_partials(part, blocks, m1, rows, m1, out,
                                         stream)
                : launch_reduce_partials(part, blocks, 2 * (m1 + 1),
                                         2 * (rows + 1), 2 * m1, out, stream);
}

// The projections (K = 1: gs_project_partial over rows 0..j; K = 2: the
// payload over rows 0..j, v_j = row j): a block a row, or the column sweep
// over the rows it sums (K = 1: j + 1; K = 2: j, v_j being its second
// column) in buckets of R rows, U pieces at once as the plan says (one in
// the 32-row bucket).  K = 1 takes the bucket that holds its rows; K = 2
// the plan's `bucket`, 8 or 16 (looped where the rows are more).
template <typename TV, int K>
static cudaError_t launch_gs_partial(const void* v, const float* w,
                                     float* out, float* part, int m1, int n,
                                     int j, int by_row, int threads,
                                     int blocks, int unroll, int bucket,
                                     int pieces, cudaStream_t stream) {
  if (m1 <= 0 || n <= 0 || j < 0 || j >= m1) return cudaErrorInvalidValue;
  const TV* vt = static_cast<const TV*>(v);
  if (by_row) {                      // a block of kThreads a row
    if (blocks != j + 1 ||
        !stream_shape_ok<TV>(n, kThreads, blocks, pieces))
      return cudaErrorInvalidValue;
    gs_partial_rows_kernel<TV, K><<<j + 1, kThreads, 0, stream>>>(
        vt, w, out, m1, j + 1, n, pieces);
    return cudaGetLastError();
  }
  if ((unroll != 1 && unroll != 2) ||
      !stream_shape_ok<TV>(n, threads, blocks, pieces))
    return cudaErrorInvalidValue;
  const int rows = K == 1 ? j + 1 : j;
  if (K == 1) bucket = rows <= 8 ? 8 : rows <= 16 ? 16 : 32;
#define REPRO_BUCKET(R, U)                                                  \
  launch_gs_partial_bucket<TV, R, U, K>(vt, w, part, out, m1, rows, n,      \
                                        threads, blocks, pieces, stream)
  if (bucket == 8)
    return unroll == 2 ? REPRO_BUCKET(8, 2) : REPRO_BUCKET(8, 1);
  if (bucket == 16)
    return unroll == 2 ? REPRO_BUCKET(16, 2) : REPRO_BUCKET(16, 1);
  if constexpr (K == 1)   // one piece at a time (K = 2 spilled here)
    if (bucket == 32) return REPRO_BUCKET(32, 1);
  return cudaErrorInvalidValue;
#undef REPRO_BUCKET
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

// The payload: v (m1, n) f32 or bf16, row-major; z (n,) f32; out
// (m1 + 1, 2) f32; rows 0..j valid; the launch shape of
// tuning.gemv_partial_shape(k=2) (pieces > 0: v, z and, past one row, the
// row stride 16-byte aligned): the column sweep in buckets of `bucket`
// rows (part holds 2 (m1 + 1) blocks floats) or with by_row a block of
// kThreads a valid row (blocks = j + 1; threads, unroll, bucket and part
// unused).
extern "C" int repro_sr_payload(const void* v, int v_bf16, const float* z,
                                float* out, float* part, int m1, int n,
                                int j, int by_row, int threads, int blocks,
                                int unroll, int bucket, int pieces,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_gs_partial<repro::bf16, 2>(
                      v, z, out, part, m1, n, j, by_row, threads, blocks,
                      unroll, bucket, pieces, s)
                : repro::launch_gs_partial<float, 2>(v, z, out, part, m1, n,
                                                     j, by_row, threads,
                                                     blocks, unroll, bucket,
                                                     pieces, s);
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
  return v_bf16 ? repro::launch_gs_partial<repro::bf16, 1>(
                      v, w, out, part, m1, n, j, by_row, threads, blocks,
                      unroll, 0, pieces, s)
                : repro::launch_gs_partial<float, 1>(v, w, out, part, m1, n,
                                                     j, by_row, threads,
                                                     blocks, unroll, 0,
                                                     pieces, s);
}
