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
// The update needs no reduction: a plain grid, a thread per column, h in
// shared memory, the rows summed in order with fma (common.cuh's
// stream_update).  A row whose h is 0 adds exactly 0, so the pipelined
// cycle passes the row prefix V[:j+1] (h is 0 past row j there) and gets
// the bits of the full call.
//
// The split-phase projection of the row-sharded CGS2 step:
//
//   partial   h = mask * (V w)                                 (m1,)
//
// replaces repro/kernels/cgs2.py::gs_project_partial (its Pallas kernel
// accumulates mask * (V_local w_local) over a sequential grid of column
// tiles; the caller all-reduces it across the shards, then runs gs_update).
// Bound: bytes, ((j + 1) s_V + 4) n: rows 0..j of V and w once, 0.021 ms
// at n = 2^20, j = 15, f32, as the payload.  Design: the payload kernel
// with one column and no norm row: w's slice staged in shared memory,
// rows 0..j eight at a time, partials [entry][block], then the same
// fixed-order reduction launch.  Rows past j are never read (written as
// zeros by the reduction), so one rank gives the bits of the partials'
// order alone, and the all-reduce's order is the only other.
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

// Dynamic shared memory: ws[cols], red[kWarps * kRowChunk].
template <typename TV>
__global__ void __launch_bounds__(kThreads)
    gs_partial_kernel(const TV* __restrict__ v, const float* __restrict__ w,
                      float* __restrict__ part, int n, int j, int cols) {
  extern __shared__ float smem[];
  float* ws = smem;
  float* red = ws + cols;
  const int nb = gridDim.x;
  const int c0 = blockIdx.x * cols;
  const int len = max(0, min(cols, n - c0));
  const int rows = j + 1;
  for (int c = threadIdx.x; c < len; c += blockDim.x) ws[c] = w[c0 + c];
  __syncthreads();
  for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
    const int nr = rows - r0 < kRowChunk ? rows - r0 : kRowChunk;
    float acc[kRowChunk];
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.f;
    const TV* vr = v + (size_t)r0 * n + c0;
    for (int c = threadIdx.x; c < len; c += blockDim.x) {
      float vv[kRowChunk];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
        vv[r] = r < nr ? to_f(vr[(size_t)r * n + c]) : 0.f;
      const float wc = ws[c];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) acc[r] = fmaf(vv[r], wc, acc[r]);
    }
    block_partials<kRowChunk>(acc, red, part, r0, nr, nb);
  }
}

template <typename TV>
__global__ void __launch_bounds__(kThreads)
    gs_update_kernel(const TV* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ h, float* __restrict__ out,
                     int m1, int n) {
  extern __shared__ float smem[];   // h
  for (int i = threadIdx.x; i < m1; i += blockDim.x) smem[i] = h[i];
  __syncthreads();
  const int c0 = blockIdx.x * kThreads;
  const int len = max(0, min(kThreads, n - c0));
  stream_update(v, w, out, smem, m1, c0, len, n);
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

template <typename TV>
static cudaError_t launch_gs_partial(const void* v, const float* w,
                                     float* out, float* part, int grid,
                                     int m1, int n, int j,
                                     cudaStream_t stream) {
  if (m1 <= 0 || n <= 0 || j < 0 || j >= m1 || grid < 1 || grid > n)
    return cudaErrorInvalidValue;
  auto kernel = gs_partial_kernel<TV>;
  const int cols = (n + grid - 1) / grid;
  const size_t smem = sizeof(float) * ((size_t)cols + kWarps * kRowChunk);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const TV*>(v), w, part,
                                           n, j, cols);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // rows j+1..m1-1 are masked to zero
  return launch_reduce_partials(part, grid, m1, j + 1, m1, out, stream);
}

template <typename TV>
static cudaError_t launch_gs_update(const void* v, const float* w,
                                    const float* h, float* out, int m1, int n,
                                    cudaStream_t stream) {
  if (m1 <= 0 || n <= 0) return cudaErrorInvalidValue;
  auto kernel = gs_update_kernel<TV>;
  const size_t smem = sizeof(float) * (size_t)m1;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
      static_cast<const TV*>(v), w, h, out, m1, n);
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

// v (m1, n) f32 or bf16, row-major; w (n,), h (m1,), out (n,) f32.
extern "C" int repro_gs_update(const void* v, int v_bf16, const float* w,
                               const float* h, float* out, int m1, int n,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_gs_update<repro::bf16>(v, w, h, out, m1, n, s)
                : repro::launch_gs_update<float>(v, w, h, out, m1, n, s);
}

// v (m1, n) f32 or bf16, row-major; w (n,) f32; out (m1,) f32; part holds
// m1 grid floats; rows 0..j valid.
extern "C" int repro_gs_project_partial(const void* v, int v_bf16,
                                        const float* w, float* out,
                                        float* part, int grid, int m1, int n,
                                        int j, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_gs_partial<repro::bf16>(v, w, out, part, grid,
                                                        m1, n, j, s)
                : repro::launch_gs_partial<float>(v, w, out, part, grid, m1,
                                                  n, j, s);
}
