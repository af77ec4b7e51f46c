// One classical Gram-Schmidt pass: h = mask * (V w), w' = w - h^T V, with
// mask selecting the valid basis rows 0..j.
//
// Replaces repro/kernels/cgs2.py::gs_project (`cgs2` is two calls), the
// Pallas kernel whose sequential two-phase grid carries h in VMEM from the
// projection phase to the update phase.
//
// Bound: latency, not bytes.  At the solver's main path (m1 = 31,
// n = 10,000, f32) the whole basis is 1.24 MB, 0.4 us of HBM time, so the
// cost is the launch and the one grid-wide exchange of h, which depends on
// all of w.
//
// Design: one cooperative launch.  Hopper's blocks run in no order, so the
// TPU's "phase 0 then phase 1" becomes a grid.sync() between them.  Block b
// loads its column slice of the j+1 valid rows of V into shared memory once
// (only those rows are read), projects its slice of w onto it, writes one
// partial h per row, syncs the grid, sums every block's partials itself (all
// blocks in the same order, so they agree without a second sync) and
// updates its w slice from shared memory.  V is read from HBM once instead
// of twice, and h never leaves the chip until block 0 writes it.  The
// alternative, two launches (partials, then reduce + update), pays a second
// launch and a second read of V; the grid-synchronised pass is also the
// building block of the fused Arnoldi step (arnoldi_fused.cu), so one design
// serves both.
//
// Where a block's slice does not fit `smem_cap` even at one block per SM
// (31 rows x 7,944 columns = 985 KB at n = 2^20, the sparse solver's
// size), the launch takes the streamed variant instead, decided from the
// shape before any launch: the same pass with V read from global memory
// (common.cuh's streamed pass; V read twice, once to project and once to
// update) on `stream_blocks_per_sm` blocks per SM, which hide the streaming
// latency better than the one block per SM the shared-memory variant wants.
// Where a slice does fit, the shared-memory variant is the faster: at
// n = 10,000, j = 15 it takes 0.0060 ms against the streamed variant's
// 0.0066 at its best (1 block per SM) and 0.0165 at 8 (chip_smoke.py
// phase 5, f32, NVIDIA H100 80GB HBM3, 700.00 W).
#include "common.cuh"

namespace repro {

template <typename TV>
__global__ void __launch_bounds__(kThreads)
    gs_project_kernel(const TV* __restrict__ v, const float* __restrict__ w,
                      float* __restrict__ h, float* __restrict__ w_out,
                      float* __restrict__ part, int m1, int n, int j,
                      int cols) {
  extern __shared__ float smem[];
  GsSmem s(smem, m1, cols);
  cg::grid_group grid = cg::this_grid();
  const int rows = j + 1;
  const int c0 = blockIdx.x * cols;
  const int len = max(0, min(cols, n - c0));

  load_basis_slice(v, n, rows, c0, len, cols, s.vs);
  for (int c = threadIdx.x; c < len; c += blockDim.x) s.ws[c] = w[c0 + c];
  for (int i = threadIdx.x; i < m1; i += blockDim.x) s.htot[i] = 0.f;
  __syncthreads();

  gs_pass(grid, s, part, rows, len, cols);

  for (int c = threadIdx.x; c < len; c += blockDim.x) w_out[c0 + c] = s.ws[c];
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < m1; i += blockDim.x)
      h[i] = i < rows ? s.htot[i] : 0.f;
}

// The same pass with V streamed from global memory: one lane of
// common.cuh's streamed pass.
template <typename TV>
__global__ void __launch_bounds__(kThreads)
    gs_project_stream_kernel(const TV* __restrict__ v,
                             const float* __restrict__ w,
                             float* __restrict__ h, float* __restrict__ w_out,
                             float* __restrict__ part, int m1, int n, int j,
                             int bpl, int cols) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* red = smem + 2 * m1;
  cg::grid_group grid = cg::this_grid();
  const int rows = j + 1;
  const int c0 = blockIdx.x * cols;
  const int len = max(0, min(cols, n - c0));
  stream_project(v, w, rows, c0, len, n, part, bpl, blockIdx.x, red);
  grid.sync();
  stream_reduce(part, rows, bpl, hs);
  stream_update(v, w, w_out, hs, rows, c0, len, n);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < m1; i += blockDim.x)
      h[i] = i < rows ? hs[i] : 0.f;
}

// Does a block's slice fit `smem_cap` at one block per SM?  (The
// shared-memory variant's largest grid has the smallest slices.)
static cudaError_t slice_fits(int m1, int n, int smem_cap, bool* fits) {
  thread_local int last_dev = -1, last_sms = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != last_dev) {
    e = cudaDeviceGetAttribute(&last_sms, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
    last_dev = dev;
  }
  const int g = last_sms < n ? last_sms : n;
  *fits = gs_smem_bytes(m1, (n + g - 1) / g) <= (size_t)smem_cap;
  return cudaSuccess;
}

template <typename TV>
static cudaError_t launch_gs_project_stream(const void* v, const float* w,
                                            float* h, float* w_out,
                                            float* part, int part_blocks,
                                            int m1, int n, int j,
                                            int blocks_per_sm,
                                            cudaStream_t stream) {
  auto kernel = gs_project_stream_kernel<TV>;
  StreamShape sh;
  cudaError_t e = stream_shape(kernel, 1, m1, n, blocks_per_sm, &sh);
  if (e != cudaSuccess) return e;
  if (sh.bpl > part_blocks) return cudaErrorInvalidValue;
  const TV* vt = static_cast<const TV*>(v);
  int bpl = sh.bpl, cols = sh.cols;
  void* args[] = {(void*)&vt,   (void*)&w, (void*)&h, (void*)&w_out,
                  (void*)&part, (void*)&m1, (void*)&n, (void*)&j,
                  (void*)&bpl,  (void*)&cols};
  e = cudaLaunchCooperativeKernel((const void*)kernel, bpl, kThreads, args,
                                  sh.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TV>
static cudaError_t launch_gs_project(const void* v, const float* w, float* h,
                                     float* w_out, float* part,
                                     int part_blocks, int m1, int n, int j,
                                     int smem_cap, int blocks_per_sm,
                                     int stream_blocks_per_sm,
                                     cudaStream_t stream) {
  if (j < 0 || j >= m1) return cudaErrorInvalidValue;
  bool fits = true;
  cudaError_t e = slice_fits(m1, n, smem_cap, &fits);
  if (e != cudaSuccess) return e;
  if (!fits)
    return launch_gs_project_stream<TV>(v, w, h, w_out, part, part_blocks,
                                        m1, n, j, stream_blocks_per_sm,
                                        stream);
  auto kernel = gs_project_kernel<TV>;
  CoopShape sh;
  e = coop_shape(kernel, m1, n, smem_cap, blocks_per_sm, &sh);
  if (e != cudaSuccess) return e;
  if (sh.grid > part_blocks) return cudaErrorInvalidValue;
  const TV* vt = static_cast<const TV*>(v);
  int cols = sh.cols;
  void* args[] = {(void*)&vt, (void*)&w, (void*)&h,  (void*)&w_out,
                  (void*)&part, (void*)&m1, (void*)&n, (void*)&j,
                  (void*)&cols};
  e = cudaLaunchCooperativeKernel((const void*)kernel, sh.grid, kThreads, args,
                                  sh.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_gs_project(const void* v, int v_bf16, const float* w,
                                float* h, float* w_out, float* part,
                                int part_blocks, int m1, int n, int j,
                                int smem_cap, int blocks_per_sm,
                                int stream_blocks_per_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_gs_project<repro::bf16>(
                      v, w, h, w_out, part, part_blocks, m1, n, j, smem_cap,
                      blocks_per_sm, stream_blocks_per_sm, s)
                : repro::launch_gs_project<float>(
                      v, w, h, w_out, part, part_blocks, m1, n, j, smem_cap,
                      blocks_per_sm, stream_blocks_per_sm, s);
}

// The launch shape repro_gs_project would use: out = {grid, cols, smem};
// cols is the slice width of either variant.
extern "C" int repro_gs_project_shape(int v_bf16, int m1, int n, int smem_cap,
                                      int blocks_per_sm,
                                      int stream_blocks_per_sm, int* out) {
  bool fits = true;
  cudaError_t e = repro::slice_fits(m1, n, smem_cap, &fits);
  if (e != cudaSuccess) return e;
  if (!fits) {
    repro::StreamShape sh;
    e = v_bf16 ? repro::stream_shape(
                     repro::gs_project_stream_kernel<repro::bf16>, 1, m1, n,
                     stream_blocks_per_sm, &sh)
               : repro::stream_shape(repro::gs_project_stream_kernel<float>,
                                     1, m1, n, stream_blocks_per_sm, &sh);
    out[0] = sh.bpl;
    out[1] = sh.cols;
    out[2] = (int)sh.smem;
    return e;
  }
  repro::CoopShape sh;
  e = v_bf16 ? repro::coop_shape(repro::gs_project_kernel<repro::bf16>, m1, n,
                                 smem_cap, blocks_per_sm, &sh)
             : repro::coop_shape(repro::gs_project_kernel<float>, m1, n,
                                 smem_cap, blocks_per_sm, &sh);
  out[0] = sh.grid;
  out[1] = sh.cols;
  out[2] = (int)sh.smem;
  return e;
}
