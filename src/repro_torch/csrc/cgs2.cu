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

template <typename TV>
static cudaError_t launch_gs_project(const void* v, const float* w, float* h,
                                     float* w_out, float* part,
                                     int part_blocks, int m1, int n, int j,
                                     int smem_cap, int blocks_per_sm,
                                     cudaStream_t stream) {
  if (j < 0 || j >= m1) return cudaErrorInvalidValue;
  auto kernel = gs_project_kernel<TV>;
  CoopShape sh;
  cudaError_t e = coop_shape(kernel, m1, n, smem_cap, blocks_per_sm, &sh);
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
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_gs_project<repro::bf16>(
                      v, w, h, w_out, part, part_blocks, m1, n, j, smem_cap,
                      blocks_per_sm, s)
                : repro::launch_gs_project<float>(
                      v, w, h, w_out, part, part_blocks, m1, n, j, smem_cap,
                      blocks_per_sm, s);
}

// The launch shape repro_gs_project would use: out = {grid, cols, smem}.
extern "C" int repro_gs_project_shape(int v_bf16, int m1, int n, int smem_cap,
                                      int blocks_per_sm, int* out) {
  repro::CoopShape sh;
  const cudaError_t e =
      v_bf16 ? repro::coop_shape(repro::gs_project_kernel<repro::bf16>, m1, n,
                                 smem_cap, blocks_per_sm, &sh)
             : repro::coop_shape(repro::gs_project_kernel<float>, m1, n,
                                 smem_cap, blocks_per_sm, &sh);
  out[0] = sh.grid;
  out[1] = sh.cols;
  out[2] = (int)sh.smem;
  return e;
}
