// Per-lane CGS2 for the block (multi-RHS) solver.  For every lane l with
// valid basis rows 0..j_l of its own basis V_l (m1, n):
//
//   h1 = V_l w_l,  w1 = w_l - V_l^T h1,  h2 = V_l w1,  w'' = w1 - V_l^T h2
//
// and h_l = h1 + h2 (entries past j_l zero).  A lane with j_l = -1 is
// skipped: h_l = 0 and w''_l = w_l.  w'' is left unnormalised.
//
// Replaces repro/kernels/block_gs.py::batched_cgs2, the Pallas kernel whose
// grid walks the lanes in order, each grid step holding one lane's whole
// basis in VMEM and running both passes against it.
//
// Bound: bytes.  The step must read each lane's valid rows of V once and w
// and w'' once: sum_l (j_l + 1) * n * s + 8 k n bytes (s the basis storage
// size).  At k = 4 lanes, n = 2^20, f32, j = 29 that is 520 MB, 0.155 ms at
// 3.35 TB/s; the reductions are 4 flops per element of V, far below the
// card's rate.
//
// Design: one cooperative launch whose blocks cover (lane, column slice):
// block b of lane l owns columns [b * cols, b * cols + len) of V_l and w_l.
// A lane's h depends on all of its w, and Hopper's blocks run in no order,
// so each pass is the design of gs_project (cgs2.cu) per lane: the block
// writes one partial sum per valid row to part[lane][row][block], the grid
// syncs once, and every block of the lane sums its lane's partials itself,
// in one fixed order, so all of them hold the same h without a second sync.
// The two passes use separate partials buffers (a slow block may still be
// reading the first).  The TPU kernel holds a lane's basis in VMEM; a
// lane's basis is 130 MB at n = 2^20 and 1 MB at n = 8192, so a block's
// slice fits no shared memory at the large size, and this kernel streams V
// from global memory in every phase (common.cuh's streamed pass: a
// project sweep summing eight rows per thread at once, the grid sync, the
// lane's reduction, an update sweep).  That reads V four times per step
// (twice per pass), against the bound's once.  Two levers are left for a later version: fusing the first update
// with the second projection (three reads), and keeping the slice resident
// in shared memory where it fits (k = 8, n = 8192 fits in 132 blocks).
// The grid is sized with the occupancy calculator so the cooperative launch
// is legal; lanes beyond what can be co-resident make the launch fail with
// an error, never fall back.
#include "common.cuh"

namespace repro {

template <typename TV>
__global__ void __launch_bounds__(kThreads)
    batched_cgs2_kernel(const TV* __restrict__ v, const float* __restrict__ w,
                        const int* __restrict__ jl, float* __restrict__ h,
                        float* w_out, float* part, int k, int m1, int n,
                        int bpl, int cols) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* htot = smem + m1;
  float* red = smem + 2 * m1;
  cg::grid_group grid = cg::this_grid();
  const int l = blockIdx.x / bpl;
  const int b = blockIdx.x - l * bpl;
  const int rows = __ldg(jl + l) + 1;
  const int c0 = b * cols;
  const int len = max(0, min(cols, n - c0));
  const TV* vl = v + (size_t)l * m1 * n;
  const float* wl = w + (size_t)l * n;
  float* wo = w_out + (size_t)l * n;
  float* p1 = part + (size_t)l * m1 * bpl;
  float* p2 = part + ((size_t)k + l) * m1 * bpl;
  for (int i = threadIdx.x; i < m1; i += blockDim.x) htot[i] = 0.f;

  // pass 1: w1 = w - V^T (V w), into w_out
  stream_project(vl, wl, rows, c0, len, n, p1, bpl, b, red);
  grid.sync();
  stream_reduce(p1, rows, bpl, hs);
  stream_update(vl, wl, wo, hs, rows, c0, len, n);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) htot[i] += hs[i];
  __syncthreads();   // the block's w1 slice is complete (and visible)

  // pass 2: w'' = w1 - V^T (V w1), in place
  stream_project(vl, wo, rows, c0, len, n, p2, bpl, b, red);
  grid.sync();
  stream_reduce(p2, rows, bpl, hs);
  stream_update(vl, wo, wo, hs, rows, c0, len, n);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) htot[i] += hs[i];
  __syncthreads();

  if (b == 0)
    for (int i = threadIdx.x; i < m1; i += blockDim.x)
      h[(size_t)l * m1 + i] = i < rows ? htot[i] : 0.f;
}

template <typename TV>
static cudaError_t launch_batched_cgs2(const void* v, const float* w,
                                       const int* jl, float* h, float* w_out,
                                       float* part, int part_blocks, int k,
                                       int m1, int n, int blocks_per_sm,
                                       cudaStream_t stream) {
  if (k <= 0 || m1 <= 0 || n <= 0) return cudaErrorInvalidValue;
  auto kernel = batched_cgs2_kernel<TV>;
  StreamShape sh;
  cudaError_t e = stream_shape(kernel, k, m1, n, blocks_per_sm, &sh);
  if (e != cudaSuccess) return e;
  if (sh.bpl > part_blocks) return cudaErrorInvalidValue;
  const TV* vt = static_cast<const TV*>(v);
  int bpl = sh.bpl, cols = sh.cols;
  void* args[] = {(void*)&vt,   (void*)&w,  (void*)&jl, (void*)&h,
                  (void*)&w_out, (void*)&part, (void*)&k, (void*)&m1,
                  (void*)&n,    (void*)&bpl, (void*)&cols};
  e = cudaLaunchCooperativeKernel((const void*)kernel, k * bpl, kThreads,
                                  args, sh.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace repro

// v (k, m1, n) f32 or bf16; w (k, n) f32; jl (k,) int32 in device memory,
// each in -1..m1-1; h (k, m1) and w_out (k, n) f32; part holds
// 2 * k * m1 * part_blocks floats.
extern "C" int repro_batched_cgs2(const void* v, int v_bf16, const float* w,
                                  const int* jl, float* h, float* w_out,
                                  float* part, int part_blocks, int k, int m1,
                                  int n, int blocks_per_sm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_batched_cgs2<repro::bf16>(
                      v, w, jl, h, w_out, part, part_blocks, k, m1, n,
                      blocks_per_sm, s)
                : repro::launch_batched_cgs2<float>(
                      v, w, jl, h, w_out, part, part_blocks, k, m1, n,
                      blocks_per_sm, s);
}

// The launch shape repro_batched_cgs2 would use: out = {grid, cols, smem}.
extern "C" int repro_batched_cgs2_shape(int v_bf16, int k, int m1, int n,
                                        int blocks_per_sm, int* out) {
  repro::StreamShape sh;
  const cudaError_t e =
      v_bf16 ? repro::stream_shape(repro::batched_cgs2_kernel<repro::bf16>, k,
                                m1, n, blocks_per_sm, &sh)
             : repro::stream_shape(repro::batched_cgs2_kernel<float>, k, m1, n,
                                blocks_per_sm, &sh);
  out[0] = k * sh.bpl;
  out[1] = sh.cols;
  out[2] = (int)sh.smem;
  return e;
}
