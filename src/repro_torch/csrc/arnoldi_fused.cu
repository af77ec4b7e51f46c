// One fused Arnoldi step: w = A v_j, then both classical Gram-Schmidt passes
// of CGS2 against the valid basis rows 0..j.  Returns h = h1 + h2 (m1,) and
// the unnormalised w'' (n,); normalisation stays with the caller.
//
// Replaces repro/kernels/arnoldi_fused.py::arnoldi_step, the Pallas kernel
// that streams A in phase 0 and runs both passes in phase 1 against the
// whole (m+1, n) basis held in one VMEM block, so w and h never round-trip
// through HBM.
//
// Bound: memory.  The step reads A once (400 MB at n = 10,000, f32; 200 MB
// in bf16) and the basis once (1.24 MB); 400 MB / 3.35 TB/s = 0.119 ms.
//
// Design: one persistent cooperative kernel.  The whole basis does not fit
// a block's 227 KB of shared memory at solver sizes (1.24 MB), so the basis
// is cut by columns instead: block b owns rows [c0, c0 + len) of A, which
// are the entries [c0, c0 + len) of w, and loads the same column slice of V
// (about 9.5 KB at n = 10,000 on 132 blocks) into shared memory once.
//   phase 0  the block's rows of A stream through all of its warps: warp k
//            takes the k-th eighth of the columns of every row (16-byte
//            loads, bf16 widened in registers, v_j read in vector loads
//            from L2), and the eight partial sums of a row are added in a
//            fixed order.  Every warp has the same work whatever the number
//            of rows per block, so no warp idles while the others stream.
//            The block's w slice lands in shared memory; no grid sync is
//            needed, the passes below only touch the block's own slice.
//   passes   two grid-synchronised GS passes (common.cuh::gs_pass), each
//            with its own partials buffer; h is reduced by every block.
// w'' and h are written to HBM once.  The grid is sized by the occupancy
// calculator so the cooperative launch is legal; a launch that could not
// be co-resident is refused and the error returned to the caller.
#include "common.cuh"

namespace repro {

// v_j (storage TV) as the other operand of A's rows (storage TA): widened,
// then rounded to TA, as the TPU kernel casts v_j to A's dtype first.
template <typename TA, typename TV>
struct BasisRowX {
  static constexpr int V = Vec16<TA>::N;   // columns per vector load of A
  static constexpr int kAlign = V * sizeof(TV) < 16 ? V * sizeof(TV) : 16;
  const TV* __restrict__ vj;
  __device__ __forceinline__ void fma(float (&acc)[1], float a, int c) const {
    acc[0] = fmaf(a, round_to<TA>(to_f(vj[c])), acc[0]);
  }
  __device__ __forceinline__ bool vec_ok(int head) const {
    return (((uintptr_t)(vj + head)) % kAlign) == 0;
  }
  template <int VA>
  __device__ __forceinline__ void fma_vec(float (&acc)[1], const float* a,
                                          int c0) const {
    float xs[VA];
    load_floats<TV, VA>(vj + c0, xs);
#pragma unroll
    for (int e = 0; e < VA; ++e)
      acc[0] = fmaf(a[e], round_to<TA>(xs[e]), acc[0]);
  }
};

template <typename TA, typename TV>
__global__ void __launch_bounds__(kThreads)
    arnoldi_step_kernel(const TA* __restrict__ a, const TV* __restrict__ v,
                        float* __restrict__ h, float* __restrict__ w_out,
                        float* __restrict__ part, int m1, int n, int j,
                        int cols) {
  extern __shared__ float smem[];
  GsSmem s(smem, m1, cols);
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = j + 1;
  const int c0 = blockIdx.x * cols;
  const int len = max(0, min(cols, n - c0));

  load_basis_slice(v, n, rows, c0, len, cols, s.vs);
  for (int i = threadIdx.x; i < m1; i += blockDim.x) s.htot[i] = 0.f;

  // Phase 0.  The column segments are multiples of 16 elements, so an
  // aligned row gives aligned segments.
  const int seg = ((n + kWarps - 1) / kWarps + 15) / 16 * 16;
  const int cb = min(n, warp * seg), ce = min(n, cb + seg);
  const BasisRowX<TA, TV> vj{v + (size_t)j * n + cb};
  for (int r = 0; r < len; ++r) {
    float acc[1] = {0.f};
    row_dot<TA, 1>(a + (size_t)(c0 + r) * n + cb, ce - cb, lane, vj, acc);
    acc[0] = warp_sum(acc[0]);
    if (lane == 0) s.ps[r * kWarps + warp] = acc[0];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < len; r += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += s.ps[r * kWarps + k];
    s.ws[r] = sum;
  }
  __syncthreads();

  gs_pass(grid, s, part, rows, len, cols);
  gs_pass(grid, s, part + (size_t)gridDim.x * m1, rows, len, cols);

  for (int c = threadIdx.x; c < len; c += blockDim.x) w_out[c0 + c] = s.ws[c];
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < m1; i += blockDim.x)
      h[i] = i < rows ? s.htot[i] : 0.f;
}

template <typename TA, typename TV>
static cudaError_t launch_arnoldi_step(const void* a, const void* v, float* h,
                                       float* w_out, float* part,
                                       int part_blocks, int m1, int n, int j,
                                       int smem_cap, int blocks_per_sm,
                                       cudaStream_t stream) {
  if (j < 0 || j >= m1) return cudaErrorInvalidValue;
  auto kernel = arnoldi_step_kernel<TA, TV>;
  CoopShape sh;
  cudaError_t e = coop_shape(kernel, m1, n, smem_cap, blocks_per_sm, &sh);
  if (e != cudaSuccess) return e;
  if (sh.grid > part_blocks) return cudaErrorInvalidValue;   // per buffer
  const TA* at = static_cast<const TA*>(a);
  const TV* vt = static_cast<const TV*>(v);
  int cols = sh.cols;
  void* args[] = {(void*)&at,   (void*)&vt, (void*)&h, (void*)&w_out,
                  (void*)&part, (void*)&m1, (void*)&n, (void*)&j,
                  (void*)&cols};
  e = cudaLaunchCooperativeKernel((const void*)kernel, sh.grid, kThreads, args,
                                  sh.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TA, typename TV>
static cudaError_t arnoldi_step_shape(int m1, int n, int smem_cap,
                                      int blocks_per_sm, CoopShape* sh) {
  return coop_shape(arnoldi_step_kernel<TA, TV>, m1, n, smem_cap,
                    blocks_per_sm, sh);
}

}  // namespace repro

extern "C" int repro_arnoldi_step(const void* a, int a_bf16, const void* v,
                                  int v_bf16, float* h, float* w_out,
                                  float* part, int part_blocks, int m1, int n,
                                  int j, int smem_cap, int blocks_per_sm,
                                  void* stream) {
  using repro::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ARNOLDI(TA, TV)                                               \
  repro::launch_arnoldi_step<TA, TV>(a, v, h, w_out, part, part_blocks, m1, \
                                     n, j, smem_cap, blocks_per_sm, s)
  if (a_bf16)
    return v_bf16 ? REPRO_ARNOLDI(bf16, bf16) : REPRO_ARNOLDI(bf16, float);
  return v_bf16 ? REPRO_ARNOLDI(float, bf16) : REPRO_ARNOLDI(float, float);
#undef REPRO_ARNOLDI
}

// The launch shape repro_arnoldi_step would use: out = {grid, cols, smem}.
extern "C" int repro_arnoldi_step_shape(int a_bf16, int v_bf16, int m1, int n,
                                        int smem_cap, int blocks_per_sm,
                                        int* out) {
  using repro::bf16;
  repro::CoopShape sh;
#define REPRO_SHAPE(TA, TV) \
  repro::arnoldi_step_shape<TA, TV>(m1, n, smem_cap, blocks_per_sm, &sh)
  const cudaError_t e =
      a_bf16 ? (v_bf16 ? REPRO_SHAPE(bf16, bf16) : REPRO_SHAPE(bf16, float))
             : (v_bf16 ? REPRO_SHAPE(float, bf16) : REPRO_SHAPE(float, float));
#undef REPRO_SHAPE
  out[0] = sh.grid;
  out[1] = sh.cols;
  out[2] = (int)sh.smem;
  return e;
}
