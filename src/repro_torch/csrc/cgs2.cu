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
// Where a block's slice does not fit shared memory even at one block per
// SM (31 rows x 7,944 columns = 985 KB at n = 2^20, the sparse solver's
// size: kernels/tuning.py::gs_stream_plan decides from the shape), V
// streams from global memory instead, and `cgs2` is one launch, not two
// passes of two sweeps each: stream_gs.cuh's three sweeps as one lane over
// the whole grid, with two grid syncs.
//
//   sweep 1  h1 partials, sum_c V[r, c] w[c] for every valid row r;
//   sync     every block sums the partials itself, in one fixed order;
//   sweep 2  w1 = w - V^T h1 written, and the h2 partials summed from the
//            same V values in registers;
//   sync     h2, as after sweep 1;
//   sweep 3  w'' = w1 - V^T h2, in place over w1; h = h1 + h2.
//
// `gs_project` (one pass, the TPU kernel's own function) runs sweeps 1
// and 3 only (sweep 3 from w): V read twice.
//
// Bound: bytes.  cgs2 must read the valid rows of V once and w and w''
// once: (j + 1) n s_V + 8 n bytes, 0.0225 ms at j = 15, n = 2^20, f32 on
// an H100 (3.35 TB/s).  The three sweeps move V three times, w twice, w1
// twice and w'' once: 222 MB at that shape, 0.066 ms.  Each thread takes
// 16-byte pieces with up to 16 rows' loads in flight and no barrier per
// row chunk, on two blocks of 128 threads an SM (batched_cgs2.cu's design
// at one lane).  The streamed design this replaces ran the pass twice with
// 4-byte loads, 8 rows a chunk and two barriers a chunk, V four times a
// step: 0.075 ms a pass f32 (0.053 bf16) at j = 15 on an H100 80GB HBM3,
// 700.00 W (PERF.md section 6 has the two in turn).  A misaligned V, w
// or row stride takes the scalar route (pieces = 0), counted by the
// wrapper.  j is a kernel argument, passed by value: no copy to the card.
//
// A Hopper variant that kept a block's leading rows of V in shared memory
// (cp.async in sweep 1, read back in sweeps 2 and 3) was timed and left
// out: slower in bf16 at every step and in f32 at j = 0 and 7 (PERF.md
// section 6).
//
// Where a slice does fit, the shared-memory kernel is the faster: at
// n = 10,000, j = 15 it took 0.0060 ms against the earlier streamed
// design's 0.0066 at its best (chip_smoke.py phase 5, f32, NVIDIA H100 80GB HBM3,
// 700.00 W).
#include "stream_gs.cuh"

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


// The streamed pass: passes = 2 (cgs2: sweeps 1, 2, 3) or 1 (gs_project:
// sweeps 1 and 3 from w).  part: passes m1 G floats.  Dynamic shared
// memory: bc_smem_bytes(m1).
template <typename TV>
__global__ void __launch_bounds__(kBcThreads, kBcBlocksPerSm)
    gs_stream_kernel(const TV* __restrict__ v, const float* w, float* h,
                     float* w_out, float* part, int m1, int n, int j,
                     int pieces, int passes) {
  extern __shared__ __align__(16) float gs_stream_smem[];
  float* hs1 = gs_stream_smem;
  float* hs2 = gs_stream_smem + m1;
  float* red = gs_stream_smem + 2 * m1;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const BcLane<TV> a{v, w, w_out, j + 1, n, pieces,
                     (int)(blockIdx.x * kBcThreads + threadIdx.x),
                     G * kBcThreads};
  float* p1 = part;
  float* p2 = part + (size_t)m1 * G;

  bc_dispatch<TV>(1, a, nullptr, p1, G, red);
  grid.sync();
  bc_reduce(p1, a.rows, G, 0, G, hs1);
  if (passes == 2) {
    bc_dispatch<TV>(2, a, hs1, p2, G, red);
    grid.sync();
    bc_reduce(p2, a.rows, G, 0, G, hs2);
    bc_dispatch<TV>(3, a, hs2, nullptr, G, red);
  } else {   // w' = w - V^T h1
    if (bc_bucket(a.rows) == 2)
      bc_update<TV, 2>(a, a.w, hs1, a.wo);
    else
      bc_update<TV, kBcMaxRows>(a, a.w, hs1, a.wo);
  }
  if (blockIdx.x == 0)
    for (int r = threadIdx.x; r < m1; r += kBcThreads)
      h[r] = r < a.rows ? (passes == 2 ? hs1[r] + hs2[r] : hs1[r]) : 0.f;
}

// Co-resident blocks of the streamed kernel (at most kBcBlocksPerSm an
// SM: the cooperative grid's limit) and its dynamic shared memory.
// Asked once a shape by the wrapper (kernels/cgs2.py keeps the answer); a
// launch past the limit is refused by the runtime itself.
template <typename TV>
static cudaError_t stream_capacity(int m1, int* blocks, int* smem) {
  const void* kernel = (const void*)gs_stream_kernel<TV>;
  const size_t sb = bc_smem_bytes(m1);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = allow_smem(kernel, sb);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kBcThreads,
                                                    sb);
  if (e != cudaSuccess) return e;
  *blocks = (occ < kBcBlocksPerSm ? occ : kBcBlocksPerSm) * sms;
  *smem = (int)sb;
  return cudaSuccess;
}

template <typename TV>
static cudaError_t launch_gs_stream(const void* v, const float* w, float* h,
                                    float* w_out, float* part, int grid,
                                    int m1, int n, int j, int pieces,
                                    int passes, cudaStream_t stream) {
  constexpr int VEC = Vec16<TV>::N;
  if (j < 0 || j >= m1 || n <= 0 || grid <= 0 || pieces < 0 ||
      (size_t)pieces * VEC > (size_t)n || (passes != 1 && passes != 2))
    return cudaErrorInvalidValue;
  const void* kernel = (const void*)gs_stream_kernel<TV>;
  const size_t smem = bc_smem_bytes(m1);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const TV* vt = static_cast<const TV*>(v);
  void* args[] = {(void*)&vt,    (void*)&w,  (void*)&h, (void*)&w_out,
                  (void*)&part,  (void*)&m1, (void*)&n, (void*)&j,
                  (void*)&pieces, (void*)&passes};
  e = cudaLaunchCooperativeKernel(kernel, grid, kBcThreads, args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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
  e = cudaLaunchCooperativeKernel((const void*)kernel, sh.grid, kThreads,
                                  args, sh.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace repro

// The shared-memory pass (a block's V slice fits smem_cap):
// v (m1, n) f32 or bf16; w (n,) f32; h (m1,), w_out (n,) f32 out;
// part holds m1 part_blocks floats.
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
      v_bf16 ? repro::coop_shape(repro::gs_project_kernel<repro::bf16>, m1,
                                 n, smem_cap, blocks_per_sm, &sh)
             : repro::coop_shape(repro::gs_project_kernel<float>, m1, n,
                                 smem_cap, blocks_per_sm, &sh);
  out[0] = sh.grid;
  out[1] = sh.cols;
  out[2] = (int)sh.smem;
  return e;
}

// The streamed pass (tuning.gs_stream_plan): v (m1, n) f32 or bf16; w
// (n,) f32; h (m1,) and w_out (n,) f32 out (h = h1 + h2 for passes = 2);
// part holds passes m1 grid floats; pieces: 16-byte pieces of V a row (0:
// the scalar route); grid at most the co-resident blocks
// (repro_gs_stream_capacity).
extern "C" int repro_gs_stream(const void* v, int v_bf16, const float* w,
                               float* h, float* w_out, float* part, int grid,
                               int m1, int n, int j, int pieces, int passes,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_gs_stream<repro::bf16>(
                      v, w, h, w_out, part, grid, m1, n, j, pieces, passes,
                      s)
                : repro::launch_gs_stream<float>(v, w, h, w_out, part, grid,
                                                 m1, n, j, pieces, passes, s);
}

// The streamed kernel at m1 basis rows on the current card: out[0] its
// co-resident blocks (at most two an SM), out[1] its dynamic shared
// memory in bytes.
extern "C" int repro_gs_stream_capacity(int v_bf16, int m1, int* out) {
  return v_bf16
             ? repro::stream_capacity<repro::bf16>(m1, out, out + 1)
             : repro::stream_capacity<float>(m1, out, out + 1);
}
