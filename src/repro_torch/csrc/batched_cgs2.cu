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
// size).  At k = 4 lanes, n = 2^20, f32, j = (0, 7, 15, 29) that is 264
// MB, 0.079 ms at 3.35 TB/s; the reductions are 4 flops per element of V,
// far below the card's rate.
//
// The first design (one cooperative launch, the grid split evenly over the
// lanes, common.cuh's streamed pass twice: a project sweep of 4-byte
// loads eight rows at a time with two barriers a chunk, a grid sync, an
// update sweep) read V four times a step and gave a lane of 30 rows the
// blocks of a lane of one: 0.609 ms f32 (0.513 bf16) at that shape on an
// H100, 0.83 TB/s from the heavy lane's quarter of the SMs.
//
// Design: three sweeps over V, not four, two grid syncs.
//   sweep 1  h1 partials: each thread sums V[r, c] w[c] for every valid
//            row r of its 16-byte pieces;
//   sync     each block sums its lane's partials itself, in one fixed
//            order, so all of them hold the same h1;
//   sweep 2  fused: the V values a thread loads to form
//            w1[c] = w[c] - sum_r h1[r] V[r, c] are exactly those it needs
//            for h2[r] += V[r, c] w1[c]; w1 is written and the h2 partials
//            summed from registers (a lane of 17-32 rows loads its first
//            16 rows' piece a second time, soon after the first loads;
//            how much of that second load hits in cache is not measured:
//            at most one more pass over those rows);
//   sync     the lane's h2, as after sweep 1;
//   sweep 3  w''[c] = w1[c] - sum_r h2[r] V[r, c], in place over w1.
// Bytes: V three times (3 sum_l (j_l + 1) n s), w read twice, w1 written
// and read, w'' written (5 x 4 k n): 759 MB at the shape above (692 of
// them V), 0.227 ms at 3.35 TB/s.  Measured in turn with the first
// design on an H100 80GB HBM3 at 700 W (chip_smoke.py --in-turn):
// 0.385 ms f32 (0.256 bf16) at that shape, 0.331 (0.187) at j = 15 in
// every lane, against 0.609 (0.513) and 0.487 (0.344).  A lane of more
// than 32 rows (m > 31) runs sweep 2 as an update and a projection (V
// four times).
// The grid is split by work (kernels/tuning.py::batched_cgs2_split): a
// lane gets blocks in proportion to its rows, at least one, none for a
// lane with j = -1, at most a round of pieces a thread; the wrapper ships
// the split (a prefix sum a lane) in the same copy as j, and a lane's
// partials are [row][global block], its blocks first[l] .. first[l + 1]
// - 1.  Every block copies a share of the skipped lanes' w.  A thread
// takes 16-byte pieces of its lane's columns (the streaming of
// sr_payload.cu): up to 16 rows' loads in flight at once, no barrier per
// row chunk; a lane of one or two rows takes 8 pieces at once (4 for
// bf16 V) so that it keeps about as many loads in flight as the others
// (two buckets, bc_bucket and bc_unroll, which tuning.batched_unroll
// copies and repro_batched_cgs2_unroll reports: each is a copy of the
// sweeps in the kernel, and more copies pushed it past 255 registers
// into spills).  The kernel is built for kBcBlocksPerSm = 2 blocks of
// 128 threads an SM (__launch_bounds__: with the block size alone ptxas
// aimed at full occupancy and spilled; one block an SM was slower in 11
// of 12 readings, PERF.md).  A misaligned V, w or row stride takes the
// scalar route (pieces = 0; the wrapper counts it).  No float atomics:
// every sum has one fixed order, the same bits every call.  The grid is
// at most the co-resident blocks (cooperative launch); more active lanes
// than that is refused, never run otherwise.  The sweeps are
// stream_gs.cuh's, which cgs2.cu's streamed cgs2 runs as one lane.
#include "stream_gs.cuh"

namespace repro {

// meta: j (k ints), then first (k + 1 ints: lane l owns blocks first[l] ..
// first[l + 1] - 1).  part: 2 m1 G floats.  Dynamic shared memory:
// hs1[m1], hs2[m1], red[kBcWarps * kBcMaxRows].
// Built for kBcBlocksPerSm blocks an SM: up to 255 registers a thread,
// the rows of a piece held without spilling.
template <typename TV>
__global__ void __launch_bounds__(kBcThreads, kBcBlocksPerSm)
    batched_cgs2_kernel(const TV* __restrict__ v, const float* w,
                        const int* __restrict__ meta, float* h,
                        float* w_out, float* part, int k, int m1, int n,
                        int pieces) {
  extern __shared__ float smem[];
  float* hs1 = smem;
  float* hs2 = smem + m1;
  float* red = smem + 2 * m1;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int* jl = meta;
  const int* first = meta + k;
  // the lane owning block b: the last l with first[l] <= b (a lane with
  // no block has first[l] == first[l + 1])
  int l = -1;
  if (b < __ldg(first + k)) {
    int lo = 0, hi = k - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(first + mid) <= b)
        lo = mid;
      else
        hi = mid - 1;
    }
    l = lo;
  }
  BcLane<TV> a{};
  int b0 = 0, nb = 0;
  if (l >= 0) {
    b0 = __ldg(first + l);
    nb = __ldg(first + l + 1) - b0;
    a = BcLane<TV>{v + (size_t)l * m1 * n, w + (size_t)l * n,
                   w_out + (size_t)l * n, __ldg(jl + l) + 1, n, pieces,
                   (b - b0) * kBcThreads + (int)threadIdx.x,
                   nb * kBcThreads};
  }
  float* p1 = part;
  float* p2 = part + (size_t)m1 * G;

  if (l >= 0) bc_dispatch<TV>(1, a, nullptr, p1, G, red);
  // the skipped lanes: w'' = w, h = 0, shared by every block
  for (int q = 0; q < k; ++q) {
    if (__ldg(jl + q) >= 0) continue;
    for (int c = b * kBcThreads + threadIdx.x; c < n; c += G * kBcThreads)
      w_out[(size_t)q * n + c] = w[(size_t)q * n + c];
    if (b == 0)
      for (int r = threadIdx.x; r < m1; r += kBcThreads)
        h[(size_t)q * m1 + r] = 0.f;
  }
  grid.sync();
  if (l >= 0) {
    bc_reduce(p1, a.rows, G, b0, nb, hs1);
    bc_dispatch<TV>(2, a, hs1, p2, G, red);
  }
  grid.sync();
  if (l >= 0) {
    bc_reduce(p2, a.rows, G, b0, nb, hs2);
    bc_dispatch<TV>(3, a, hs2, nullptr, G, red);
    if (b == b0)
      for (int r = threadIdx.x; r < m1; r += kBcThreads)
        h[(size_t)l * m1 + r] = r < a.rows ? hs1[r] + hs2[r] : 0.f;
  }
}

// Co-resident blocks of the kernel, at most kBcBlocksPerSm an SM (the
// occupancy calculator's, which the registers hold to that): the
// cooperative grid's limit.  Kept per host thread for the last (kernel,
// device, m1).
template <typename TV>
static cudaError_t bc_capacity(int m1, int* out) {
  struct Key {
    const void* kernel;
    int dev, m1;
  };
  thread_local Key last{nullptr, -1, 0};
  thread_local int last_cap = 0;
  auto kernel = batched_cgs2_kernel<TV>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (last.kernel == (const void*)kernel && last.dev == dev &&
      last.m1 == m1) {
    *out = last_cap;
    return cudaSuccess;
  }
  int sms = 0, occ = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t sb = bc_smem_bytes(m1);
  e = allow_smem(kernel, sb);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kBcThreads,
                                                    sb);
  if (e != cudaSuccess) return e;
  *out = (occ < kBcBlocksPerSm ? occ : kBcBlocksPerSm) * sms;
  last = Key{(const void*)kernel, dev, m1};
  last_cap = *out;
  return cudaSuccess;
}

template <typename TV>
static cudaError_t launch_batched_cgs2(const void* v, const float* w,
                                       const int* meta, float* h,
                                       float* w_out, float* part, int grid,
                                       int k, int m1, int n, int pieces,
                                       cudaStream_t stream) {
  if (k <= 0 || m1 <= 0 || n <= 0 || grid <= 0 || pieces < 0)
    return cudaErrorInvalidValue;
  int cap = 0;
  cudaError_t e = bc_capacity<TV>(m1, &cap);
  if (e != cudaSuccess) return e;
  if (grid > cap) return cudaErrorCooperativeLaunchTooLarge;
  auto kernel = batched_cgs2_kernel<TV>;
  const TV* vt = static_cast<const TV*>(v);
  void* args[] = {(void*)&vt, (void*)&w,  (void*)&meta, (void*)&h,
                  (void*)&w_out, (void*)&part, (void*)&k, (void*)&m1,
                  (void*)&n,  (void*)&pieces};
  e = cudaLaunchCooperativeKernel((const void*)kernel, grid, kBcThreads,
                                  args, bc_smem_bytes(m1), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace repro

// v (k, m1, n) f32 or bf16; w (k, n) f32; meta (device, 2 k + 1 ints): j
// (each in -1..m1-1) then the split's prefix sums (tuning.
// batched_cgs2_split); h (k, m1) and w_out (k, n) f32; part 2 m1 grid
// floats; pieces: 16-byte pieces of V a lane row (0: the scalar route);
// grid at most the co-resident blocks (repro_batched_cgs2_capacity).
extern "C" int repro_batched_cgs2(const void* v, int v_bf16, const float* w,
                                  const int* meta, float* h, float* w_out,
                                  float* part, int grid, int k, int m1,
                                  int n, int pieces, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_batched_cgs2<repro::bf16>(
                      v, w, meta, h, w_out, part, grid, k, m1, n, pieces, s)
                : repro::launch_batched_cgs2<float>(
                      v, w, meta, h, w_out, part, grid, k, m1, n, pieces,
                      s);
}

// The co-resident blocks of the kernel (at most kBcBlocksPerSm an SM):
// out[0].
extern "C" int repro_batched_cgs2_capacity(int v_bf16, int m1, int* out) {
  return v_bf16 ? repro::bc_capacity<repro::bf16>(m1, out)
                : repro::bc_capacity<float>(m1, out);
}

// The kernel's launch-shape rule for a lane of `rows` valid rows of
// `elem_size`-byte V (tuning.batched_unroll and BATCHED_THREADS keep a
// copy for the split, which the card tests hold to this): out[0] the
// bucket of rows, out[1] the 16-byte pieces a thread takes at once,
// out[2] the threads of a block.
extern "C" int repro_batched_cgs2_unroll(int rows, int elem_size, int* out) {
  if (rows < 1 || (elem_size != 2 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  const int r = repro::bc_bucket(rows);
  out[0] = r;
  out[1] = repro::bc_unroll(r, 16 / elem_size);
  out[2] = repro::kBcThreads;
  return (int)cudaSuccess;
}
