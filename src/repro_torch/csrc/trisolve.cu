// Banded ILU(0): the triangular sweeps of its apply, and its setup.
//
// (1) The sweep.  For a band stack (nbands, n) with offsets all <= 0
//     (lower) or all >= 0 (upper), solve L z = v row by row:
//
//       z_i = (v_i - sum_{off != 0} b_{off,i} z_{i+off}) / b_{0,i}
//
//     (no division with a unit diagonal), forward for lower, backward for
//     upper; terms whose column is outside [0, n) count as zero.  v and z
//     are (k, n): k right-hand sides.
//
//     Replaces repro/kernels/trisolve.py::banded_trisweep_kernel (body
//     _trisweep_kernel).  The TPU kernel walks the rows one at a time in
//     sequential row blocks, the last K = max|off| solved entries carried
//     in a VMEM ring, and runs an upper sweep as the lower sweep of flipped
//     copies of the bands and v.
//
//     Bound: bytes, nbands * n * s + 8 n per right-hand side (bands, v, z):
//     16.8 MB for the five-point stencil's L and 21.0 MB for its U at
//     n = 2^20 (0.0050 and 0.0063 ms at 3.35 TB/s).  The chain of n / c
//     chunks below is the real floor: about 1,000 dependent steps at 2^20.
//
//     Design: one block of kSweepThreads threads per right-hand side, and
//     a chunked affine scan.  c is the nearest far offset (|off| >= 2; n
//     without one): rows p..p+c-1 reach a far term only in rows solved
//     before p.  So per chunk of min(c, kSweepThreads) rows each thread
//     forms its row's map z_i = a_i z_{i-1} + b_i, with
//       b_i = (v_i - sum_far b_{off,i} z_{i+off}) / d_i,
//       a_i = -b_{-1,i} / d_i,
//     and a block-wide inclusive scan composes the maps, (a2 a1, a2 b1 +
//     b2), in about log2(1024) steps (warp shuffles, then the 32 warp
//     totals by one warp, which also applies them to the carry, the last z
//     of the chunk before).  Three block barriers per chunk; the far terms
//     read z written by the same block in earlier chunks.  An upper sweep
//     runs the same loop over the rows back to front (logical row p is
//     physical row n - 1 - p): no flipped copies.  k right-hand sides are
//     k blocks.  The scan sums in another order than the sequential
//     substitution (the plain version scans the same way).
//
// (2) The setup.  ILU(0) of a band stack restricted to its own pattern:
//     row i eliminates its lower entries l (most negative first) against
//     the factored row i + l (rows before 0 are unit-diagonal rows),
//
//       l_i = a_{i,l} / u_{i+l,0};  a_{i,u+l} -= l_i u_{i+l,u}
//
//     for each upper offset u with u + l on the pattern, then guards its
//     pivot: |p| < max(max_j |a_{i,j}| eps, tiny^(1/2)) becomes that floor
//     with p's sign.  Out-of-range entries are zeroed first.  The factors
//     are written in f32, (nbands, n) in the offsets' order.
//
//     Replaces repro/kernels/trisolve.py::_ilu0_factor, a lax.scan with no
//     Pallas in it that carries the last K factored rows in a ring.
//
//     Bound: bytes, nbands * n * (s + 4) (20.9 MB at the 1024 x 1024
//     five-point stencil, 0.0063 ms), but it is a recurrence over all n
//     rows: row i needs rows i - 1 and i - K.
//
//     Design: one thread walks the rows.  The offset combinatorics are
//     resolved on the host into an IluPlan passed by value (the lower
//     offsets in order, and for each the (upper band, target band) pairs
//     it updates), read at constant indices in unrolled loops, and the
//     row is held in registers, kMaxIluBands floats read and written only
//     at constant indices.  The ring is the output itself: row i + l is
//     read back from the factors the thread wrote.  (A shared-memory ring
//     of the last K rows was no faster: the single thread's chain of
//     dependent instructions, not the ring, sets the pace; PERF.md.)
//     Every product and sum is rounded as the plain version rounds it (no
//     fused multiply-add), and the division is IEEE, so the factors match
//     the plain version's bits.
#include "common.cuh"

#include <algorithm>
#include <vector>

namespace repro {

constexpr int kSweepThreads = 1024;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kMaxIluBands = 16;

// (a2, b2) after (a1, b1): x -> a2 (a1 x + b1) + b2.
__device__ __forceinline__ void compose(float a1, float b1, float* a2,
                                        float* b2) {
  *b2 = fmaf(*a2, b1, *b2);
  *a2 = *a2 * a1;
}

template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
    trisweep_kernel(const T* __restrict__ bands, BandOffsets offs,
                    int nbands, const float* __restrict__ v, float* z,
                    int n, int chunk, int unit, int reverse) {
  __shared__ float wa[kSweepWarps], wb[kSweepWarps], win[kSweepWarps];
  __shared__ float carry_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* vr = v + (size_t)blockIdx.x * n;
  float* zr = z + (size_t)blockIdx.x * n;
  if (chunk > kSweepThreads) chunk = kSweepThreads;
  float carry = 0.f;   // z of the chunk's previous row (0 before row 0)
  for (int p0 = 0; p0 < n; p0 += chunk) {
    const int len = min(chunk, n - p0);
    float a = 1.f, b = 0.f;   // the identity map for idle threads
    int row = 0;
    if (tid < len) {
      const int p = p0 + tid;
      row = reverse ? n - 1 - p : p;
      float rhs = __ldg(vr + row), near = 0.f, diag = 1.f;
#pragma unroll
      for (int d = 0; d < kMaxBands; ++d) {   // offsets at constant indices
        if (d >= nbands) break;
        const int off = offs.off[d];
        const float coef = to_f(bands[(size_t)d * n + row]);
        if (off == 0) {
          diag = coef;
          continue;
        }
        const int col = row + off;
        if (col < 0 || col >= n) continue;     // the zero halo
        if (off == 1 || off == -1)
          near = coef;
        else                                   // solved in an earlier chunk
          rhs = rhs - coef * zr[col];
      }
      a = -near;
      b = rhs;
      if (!unit) {
        a = a / diag;
        b = b / diag;
      }
    }
    // inclusive scan of the maps within each warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float ua = __shfl_up_sync(0xffffffffu, a, o);
      const float ub = __shfl_up_sync(0xffffffffu, b, o);
      if (lane >= o) compose(ua, ub, &a, &b);
    }
    if (lane == 31) {
      wa[warp] = a;
      wb[warp] = b;
    }
    __syncthreads();
    // warp 0: the value entering each warp, from the carry and the warp
    // totals in order
    if (warp == 0) {
      float ta = wa[lane], tb = wb[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float ua = __shfl_up_sync(0xffffffffu, ta, o);
        const float ub = __shfl_up_sync(0xffffffffu, tb, o);
        if (lane >= o) compose(ua, ub, &ta, &tb);
      }
      // inclusive prefix through warp `lane`, applied to the carry
      const float zin = fmaf(ta, carry, tb);
      const float prev = __shfl_up_sync(0xffffffffu, zin, 1);
      win[lane] = lane == 0 ? carry : prev;
    }
    __syncthreads();
    const float zi = fmaf(a, win[warp], b);
    if (tid < len) zr[row] = zi;
    if (tid == len - 1) carry_s = zi;
    __syncthreads();   // z of this chunk and the carry, for the next one
    carry = carry_s;
  }
}

struct IluPlan {
  int nbands, idx0, nlower;
  int off[kMaxIluBands];             // every band's offset (the OOB mask)
  int l_off[kMaxIluBands];           // lower offsets, most negative first
  int l_band[kMaxIluBands];          // their bands
  int npair[kMaxIluBands];           // per lower offset: the updates,
  int pair_u[kMaxIluBands][kMaxIluBands];   // upper band read from row k
  int pair_t[kMaxIluBands][kMaxIluBands];   // band of row i it updates
};

// row[d] at a run-time d, the row held in registers (constant indices).
__device__ __forceinline__ float get(const float (&row)[kMaxIluBands],
                                     int d) {
  float x = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxIluBands; ++q)
    if (q == d) x = row[q];
  return x;
}

__device__ __forceinline__ void put(float (&row)[kMaxIluBands], int d,
                                    float x) {
#pragma unroll
  for (int q = 0; q < kMaxIluBands; ++q)
    if (q == d) row[q] = x;
}

template <typename T>
__global__ void ilu0_kernel(const T* __restrict__ bands, IluPlan plan,
                            float* fact, int n, float eps, float guard) {
  const int nb = plan.nbands;
  for (int i = 0; i < n; ++i) {
    float row[kMaxIluBands];
#pragma unroll
    for (int d = 0; d < kMaxIluBands; ++d) {
      row[d] = 0.f;
      if (d < nb) {
        const int col = i + plan.off[d];
        if (col >= 0 && col < n)
          row[d] = to_f(__ldg(bands + (size_t)d * n + i));
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxIluBands; ++j) {   // the plan at constant indices
      if (j >= plan.nlower) break;
      const int k = i + plan.l_off[j];
      const int lb = plan.l_band[j];
      // row k of the factors, or a unit-diagonal row before row 0
      const float kd = k < 0 ? 1.f : fact[(size_t)plan.idx0 * n + k];
      const float lik = __fdiv_rn(get(row, lb), kd);
      put(row, lb, lik);
#pragma unroll
      for (int q = 0; q < kMaxIluBands; ++q) {
        if (q >= plan.npair[j]) break;
        const int u = plan.pair_u[j][q], t = plan.pair_t[j][q];
        const float ku = k < 0 ? (u == plan.idx0 ? 1.f : 0.f)
                               : fact[(size_t)u * n + k];
        put(row, t, __fadd_rn(get(row, t), __fmul_rn(-lik, ku)));
      }
    }
    float mx = 0.f;
#pragma unroll
    for (int d = 0; d < kMaxIluBands; ++d) mx = fmaxf(mx, fabsf(row[d]));
    const float floor = fmaxf(__fmul_rn(mx, eps), guard);
    const float piv = get(row, plan.idx0);
    if (!(fabsf(piv) >= floor))
      put(row, plan.idx0, piv < 0.f ? -floor : floor);
#pragma unroll
    for (int d = 0; d < kMaxIluBands; ++d)
      if (d < nb) fact[(size_t)d * n + i] = row[d];
  }
}

// The plan of offsets (host memory, nbands ints; must include 0).
static cudaError_t ilu_plan(const int* offsets, int nbands, IluPlan* plan) {
  if (nbands <= 0 || nbands > kMaxIluBands) return cudaErrorInvalidValue;
  *plan = IluPlan{};
  plan->nbands = nbands;
  plan->idx0 = -1;
  auto band_of = [&](int off) {
    for (int d = 0; d < nbands; ++d)
      if (offsets[d] == off) return d;
    return -1;
  };
  std::vector<int> lower, upper;
  for (int d = 0; d < nbands; ++d) {
    plan->off[d] = offsets[d];
    if (offsets[d] == 0) plan->idx0 = d;
    if (offsets[d] < 0) lower.push_back(offsets[d]);
    if (offsets[d] > 0) upper.push_back(offsets[d]);
  }
  if (plan->idx0 < 0) return cudaErrorInvalidValue;
  std::sort(lower.begin(), lower.end());
  std::sort(upper.begin(), upper.end());
  plan->nlower = (int)lower.size();
  for (int j = 0; j < plan->nlower; ++j) {
    plan->l_off[j] = lower[j];
    plan->l_band[j] = band_of(lower[j]);
    int q = 0;
    for (int u : upper) {
      const int t = band_of(u + lower[j]);
      if (t < 0) continue;
      plan->pair_u[j][q] = band_of(u);
      plan->pair_t[j][q] = t;
      ++q;
    }
    plan->npair[j] = q;
  }
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_trisweep(const void* bands, const int* offsets,
                                   int nbands, const float* v, float* z,
                                   int n, int k, int chunk, int unit,
                                   int reverse, cudaStream_t stream) {
  if (n <= 0 || k <= 0 || chunk <= 0 || nbands <= 0 || nbands > kMaxBands)
    return cudaErrorInvalidValue;
  BandOffsets offs{};
  for (int d = 0; d < nbands; ++d) offs.off[d] = offsets[d];
  trisweep_kernel<T><<<k, kSweepThreads, 0, stream>>>(
      static_cast<const T*>(bands), offs, nbands, v, z, n, chunk, unit,
      reverse);
  return cudaGetLastError();
}

}  // namespace repro

// bands (nbands, n) row-major, offsets host memory (all <= 0 for a forward
// sweep, all >= 0 with reverse = 1 for a backward one); v and z (k, n) f32;
// chunk = the nearest far offset |off| >= 2 (n without one).
extern "C" int repro_banded_trisweep(const void* bands, int b_bf16,
                                     const int* offsets, int nbands,
                                     const float* v, float* z, int n, int k,
                                     int chunk, int unit, int reverse,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return b_bf16 ? repro::launch_trisweep<repro::bf16>(
                      bands, offsets, nbands, v, z, n, k, chunk, unit,
                      reverse, st)
                : repro::launch_trisweep<float>(bands, offsets, nbands, v,
                                                z, n, k, chunk, unit,
                                                reverse, st);
}

// bands (nbands, n) row-major, offsets host memory (with 0); fact (nbands,
// n) f32 out; eps and guard the pivot floor's terms.
extern "C" int repro_ilu0_factor(const void* bands, int b_bf16,
                                 const int* offsets, int nbands, float* fact,
                                 int n, float eps, float guard,
                                 void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  repro::IluPlan plan;
  cudaError_t e = repro::ilu_plan(offsets, nbands, &plan);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_bf16)
    repro::ilu0_kernel<repro::bf16><<<1, 1, 0, st>>>(
        static_cast<const repro::bf16*>(bands), plan, fact, n, eps, guard);
  else
    repro::ilu0_kernel<float><<<1, 1, 0, st>>>(
        static_cast<const float*>(bands), plan, fact, n, eps, guard);
  return cudaGetLastError();
}
