// The s normalized matrix powers of the s-step GMRES cycle, in one launch:
//
//   u_0 = x;  w = (A - shift_p I) u_{p-1};  sigma_p = ||w||;
//   u_p = w / max(sigma_p, eps)                       p = 1..s
//
// (shift_p = 0 without shifts: the monomial basis; with shifts, the Newton
// basis.)  Returns u (s, n), row p-1 holding u_p, and sigma (s,), float32.
// A is banded (bands (nbands, n), offsets by value), ELL (values/cols
// (n, width), padding slots value 0 at column 0) or dense ((n, n),
// unshifted), stored as float or bf16 and widened in registers; every sum
// is taken in float.  eps is tiny(float)^(1/2), the breakdown guard.
//
// Replaces repro/kernels/matrix_powers.py::banded_powers, ::ell_powers and
// ::dense_powers.  The TPU kernels walk a sequential grid over the powers
// with the operand carried in VMEM scratch: the band stack and the ELL
// table stay in VMEM for all s powers, dense A streams once per power in
// (b, b) tiles, and the norm of each power is reduced in-register at the
// power boundary.
//
// Bound: bytes.  Each input once, each output once (s the storage size):
//   banded  nbands * n * s + 4 n + 4 s n
//   ELL     n * width * (s + 4) + 4 n + 4 s n
//   dense   powers * n^2 * s + 4 n + 4 s n   (A streams once per power:
//           nothing of it can be kept between powers at n = 10^4)
// At the 1024 x 1024 five-point stencil, s = 5, f32, banded moves 46 MB
// (0.014 ms at 3.35 TB/s), ELL 67 MB (0.020 ms); the dense system at
// n = 10,000, s = 5 moves 2.0 GB (0.60 ms).  Two flops per stored entry
// and power: far below the card's 20 flops per byte.
//
// Design: one cooperative launch per call.  Hopper's blocks run in no
// order, so the TPU's power boundary becomes one grid sync per power:
//   (a) every block computes w for its rows from the previous power, writes
//       it unnormalised to a scratch row (`raw`, two rows used in turn) and
//       stores its partial ||w||^2 (one float, in a fixed order) to
//       part[power][block];
//   (b) grid sync;
//   (c) every block sums the partials itself, in one order, so all blocks
//       hold the same sigma without a second sync, and writes its own rows
//       of u_p = w / max(sigma, eps).
// The next power reads its operand as raw / max(sigma, eps), the same
// correctly rounded division that produced u_p, so it sees u_p exactly
// while other blocks are still writing u_p.  The two raw rows alternate:
// a row is rewritten two powers later, after a grid sync that every read
// of it precedes.  Values written during the launch are read through L2
// (__ldcg): an SM's L1 may hold stale lines of a neighbour's rows.
//   banded  a block owns a contiguous range of rows (a multiple of 32),
//           a thread per row; the offsets come by value and are read at
//           constant indices (PR 12's banded SpMV lost 6x to a local-memory
//           copy of them); an out-of-range neighbour is skipped (the TPU's
//           zero halo).  The TPU keeps the band stack in VMEM; here it
//           stays in the 50 MB L2 between powers (21 MB at n = 2^20, f32)
//           with the operand rows (4 MB each).
//   ELL     its own kernel (ell_powers_kernel, below): the table read once
//           from HBM, kept in shared memory across the s powers.
//   dense   a warp per row (rows dealt round-robin over the grid's warps),
//           the row read in 16-byte vectors (common.cuh::row_dot, bf16
//           widened in registers); each block first divides the whole
//           operand into shared memory (n floats: 40 KB at n = 10,000) and
//           the rows read it there.
// The grid is sized by the occupancy calculator so the cooperative launch
// is legal.
//
// The fused Chebyshev preconditioner apply, z ~= A^-1 v for a banded A:
//
//   z_0 = v / theta;  z_{t+1} = rho_t (c (v - A z_t) + rho_old_t (z_t -
//   z_{t-1})) + z_t,  c = 2 / delta,  z_{-1} = 0,   t = 0..steps-1
//
// Replaces repro/kernels/matrix_powers.py::banded_cheb_apply (body
// _banded_cheb_kernel).  The TPU kernel keeps the band stack, v and the
// recurrence's vectors in VMEM and unrolls the `order - 1` steps at trace
// time (theta, delta and the rhos are static floats).
// Bound: bytes, nbands * n * s + 8 n (bands and v read once, z written
// once): 29.4 MB at the 1024 x 1024 five-point stencil in f32 (0.0088 ms
// at 3.35 TB/s), 18.9 MB with bf16 bands (0.0056 ms).  2 nbands + 7 flops
// per row and step.
// Design: one cooperative launch with the banded powers' row partition (a
// thread per row, offsets by value at constant indices) and one grid sync
// per step, as the powers have one per power.  z is published for the
// neighbours' stencil in two scratch rows used in turn: step t reads z_t
// from row t & 1 and writes z_{t+1} over z_{t-1} in the other row, each
// thread reading its own rows' z_{t-1} there before it overwrites them, so
// nothing but z is stored and no row is read while it is written.  The
// last step writes the output instead.  v is read again at each step
// (from L2: the stack, v and both rows, 33 MB at n = 2^20, fit the 50 MB
// L2).  theta, c and the (rho, rho_old) pairs come by value.  No norm, no
// reduction: the bits do not depend on the grid.
//
// The row-sharded banded powers (communication-avoiding), for one shard:
//
//   x = u_0 over the padded width W = n_local + 2 s halo (s halo exchanged
//   rows each side);  w_p = B w_{p-1} over all W rows (reads outside
//   [0, W) count as zero);  z_p = rows [s halo, s halo + n_local) of w_p;
//   nrm_p = ||z_p||^2 (this shard's part)                  p = 1..s
//
// with B the band stack padded the same way ((nbands, W): (s - 1) halo
// exchanged columns each side, then halo zeros) and pre-scaled by the
// caller (core/sstep.py) so the raw powers cannot overflow.  Rows closer
// than p halo to an edge go stale at power p; the centre rows stay exact.
// Replaces repro/kernels/matrix_powers.py::banded_powers_halo (a
// sequential grid over the powers, the operand carried in VMEM scratch;
// the raw powers are not normalised between powers, so no collective
// stands between them: one all-reduce of the s squared norms follows).
// Bound: bytes, nbands W s_B + 4 W + 4 s n_local + 4 s (the padded stack
// and operand once, z and the norms once): 0.014 ms at 1024^2, s = 5,
// f32, as banded_powers.  Design: banded_powers' cooperative launch (a
// thread per row of W, the offsets by value at constant indices, the raw
// power in two alternating scratch rows read through L2) with no
// normalisation, so one grid sync per power and no norm between powers;
// each block writes its centre rows of z_p and stores its partial of
// ||z_p||^2 at part[p][block], and a second launch (common.cuh's
// reduce_partials_kernel) sums them in one fixed order.
#include "common.cuh"

namespace repro {

// Rows [r0, r1) of this block: equal chunks, each a multiple of 32 rows.
__device__ __forceinline__ void row_range(int n, int* r0, int* r1) {
  const int per = ((n + (int)gridDim.x - 1) / (int)gridDim.x + 31) / 32 * 32;
  *r0 = min(n, (int)blockIdx.x * per);
  *r1 = min(n, *r0 + per);
}

// The norm of one power: every block sums the grid's partials in the same
// order.  red holds kWarps + 1 floats; the result is in every thread.
__device__ inline float grid_norm(const float* part, float* red) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int b = lane; b < (int)gridDim.x; b += 32) s += __ldcg(part + b);
    s = warp_sum(s);
    if (lane == 0) red[kWarps] = sqrtf(s);
  }
  __syncthreads();
  return red[kWarps];
}

// u_p = w / max(sigma, eps) over the block's rows; sigma_p by block 0.
__device__ __forceinline__ void finish_power(float sg, float denom, int p,
                                             const float* out, float* u,
                                             float* sigma, int n, int r0,
                                             int r1) {
  if (blockIdx.x == 0 && threadIdx.x == 0) sigma[p] = sg;
  for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x)
    u[(size_t)p * n + i] = __ldcg(out + i) / denom;
}

// The banded powers; x is the previous power's raw row divided by denom (x
// itself at p = 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_powers_kernel(const T* __restrict__ mat, BandOffsets offs,
                         int nbands, const float* __restrict__ x,
                         const float* __restrict__ shifts, float* u,
                         float* __restrict__ sigma, float* raw, float* part,
                         int n, int s, float eps) {
  __shared__ float red[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  int r0, r1;
  row_range(n, &r0, &r1);
  const float* cur = x;
  float denom = 1.f;
  for (int p = 0; p < s; ++p) {
    float* out = raw + (size_t)(p & 1) * n;
    float sq = 0.f;
    for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxBands; ++d) {   // offsets at constant indices
        if (d >= nbands) break;
        const int c = i + offs.off[d];
        if (c < 0 || c >= n) continue;         // the zero halo
        acc = fmaf(to_f(mat[(size_t)d * n + i]), __ldcg(cur + c) / denom,
                   acc);
      }
      if (shifts != nullptr)   // w - shift * u, rounded as the plain version
        acc = __fsub_rn(acc,
                        __fmul_rn(__ldg(shifts + p), __ldcg(cur + i) / denom));
      __stcg(out + i, acc);
      sq = fmaf(acc, acc, sq);
    }
    sq = block_sum(sq, red);
    if (threadIdx.x == 0) part[(size_t)p * gridDim.x + blockIdx.x] = sq;
    grid.sync();
    const float sg = grid_norm(part + (size_t)p * gridDim.x, red);
    denom = fmaxf(sg, eps);
    finish_power(sg, denom, p, out, u, sigma, n, r0, r1);
    cur = out;
  }
}

// ---------------------------------------------------------------------------
// The ELL powers (kernel-table row 17).
//
// The TPU kernel keeps values and cols in VMEM for all s powers (constant
// index maps over its (s,) grid), so its bound counts the table once.  The
// first Hopper design was the banded kernel's thread a row walking
// its slots in a runtime loop: each slot a load of cols, then the dependent
// gather, strided 4 * width bytes across the warp, and the whole table
// (42 MB at the 1024^2 stencil, f32) read again every power; 0.155 ms
// against a 0.020 bound.  The Hopper form of the TPU's residency:
//
// - Segments.  The norm's partials must be the banded kernel's, so that a
//   stencil gets the same bits in both formats: the rows are cut into the
//   banded grid's `segs` ranges (row_range's rule), and a segment's partial
//   is what a block of kThreads would sum: thread t takes rows r0 + t,
//   r0 + t + kThreads, ... in order, then warp shuffles and the warps in
//   order.  A block of this kernel owns `seg_per_block` consecutive
//   segments and runs `blockDim / kThreads` of them at once, one group of
//   kThreads threads each, writing one partial a segment in the same order.
//   Each row's sum is the same fmaf chain in slot order over raw / denom,
//   the same division (the banded kernel's note above), so u and sigma are
//   the banded kernel's bits.
// - Residency.  The first `res_seg` rows of each segment stay in shared
//   memory for all s powers: in power 1 the warp that owns a chunk of 32 rows
//   (in every power the same warp) copies the chunk's values and cols, which
//   are contiguous in the row-major table, with 16-byte evict-first loads,
//   and stores them slot-major ([slot][32 rows]) so that reading them is
//   conflict-free.  The other rows are read from global memory every power;
//   the resident part's evict-first loads leave L2 to them.  HBM sees the
//   table once where it fits on chip: one block of SMEM_BUDGET an SM holds
//   63% of the 1024^2 stencil's f32 table and 84% with bf16 values.
// - Every gather in flight.  Slots are unrolled to the width bucket WB (a
//   template parameter: 4, 5 (the five-point stencil), 8 or 16; wider rows
//   loop over groups of WB slots), and a thread takes RB rows at once:
//   their cols first, then all their gathers, then the fmaf chains.  The
//   norm's partials and the rows of u_p are read back eight loads at once.
//   The time is set by each thread's chain of dependent round trips, not
//   by bytes (PERF.md §6): 1,024 threads (four segments at once, two
//   rows in flight, 48 bytes of spill at WB = 5) beat 512 (two segments,
//   four rows, no spill); more rows on chip, gathers through L1, a
//   slot-major copy of the other rows, or gathering the normalized u_p
//   after a second grid sync (no division) did not help.
// tuning.ell_powers_plan chooses segs (the banded grid), the segments a
// block and its resident rows; res_seg = 0 (a table too wide for one chunk
// of 32 rows) is the streamed route, the same kernel.
// ---------------------------------------------------------------------------
constexpr int kEllMaxThreads = 4 * kThreads;   // four segments at once

// Rows [r0, r1) of segment `seg` of `segs`: row_range's rule for a grid of
// `segs` blocks.
__device__ __forceinline__ void seg_range(int n, int segs, int seg, int* r0,
                                          int* r1) {
  const int per = ((n + segs - 1) / segs + 31) / 32 * 32;
  *r0 = min(n, seg * per);
  *r1 = min(n, *r0 + per);
}

// Shared memory of the ELL kernel: the partials' slots (kWarps a segment and
// one for the norm), then the resident values and cols, 16-byte aligned.
__host__ __device__ inline size_t ell_red_bytes(int seg_per_block) {
  return ((size_t)(seg_per_block * kWarps + 1) * sizeof(float) + 15) / 16 * 16;
}
__host__ __device__ inline size_t ell_vals_bytes(int seg_per_block,
                                                 int res_seg, int width,
                                                 int elem) {
  return ((size_t)seg_per_block * res_seg * width * elem + 15) / 16 * 16;
}
__host__ __device__ inline size_t ell_smem_bytes(int seg_per_block,
                                                 int res_seg, int width,
                                                 int elem) {
  return ell_red_bytes(seg_per_block) +
         ell_vals_bytes(seg_per_block, res_seg, width, elem) +
         (size_t)seg_per_block * res_seg * width * sizeof(int);
}

// Element k of a 16-byte word holding 16 / sizeof(T) entries of T.
template <typename T> __device__ __forceinline__ T word_elem(uint4 r, int k);
template <> __device__ __forceinline__ float word_elem<float>(uint4 r, int k) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  return __uint_as_float(w[k]);
}
template <> __device__ __forceinline__ bf16 word_elem<bf16>(uint4 r, int k) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  return __ushort_as_bfloat16(
      (unsigned short)(k & 1 ? w[k >> 1] >> 16 : w[k >> 1] & 0xffffu));
}
template <> __device__ __forceinline__ int word_elem<int>(uint4 r, int k) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  return (int)w[k];
}

// One chunk's `cnt` consecutive entries of a row-major table (width slots a
// row, 32 rows at most) into shared memory slot-major: entry e (row
// e / width, slot e % width) to dst[slot * 32 + row].  16-byte evict-first
// loads where `vec` (the chunk starts 16-byte aligned), else one entry a
// lane; the warp's lanes stride the chunk.
template <typename E>
__device__ __forceinline__ void chunk_to_smem(const E* __restrict__ src,
                                              int cnt, int width, E* dst,
                                              int lane, bool vec) {
  constexpr int P = 16 / (int)sizeof(E);
  int done = 0;
  if (vec) {
    const int nq = cnt / P;
    const uint4* q4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 2
    for (int q = lane; q < nq; q += 32) {
      const uint4 r = __ldcs(q4 + q);
      const int e0 = q * P;
      int row = e0 / width, slot = e0 - row * width;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        dst[slot * 32 + row] = word_elem<E>(r, k);
        if (++slot == width) {
          slot = 0;
          ++row;
        }
      }
    }
    done = nq * P;
  }
  for (int e = done + lane; e < cnt; e += 32) {
    const int row = e / width;
    dst[(e - row * width) * 32 + row] = src[e];
  }
}

// Rows a thread has in flight: about ten slots' cols, gathers and values
// in the 64 registers a thread of 1,024 has.
__host__ __device__ constexpr int ell_rows_in_flight(int bucket) {
  return bucket <= 5 ? 2 : 1;
}

// The block's rows of u_p = raw / denom, kFinishLoads loads of each
// thread's stride in flight at once (a block of 512 threads owns 8,064 rows
// at the 1024^2 stencil: two round trips, not sixteen).
constexpr int kFinishLoads = 8;
__device__ __forceinline__ void ell_finish(float denom, int p,
                                           const float* out, float* u, int n,
                                           int r0, int r1) {
  for (int i0 = r0 + threadIdx.x; i0 < r1;
       i0 += kFinishLoads * blockDim.x) {
    float w[kFinishLoads];
#pragma unroll
    for (int k = 0; k < kFinishLoads; ++k) {
      const int i = i0 + k * blockDim.x;
      w[k] = i < r1 ? __ldcg(out + i) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kFinishLoads; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < r1) u[(size_t)p * n + i] = w[k] / denom;
    }
  }
}

// grid_norm's sum over `segs` partials (lane l: partials l, l + 32, ... in
// order from 0, then the shuffles), the loads kFinishLoads at once.
__device__ __forceinline__ float ell_norm(const float* part, int segs,
                                          int lane) {
  float a = 0.f;
  for (int b0 = lane; b0 < segs; b0 += 32 * kFinishLoads) {
    float w[kFinishLoads];
#pragma unroll
    for (int k = 0; k < kFinishLoads; ++k) {
      const int b = b0 + 32 * k;
      w[k] = b < segs ? __ldcg(part + b) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kFinishLoads; ++k)
      if (b0 + 32 * k < segs) a += w[k];
  }
  return sqrtf(warp_sum(a));
}

template <typename T, int WB>
__global__ void __launch_bounds__(kEllMaxThreads, 1)
    ell_powers_kernel(const T* __restrict__ values,
                      const int* __restrict__ cols, int width,
                      const float* __restrict__ x,
                      const float* __restrict__ shifts, float* u,
                      float* __restrict__ sigma, float* raw, float* part,
                      int n, int s, float eps, int segs, int seg_per_block,
                      int res_seg, int vec) {
  constexpr int RB = ell_rows_in_flight(WB);
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* red = reinterpret_cast<float*>(base);   // [segment][warp], norm
  T* vals_s = reinterpret_cast<T*>(base + ell_red_bytes(seg_per_block));
  int* cols_s = reinterpret_cast<int*>(
      reinterpret_cast<char*>(vals_s) +
      ell_vals_bytes(seg_per_block, res_seg, width, (int)sizeof(T)));
  float* norm_s = red + seg_per_block * kWarps;
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int groups = blockDim.x / kThreads;
  const int t = threadIdx.x % kThreads;   // the thread within its segment
  const int warp = t >> 5;
  const int seg0 = blockIdx.x * seg_per_block;
  const int seg_end = min(segs, seg0 + seg_per_block);
  int rows0, rows1, unused;
  seg_range(n, segs, seg0, &rows0, &unused);
  seg_range(n, segs, seg_end - 1, &unused, &rows1);
  const size_t res_elems = (size_t)res_seg * width;
  const float* cur = x;
  float denom = 1.f;
  for (int p = 0; p < s; ++p) {
    float* out = raw + (size_t)(p & 1) * n;
    const float shift = shifts != nullptr ? __ldg(shifts + p) : 0.f;
    for (int ls = threadIdx.x / kThreads; ls < seg_per_block; ls += groups) {
      float sq = 0.f;
      if (seg0 + ls < segs) {
        int r0, r1;
        seg_range(n, segs, seg0 + ls, &r0, &r1);
        const T* vs = vals_s + ls * res_elems;
        const int* cs = cols_s + ls * res_elems;
        for (int k0 = r0; k0 < r1; k0 += RB * kThreads) {
          int row[RB];
          bool ok[RB], res[RB];
#pragma unroll
          for (int b = 0; b < RB; ++b) {
            row[b] = k0 + b * kThreads + t;
            ok[b] = row[b] < r1;
            res[b] = row[b] - r0 < res_seg;   // uniform in the warp
          }
          if (p == 0) {   // the resident chunks into shared memory
#pragma unroll
            for (int b = 0; b < RB; ++b) {
              const int c0 = k0 + b * kThreads + warp * 32;   // chunk start
              if (res[b] && c0 < r1) {
                const size_t at = (size_t)(c0 - r0) * width;
                const int cnt = min(32, r1 - c0) * width;
                chunk_to_smem<T>(values + (size_t)c0 * width, cnt, width,
                                 const_cast<T*>(vs) + at, lane, vec);
                chunk_to_smem<int>(cols + (size_t)c0 * width, cnt, width,
                                   const_cast<int*>(cs) + at, lane, vec);
              }
            }
            __syncwarp();
          }
          float acc[RB];
#pragma unroll
          for (int b = 0; b < RB; ++b) acc[b] = 0.f;
          for (int t0 = 0; t0 < width; t0 += WB) {
            int col[RB][WB];
            float val[RB][WB], g[RB][WB];
#pragma unroll
            for (int b = 0; b < RB; ++b) {   // cols (and values) first
              const size_t at = (size_t)(row[b] - r0 - lane) * width;
#pragma unroll
              for (int q = 0; q < WB; ++q) {
                const int tt = t0 + q;
                col[b][q] = 0;
                val[b][q] = 0.f;
                if (ok[b] && tt < width) {
                  if (res[b]) {
                    col[b][q] = cs[at + tt * 32 + lane];
                    val[b][q] = to_f(vs[at + tt * 32 + lane]);
                  } else {
                    const size_t e = (size_t)row[b] * width + tt;
                    col[b][q] = __ldg(cols + e);
                    val[b][q] = to_f(values[e]);
                  }
                }
              }
            }
#pragma unroll
            for (int b = 0; b < RB; ++b)   // then every gather
#pragma unroll
              for (int q = 0; q < WB; ++q)
                g[b][q] = ok[b] && t0 + q < width ? __ldcg(cur + col[b][q])
                                                  : 0.f;
#pragma unroll
            for (int b = 0; b < RB; ++b)   // the fmaf chain in slot order
#pragma unroll
              for (int q = 0; q < WB; ++q)
                if (t0 + q < width)
                  acc[b] = fmaf(val[b][q], g[b][q] / denom, acc[b]);
          }
#pragma unroll
          for (int b = 0; b < RB; ++b) {
            if (!ok[b]) continue;
            if (shifts != nullptr)   // w - shift * u, as the banded kernel
              acc[b] = __fsub_rn(
                  acc[b], __fmul_rn(shift, __ldcg(cur + row[b]) / denom));
            __stcg(out + row[b], acc[b]);
            sq = fmaf(acc[b], acc[b], sq);
          }
        }
      }
      sq = warp_sum(sq);
      if (lane == 0) red[ls * kWarps + warp] = sq;
    }
    __syncthreads();
    for (int ls = threadIdx.x; ls < seg_end - seg0; ls += blockDim.x) {
      float a = 0.f;   // block_sum's order: the warps in order
#pragma unroll
      for (int q = 0; q < kWarps; ++q) a += red[ls * kWarps + q];
      part[(size_t)p * segs + seg0 + ls] = a;
    }
    grid.sync();
    if (threadIdx.x < 32) {   // grid_norm's order over the segments
      const float a = ell_norm(part + (size_t)p * segs, segs, lane);
      if (lane == 0) *norm_s = a;
    }
    __syncthreads();
    const float sg = *norm_s;
    denom = fmaxf(sg, eps);
    if (blockIdx.x == 0 && threadIdx.x == 0) sigma[p] = sg;
    ell_finish(denom, p, out, u, n, rows0, rows1);
    cur = out;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_powers_halo_kernel(const T* __restrict__ bands, BandOffsets offs,
                              int nbands, const float* __restrict__ x,
                              float* __restrict__ z, float* raw, float* part,
                              int width, int ln, int center, int s) {
  __shared__ float red[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  int r0, r1;
  row_range(width, &r0, &r1);
  const float* cur = x;
  for (int p = 0; p < s; ++p) {
    float* out = raw + (size_t)(p & 1) * width;
    float sq = 0.f;
    for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxBands; ++d) {   // offsets at constant indices
        if (d >= nbands) break;
        const int c = i + offs.off[d];
        if (c < 0 || c >= width) continue;     // the zero margin
        acc = fmaf(to_f(bands[(size_t)d * width + i]), __ldcg(cur + c), acc);
      }
      if (p + 1 < s) __stcg(out + i, acc);
      if (i >= center && i < center + ln) {
        z[(size_t)p * ln + (i - center)] = acc;
        sq = fmaf(acc, acc, sq);
      }
    }
    sq = block_sum(sq, red);
    if (threadIdx.x == 0) part[(size_t)p * gridDim.x + blockIdx.x] = sq;
    if (p + 1 < s) grid.sync();
    cur = out;
  }
}

// The dense operand, read from shared memory by common.cuh::row_dot.
struct SharedX {
  const float* xs;
  __device__ __forceinline__ void fma(float (&acc)[1], float a, int c) const {
    acc[0] = fmaf(a, xs[c], acc[0]);
  }
  __device__ __forceinline__ bool vec_ok(int head) const {
    return (head & 3) == 0;
  }
  template <int VA>
  __device__ __forceinline__ void fma_vec(float (&acc)[1], const float* a,
                                          int c0) const {
    const float4* p = reinterpret_cast<const float4*>(xs + c0);
#pragma unroll
    for (int q = 0; q < VA / 4; ++q) {
      const float4 v = p[q];
      acc[0] = fmaf(a[4 * q], v.x, acc[0]);
      acc[0] = fmaf(a[4 * q + 1], v.y, acc[0]);
      acc[0] = fmaf(a[4 * q + 2], v.z, acc[0]);
      acc[0] = fmaf(a[4 * q + 3], v.w, acc[0]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_powers_kernel(const T* __restrict__ a, const float* __restrict__ x,
                        float* u, float* __restrict__ sigma, float* raw,
                        float* part, int n, int s, float eps) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  __shared__ float red[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  const float* cur = x;
  float denom = 1.f;
  for (int p = 0; p < s; ++p) {
    // every warp of this block finished the previous power before the
    // grid sync, so xs is free to overwrite
    for (int c = threadIdx.x; c < n; c += blockDim.x)
      xs[c] = __ldcg(cur + c) / denom;
    __syncthreads();
    float* out = raw + (size_t)(p & 1) * n;
    float sq = 0.f;
    for (int r = gw; r < n; r += nwarps) {
      float acc[1] = {0.f};
      row_dot<T, 1>(a + (size_t)r * n, n, lane, SharedX{xs}, acc);
      acc[0] = warp_sum(acc[0]);
      if (lane == 0) {
        __stcg(out + r, acc[0]);
        sq = fmaf(acc[0], acc[0], sq);
      }
    }
    sq = block_sum(sq, red);
    if (threadIdx.x == 0) part[(size_t)p * gridDim.x + blockIdx.x] = sq;
    grid.sync();
    const float sg = grid_norm(part + (size_t)p * gridDim.x, red);
    denom = fmaxf(sg, eps);
    if (blockIdx.x == 0 && threadIdx.x == 0) sigma[p] = sg;
    if (lane == 0)
      for (int r = gw; r < n; r += nwarps)
        u[(size_t)p * n + r] = __ldcg(out + r) / denom;
    cur = out;
  }
}

constexpr int kMaxChebSteps = 32;
struct ChebRhos {
  float rho[kMaxChebSteps];
  float rho_old[kMaxChebSteps];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_cheb_kernel(const T* __restrict__ bands, BandOffsets offs,
                       int nbands, const float* __restrict__ v, float* zbuf,
                       float* __restrict__ out, int n, float theta, float c,
                       ChebRhos rhos, int steps) {
  cg::grid_group grid = cg::this_grid();
  int r0, r1;
  row_range(n, &r0, &r1);
  for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const float z0 = __ldg(v + i) / theta;
    if (steps == 0)
      out[i] = z0;
    else
      __stcg(zbuf + i, z0);
  }
  for (int t = 0; t < steps; ++t) {
    grid.sync();
    const float* z = zbuf + (size_t)(t & 1) * n;
    float* znext = zbuf + (size_t)((t + 1) & 1) * n;
    const float rho = rhos.rho[t], rho_old = rhos.rho_old[t];
    const bool last = t == steps - 1;
    for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
      float w = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxBands; ++d) {   // offsets at constant indices
        if (d >= nbands) break;
        const int col = i + offs.off[d];
        if (col < 0 || col >= n) continue;     // the zero halo
        w = fmaf(to_f(bands[(size_t)d * n + i]), __ldcg(z + col), w);
      }
      const float zi = __ldcg(z + i);
      const float zold = t == 0 ? 0.f : __ldcg(znext + i);
      const float znew =
          rho * (c * (__ldg(v + i) - w) + rho_old * (zi - zold)) + zi;
      if (last)
        out[i] = znew;
      else
        __stcg(znext + i, znew);
    }
  }
}

template <typename T>
static cudaError_t launch_banded_cheb(const void* bands, const int* offsets,
                                      int nbands, const float* v,
                                      float* zbuf, float* out, int n,
                                      float theta, float c, const float* rho,
                                      const float* rho_old, int steps,
                                      int blocks_per_sm,
                                      cudaStream_t stream) {
  if (n <= 0 || nbands <= 0 || nbands > kMaxBands || steps < 0 ||
      steps > kMaxChebSteps)
    return cudaErrorInvalidValue;
  BandOffsets offs{};
  for (int d = 0; d < nbands; ++d) offs.off[d] = offsets[d];
  ChebRhos rhos{};
  for (int t = 0; t < steps; ++t) {
    rhos.rho[t] = rho[t];
    rhos.rho_old[t] = rho_old[t];
  }
  int g = 0;
  cudaError_t e = persistent_grid(banded_cheb_kernel<T>, 0, blocks_per_sm,
                                  (n + kThreads - 1) / kThreads, &g);
  if (e != cudaSuccess) return e;
  const T* bt = static_cast<const T*>(bands);
  void* args[] = {(void*)&bt, (void*)&offs,  (void*)&nbands, (void*)&v,
                  (void*)&zbuf, (void*)&out, (void*)&n,     (void*)&theta,
                  (void*)&c,  (void*)&rhos,  (void*)&steps};
  e = cudaLaunchCooperativeKernel((const void*)banded_cheb_kernel<T>, g,
                                  kThreads, args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Grid of the banded kernel: a thread per row at least.  Its blocks are
// the ELL kernel's segments, so both formats share one row partition.
template <typename T>
static cudaError_t banded_grid(int n, int blocks_per_sm, int* grid) {
  return persistent_grid(banded_powers_kernel<T>, 0, blocks_per_sm,
                         (n + kThreads - 1) / kThreads, grid);
}

template <typename T>
static cudaError_t launch_banded_powers_halo(
    const void* bands, const int* offsets, int nbands, const float* x,
    float* z, float* nrm, float* raw, float* part, int part_blocks, int width,
    int s, int blocks_per_sm, cudaStream_t stream) {
  if (width <= 0 || s <= 0 || nbands <= 0 || nbands > kMaxBands)
    return cudaErrorInvalidValue;
  BandOffsets offs{};
  int halo = 0;
  for (int d = 0; d < nbands; ++d) {
    offs.off[d] = offsets[d];
    const int a = offsets[d] < 0 ? -offsets[d] : offsets[d];
    halo = a > halo ? a : halo;
  }
  int center = s * halo;
  int ln = width - 2 * center;
  if (ln <= 0) return cudaErrorInvalidValue;
  int g = 0;
  cudaError_t e = persistent_grid(banded_powers_halo_kernel<T>, 0,
                                  blocks_per_sm,
                                  (width + kThreads - 1) / kThreads, &g);
  if (e != cudaSuccess) return e;
  if (g > part_blocks) return cudaErrorInvalidValue;
  const T* bt = static_cast<const T*>(bands);
  void* args[] = {(void*)&bt,  (void*)&offs, (void*)&nbands, (void*)&x,
                  (void*)&z,   (void*)&raw,  (void*)&part,   (void*)&width,
                  (void*)&ln,  (void*)&center, (void*)&s};
  e = cudaLaunchCooperativeKernel((const void*)banded_powers_halo_kernel<T>,
                                  g, kThreads, args, 0, stream);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(part, g, s, 0, 0, nrm, stream);
}

template <typename T>
static cudaError_t dense_grid(int n, int blocks_per_sm, int* grid) {
  return persistent_grid(dense_powers_kernel<T>, sizeof(float) * (size_t)n,
                         blocks_per_sm, (n + kWarps - 1) / kWarps, grid);
}

template <typename T>
static cudaError_t launch_banded_powers(const void* mat, const int* offsets,
                                        int nbands, const float* x,
                                        const float* shifts, float* u,
                                        float* sigma, float* raw, float* part,
                                        int part_blocks, int n, int s,
                                        float eps, int blocks_per_sm,
                                        cudaStream_t stream) {
  if (n <= 0 || s <= 0 || nbands <= 0 || nbands > kMaxBands)
    return cudaErrorInvalidValue;
  BandOffsets offs{};
  for (int d = 0; d < nbands; ++d) offs.off[d] = offsets[d];
  int g = 0;
  cudaError_t e = banded_grid<T>(n, blocks_per_sm, &g);
  if (e != cudaSuccess) return e;
  if (g > part_blocks) return cudaErrorInvalidValue;
  const T* mt = static_cast<const T*>(mat);
  void* args[] = {(void*)&mt,     (void*)&offs, (void*)&nbands,
                  (void*)&x,      (void*)&shifts, (void*)&u,
                  (void*)&sigma,  (void*)&raw,  (void*)&part,
                  (void*)&n,      (void*)&s,    (void*)&eps};
  e = cudaLaunchCooperativeKernel((const void*)banded_powers_kernel<T>, g,
                                  kThreads, args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The ELL kernel at the plan's shape (tuning.ell_powers_plan): `segs` must
// be the banded kernel's grid at this n (the shared row partition), the
// blocks cover the segments, and `smem` is ell_smem_bytes of the plan,
// within smem_cap.  A grid that cannot be co-resident is refused by the
// cooperative launch.
template <typename T, int WB>
static cudaError_t launch_ell_bucket(const T* values, const int* cols,
                                     int width, const float* x,
                                     const float* shifts, float* u,
                                     float* sigma, float* raw, float* part,
                                     int n, int s, float eps, int segs,
                                     int seg_per_block, int blocks,
                                     int threads, int res_seg, int vec,
                                     int smem, cudaStream_t stream) {
  auto kernel = ell_powers_kernel<T, WB>;
  cudaError_t e = allow_smem(kernel, (size_t)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {(void*)&values, (void*)&cols,  (void*)&width,
                  (void*)&x,      (void*)&shifts, (void*)&u,
                  (void*)&sigma,  (void*)&raw,   (void*)&part,
                  (void*)&n,      (void*)&s,     (void*)&eps,
                  (void*)&segs,   (void*)&seg_per_block,
                  (void*)&res_seg, (void*)&vec};
  e = cudaLaunchCooperativeKernel((const void*)kernel, blocks, threads, args,
                                  (size_t)smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_ell_powers(
    const void* values, const int* cols, int width, const float* x,
    const float* shifts, float* u, float* sigma, float* raw, float* part,
    int part_blocks, int n, int s, float eps, int segs, int seg_per_block,
    int blocks, int threads, int res_seg, int bucket, int vec, int smem,
    int smem_cap, int blocks_per_sm, cudaStream_t stream) {
  if (n <= 0 || s <= 0 || width <= 0 || segs < 1 || seg_per_block < 1 ||
      segs > part_blocks || blocks != (segs + seg_per_block - 1) /
                                           seg_per_block ||
      threads % kThreads || threads < kThreads || threads > kEllMaxThreads ||
      res_seg < 0 || res_seg % 32 || smem > smem_cap ||
      (size_t)smem != ell_smem_bytes(seg_per_block, res_seg, width,
                                     (int)sizeof(T)))
    return cudaErrorInvalidValue;
  int g = 0;
  cudaError_t e = banded_grid<T>(n, blocks_per_sm, &g);
  if (e != cudaSuccess) return e;
  if (g != segs) return cudaErrorInvalidValue;
  const T* vt = static_cast<const T*>(values);
#define REPRO_ELL_BUCKET(WB)                                                 \
  launch_ell_bucket<T, WB>(vt, cols, width, x, shifts, u, sigma, raw, part, \
                           n, s, eps, segs, seg_per_block, blocks, threads, \
                           res_seg, vec, smem, stream)
  switch (bucket) {
    case 4: return REPRO_ELL_BUCKET(4);
    case 5: return REPRO_ELL_BUCKET(5);
    case 8: return REPRO_ELL_BUCKET(8);
    case 16: return REPRO_ELL_BUCKET(16);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_ELL_BUCKET
}

template <typename T>
static cudaError_t launch_dense_powers(const void* a, const float* x,
                                       float* u, float* sigma, float* raw,
                                       float* part, int part_blocks, int n,
                                       int s, float eps, int smem_cap,
                                       int blocks_per_sm,
                                       cudaStream_t stream) {
  if (n <= 0 || s <= 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)n;
  if (smem > (size_t)smem_cap) return cudaErrorInvalidValue;
  int g = 0;
  cudaError_t e = dense_grid<T>(n, blocks_per_sm, &g);
  if (e != cudaSuccess) return e;
  if (g > part_blocks) return cudaErrorInvalidValue;
  const T* at = static_cast<const T*>(a);
  void* args[] = {(void*)&at,  (void*)&x,   (void*)&u,
                  (void*)&sigma, (void*)&raw, (void*)&part,
                  (void*)&n,   (void*)&s,   (void*)&eps};
  e = cudaLaunchCooperativeKernel((const void*)dense_powers_kernel<T>, g,
                                  kThreads, args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace repro

// Common arguments: x (n,) f32; shifts (s,) f32 in device memory or null
// (monomial basis); u (s, n) and sigma (s,) f32 out; raw holds 2 n floats
// and part s * part_blocks floats of scratch.
//
// bands (nbands, n); offsets is host memory (nbands ints), copied into the
// launch's parameters.
extern "C" int repro_banded_powers(const void* bands, int b_bf16,
                                   const int* offsets, int nbands,
                                   const float* x, const float* shifts,
                                   float* u, float* sigma, float* raw,
                                   float* part, int part_blocks, int n, int s,
                                   float eps, int blocks_per_sm,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BANDED(T)                                                       \
  repro::launch_banded_powers<T>(bands, offsets, nbands, x, shifts, u,       \
                                 sigma, raw, part, part_blocks, n, s, eps,   \
                                 blocks_per_sm, st)
  return b_bf16 ? REPRO_BANDED(repro::bf16) : REPRO_BANDED(float);
#undef REPRO_BANDED
}

// values (n, width) and cols (n, width) int32, row-major; the plan of
// tuning.ell_powers_plan: segs (the banded grid), seg_per_block, blocks,
// threads, res_seg (resident rows a segment), bucket (4, 5, 8 or 16 slots
// unrolled), vec (values and cols 16-byte aligned), smem (its bytes, at
// most smem_cap); raw holds 2 n floats and part s * part_blocks.
extern "C" int repro_ell_powers(const void* values, int v_bf16,
                                const int* cols, int width, const float* x,
                                const float* shifts, float* u, float* sigma,
                                float* raw, float* part, int part_blocks,
                                int n, int s, float eps, int segs,
                                int seg_per_block, int blocks, int threads,
                                int res_seg, int bucket, int vec, int smem,
                                int smem_cap, int blocks_per_sm,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ELL(T)                                                         \
  repro::launch_ell_powers<T>(values, cols, width, x, shifts, u, sigma, raw, \
                              part, part_blocks, n, s, eps, segs,            \
                              seg_per_block, blocks, threads, res_seg,       \
                              bucket, vec, smem, smem_cap, blocks_per_sm, st)
  return v_bf16 ? REPRO_ELL(repro::bf16) : REPRO_ELL(float);
#undef REPRO_ELL
}

// a (n, n) row-major; n floats of dynamic shared memory must fit smem_cap.
extern "C" int repro_dense_powers(const void* a, int a_bf16, const float* x,
                                  float* u, float* sigma, float* raw,
                                  float* part, int part_blocks, int n, int s,
                                  float eps, int smem_cap, int blocks_per_sm,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a_bf16 ? repro::launch_dense_powers<repro::bf16>(
                      a, x, u, sigma, raw, part, part_blocks, n, s, eps,
                      smem_cap, blocks_per_sm, st)
                : repro::launch_dense_powers<float>(
                      a, x, u, sigma, raw, part, part_blocks, n, s, eps,
                      smem_cap, blocks_per_sm, st);
}

// The fused Chebyshev apply: bands (nbands, n), offsets host memory; v (n,)
// f32; zbuf 2 n floats of scratch; out (n,) f32; c = 2 / delta; rho and
// rho_old host memory, `steps` floats each.
extern "C" int repro_banded_cheb_apply(const void* bands, int b_bf16,
                                       const int* offsets, int nbands,
                                       const float* v, float* zbuf,
                                       float* out, int n, float theta,
                                       float c, const float* rho,
                                       const float* rho_old, int steps,
                                       int blocks_per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CHEB(T)                                                        \
  repro::launch_banded_cheb<T>(bands, offsets, nbands, v, zbuf, out, n,     \
                               theta, c, rho, rho_old, steps, blocks_per_sm, \
                               st)
  return b_bf16 ? REPRO_CHEB(repro::bf16) : REPRO_CHEB(float);
#undef REPRO_CHEB
}

// The row-sharded banded powers: bands (nbands, width), offsets host
// memory; x (width,) f32; z (s, width - 2 s halo) and nrm (s,) f32 out; raw
// holds 2 width floats and part s * part_blocks floats of scratch.
extern "C" int repro_banded_powers_halo(const void* bands, int b_bf16,
                                        const int* offsets, int nbands,
                                        const float* x, float* z, float* nrm,
                                        float* raw, float* part,
                                        int part_blocks, int width, int s,
                                        int blocks_per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_HALO(T)                                                       \
  repro::launch_banded_powers_halo<T>(bands, offsets, nbands, x, z, nrm,   \
                                      raw, part, part_blocks, width, s,    \
                                      blocks_per_sm, st)
  return b_bf16 ? REPRO_HALO(repro::bf16) : REPRO_HALO(float);
#undef REPRO_HALO
}

// The launch shape of kind 0 (banded) or 2 (dense; the ELL kernel's is
// tuning.ell_powers_plan, on the banded grid): out = {grid, rows per block
// (banded) or warps (dense), smem bytes}.
extern "C" int repro_matrix_powers_shape(int kind, int is_bf16, int n,
                                         int blocks_per_sm, int* out) {
  using repro::bf16;
  int g = 0;
  cudaError_t e;
  if (kind == 0)
    e = is_bf16 ? repro::banded_grid<bf16>(n, blocks_per_sm, &g)
                : repro::banded_grid<float>(n, blocks_per_sm, &g);
  else if (kind == 2)
    e = is_bf16 ? repro::dense_grid<bf16>(n, blocks_per_sm, &g)
                : repro::dense_grid<float>(n, blocks_per_sm, &g);
  else
    return cudaErrorInvalidValue;
  out[0] = g;
  out[1] = kind == 2 ? g * repro::kWarps
                     : (g ? ((n + g - 1) / g + 31) / 32 * 32 : 0);
  out[2] = kind == 2 ? (int)(sizeof(float) * (size_t)n) : 0;
  return e;
}
