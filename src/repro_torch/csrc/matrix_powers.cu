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
// (__ldcg, cp.async.cg): an SM's L1 may hold stale lines of a neighbour's
// rows.
//   banded  the ELL kernel's block shape (up to four row segments a block,
//           one block an SM; the segments are the first design's grid, so
//           the same bits): the band stack copied into shared memory once
//           and kept for all s powers (the TPU's VMEM residency: the whole
//           21 MB f32 stack of the 1024^2 stencil on 132 SMs), and after
//           each grid sync the block's rows of the operand and a halo of
//           max|offset| rows each side copied from L2 in 16-byte pieces,
//           all in flight, and divided once into a shared tile, from which
//           u_{p-1} is written and the stencil reads.  The offsets come by
//           value and are never indexed at run time in the parameters (a
//           banded SpMV that did lost 6x to a local-memory copy of them);
//           an out-of-range neighbour is skipped (the TPU's zero halo).
//           The section
//           "The banded powers and the fused Chebyshev apply" below has
//           the details and the routes (tuning.banded_plan).
//   ELL     its own kernel (ell_powers_kernel, below): the table read once
//           from HBM, kept in shared memory across the s powers.
//   dense   a warp per row (rows dealt round-robin over the grid's warps),
//           the row read in 16-byte vectors (common.cuh::row_dot, bf16
//           widened in registers); each block first divides the whole
//           operand into shared memory (n floats: 40 KB at n = 10,000) and
//           the rows read it there.
// The dense grid is sized by the occupancy calculator so the cooperative
// launch is legal; the banded and ELL plans are one block an SM, which the
// cooperative launch refuses if it cannot be co-resident.
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
// Design: one cooperative launch on the banded powers' plan (their block
// shape, band stack kept in shared memory and operand tile), one grid sync
// between steps: step 0 divides v / theta into its tile itself (z_0 is
// never stored), step t copies z_t's tile from the scratch row that step
// t - 1 wrote (two rows used in turn: step t writes z_{t+1} over z_{t-1}),
// and the last step writes the output instead.  A thread keeps v and
// z_{t-1} of its first kKeepRows rows in registers.  theta, c and the
// (rho, rho_old) pairs come by value.  No norm, no reduction: the bits do
// not depend on the grid.
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
//   same `segs` ranges (tuning.powers_segments, row_range's rule for a grid
//   of `segs` blocks), and a segment's partial
//   is what a block of kThreads would sum: thread t takes rows r0 + t,
//   r0 + t + kThreads, ... in order, then warp shuffles and the warps in
//   order.  A block of this kernel owns `seg_per_block` consecutive
//   segments and runs `blockDim / kThreads` of them at once, one group of
//   kThreads threads each, writing one partial a segment in the same order.
//   Each row's sum is the same fmaf chain in slot order over raw / denom,
//   the same division (the source note above), so u and sigma are the
//   banded kernel's bits.
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
// tuning.ell_powers_plan chooses segs (tuning.powers_segments, as the
// banded kernels), the segments a block and its resident rows; res_seg = 0 (a table too wide for one chunk
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

// ---------------------------------------------------------------------------
// The banded powers and the fused Chebyshev apply (kernel-table rows 14 and
// 18), on the ELL kernel's block shape.
//
// The first Hopper designs were a thread a row on a grid of
// four blocks an SM, each row's operands gathered from L2 and divided by
// max(sigma, eps) one at a time, the row's raw value stored, and a second
// walk over the rows to write u_p: every row of a thread a dependent L2
// round trip, about 20 us a power against a bound of 2.8 (the ELL note's
// finding: the chains, not the bytes).  The offsets come by value, so no
// load waits on an index, and a block's operand is a contiguous range:
//
// - Segments.  The rows are cut into `segs` segments (tuning.powers_segments,
//   row_range's rule for a grid of `segs` blocks: the first design's grid),
//   up to four consecutive ones a block, one group of kThreads threads a
//   segment (1,024 threads, one block an SM), and the norm is summed
//   exactly as before: thread t's rows r0 + t, r0 + t + kThreads, ... in
//   order, the warp shuffles, the warps in order, one partial a segment,
//   grid_norm's order over the segments.  So u and sigma are the first
//   design's bits, and the ELL kernel's.
// - The band stack on chip.  The first res_seg rows of each segment, every
//   band, are copied into shared memory once, before power 1, band-major
//   ([segment][band][row]: consecutive threads read consecutive words), with
//   16-byte asynchronous copies (cp.async, all in flight, the L2 lines
//   marked evict-first).  The other rows' entries are read from global
//   memory every power.
// - The operand divided once, into a tile: the block's rows and `tile_halo`
//   rows each side (the ends on 16-byte boundaries).  Right after each grid
//   sync the block starts 16-byte cp.async copies of the tile from the raw
//   row, which fly while the norm is summed; then each thread divides the
//   pieces it copied once by max(sigma, eps) (the same correctly rounded
//   division as the first design's) and writes u_{p-1} for the block's own
//   rows from the same values.  The stencil and the shift term read only
//   shared memory, at 32-bit shared addresses; the offsets of 3, 5, 7 or 9
//   bands are a template parameter's registers (else shared memory), rows
//   with every neighbour in range take no bounds check and the others skip
//   their out-of-range bands by predication.  Rows past the resident ones
//   and bands farther than tile_halo (route "far": the halo does not fit
//   beside the block's rows) take a general loop that reads L2 (with a
//   division each, as before) through volatile loads: a non-volatile
//   __ldcg there was run ahead of its branch for every band and put an L2
//   round trip on every row.  Where not even the block's rows fit (route
//   "l2") every band is read so, and u_p is written by ell_finish.
// - The norm: every partial loaded at once into shared memory (a thread
//   each), then summed by warp 0 there in grid_norm's order.
// Tried on the card and dropped (PERF.md section 6): the 32-way unrolled,
// constant-indexed band loop with its L2 path in every copy (the
// speculated loads above); a called (noinline) general path (caller-saved
// registers spilled to an L1 that 200 KB of shared memory leaves at about
// 28 KB); keeping each thread's raw rows in registers between powers so
// L2 carries only the halos (no faster: a longer stencil and a colder
// instruction cache); 512 threads, two segments a group (slower).
//
// The Chebyshev apply has no norm, so its bits do not depend on the grid;
// it takes the same plan and block.  A thread keeps v and z_{t-1} of its
// first kKeepRows rows that read only the tile and the stack (resident,
// interior, every band near) in registers across the steps (its rows are
// the same in every step); its other rows read them from global memory
// (z_{t-1} from the row about to be overwritten, z_0 as v / theta).
// z_0 = v / theta is divided into step 0's tile straight from v, so no sync
// comes before step 0 and z_0 is never stored.  Each row's sums are the
// first design's: the fmaf chain in band order, and cheb_next's roundings,
// so the bits are too.
// ---------------------------------------------------------------------------
constexpr int kTileSlack = 8;      // tile rows beyond rows + 2 halo: both
                                   // ends moved to 16-byte boundaries
constexpr int kKeepRows = 8;       // rows of a segment a thread keeps in
                                   // registers between steps (Chebyshev)
constexpr int kRanges = 3;         // L2 ranges of a tile: halos, own rows

// Shared memory of the banded kernels: the partials' slots (kWarps a
// segment, the norm, then the grid's `segs` partials), the tile (tile_rows
// floats), then the resident stack, each 16-byte aligned.
__host__ __device__ inline size_t banded_red_bytes(int seg_per_block,
                                                   int segs) {
  return ((size_t)(seg_per_block * kWarps + 1 + segs) * sizeof(float) + 15) /
         16 * 16;
}
__host__ __device__ inline size_t banded_tile_bytes(int tile_rows) {
  return ((size_t)tile_rows * sizeof(float) + 15) / 16 * 16;
}
__host__ __device__ inline size_t banded_smem_bytes(int seg_per_block,
                                                    int segs, int res_seg,
                                                    int nbands, int elem,
                                                    int tile_rows) {
  return banded_red_bytes(seg_per_block, segs) +
         banded_tile_bytes(tile_rows) +
         ((size_t)seg_per_block * res_seg * nbands * elem + 15) / 16 * 16;
}

// A block's segments, rows and tile: segments [seg0, seg_end), rows
// [rows0, rows1), tile rows [t0, t1) (empty without a tile).
struct BandedBlock {
  int seg0, seg_end, rows0, rows1, t0, t1;
};
__device__ __forceinline__ BandedBlock banded_block(int n, int segs,
                                                    int seg_per_block,
                                                    int tile_halo) {
  BandedBlock b;
  int unused;
  b.seg0 = blockIdx.x * seg_per_block;
  b.seg_end = min(segs, b.seg0 + seg_per_block);
  seg_range(n, segs, b.seg0, &b.rows0, &unused);
  seg_range(n, segs, b.seg_end - 1, &unused, &b.rows1);
  if (tile_halo >= 0) {
    b.t0 = max(0, b.rows0 - tile_halo) & ~3;
    b.t1 = min(n, (b.rows1 + tile_halo + 3) & ~3);
  } else {
    b.t0 = b.t1 = 0;
  }
  return b;
}

// The offsets into shared memory (read at constant indices from the
// parameters), and the bands read from the tile: |offset| <= tile_halo.
__device__ __forceinline__ unsigned load_offsets(const BandOffsets& offs,
                                                 int nbands, int tile_halo,
                                                 int* offs_s) {
  unsigned near = 0;
#pragma unroll
  for (int d = 0; d < kMaxBands; ++d) {
    if (d >= nbands) break;
    if (threadIdx.x == 0) offs_s[d] = offs.off[d];
    if (abs(offs.off[d]) <= tile_halo) near |= 1u << d;
  }
  return near;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           uint64_t policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          s),
      "l"(gmem), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The resident stack: rows [r0, r0 + min(res_seg, r1 - r0)) of each of the
// block's segments, every band, to stack[(ls * nbands + d) * res_seg + row -
// r0].  `vec`: 16-byte copies in flight (cp.async, evict-first in L2); the
// caller waits (cp_async_wait_all) and syncs.  Else one entry a thread.
template <typename T>
__device__ __forceinline__ void load_stack(const T* __restrict__ bands,
                                           T* stack, int nbands, int n,
                                           int segs, const BandedBlock& b,
                                           int res_seg, int vec) {
  constexpr int P = 16 / (int)sizeof(T);
  const int per_band = res_seg / (vec ? P : 1);   // pieces or entries
  const int total = (b.seg_end - b.seg0) * nbands * per_band;
  uint64_t policy = 0;
  if (vec)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int slice = e / per_band, q = e - slice * per_band;
    const int ls = slice / nbands, d = slice - ls * nbands;
    int r0, r1;
    seg_range(n, segs, b.seg0 + ls, &r0, &r1);
    const int len = min(res_seg, r1 - r0);
    T* dst = stack + (size_t)slice * res_seg;
    const T* src = bands + (size_t)d * n + r0;
    if (vec) {
      if (q * P < len) cp_async16(dst + q * P, src + q * P, policy);
    } else if (q < len) {
      dst[q] = src[q];
    }
  }
}

// The tile rows a block reads from L2: the halos [t0, rows0) and [rows1,
// t1) (with_halo) and its own rows [rows0, rows1).  Empty ranges have
// lo >= hi.
__device__ __forceinline__ void tile_ranges(const BandedBlock& b,
                                            bool with_halo,
                                            int (&lo)[kRanges],
                                            int (&hi)[kRanges]) {
  lo[0] = b.t0;
  hi[0] = with_halo ? b.rows0 : b.t0;
  lo[1] = b.rows1;
  hi[1] = with_halo ? b.t1 : b.rows1;
  lo[2] = b.rows0;
  hi[2] = b.rows1;
}

// Copying the ranges of src into the tile (tile[i - t0] = src[i]) is split
// in two: issue_ranges starts the 16-byte cp.async pieces where `vec` (src
// 16-byte aligned, the ranges on 16-byte boundaries or n), so that they
// fly while the block does other work; finish_ranges waits for them and
// has each thread divide the pieces it copied by denom (DIV), in place,
// writing range 2 (the block's own rows) to u_out as well where given.
// Without `vec`, finish_ranges does it all: kFinishLoads loads of each
// thread's stride at once, through L2.  The caller syncs.
__device__ __forceinline__ void issue_ranges(const float* src, float* tile,
                                             int t0, const int (&lo)[kRanges],
                                             const int (&hi)[kRanges],
                                             int vec) {
  if (!vec) return;
  float4* tile4 = reinterpret_cast<float4*>(tile);
#pragma unroll
  for (int r = 0; r < kRanges; ++r)
    for (int q = ((lo[r] - t0) >> 2) + threadIdx.x;
         q < ((hi[r] - t0 + 3) >> 2); q += blockDim.x)
      cp_async16(tile4 + q, src + t0 + 4 * q);
}

template <bool DIV>
__device__ __forceinline__ void finish_ranges(const float* src, float denom,
                                              float* tile, int t0,
                                              const int (&lo)[kRanges],
                                              const int (&hi)[kRanges],
                                              float* u_out, int vec) {
  if (vec) {
    float4* tile4 = reinterpret_cast<float4*>(tile);
    cp_async_wait_all();
#pragma unroll
    for (int r = 0; r < kRanges; ++r) {
      float* u_r = r == 2 ? u_out : nullptr;   // range 2: own rows
      for (int q = ((lo[r] - t0) >> 2) + threadIdx.x;
           q < ((hi[r] - t0 + 3) >> 2); q += blockDim.x) {
        float4 w = tile4[q];
        if (DIV) {
          w.x = w.x / denom;
          w.y = w.y / denom;
          w.z = w.z / denom;
          w.w = w.w / denom;
        }
        tile4[q] = w;
        if (u_r != nullptr) *reinterpret_cast<float4*>(u_r + t0 + 4 * q) = w;
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRanges; ++r) {
    float* u_r = r == 2 ? u_out : nullptr;
    for (int i0 = lo[r] + threadIdx.x; i0 < hi[r];
         i0 += kFinishLoads * blockDim.x) {
      float w[kFinishLoads];
#pragma unroll
      for (int k = 0; k < kFinishLoads; ++k) {
        const int i = i0 + k * blockDim.x;
        w[k] = i < hi[r] ? __ldcg(src + i) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kFinishLoads; ++k) {
        const int i = i0 + k * blockDim.x;
        if (i >= hi[r]) continue;
        const float y = DIV ? w[k] / denom : w[k];
        tile[i - t0] = y;
        if (u_r != nullptr) u_r[i] = y;
      }
    }
  }
}

// Shared-memory loads at 32-bit shared addresses (through the kernels'
// generic pointers each tile and stack read cost 64-bit address
// arithmetic: about 100 instructions a five-band row).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
template <typename T> __device__ __forceinline__ float lds(unsigned a);
template <> __device__ __forceinline__ float lds<float>(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
template <> __device__ __forceinline__ float lds<bf16>(unsigned a) {
  unsigned short h;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(h) : "r"(a));
  return __bfloat162float(__ushort_as_bfloat16(h));
}

// Row i's (row j of its segment's) fmaf chain in band order over the tile
// (tile_i: the shared address of the tile at row i) and the resident stack
// (st_j: of the stack at row j, band d res_bytes further on): every band
// near, the row resident.  NB > 0: the offsets o[] in registers; NB = 0:
// nbands of them from shared memory.  CHECK: a neighbour may be out of
// range, and its band is skipped (predicated: the zero halo).
template <typename T, int NB, bool CHECK>
__device__ __forceinline__ float tile_row(const int (&o)[NB > 0 ? NB : 1],
                                          const int* offs_s, int nbands,
                                          unsigned st_j, unsigned tile_i,
                                          unsigned res_bytes, int n, int i) {
  float acc = 0.f;
  if constexpr (NB > 0) {
#pragma unroll
    for (int d = 0; d < NB; ++d)
      if (!CHECK || (unsigned)(i + o[d]) < (unsigned)n)
        acc = fmaf(lds<T>(st_j + d * res_bytes), lds<float>(tile_i + 4 * o[d]),
                   acc);
  } else {
    for (int d = 0; d < nbands; ++d) {
      const int od = offs_s[d];
      if (!CHECK || (unsigned)(i + od) < (unsigned)n)
        acc = fmaf(lds<T>(st_j + d * res_bytes), lds<float>(tile_i + 4 * od),
                   acc);
    }
  }
  return acc;
}

// An L2 read that the compiler may not execute ahead of its branch (a
// non-volatile __ldcg in a band's far path was run for every band,
// putting an L2 round trip on each row of the tile path).
__device__ __forceinline__ float ld_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// An operand through L2: src[c] / scale (div) or src[c].
__device__ __forceinline__ float far_value(const float* src, float scale,
                                           int div, int c) {
  const float y = ld_l2(src + c);
  return div ? y / scale : y;
}

// The same chain for every other row (a neighbour out of range, a row
// past the resident ones, a band beyond the tile): the entry from the
// resident stack (j < res_seg) or global memory, the operand from the
// tile (near bands) or far_value (L2); the offsets from shared memory.
template <typename T>
__device__ __forceinline__ float band_row(const T* __restrict__ bands,
                                          const T* st, const int* offs_s,
                                          int nbands, unsigned near,
                                          const float* tile, int t0,
                                          int res_seg, int n, int i, int j,
                                          const float* src, float scale,
                                          int div) {
  float acc = 0.f;
  const bool res = j < res_seg;
  for (int d = 0; d < nbands; ++d) {
    const int c = i + offs_s[d];
    if (c < 0 || c >= n) continue;         // the zero halo
    const float a = to_f(res ? st[d * res_seg + j] : bands[(size_t)d * n + i]);
    acc = fmaf(a, (near >> d) & 1u ? tile[c - t0]
                                   : far_value(src, scale, div, c), acc);
  }
  return acc;
}

// The rows of a block whose neighbours are all in range, [lo, hi), and the
// offsets in registers (NB > 0).
template <int NB>
struct Bands {
  int o[NB > 0 ? NB : 1];
  int lo, hi;
};
template <int NB>
__device__ __forceinline__ Bands<NB> bands_of(const BandOffsets& offs,
                                              int nbands, int n) {
  Bands<NB> r;
  int mn = 0, mx = 0;
#pragma unroll
  for (int d = 0; d < kMaxBands; ++d) {   // offsets at constant indices
    if (d >= nbands) break;
    if (d < (NB > 0 ? NB : 1)) r.o[d] = offs.off[d];
    mn = min(mn, offs.off[d]);
    mx = max(mx, offs.off[d]);
  }
  r.lo = -mn;
  r.hi = n - mx;
  return r;
}

template <typename T, int NB>
__global__ void __launch_bounds__(kEllMaxThreads, 1)
    banded_powers_kernel(const T* __restrict__ bands, BandOffsets offs,
                         int nbands, const float* __restrict__ x,
                         const float* __restrict__ shifts, float* u,
                         float* __restrict__ sigma, float* raw, float* part,
                         int n, int s, float eps, int segs, int seg_per_block,
                         int res_seg, int tile_halo, int tile_rows, int vec) {
  extern __shared__ float4 smem4[];
  __shared__ int offs_s[kMaxBands];
  char* base = reinterpret_cast<char*>(smem4);
  float* red = reinterpret_cast<float*>(base);   // [segment][warp]
  float* norm_s = red + seg_per_block * kWarps;
  float* part_s = norm_s + 1;                    // the grid's partials
  float* tile = reinterpret_cast<float*>(
      base + banded_red_bytes(seg_per_block, segs));
  T* stack = reinterpret_cast<T*>(reinterpret_cast<char*>(tile) +
                                  banded_tile_bytes(tile_rows));
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int ls = threadIdx.x / kThreads;   // this thread's segment
  const int t = threadIdx.x % kThreads;    // the thread within it
  const int warp = t >> 5;
  const BandedBlock b = banded_block(n, segs, seg_per_block, tile_halo);
  int r0 = n, r1 = n;
  if (b.seg0 + ls < b.seg_end) seg_range(n, segs, b.seg0 + ls, &r0, &r1);
  const bool tiled = tile_halo >= 0;
  const unsigned near = load_offsets(offs, nbands, tile_halo, offs_s);
  const bool all_near = near == (nbands == 32 ? ~0u : (1u << nbands) - 1);
  const Bands<NB> bo = bands_of<NB>(offs, nbands, n);
  const T* st = stack + (size_t)ls * nbands * res_seg;
  load_stack<T>(bands, stack, nbands, n, segs, b, res_seg, vec);
  int lo[kRanges], hi[kRanges];   // the tile's ranges from L2
  tile_ranges(b, true, lo, hi);
  if (tiled) issue_ranges(x, tile, b.t0, lo, hi, vec);
  const float* cur = x;
  float denom = 1.f;
  for (int p = 0;; ++p) {
    // the operand, divided once; u_{p-1} from the same values
    if (tiled)
      finish_ranges<true>(cur, denom, tile, b.t0, lo, hi,
                          p > 0 ? u + (size_t)(p - 1) * n : nullptr, vec);
    else if (p > 0)
      ell_finish(denom, p - 1, cur, u, n, b.rows0, b.rows1);
    if (p == s) break;
    cp_async_wait_all();   // the stack, before power 1
    __syncthreads();
    float* out = raw + (size_t)(p & 1) * n;
    const float shift = shifts != nullptr ? __ldg(shifts + p) : 0.f;
    const unsigned res_bytes = res_seg * (unsigned)sizeof(T);
    float sq = 0.f;
    for (int i = r0 + t; i < r1; i += kThreads) {
      const int j = i - r0;
      float acc;
      if (all_near && j < res_seg) {   // uniform in the warp
        const unsigned st_j = smem_addr(st + j);
        const unsigned tile_i = smem_addr(tile + (i - b.t0));
        acc = i >= bo.lo && i < bo.hi
                  ? tile_row<T, NB, false>(bo.o, offs_s, nbands, st_j, tile_i,
                                           res_bytes, n, i)
                  : tile_row<T, NB, true>(bo.o, offs_s, nbands, st_j, tile_i,
                                          res_bytes, n, i);
      } else {
        acc = band_row(bands, st, offs_s, nbands, near, tile, b.t0, res_seg,
                       n, i, j, cur, denom, 1);
      }
      if (shifts != nullptr)   // w - shift * u, as the plain version
        acc = __fsub_rn(acc, __fmul_rn(shift, tiled ? tile[i - b.t0]
                                                    : far_value(cur, denom, 1,
                                                                i)));
      __stcg(out + i, acc);
      sq = fmaf(acc, acc, sq);
    }
    sq = warp_sum(sq);
    if (lane == 0) red[ls * kWarps + warp] = sq;
    __syncthreads();
    if (threadIdx.x < b.seg_end - b.seg0) {
      float a = 0.f;   // block_sum's order: the warps in order
#pragma unroll
      for (int q = 0; q < kWarps; ++q) a += red[threadIdx.x * kWarps + q];
      part[(size_t)p * segs + b.seg0 + threadIdx.x] = a;
    }
    grid.sync();
    // the next tile's pieces fly while the norm is summed (the last pass
    // needs only the block's own rows)
    if (tiled) {
      tile_ranges(b, p + 1 < s, lo, hi);
      issue_ranges(out, tile, b.t0, lo, hi, vec);
    }
    // grid_norm's order over the segments, every partial loaded at once
    for (int q = threadIdx.x; q < segs; q += blockDim.x)
      part_s[q] = __ldcg(part + (size_t)p * segs + q);
    __syncthreads();
    if (threadIdx.x < 32) {
      float a = 0.f;
      for (int q = lane; q < segs; q += 32) a += part_s[q];
      a = sqrtf(warp_sum(a));
      if (lane == 0) *norm_s = a;
    }
    __syncthreads();
    const float sg = *norm_s;
    denom = fmaxf(sg, eps);
    if (blockIdx.x == 0 && threadIdx.x == 0) sigma[p] = sg;
    cur = out;
  }
}

// One Chebyshev step of a row: z_{t+1} = rho (c (v - w) + rho_old (z_t -
// z_{t-1})) + z_t, rounded as the first design's kernel was compiled (its
// SASS: c (v - w) rounded, rho_old's product fused into it, then rho's).
// Written out: left to the compiler, the same expression in this kernel
// fused c's product instead, and the bits moved by an ulp.
__device__ __forceinline__ float cheb_next(float rho, float c, float rho_old,
                                           float v, float w, float z,
                                           float zold) {
  return fmaf(rho, fmaf(rho_old, z - zold, __fmul_rn(c, v - w)), z);
}

constexpr int kMaxChebSteps = 32;
struct ChebRhos {
  float rho[kMaxChebSteps];
  float rho_old[kMaxChebSteps];
};

template <typename T, int NB>
__global__ void __launch_bounds__(kEllMaxThreads, 1)
    banded_cheb_kernel(const T* __restrict__ bands, BandOffsets offs,
                       int nbands, const float* __restrict__ v, float* zbuf,
                       float* __restrict__ out, int n, float theta, float c,
                       ChebRhos rhos, int steps, int segs, int seg_per_block,
                       int res_seg, int tile_halo, int tile_rows, int vec) {
  extern __shared__ float4 smem4[];
  __shared__ int offs_s[kMaxBands];
  char* base = reinterpret_cast<char*>(smem4);
  float* tile = reinterpret_cast<float*>(
      base + banded_red_bytes(seg_per_block, segs));
  T* stack = reinterpret_cast<T*>(reinterpret_cast<char*>(tile) +
                                  banded_tile_bytes(tile_rows));
  cg::grid_group grid = cg::this_grid();
  const int ls = threadIdx.x / kThreads;   // this thread's segment
  const int t = threadIdx.x % kThreads;
  const BandedBlock b = banded_block(n, segs, seg_per_block, tile_halo);
  if (steps == 0) {
    for (int i = b.rows0 + threadIdx.x; i < b.rows1; i += blockDim.x)
      out[i] = __ldg(v + i) / theta;
    return;
  }
  const bool tiled = tile_halo >= 0;
  const unsigned near = load_offsets(offs, nbands, tile_halo, offs_s);
  const bool all_near = near == (nbands == 32 ? ~0u : (1u << nbands) - 1);
  const Bands<NB> bo = bands_of<NB>(offs, nbands, n);
  load_stack<T>(bands, stack, nbands, n, segs, b, res_seg, vec);
  // A thread's rows r0 + t + j kThreads of its segment; the first
  // kKeepRows of them that read only the tile and the stack ("kept":
  // resident, interior, every band near) keep v and z_{t-1} here, the
  // others read them from global memory
  int r0 = n, r1 = n;
  if (b.seg0 + ls < b.seg_end) seg_range(n, segs, b.seg0 + ls, &r0, &r1);
  const T* st = stack + (size_t)ls * nbands * res_seg;
  float vr[kKeepRows], zo[kKeepRows];
#pragma unroll
  for (int j = 0; j < kKeepRows; ++j) {
    const int i = r0 + t + j * kThreads;
    vr[j] = i < r1 ? __ldg(v + i) : 0.f;
    zo[j] = 0.f;
  }
  auto kept = [&](int i) {
    return i - r0 < kKeepRows * kThreads && all_near && i - r0 < res_seg &&
           i >= bo.lo && i < bo.hi;
  };
  for (int step = 0; step < steps; ++step) {
    const float* z = zbuf + (size_t)(step & 1) * n;
    float* znext = zbuf + (size_t)((step + 1) & 1) * n;
    if (step > 0) grid.sync();
    if (tiled) {
      int lo[kRanges], hi[kRanges];
      tile_ranges(b, true, lo, hi);
      issue_ranges(step == 0 ? v : z, tile, b.t0, lo, hi, vec);
      if (step == 0)
        finish_ranges<true>(v, theta, tile, b.t0, lo, hi, nullptr, vec);
      else
        finish_ranges<false>(z, 1.f, tile, b.t0, lo, hi, nullptr, vec);
    }
    cp_async_wait_all();   // the stack, before step 0
    __syncthreads();
    const float rho = rhos.rho[step], rho_old = rhos.rho_old[step];
    const bool last = step == steps - 1;
    // z_t through L2: v / theta at step 0, else the scratch row
    const float* src = step == 0 ? v : z;
    const int div = step == 0;
    const unsigned res_bytes = res_seg * (unsigned)sizeof(T);
#pragma unroll
    for (int j = 0; j < kKeepRows; ++j) {
      const int i = r0 + t + j * kThreads;
      if (i >= r1 || !kept(i)) continue;
      const float w = tile_row<T, NB, false>(
          bo.o, offs_s, nbands, smem_addr(st + (i - r0)),
          smem_addr(tile + (i - b.t0)), res_bytes, n, i);
      const float zi = tile[i - b.t0];
      const float znew = cheb_next(rho, c, rho_old, vr[j], w, zi, zo[j]);
      if (last)
        out[i] = znew;
      else
        __stcg(znext + i, znew);
      zo[j] = zi;
    }
    for (int i = r0 + t; i < r1; i += kThreads) {
      if (kept(i)) continue;
      const float w =
          all_near && i - r0 < res_seg   // uniform in the warp
              ? tile_row<T, NB, true>(bo.o, offs_s, nbands,
                                      smem_addr(st + (i - r0)),
                                      smem_addr(tile + (i - b.t0)), res_bytes,
                                      n, i)
              : band_row(bands, st, offs_s, nbands, near, tile, b.t0, res_seg,
                         n, i, i - r0, src, theta, div);
      const float zi = tiled ? tile[i - b.t0] : far_value(src, theta, div, i);
      const float vi = __ldg(v + i);
      const float zold = step == 0   ? 0.f
                         : step == 1 ? vi / theta
                                     : __ldcg(znext + i);
      const float znew = cheb_next(rho, c, rho_old, vi, w, zi, zold);
      if (last)
        out[i] = znew;
      else
        __stcg(znext + i, znew);
    }
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

// The instantiation for a band count: its offsets in registers for the
// stencils' counts (3, 5, 7, 9), else from shared memory (NB = 0).
template <typename T>
static const void* powers_kernel(int nbands) {
  switch (nbands) {
    case 3: return (const void*)banded_powers_kernel<T, 3>;
    case 5: return (const void*)banded_powers_kernel<T, 5>;
    case 7: return (const void*)banded_powers_kernel<T, 7>;
    case 9: return (const void*)banded_powers_kernel<T, 9>;
    default: return (const void*)banded_powers_kernel<T, 0>;
  }
}
template <typename T>
static const void* cheb_kernel(int nbands) {
  switch (nbands) {
    case 3: return (const void*)banded_cheb_kernel<T, 3>;
    case 5: return (const void*)banded_cheb_kernel<T, 5>;
    case 7: return (const void*)banded_cheb_kernel<T, 7>;
    case 9: return (const void*)banded_cheb_kernel<T, 9>;
    default: return (const void*)banded_cheb_kernel<T, 0>;
  }
}

// The banded plan (tuning.banded_plan) against the kernels' layout: the
// blocks cover the segments, at most four a block, a group of kThreads
// threads each, whole chunks of 32 resident rows, a tile of the block's
// rows and tile_halo rows each side (or none: tile_halo = -1, tile_rows =
// 0), and `smem` the layout's bytes, within smem_cap.
static bool banded_plan_ok(int n, int nbands, int halo, int segs,
                           int seg_per_block, int blocks, int threads,
                           int res_seg, int tile_halo, int tile_rows,
                           int elem, int smem, int smem_cap) {
  if (n <= 0 || nbands <= 0 || nbands > kMaxBands || segs < 1 ||
      seg_per_block < 1 || seg_per_block * kThreads > kEllMaxThreads ||
      blocks != (segs + seg_per_block - 1) / seg_per_block ||
      threads != seg_per_block * kThreads)
    return false;
  const int per = ((n + segs - 1) / segs + 31) / 32 * 32;
  if (res_seg < 0 || res_seg % 32 || res_seg > per || tile_halo > halo ||
      tile_halo < -1)
    return false;
  if (tile_halo >= 0 ? (long long)tile_rows <
                           (long long)seg_per_block * per + 2LL * tile_halo +
                               kTileSlack
                     : tile_rows != 0)
    return false;
  return smem <= smem_cap &&
         (size_t)smem == banded_smem_bytes(seg_per_block, segs, res_seg,
                                           nbands, elem, tile_rows);
}

template <typename T>
static cudaError_t launch_banded_powers(
    const void* bands, const int* offsets, int nbands, const float* x,
    const float* shifts, float* u, float* sigma, float* raw, float* part,
    int part_blocks, int n, int s, float eps, int segs, int seg_per_block,
    int blocks, int threads, int res_seg, int tile_halo, int tile_rows,
    int vec, int smem, int smem_cap, cudaStream_t stream) {
  BandOffsets offs{};
  int halo = 0;
  for (int d = 0; d < nbands && d < kMaxBands; ++d) {
    offs.off[d] = offsets[d];
    const int a = offsets[d] < 0 ? -offsets[d] : offsets[d];
    halo = a > halo ? a : halo;
  }
  if (s <= 0 || segs > part_blocks ||
      !banded_plan_ok(n, nbands, halo, segs, seg_per_block, blocks, threads,
                      res_seg, tile_halo, tile_rows, (int)sizeof(T), smem,
                      smem_cap))
    return cudaErrorInvalidValue;
  const void* kernel = powers_kernel<T>(nbands);
  cudaError_t e = allow_smem(kernel, (size_t)smem);
  if (e != cudaSuccess) return e;
  const T* bt = static_cast<const T*>(bands);
  void* args[] = {(void*)&bt,       (void*)&offs,      (void*)&nbands,
                  (void*)&x,        (void*)&shifts,    (void*)&u,
                  (void*)&sigma,    (void*)&raw,       (void*)&part,
                  (void*)&n,        (void*)&s,         (void*)&eps,
                  (void*)&segs,     (void*)&seg_per_block,
                  (void*)&res_seg,  (void*)&tile_halo, (void*)&tile_rows,
                  (void*)&vec};
  e = cudaLaunchCooperativeKernel(kernel, blocks, threads, args,
                                  (size_t)smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_banded_cheb(
    const void* bands, const int* offsets, int nbands, const float* v,
    float* zbuf, float* out, int n, float theta, float c, const float* rho,
    const float* rho_old, int steps, int segs, int seg_per_block, int blocks,
    int threads, int res_seg, int tile_halo, int tile_rows, int vec,
    int smem, int smem_cap, cudaStream_t stream) {
  BandOffsets offs{};
  int halo = 0;
  for (int d = 0; d < nbands && d < kMaxBands; ++d) {
    offs.off[d] = offsets[d];
    const int a = offsets[d] < 0 ? -offsets[d] : offsets[d];
    halo = a > halo ? a : halo;
  }
  if (steps < 0 || steps > kMaxChebSteps ||
      !banded_plan_ok(n, nbands, halo, segs, seg_per_block, blocks, threads,
                      res_seg, tile_halo, tile_rows, (int)sizeof(T), smem,
                      smem_cap))
    return cudaErrorInvalidValue;
  ChebRhos rhos{};
  for (int t = 0; t < steps; ++t) {
    rhos.rho[t] = rho[t];
    rhos.rho_old[t] = rho_old[t];
  }
  const void* kernel = cheb_kernel<T>(nbands);
  cudaError_t e = allow_smem(kernel, (size_t)smem);
  if (e != cudaSuccess) return e;
  const T* bt = static_cast<const T*>(bands);
  void* args[] = {(void*)&bt,        (void*)&offs,   (void*)&nbands,
                  (void*)&v,         (void*)&zbuf,   (void*)&out,
                  (void*)&n,         (void*)&theta,  (void*)&c,
                  (void*)&rhos,      (void*)&steps,  (void*)&segs,
                  (void*)&seg_per_block, (void*)&res_seg,
                  (void*)&tile_halo, (void*)&tile_rows, (void*)&vec};
  e = cudaLaunchCooperativeKernel(kernel, blocks, threads, args,
                                  (size_t)smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The kernels' own account of a banded plan: blocks an SM the occupancy
// calculator co-schedules at its threads and shared memory, the layout's
// bytes, and the rows of a segment a thread keeps in registers (the
// Chebyshev apply; 0 for the powers).
template <typename T>
static cudaError_t banded_shape(int cheb, int nbands, int segs,
                                int seg_per_block, int res_seg,
                                int tile_rows, int* out) {
  const size_t smem = banded_smem_bytes(seg_per_block, segs, res_seg, nbands,
                                        (int)sizeof(T), tile_rows);
  const void* kernel = cheb ? cheb_kernel<T>(nbands)
                            : powers_kernel<T>(nbands);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, kernel, seg_per_block * kThreads, smem);
  out[0] = occ;
  out[1] = (int)smem;
  out[2] = cheb ? kKeepRows : 0;
  return e;
}

// The ELL kernel at the plan's shape (tuning.ell_powers_plan): `segs` is
// tuning.powers_segments (the banded kernel's, the shared row partition),
// the blocks cover the segments, and `smem` is ell_smem_bytes of the plan,
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
    int smem_cap, cudaStream_t stream) {
  if (n <= 0 || s <= 0 || width <= 0 || segs < 1 || seg_per_block < 1 ||
      segs > part_blocks || blocks != (segs + seg_per_block - 1) /
                                           seg_per_block ||
      threads % kThreads || threads < kThreads || threads > kEllMaxThreads ||
      res_seg < 0 || res_seg % 32 || smem > smem_cap ||
      (size_t)smem != ell_smem_bytes(seg_per_block, res_seg, width,
                                     (int)sizeof(T)))
    return cudaErrorInvalidValue;
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
// launch's parameters; the plan of tuning.banded_plan: segs
// (tuning.powers_segments), seg_per_block, blocks, threads, res_seg
// (resident rows a segment), tile_halo (-1: no tile), tile_rows, vec
// (bands, x and n on 16-byte boundaries), smem (its bytes, at most
// smem_cap).
extern "C" int repro_banded_powers(const void* bands, int b_bf16,
                                   const int* offsets, int nbands,
                                   const float* x, const float* shifts,
                                   float* u, float* sigma, float* raw,
                                   float* part, int part_blocks, int n, int s,
                                   float eps, int segs, int seg_per_block,
                                   int blocks, int threads, int res_seg,
                                   int tile_halo, int tile_rows, int vec,
                                   int smem, int smem_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_BANDED(T)                                                      \
  repro::launch_banded_powers<T>(bands, offsets, nbands, x, shifts, u,      \
                                 sigma, raw, part, part_blocks, n, s, eps,  \
                                 segs, seg_per_block, blocks, threads,      \
                                 res_seg, tile_halo, tile_rows, vec, smem,  \
                                 smem_cap, st)
  return b_bf16 ? REPRO_BANDED(repro::bf16) : REPRO_BANDED(float);
#undef REPRO_BANDED
}

// values (n, width) and cols (n, width) int32, row-major; the plan of
// tuning.ell_powers_plan: segs (tuning.powers_segments), seg_per_block,
// blocks,
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
                                int smem_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ELL(T)                                                         \
  repro::launch_ell_powers<T>(values, cols, width, x, shifts, u, sigma, raw, \
                              part, part_blocks, n, s, eps, segs,            \
                              seg_per_block, blocks, threads, res_seg,       \
                              bucket, vec, smem, smem_cap, st)
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
// rho_old host memory, `steps` floats each; the plan as repro_banded_powers'
// (vec: bands, v and n on 16-byte boundaries).
extern "C" int repro_banded_cheb_apply(const void* bands, int b_bf16,
                                       const int* offsets, int nbands,
                                       const float* v, float* zbuf,
                                       float* out, int n, float theta,
                                       float c, const float* rho,
                                       const float* rho_old, int steps,
                                       int segs, int seg_per_block,
                                       int blocks, int threads, int res_seg,
                                       int tile_halo, int tile_rows, int vec,
                                       int smem, int smem_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CHEB(T)                                                        \
  repro::launch_banded_cheb<T>(bands, offsets, nbands, v, zbuf, out, n,     \
                               theta, c, rho, rho_old, steps, segs,         \
                               seg_per_block, blocks, threads, res_seg,     \
                               tile_halo, tile_rows, vec, smem, smem_cap, st)
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

// The launch shape of kind 0 (banded powers), 1 (the Chebyshev apply) or 2
// (dense; the ELL kernel's is tuning.ell_powers_plan).  Banded and
// Chebyshev, for the plan's segs, seg_per_block, res_seg and tile_rows: out
// = {blocks an SM the occupancy calculator co-schedules, the layout's
// shared memory bytes, rows of a segment a thread keeps in registers}.
// Dense: out = {grid, warps, smem bytes}.
extern "C" int repro_matrix_powers_shape(int kind, int is_bf16, int n,
                                         int nbands, int segs,
                                         int seg_per_block, int res_seg,
                                         int tile_rows, int blocks_per_sm,
                                         int* out) {
  using repro::bf16;
  if (kind == 0 || kind == 1)
    return is_bf16 ? repro::banded_shape<bf16>(kind, nbands, segs,
                                               seg_per_block, res_seg,
                                               tile_rows, out)
                   : repro::banded_shape<float>(kind, nbands, segs,
                                                seg_per_block, res_seg,
                                                tile_rows, out);
  if (kind != 2) return cudaErrorInvalidValue;
  int g = 0;
  cudaError_t e = is_bf16 ? repro::dense_grid<bf16>(n, blocks_per_sm, &g)
                          : repro::dense_grid<float>(n, blocks_per_sm, &g);
  out[0] = g;
  out[1] = g * repro::kWarps;
  out[2] = (int)(sizeof(float) * (size_t)n);
  return e;
}
