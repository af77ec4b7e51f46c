// One fused block Gram-Schmidt pass of the s-step GMRES cycle:
//
//   Q  = T W                 T (s, s), W (s, n): the previous pass's CholQR
//                            back-substitution, folded into this pass
//   C  = mask * (V Q^T)      V (m1, n), mask = rows 0..k_start
//   W' = Q - C^T V
//   G  = W' W'^T             the Gram matrix of the next CholQR
//
// Returns C (m1, s) (rows past k_start zero), W' (s, n) and G (s, s), all
// float32.  V is float or bf16 (widened in registers), W and T float; every
// sum is taken in float.  s is at most 8.
//
// Replaces repro/kernels/block_gs.py::block_gs_pass, the Pallas kernel that
// holds V, W and the outputs in one VMEM block and computes the four
// products in one grid step.
//
// Bound: bytes.  The pass must read the valid rows of V once, W once, and
// write W' once: (k_start + 1) * n * s_V + 8 s n bytes (s_V the storage
// size of V).  At m1 = 31, n = 2^20, s = 5, f32, k_start = 25 that is
// 130 MB (0.039 ms at 3.35 TB/s); 4 flops per element of V and s per
// column, far below the card's rate.
//
// Design: one cooperative launch with three grid syncs.  C needs all of n
// before W' can be formed, and G needs all of W'; Hopper's blocks run in
// no order, so each of those is a grid sync.  One block of kThreads an SM;
// block b owns a contiguous range of 16-byte pieces of V's columns (4 f32
// or 8 bf16 columns) and of the scalar tail (kernels/tuning.py::
// block_gs_plan; pieces = 0 where V, W, W' or a row stride is not 16-byte
// aligned: the scalar route, every column a tail column).
//   1. Projection sweep.  The block's warps split the valid rows into
//      groups of eight (a warp a group, the rest of the warps a second,
//      third ... column share of the same groups), so a thread holds 8 x S
//      accumulators.  For each of its pieces a thread issues its eight
//      rows' 16-byte loads of V, then forms Q = T W for the piece's columns
//      in registers (W in 16-byte loads, T in shared memory: Q is never
//      written to HBM and never read back), and sums V[r, c] Q[a, c].
//      Reduced over the block in a fixed order to part_c[row][col][block].
//   2. grid sync; each of the (k_start + 1) * s entries of C is summed by
//      one warp of the grid, over all blocks in one order, into the C
//      output; grid sync.  (Every block summing every entry itself would
//      read (k_start + 1) * s times the grid's partials in every block.)
//   3. Update sweep.  A thread a piece: u = C^T V[:, piece] over the rows
//      in row order (16 f32 or 8 bf16 rows' loads in flight), then Q of the
//      piece again from W and T (the same fmaf chain as the projection, so
//      Q's bits match), W' = Q - u (the sum first, then the difference, as
//      the plain version rounds it) written once, and the s (s + 1) / 2
//      products of G's upper triangle per thread, reduced over the block to
//      part_g; grid sync; block 0 sums part_g in one order and writes G
//      (both triangles from the same sums).
// Bytes: V twice, W twice, W' once: 281 MB at k_start 25, s = 5, n = 2^20,
// f32, 0.084 ms at 3.35 TB/s.  No barrier per row chunk, no Q round trip.
// The design this replaces walked the columns once per 8-row chunk
// with 4-byte loads and two barriers a chunk, and wrote Q to W' to read it
// back: 0.238 ms f32 (0.273 bf16) at that shape on an H100 80GB HBM3,
// 700.00 W.
//
// A Hopper variant that kept the block's leading rows of V in shared
// memory between the projection and the update (cp.async) was timed and
// left out: slower at k_start 25 in f32 and bf16 (PERF.md section 6).
#include "stream_gs.cuh"

namespace repro {

constexpr int kBgRows = 8;                  // rows a warp's group holds
constexpr int kBgSetRows = kBgRows * kWarps;   // rows one sweep covers

// Q[a][0..3] = sum_b T[a, b] W[b, c0..c0+3] for the four columns at wp
// (W row stride n; T in shared memory), each an fmaf chain from 0 over b:
// the projection and the update form Q through this one function, so its
// bits are the same in both.
template <int S>
__device__ __forceinline__ void q_of_four(const float* ts, const float* wp,
                                          int n, float (&q)[S][4]) {
  float wv[S][4];
#pragma unroll
  for (int b = 0; b < S; ++b) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(
        wp + (size_t)b * n));
    wv[b][0] = t.x;
    wv[b][1] = t.y;
    wv[b][2] = t.z;
    wv[b][3] = t.w;
  }
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float t = 0.f;
#pragma unroll
      for (int b = 0; b < S; ++b) t = fmaf(ts[a * S + b], wv[b][c], t);
      q[a][c] = t;
    }
}

// The same for one column c (the scalar tail and route).
template <int S>
__device__ __forceinline__ void q_of_one(const float* ts, const float* w,
                                         int n, int c, float (&q)[S]) {
  float wv[S];
#pragma unroll
  for (int b = 0; b < S; ++b) wv[b] = __ldg(w + (size_t)b * n + c);
#pragma unroll
  for (int a = 0; a < S; ++a) {
    float t = 0.f;
#pragma unroll
    for (int b = 0; b < S; ++b) t = fmaf(ts[a * S + b], wv[b], t);
    q[a] = t;
  }
}

// Columns 4 q4 .. 4 q4 + 3 of a 16-byte piece of V, widened to floats.
template <typename TV>
__device__ __forceinline__ void unpack_four(uint4 raw, int q4, float* f) {
  if constexpr (Vec16<TV>::N == 4) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  } else {
    const uint32_t lo = q4 ? raw.z : raw.x, hi = q4 ? raw.w : raw.y;
    f[0] = __uint_as_float(lo << 16);
    f[1] = __uint_as_float(lo & 0xffff0000u);
    f[2] = __uint_as_float(hi << 16);
    f[3] = __uint_as_float(hi & 0xffff0000u);
  }
}

// Dynamic shared memory: ts[S * S], cs[m1 * S], red[kWarps * kBgRows * S].
__host__ __device__ inline size_t block_gs_smem_bytes(int m1, int s) {
  return sizeof(float) * ((size_t)s * s + (size_t)m1 * s +
                          (size_t)kWarps * kBgRows * s);
}

// The projection sweep of block_gs_pass, block_gs_project_gram and
// block_gs_project: C's partials over rows 0..rows-1 of V and the block's
// pieces [p_lo, p_hi) and tail columns [t_lo, t_hi), stored at
// part[(row * S + a) * nb + blockIdx.x].  A set of up to kBgSetRows rows
// at a time (one set for rows <= 64): warp w takes
// rows rs + 8 (w % ng) .. of the set over column share w / ng of the
// block's pieces, issues its eight rows' 16-byte loads of a piece, forms
// Q = T W for the piece's columns in registers (q_of_four) and sums
// V[r, c] Q[a, c]; the block sums a row group's shares in order.  kQ: the
// warps of row group 0 in the first set also store the Q they form to
// q_out (S, n), each column once, and (kGram) add its products to gacc,
// the upper triangle of M = Q Q^T row by row.  Every thread of the block
// calls it; it ends in a barrier.
template <typename TV, int S, bool kQ, bool kGram>
__device__ __forceinline__ void project_sweep(
    const TV* __restrict__ v, const float* __restrict__ w, const float* ts,
    float* red, float* part, float* __restrict__ q_out,
    float (&gacc)[S * (S + 1) / 2], int rows, int n, int p_lo, int p_hi,
    int t_lo, int t_hi) {
  constexpr int VEC = Vec16<TV>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  for (int rs = 0; rs < rows; rs += kBgSetRows) {
    const int nrs = min(kBgSetRows, rows - rs);
    const int ng = (nrs + kBgRows - 1) / kBgRows;   // row groups
    const int nsh = kWarps / ng;                     // column shares
    const bool active = warp < ng * nsh;
    const int rg = warp % ng, sh = warp / ng;
    const int r0 = rs + rg * kBgRows;
    const int nr = active ? min(kBgRows, rows - r0) : 0;
    const bool keep_q = kQ && rs == 0 && rg == 0;   // warp-uniform
    float acc[kBgRows][S];
#pragma unroll
    for (int r = 0; r < kBgRows; ++r)
#pragma unroll
      for (int a = 0; a < S; ++a) acc[r][a] = 0.f;
    const int step = nsh * 32;
    for (int p = p_lo + sh * 32 + lane; active && p < p_hi; p += step) {
      uint4 raw[kBgRows];
      const TV* q = v + (size_t)r0 * n + (size_t)p * VEC;
#pragma unroll
      for (int r = 0; r < kBgRows; ++r) {
        if (r < nr) raw[r] = __ldg(reinterpret_cast<const uint4*>(q));
        q = next_row(q, n);
      }
#pragma unroll
      for (int q4 = 0; q4 < VEC / 4; ++q4) {
        float qv[S][4];
        q_of_four<S>(ts, w + (size_t)p * VEC + 4 * q4, n, qv);
        if constexpr (kQ) {
          if (keep_q) {
#pragma unroll
            for (int a = 0; a < S; ++a)
              *reinterpret_cast<float4*>(q_out + (size_t)a * n +
                                         (size_t)p * VEC + 4 * q4) =
                  make_float4(qv[a][0], qv[a][1], qv[a][2], qv[a][3]);
            if constexpr (kGram) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                int k = 0;
#pragma unroll
                for (int a = 0; a < S; ++a)
#pragma unroll
                  for (int b = a; b < S; ++b, ++k)
                    gacc[k] = fmaf(qv[a][c], qv[b][c], gacc[k]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kBgRows; ++r) {
          if (r < nr) {
            float f[4];
            unpack_four<TV>(raw[r], q4, f);
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int a = 0; a < S; ++a)
                acc[r][a] = fmaf(f[c], qv[a][c], acc[r][a]);
          }
        }
      }
    }
    for (int c = t_lo + sh * 32 + lane; active && c < t_hi; c += step) {
      float qv[S];
      q_of_one<S>(ts, w, n, c, qv);
      if constexpr (kQ) {
        if (keep_q) {
#pragma unroll
          for (int a = 0; a < S; ++a) q_out[(size_t)a * n + c] = qv[a];
          if constexpr (kGram) {
            int k = 0;
#pragma unroll
            for (int a = 0; a < S; ++a)
#pragma unroll
              for (int b = a; b < S; ++b, ++k)
                gacc[k] = fmaf(qv[a], qv[b], gacc[k]);
          }
        }
      }
      const TV* q = v + (size_t)r0 * n + c;
#pragma unroll
      for (int r = 0; r < kBgRows; ++r) {
        if (r < nr) {
          const float f = to_f(*q);
#pragma unroll
          for (int a = 0; a < S; ++a) acc[r][a] = fmaf(f, qv[a], acc[r][a]);
        }
        q = next_row(q, n);
      }
    }
#pragma unroll
    for (int r = 0; r < kBgRows; ++r)
#pragma unroll
      for (int a = 0; a < S; ++a) {
        const float t = warp_sum(acc[r][a]);
        if (lane == 0) red[(warp * kBgRows + r) * S + a] = t;
      }
    __syncthreads();
    for (int e = threadIdx.x; e < nrs * S; e += blockDim.x) {
      const int i = e / S, a = e - i * S;   // row rs + i, column a of C
      const int g = i / kBgRows, r = i - g * kBgRows;
      float t = 0.f;
      for (int s2 = 0; s2 < nsh; ++s2)
        t += red[((s2 * ng + g) * kBgRows + r) * S + a];
      part[((size_t)(rs + i) * S + a) * nb + blockIdx.x] = t;
    }
    __syncthreads();
  }
}

// rows = k_start + 1 valid rows; pieces 16-byte pieces of a row (0: the
// scalar route), pb of them a block; the tail columns [pieces VEC, n), tb
// a block.
template <typename TV, int S>
__global__ void __launch_bounds__(kThreads, 1)
    block_gs_kernel(const TV* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ tin, float* c_out,
                    float* __restrict__ w_out, float* __restrict__ g_out,
                    float* part_c, float* part_g, int m1, int n, int rows,
                    int pieces, int pb, int tb) {
  constexpr int VEC = Vec16<TV>::N;
  constexpr int kG = S * (S + 1) / 2;
  constexpr int CU = 64 / VEC;     // rows' loads in flight in the update
  extern __shared__ __align__(16) float bg_smem[];
  float* ts = bg_smem;                       // T, (S, S)
  float* cs = ts + S * S;                    // C, (rows, S)
  float* red = cs + (size_t)m1 * S;          // kWarps * kBgRows * S
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  const int p_lo = min(pieces, (int)blockIdx.x * pb);
  const int p_hi = min(pieces, p_lo + pb);
  const int t_lo = min(n, pieces * VEC + (int)blockIdx.x * tb);
  const int t_hi = min(n, t_lo + tb);

  for (int i = threadIdx.x; i < S * S; i += blockDim.x) ts[i] = tin[i];
  __syncthreads();

  // 1. C partials
  float gacc[kG];   // the update's G below; the sweep leaves it alone
  project_sweep<TV, S, false, false>(v, w, ts, red, part_c, nullptr, gacc,
                                     rows, n, p_lo, p_hi, t_lo, t_hi);
  grid.sync();

  // 2. each entry of C summed by one warp of the grid, in one order
  for (int e = blockIdx.x * kWarps + warp; e < rows * S; e += nb * kWarps) {
    float t = 0.f;
    for (int b = lane; b < nb; b += 32) t += __ldcg(part_c + (size_t)e * nb + b);
    t = warp_sum(t);
    if (lane == 0) c_out[e] = t;
  }
  grid.sync();

  // 3. W' = Q - C^T V and the Gram partials, a thread a piece
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x)
    cs[i] = __ldcg(c_out + i);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kG; ++k) gacc[k] = 0.f;
  for (int p = p_lo + threadIdx.x; p < p_hi; p += blockDim.x) {
    float u[S][VEC];
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int c = 0; c < VEC; ++c) u[a][c] = 0.f;
    const TV* q = v + (size_t)p * VEC;
    for (int r0 = 0; r0 < rows; r0 += CU) {
      const int nr = min(CU, rows - r0);
      uint4 raw[CU];
#pragma unroll
      for (int r = 0; r < CU; ++r) {
        if (r < nr) raw[r] = __ldg(reinterpret_cast<const uint4*>(q));
        q = next_row(q, n);
      }
#pragma unroll
      for (int r = 0; r < CU; ++r) {
        if (r < nr) {
          float f[VEC];
          Vec16<TV>::unpack(raw[r], f);
#pragma unroll
          for (int a = 0; a < S; ++a) {
            const float cr = cs[(r0 + r) * S + a];
#pragma unroll
            for (int c = 0; c < VEC; ++c) u[a][c] = fmaf(cr, f[c], u[a][c]);
          }
        }
      }
    }
#pragma unroll
    for (int q4 = 0; q4 < VEC / 4; ++q4) {
      float qv[S][4];
      q_of_four<S>(ts, w + (size_t)p * VEC + 4 * q4, n, qv);
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) qv[a][c] -= u[a][4 * q4 + c];   // W'
#pragma unroll
      for (int a = 0; a < S; ++a)
        *reinterpret_cast<float4*>(w_out + (size_t)a * n + (size_t)p * VEC +
                                   4 * q4) =
            make_float4(qv[a][0], qv[a][1], qv[a][2], qv[a][3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int k = 0;
#pragma unroll
        for (int a = 0; a < S; ++a)
#pragma unroll
          for (int b = a; b < S; ++b, ++k)
            gacc[k] = fmaf(qv[a][c], qv[b][c], gacc[k]);
      }
    }
  }
  for (int c = t_lo + threadIdx.x; c < t_hi; c += blockDim.x) {
    float u[S];
#pragma unroll
    for (int a = 0; a < S; ++a) u[a] = 0.f;
    const TV* q = v + c;
    for (int r = 0; r < rows; ++r) {
      const float f = to_f(*q);
#pragma unroll
      for (int a = 0; a < S; ++a) u[a] = fmaf(cs[r * S + a], f, u[a]);
      q = next_row(q, n);
    }
    float qv[S];
    q_of_one<S>(ts, w, n, c, qv);
#pragma unroll
    for (int a = 0; a < S; ++a) {
      qv[a] -= u[a];
      w_out[(size_t)a * n + c] = qv[a];
    }
    int k = 0;
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int b = a; b < S; ++b, ++k) gacc[k] = fmaf(qv[a], qv[b], gacc[k]);
  }
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    const float t = warp_sum(gacc[k]);
    if (lane == 0) red[warp * kG + k] = t;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kG; k += blockDim.x) {
    float t = 0.f;
    for (int q = 0; q < kWarps; ++q) t += red[q * kG + k];
    part_g[(size_t)k * nb + blockIdx.x] = t;
  }
  grid.sync();

  if (blockIdx.x != 0) return;
  for (int k = warp; k < kG; k += kWarps) {
    float t = 0.f;
    for (int b = lane; b < nb; b += 32) t += __ldcg(part_g + (size_t)k * nb + b);
    t = warp_sum(t);
    if (lane == 0) {
      int a = 0, kk = k;   // entry k of the upper triangle, row by row
      while (kk >= S - a) kk -= S - a++;
      g_out[a * S + a + kk] = t;
      g_out[(a + kk) * S + a] = t;
    }
  }
  for (int i = rows * S + threadIdx.x; i < m1 * S; i += blockDim.x)
    c_out[i] = 0.f;   // the masked rows
}

// The kernel for (storage, s).
template <typename TV>
static cudaError_t block_gs_kernel_for(int s, const void** kernel) {
  switch (s) {
#define REPRO_CASE(S)                                                   \
  case S:                                                               \
    *kernel = (const void*)block_gs_kernel<TV, S>;                      \
    return cudaSuccess;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TV>
static cudaError_t launch_block_gs(const void* v, const float* w,
                                   const float* tin, float* c, float* w_out,
                                   float* g, float* part, int grid, int m1,
                                   int n, int s, int rows, int pieces,
                                   cudaStream_t stream) {
  constexpr int VEC = Vec16<TV>::N;
  if (m1 <= 0 || n <= 0 || rows < 1 || rows > m1 || grid < 1 ||
      pieces < 0 || (size_t)pieces * VEC > (size_t)n)
    return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  cudaError_t e = block_gs_kernel_for<TV>(s, &kernel);
  if (e != cudaSuccess) return e;
  int pb = (pieces + grid - 1) / grid;
  const int tail = n - pieces * VEC;
  int tb = (tail + grid - 1) / grid;
  const size_t smem = block_gs_smem_bytes(m1, s);
  int cap = 0;
  e = persistent_grid(kernel, smem, 1, grid, &cap);
  if (e != cudaSuccess) return e;
  if (cap < grid) return cudaErrorCooperativeLaunchTooLarge;
  const TV* vt = static_cast<const TV*>(v);
  // part holds m1 * s partials per block for C, then s (s + 1) / 2 for G
  float* part_c = part;
  float* part_g = part + (size_t)m1 * s * grid;
  void* args[] = {(void*)&vt,     (void*)&w,      (void*)&tin,
                  (void*)&c,      (void*)&w_out,  (void*)&g,
                  (void*)&part_c, (void*)&part_g, (void*)&m1,
                  (void*)&n,      (void*)&rows,   (void*)&pieces,
                  (void*)&pb,     (void*)&tb};
  e = cudaLaunchCooperativeKernel(kernel, grid, kThreads, args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The single-reduce pass (gs = "cgs2_pipelined") and the row-sharded split
// pass's projection: plain grids whose partials a second small launch
// reduces (common.cuh's reduce_partials_kernel).
//
//   block_gs_project_gram   Q = T W,  C_hat = V Q^T (unmasked),  M = Q Q^T
//   block_gs_project        Q = T W,  C = mask * (V Q^T),  mask = rows
//                           0..k_start
//   block_gs_update         W' = Q - C^T V,  G = W' W'^T
//
// Replace repro/kernels/block_gs.py::block_gs_project_gram,
// ::block_gs_project and ::block_gs_update, the Pallas kernels that hold
// V, W (or Q) and the outputs in one VMEM block (block_gs_project: the
// shard) and compute the products in one grid step.  The single-reduce
// caller recovers C and the CholQR Gram from [C_hat; M] against the
// maintained basis Gram matrix (kernels/block_gs.py), so G of the update
// is not needed there; it is the kernel's contract (the row-sharded pass
// reduces it across shards) and costs s (s + 1) / 2 fmas per column.  The
// row-sharded caller all-reduces C over the shards and runs the update.
//
// Bound: bytes.  Each must read the rows of V it is given (block_gs_project:
// rows 0..k_start) once, W or Q once, and write Q or W' once: (rows s_V +
// 8 s) n bytes.  With rows = k_start + 1 = 26, s = 5, n = 2^20: 151 MB in
// f32 (0.0451 ms at 3.35 TB/s), 96.5 MB in bf16 (0.0288 ms).  The products
// are 2 (rows + s) s + s (s + 1) flops a column, far below the card's
// rate.  At n = 10^4 the two launches bound them.
//
// The projections (one template; kGram false for block_gs_project) are
// block_gs_pass's projection sweep (project_sweep) as a plain launch.
// Block b owns a contiguous range of 16-byte pieces of the columns (4 f32
// or 8 bf16) and a share of the scalar tail (kernels/tuning.py::
// block_gs_plan).  The warps take row groups of eight and column shares; a
// thread issues its eight rows' 16-byte loads of a piece, forms Q for the
// piece's columns in registers from W (16-byte loads) and T (shared
// memory), and sums V Q^T in 8 x s registers.  V is read once, in pieces,
// and Q never passes through shared memory.  The warps of row group 0 in
// the first set of rows store Q (float4) and add Q's products for M.  Q is
// the fmaf chain from 0 over b (q_of_four), the order the design before
// this one formed it in: the same bits.  Each block writes C's partials
// (and M's, to both triangles: M is symmetric to the bit) [entry][block];
// the reduction launch sums each entry over the blocks in one order (no
// float atomics: the same bits every run) and writes block_gs_project's
// rows past k_start as zeros (they are never read).
//
// The scalar route (pieces = 0: every column a tail column, 4-byte or
// 2-byte loads) remains for a V, W or row stride that is not 16-byte
// aligned (n = 100,003; n = 1,027 in bf16; a view one element into its
// buffer): there a 16-byte load would fault or straddle two rows.
//
// The design this replaces kept a block's (s, cols) slice of Q in shared
// memory, formed and written (with M reduced) behind a barrier before the
// first load of V, then swept the slice once per 8-row chunk with 4-byte
// (bf16: 2-byte) loads and a block reduction a chunk.  At rows 26, s = 5,
// n = 2^20, cold, it took 0.0868 ms f32 / 0.0904 bf16 (block_gs_project
// 0.0854 / 0.0969) on an NVIDIA H100 80GB HBM3, 700.00 W: slower in bf16
// than in f32 though bf16 moves 36% fewer bytes, the 16 KB of loads in
// flight an SM setting the pace.
//
// The update is unchanged: C in shared memory; a thread a column of its
// block's column slice (tuning.sr_grid), u = C^T V[:, c] over the rows in
// order (eight loads in flight), W' = Q - u, and the upper triangle of G.
// block_gs_project_gram and the update read every row of the V passed: the
// s-step cycle passes the valid prefix V[:k_start+1] (the rows past it are
// zero in its fresh basis).
// ---------------------------------------------------------------------------

// rows rows of V read (block_gs_project: k_start + 1); pieces 16-byte
// pieces of a row (0: the scalar route), pb of them a block; the tail
// columns [pieces VEC, n), tb a block.  part: C's rows * S partials, then
// (kGram) M's S * S, [entry][block].
template <typename TV, int S, bool kGram>
__global__ void __launch_bounds__(kThreads, 1)
    block_gs_project_gram_kernel(const TV* __restrict__ v,
                                 const float* __restrict__ w,
                                 const float* __restrict__ tin,
                                 float* __restrict__ q_out,
                                 float* __restrict__ part, int rows, int n,
                                 int pieces, int pb, int tb) {
  constexpr int VEC = Vec16<TV>::N;
  constexpr int kG = S * (S + 1) / 2;
  __shared__ float ts[S * S];
  __shared__ float red[kWarps * kBgRows * S];
  const int p_lo = min(pieces, (int)blockIdx.x * pb);
  const int p_hi = min(pieces, p_lo + pb);
  const int t_lo = min(n, pieces * VEC + (int)blockIdx.x * tb);
  const int t_hi = min(n, t_lo + tb);

  for (int i = threadIdx.x; i < S * S; i += blockDim.x) ts[i] = tin[i];
  __syncthreads();
  float gacc[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) gacc[k] = 0.f;
  project_sweep<TV, S, true, kGram>(v, w, ts, red, part, q_out, gacc, rows,
                                    n, p_lo, p_hi, t_lo, t_hi);
  if constexpr (kGram) {
    // M's partials: the row-group-0 warps of the first set (one a column
    // share), their shares summed in order (red is free: the sweep ended
    // in a barrier)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nb = gridDim.x;
    const int ng = (min(rows, kBgSetRows) + kBgRows - 1) / kBgRows;
    const int nsh = kWarps / ng;
    if (warp % ng == 0 && warp < ng * nsh) {
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        const float t = warp_sum(gacc[k]);
        if (lane == 0) red[(warp / ng) * kG + k] = t;
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kG; k += blockDim.x) {
      float t = 0.f;
      for (int sh = 0; sh < nsh; ++sh) t += red[sh * kG + k];
      int a = 0, kk = k;   // entry k of the upper triangle, row by row
      while (kk >= S - a) kk -= S - a++;
      const size_t e0 = (size_t)rows * S;
      part[(e0 + a * S + a + kk) * nb + blockIdx.x] = t;
      part[(e0 + (a + kk) * S + a) * nb + blockIdx.x] = t;
    }
  }
}

// Dynamic shared memory: cs[m1 * S], red[kWarps * kG]
template <typename TV, int S>
__global__ void __launch_bounds__(kThreads)
    block_gs_update_kernel(const TV* __restrict__ v,
                           const float* __restrict__ q,
                           const float* __restrict__ c_in,
                           float* __restrict__ w_out,
                           float* __restrict__ part, int m1, int n,
                           int cols) {
  constexpr int kG = S * (S + 1) / 2;
  extern __shared__ float smem[];
  float* cs = smem;
  float* red = cs + (size_t)m1 * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  const int c0 = blockIdx.x * cols;
  const int len = max(0, min(cols, n - c0));

  for (int i = threadIdx.x; i < m1 * S; i += blockDim.x) cs[i] = c_in[i];
  __syncthreads();
  float gacc[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) gacc[k] = 0.f;
  for (int c = threadIdx.x; c < len; c += blockDim.x) {
    float u[S];
#pragma unroll
    for (int a = 0; a < S; ++a) u[a] = 0.f;
    for (int r0 = 0; r0 < m1; r0 += kRowChunk) {
      const int nr = m1 - r0 < kRowChunk ? m1 - r0 : kRowChunk;
      const TV* vr = v + (size_t)r0 * n + c0 + c;
      float vv[kRowChunk];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
        vv[r] = r < nr ? to_f(vr[(size_t)r * n]) : 0.f;
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
        if (r < nr)
#pragma unroll
          for (int a = 0; a < S; ++a)
            u[a] = fmaf(cs[(r0 + r) * S + a], vv[r], u[a]);
    }
    float w2[S];
#pragma unroll
    for (int a = 0; a < S; ++a) {
      w2[a] = q[(size_t)a * n + c0 + c] - u[a];
      w_out[(size_t)a * n + c0 + c] = w2[a];
    }
    int k = 0;
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int b = a; b < S; ++b, ++k) gacc[k] = fmaf(w2[a], w2[b], gacc[k]);
  }
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    const float t = warp_sum(gacc[k]);
    if (lane == 0) red[warp * kG + k] = t;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kG; k += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < kWarps; ++r) t += red[r * kG + k];
    int a = 0, kk = k;
    while (kk >= S - a) kk -= S - a++;
    part[((size_t)a * S + a + kk) * nb + blockIdx.x] = t;
    part[((size_t)(a + kk) * S + a) * nb + blockIdx.x] = t;
  }
}

template <typename TV, bool kGram>
static cudaError_t project_gram_kernel_for(int s, const void** kernel) {
  switch (s) {
#define REPRO_CASE(S)                                                   \
  case S:                                                               \
    *kernel = (const void*)block_gs_project_gram_kernel<TV, S, kGram>;  \
    return cudaSuccess;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TV>
static cudaError_t block_update_kernel_for(int s, const void** kernel) {
  switch (s) {
#define REPRO_CASE(S)                                               \
  case S:                                                           \
    *kernel = (const void*)block_gs_update_kernel<TV, S>;           \
    return cudaSuccess;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

static cudaError_t launch_plain(const void* kernel, int grid, size_t smem,
                                void** args, cudaStream_t stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernel(kernel, grid, kThreads, args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The projection over rows 0..rows-1 of V (pieces 16-byte pieces a row, 0:
// the scalar route) and its reduction into out: n_out entries, C's rows *
// s, then (gram) M's s * s, or (not gram) zeros from rows * s on.
template <typename TV>
static cudaError_t launch_project(const void* v, const float* w,
                                  const float* tin, float* q, float* out,
                                  float* part, int grid, int rows, int n,
                                  int s, int pieces, bool gram, int n_out,
                                  cudaStream_t stream) {
  constexpr int VEC = Vec16<TV>::N;
  if (rows < 1 || n <= 0 || grid < 1 || pieces < 0 ||
      (size_t)pieces * VEC > (size_t)n)
    return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  cudaError_t e = gram ? project_gram_kernel_for<TV, true>(s, &kernel)
                       : project_gram_kernel_for<TV, false>(s, &kernel);
  if (e != cudaSuccess) return e;
  const TV* vt = static_cast<const TV*>(v);
  int pb = (pieces + grid - 1) / grid;
  int tb = (n - pieces * VEC + grid - 1) / grid;
  void* args[] = {(void*)&vt,   (void*)&w,    (void*)&tin,
                  (void*)&q,    (void*)&part, (void*)&rows,
                  (void*)&n,    (void*)&pieces, (void*)&pb,
                  (void*)&tb};
  e = launch_plain(kernel, grid, 0, args, stream);
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(part, grid, n_out, gram ? 0 : rows * s,
                                gram ? 0 : n_out, out, stream);
}

template <typename TV>
static cudaError_t launch_block_update(const void* v, const float* q,
                                       const float* c, float* w_out, float* g,
                                       float* part, int grid, int m1, int n,
                                       int s, cudaStream_t stream) {
  if (m1 <= 0 || n <= 0 || grid < 1 || grid > n) return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  cudaError_t e = block_update_kernel_for<TV>(s, &kernel);
  if (e != cudaSuccess) return e;
  const TV* vt = static_cast<const TV*>(v);
  int cols = (n + grid - 1) / grid;
  const size_t smem =
      sizeof(float) * ((size_t)m1 * s + (size_t)kWarps * s * (s + 1) / 2);
  void* args[] = {(void*)&vt,   (void*)&q,  (void*)&c, (void*)&w_out,
                  (void*)&part, (void*)&m1, (void*)&n, (void*)&cols};
  e = launch_plain(kernel, grid, smem, args, stream);
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(part, grid, s * s, 0, 0, g, stream);
}

}  // namespace repro

// v (m1, n) f32 or bf16, row-major; w (s, n) and tin (s, s) f32; rows =
// k_start + 1 valid basis rows; c (m1, s), w_out (s, n), g (s, s) f32 out;
// part holds (m1 * s + s * (s + 1) / 2) * grid floats; grid blocks, one
// an SM at most (tuning.block_gs_plan), pieces 16-byte pieces of V a row
// (0: the scalar route).
extern "C" int repro_block_gs_pass(const void* v, int v_bf16, const float* w,
                                   const float* tin, float* c, float* w_out,
                                   float* g, float* part, int grid, int m1,
                                   int n, int s, int rows, int pieces,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_block_gs<repro::bf16>(
                      v, w, tin, c, w_out, g, part, grid, m1, n, s, rows,
                      pieces, st)
                : repro::launch_block_gs<float>(
                      v, w, tin, c, w_out, g, part, grid, m1, n, s, rows,
                      pieces, st);
}

// The dynamic shared memory of repro_block_gs_pass's kernel: out[0] bytes.
extern "C" int repro_block_gs_pass_smem(int m1, int s, int* out) {
  out[0] = (int)repro::block_gs_smem_bytes(m1, s);
  return 0;
}

// v (m1, n) f32 or bf16, row-major (every row is read); w (s, n), tin
// (s, s) f32; q (s, n) f32 out; out (m1 + s, s) f32 = [C_hat; M]; part
// holds (m1 + s) s grid floats; grid blocks and pieces 16-byte pieces of
// V a row (0: the scalar route) from tuning.block_gs_plan.
extern "C" int repro_block_gs_project_gram(const void* v, int v_bf16,
                                           const float* w, const float* tin,
                                           float* q, float* out, float* part,
                                           int grid, int m1, int n, int s,
                                           int pieces, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_out = (m1 + s) * s;
  return v_bf16 ? repro::launch_project<repro::bf16>(
                      v, w, tin, q, out, part, grid, m1, n, s, pieces, true,
                      n_out, st)
                : repro::launch_project<float>(v, w, tin, q, out, part,
                                               grid, m1, n, s, pieces, true,
                                               n_out, st);
}

// v (m1, n) f32 or bf16, row-major; q (s, n), c (m1, s) f32; w_out (s, n)
// and g (s, s) f32 out; part holds s s grid floats.
extern "C" int repro_block_gs_update(const void* v, int v_bf16,
                                     const float* q, const float* c,
                                     float* w_out, float* g, float* part,
                                     int grid, int m1, int n, int s,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_block_update<repro::bf16>(
                      v, q, c, w_out, g, part, grid, m1, n, s, st)
                : repro::launch_block_update<float>(v, q, c, w_out, g, part,
                                                    grid, m1, n, s, st);
}

// v (m1, n) f32 or bf16, row-major, rows 0..rows-1 read; w (s, n), tin
// (s, s) f32; q (s, n) and c (m1, s) f32 out, c's rows past rows - 1
// zero; part holds rows s grid floats; grid and pieces as above.
extern "C" int repro_block_gs_project(const void* v, int v_bf16,
                                      const float* w, const float* tin,
                                      float* q, float* c, float* part,
                                      int grid, int m1, int rows, int n,
                                      int s, int pieces, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > m1) return cudaErrorInvalidValue;
  return v_bf16 ? repro::launch_project<repro::bf16>(
                      v, w, tin, q, c, part, grid, rows, n, s, pieces, false,
                      m1 * s, st)
                : repro::launch_project<float>(v, w, tin, q, c, part, grid,
                                               rows, n, s, pieces, false,
                                               m1 * s, st);
}
