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
// no order, so each of those is a grid sync.  Block b owns the column slice
// [b * cols, b * cols + len); a thread takes its columns in turn.
//   1. Q = T W for the block's columns (T in shared memory), written to
//      the W' output, which holds Q until step 4 overwrites it.
//   2. C partials: the valid rows in chunks of eight, each thread summing
//      eight rows times s columns of Q at once (eight loads of V in flight,
//      coalesced across the warp), reduced over the block in a fixed order
//      to part_c[row][col][block].  Rows past k_start are never read.
//   3. grid sync; each of the (k_start + 1) * s entries of C is summed by
//      one warp of the grid, over all blocks in one order, into the C
//      output; grid sync.  (Every block summing every entry itself, as
//      gs_project does for its m1 entries, would read (k_start + 1) * s
//      times the grid's partials in every block: 280 MB of L2 traffic at
//      528 blocks.)
//   4. every block reads C into shared memory and forms W' = Q - C^T V for
//      its columns (the sum over rows first, in row order, then the
//      difference, as the plain version rounds it), writes W', and keeps
//      the s (s + 1) / 2 products of G's upper triangle per thread, reduced
//      over the block to part_g; grid sync; block 0 sums part_g in one order
//      and writes G (both triangles from the same sums).
// V is read twice (steps 2 and 4), against the bound's once: its slices
// do not fit shared memory at n = 2^20 (7,944 columns x 31 rows per SM).
// The TPU kernel keeps V whole in VMEM; at n = 10,000 a slice would fit,
// and a shared-memory variant is the first lever for a faster version.
#include "common.cuh"

namespace repro {

template <typename TV, int S>
__global__ void __launch_bounds__(kThreads)
    block_gs_kernel(const TV* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ tin, float* c_out,
                    float* w_out, float* __restrict__ g_out, float* part_c,
                    float* part_g, int m1, int n, int rows, int cols) {
  constexpr int kG = S * (S + 1) / 2;
  extern __shared__ float smem[];
  float* ts = smem;                      // T, (S, S)
  float* cs = ts + S * S;                // C, (rows, S)
  float* red = cs + (size_t)m1 * S;      // kWarps * kRowChunk * S
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  const int c0 = blockIdx.x * cols;
  const int len = max(0, min(cols, n - c0));
  float* wq = w_out + c0;

  for (int i = threadIdx.x; i < S * S; i += blockDim.x) ts[i] = tin[i];
  __syncthreads();

  // 1. Q = T W
  for (int c = threadIdx.x; c < len; c += blockDim.x) {
    float wc[S];
#pragma unroll
    for (int b = 0; b < S; ++b) wc[b] = __ldg(w + (size_t)b * n + c0 + c);
#pragma unroll
    for (int a = 0; a < S; ++a) {
      float q = 0.f;
#pragma unroll
      for (int b = 0; b < S; ++b) q = fmaf(ts[a * S + b], wc[b], q);
      wq[(size_t)a * n + c] = q;
    }
  }

  // 2. C partials, eight rows at a time
  for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
    const int nr = rows - r0 < kRowChunk ? rows - r0 : kRowChunk;
    float acc[kRowChunk][S];
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r)
#pragma unroll
      for (int a = 0; a < S; ++a) acc[r][a] = 0.f;
    const TV* vr = v + (size_t)r0 * n + c0;
    for (int c = threadIdx.x; c < len; c += blockDim.x) {
      float vv[kRowChunk], q[S];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
        vv[r] = r < nr ? to_f(vr[(size_t)r * n + c]) : 0.f;
#pragma unroll
      for (int a = 0; a < S; ++a) q[a] = wq[(size_t)a * n + c];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
#pragma unroll
        for (int a = 0; a < S; ++a) acc[r][a] = fmaf(vv[r], q[a], acc[r][a]);
    }
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r)
#pragma unroll
      for (int a = 0; a < S; ++a) {
        const float t = warp_sum(acc[r][a]);
        if (lane == 0) red[(warp * kRowChunk + r) * S + a] = t;
      }
    __syncthreads();
    for (int e = threadIdx.x; e < nr * S; e += blockDim.x) {
      float t = 0.f;
      for (int q = 0; q < kWarps; ++q) t += red[q * kRowChunk * S + e];
      part_c[((size_t)r0 * S + e) * nb + blockIdx.x] = t;
    }
    __syncthreads();
  }
  grid.sync();

  // 3. each entry of C summed by one warp of the grid, in one order
  for (int e = blockIdx.x * kWarps + warp; e < rows * S; e += nb * kWarps) {
    float t = 0.f;
    for (int b = lane; b < nb; b += 32) t += __ldcg(part_c + (size_t)e * nb + b);
    t = warp_sum(t);
    if (lane == 0) c_out[e] = t;
  }
  grid.sync();

  // 4. W' = Q - C^T V and the Gram partials
  for (int i = threadIdx.x; i < rows * S; i += blockDim.x)
    cs[i] = __ldcg(c_out + i);
  __syncthreads();
  float gacc[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) gacc[k] = 0.f;
  for (int c = threadIdx.x; c < len; c += blockDim.x) {
    float u[S];
#pragma unroll
    for (int a = 0; a < S; ++a) u[a] = 0.f;
    for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
      const int nr = rows - r0 < kRowChunk ? rows - r0 : kRowChunk;
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
      w2[a] = wq[(size_t)a * n + c] - u[a];
      wq[(size_t)a * n + c] = w2[a];
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

__host__ __device__ inline size_t block_gs_smem_bytes(int m1, int s) {
  return sizeof(float) *
         ((size_t)s * s + (size_t)m1 * s + (size_t)kWarps * kRowChunk * s);
}

// The kernel for (storage, s), and its grid: at most a thread per column.
template <typename TV>
static cudaError_t block_gs_kernel_for(int s, const void** kernel) {
  switch (s) {
#define REPRO_CASE(S)                                          \
  case S:                                                      \
    *kernel = (const void*)block_gs_kernel<TV, S>;             \
    return cudaSuccess;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TV>
static cudaError_t block_gs_grid(int m1, int n, int s, int blocks_per_sm,
                                 const void** kernel, int* grid) {
  cudaError_t e = block_gs_kernel_for<TV>(s, kernel);
  if (e != cudaSuccess) return e;
  return persistent_grid(*kernel, block_gs_smem_bytes(m1, s), blocks_per_sm,
                         (n + kThreads - 1) / kThreads, grid);
}

template <typename TV>
static cudaError_t launch_block_gs(const void* v, const float* w,
                                   const float* tin, float* c, float* w_out,
                                   float* g, float* part, int part_blocks,
                                   int m1, int n, int s, int rows,
                                   int blocks_per_sm, cudaStream_t stream) {
  if (m1 <= 0 || n <= 0 || rows < 1 || rows > m1) return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  int grid = 0;
  cudaError_t e = block_gs_grid<TV>(m1, n, s, blocks_per_sm, &kernel, &grid);
  if (e != cudaSuccess) return e;
  if (grid > part_blocks) return cudaErrorInvalidValue;
  const TV* vt = static_cast<const TV*>(v);
  int cols = (n + grid - 1) / grid;
  // part holds m1 * s partials per block for C, then s (s + 1) / 2 for G
  float* part_c = part;
  float* part_g = part + (size_t)m1 * s * grid;
  void* args[] = {(void*)&vt,     (void*)&w,      (void*)&tin,  (void*)&c,
                  (void*)&w_out,  (void*)&g,      (void*)&part_c,
                  (void*)&part_g, (void*)&m1,     (void*)&n,    (void*)&rows,
                  (void*)&cols};
  e = cudaLaunchCooperativeKernel(kernel, grid, kThreads, args,
                                  block_gs_smem_bytes(m1, s), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The single-reduce pass (gs = "cgs2_pipelined"): two kernels, each a plain
// grid whose partials a second small launch reduces (common.cuh).
//
//   block_gs_project_gram   Q = T W,  C_hat = V Q^T (unmasked),  M = Q Q^T
//   block_gs_update         W' = Q - C^T V,  G = W' W'^T
//
// Replace repro/kernels/block_gs.py::block_gs_project_gram and
// ::block_gs_update, the Pallas kernels that hold V, W (or Q) and the
// outputs in one VMEM block and compute the products in one grid step.
// The caller recovers C and the CholQR Gram from [C_hat; M] against the
// maintained basis Gram matrix (kernels/block_gs.py), so G of the update
// is not needed by the single-reduce pass; it is the kernel's contract
// (the row-sharded pass reduces it across shards) and costs s (s + 1) / 2
// fmas per column.
//
// Bound: bytes.  Each must read the rows of V it is given once, and W or
// Q once, and write Q or W' once: (rows s_V + 8 s) n bytes.  With the
// prefix rows = k_start + 1 = 26, s = 5, n = 2^20, f32: 144 MiB, 0.045 ms
// at 3.35 TB/s each.  At n = 10^4 both are launch-bound.
//
// Design.  No grid sync is needed: C_hat and M (and G) are sums over n of
// per-column products, so each block writes partials [entry][block] and
// reduce_partials_kernel sums them in one order (no float atomics: the
// same bits every run).  Block b owns the column slice [b * cols,
// b * cols + len); a thread takes its columns in turn.
//   project_gram: T in shared memory; Q = T W for the slice, kept in shared
//   memory (s x cols floats) and written out, with the upper triangle of M
//   per thread; then the rows of V eight at a time against the slice of Q,
//   eight loads of V in flight per thread.  V is read once.  The reduced
//   output is the stacked (m1 + s, s) block [C_hat; M]; M's partials are
//   stored to both triangles, so M comes out symmetric to the bit.
//   update: C in shared memory; per column u = C^T V[:, c] over the rows in
//   order (eight loads in flight), W' = Q - u, and the upper triangle of G.
// Every row of the V passed is read: the s-step cycle passes the valid
// prefix V[:k_start+1] (the rows past it are zero in its fresh basis).
//
// The row-sharded split pass (gs = "cgs2" across shards) has its own
// projection, block_gs_project:  Q = T W,  C = mask * (V Q^T),  mask =
// rows 0..k_start.  It replaces repro/kernels/block_gs.py::block_gs_project
// (one Pallas grid step over the VMEM-resident shard) and is the
// project-gram kernel without M (kGram false): the rows 0..k_start are
// read, their C partials reduced in the same fixed order, the rows past
// k_start written as zeros by the reduction launch.  The caller
// all-reduces C over the shards and runs block_gs_update.  Bound: bytes,
// ((k_start + 1) s_V + 8 s) n, 0.045 ms at k_start 25, s = 5, n = 2^20,
// f32, as the pair above.
// ---------------------------------------------------------------------------

// Dynamic shared memory: ts[S * S], qs[S * cols], red[kWarps * kRowChunk * S]
// kGram false: no M (block_gs_project).
template <typename TV, int S, bool kGram>
__global__ void __launch_bounds__(kThreads)
    block_gs_project_gram_kernel(const TV* __restrict__ v,
                                 const float* __restrict__ w,
                                 const float* __restrict__ tin,
                                 float* __restrict__ q_out,
                                 float* __restrict__ part, int m1, int n,
                                 int cols) {
  constexpr int kG = S * (S + 1) / 2;
  extern __shared__ float smem[];
  float* ts = smem;
  float* qs = ts + S * S;
  float* red = qs + (size_t)S * cols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  const int c0 = blockIdx.x * cols;
  const int len = max(0, min(cols, n - c0));

  for (int i = threadIdx.x; i < S * S; i += blockDim.x) ts[i] = tin[i];
  __syncthreads();

  // Q = T W and the upper triangle of M = Q Q^T
  float gacc[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) gacc[k] = 0.f;
  for (int c = threadIdx.x; c < len; c += blockDim.x) {
    float wc[S], q[S];
#pragma unroll
    for (int b = 0; b < S; ++b) wc[b] = w[(size_t)b * n + c0 + c];
#pragma unroll
    for (int a = 0; a < S; ++a) {
      float t = 0.f;
#pragma unroll
      for (int b = 0; b < S; ++b) t = fmaf(ts[a * S + b], wc[b], t);
      q[a] = t;
      qs[(size_t)a * cols + c] = t;
      q_out[(size_t)a * n + c0 + c] = t;
    }
    if constexpr (kGram) {
      int k = 0;
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int b = a; b < S; ++b, ++k) gacc[k] = fmaf(q[a], q[b], gacc[k]);
    }
  }
  if constexpr (kGram) {
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const float t = warp_sum(gacc[k]);
      if (lane == 0) red[warp * kG + k] = t;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kG; k += blockDim.x) {
      float t = 0.f;
      for (int r = 0; r < kWarps; ++r) t += red[r * kG + k];
      int a = 0, kk = k;   // entry k of the upper triangle, row by row
      while (kk >= S - a) kk -= S - a++;
      const size_t e0 = (size_t)m1 * S;
      part[(e0 + a * S + a + kk) * nb + blockIdx.x] = t;
      part[(e0 + (a + kk) * S + a) * nb + blockIdx.x] = t;
    }
  }
  __syncthreads();

  // C_hat = V Q^T, eight rows at a time
  for (int r0 = 0; r0 < m1; r0 += kRowChunk) {
    const int nr = m1 - r0 < kRowChunk ? m1 - r0 : kRowChunk;
    float acc[kRowChunk * S];
#pragma unroll
    for (int i = 0; i < kRowChunk * S; ++i) acc[i] = 0.f;
    const TV* vr = v + (size_t)r0 * n + c0;
    for (int c = threadIdx.x; c < len; c += blockDim.x) {
      float vv[kRowChunk], q[S];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
        vv[r] = r < nr ? to_f(vr[(size_t)r * n + c]) : 0.f;
#pragma unroll
      for (int a = 0; a < S; ++a) q[a] = qs[(size_t)a * cols + c];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r)
#pragma unroll
        for (int a = 0; a < S; ++a)
          acc[r * S + a] = fmaf(vv[r], q[a], acc[r * S + a]);
    }
    block_partials<kRowChunk * S>(acc, red, part, r0 * S, nr * S, nb);
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

template <typename TV>
static cudaError_t launch_project_gram(const void* v, const float* w,
                                       const float* tin, float* q, float* out,
                                       float* part, int grid, int m1, int n,
                                       int s, cudaStream_t stream) {
  if (m1 <= 0 || n <= 0 || grid < 1 || grid > n) return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  cudaError_t e = project_gram_kernel_for<TV, true>(s, &kernel);
  if (e != cudaSuccess) return e;
  const TV* vt = static_cast<const TV*>(v);
  int cols = (n + grid - 1) / grid;
  const size_t smem = sizeof(float) * ((size_t)s * s + (size_t)s * cols +
                                       (size_t)kWarps * kRowChunk * s);
  void* args[] = {(void*)&vt, (void*)&w, (void*)&tin, (void*)&q,
                  (void*)&part, (void*)&m1, (void*)&n, (void*)&cols};
  e = launch_plain(kernel, grid, smem, args, stream);
  if (e != cudaSuccess) return e;
  // out = [C_hat (m1, s); M (s, s)]
  return launch_reduce_partials(part, grid, (m1 + s) * s, 0, 0, out, stream);
}

// block_gs_project: the kernel reads rows 0..rows-1 of V; c (m1, s) comes
// back with the rows past them zero.
template <typename TV>
static cudaError_t launch_block_project(const void* v, const float* w,
                                        const float* tin, float* q, float* c,
                                        float* part, int grid, int m1,
                                        int rows, int n, int s,
                                        cudaStream_t stream) {
  if (m1 <= 0 || rows <= 0 || rows > m1 || n <= 0 || grid < 1 || grid > n)
    return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  cudaError_t e = project_gram_kernel_for<TV, false>(s, &kernel);
  if (e != cudaSuccess) return e;
  const TV* vt = static_cast<const TV*>(v);
  int cols = (n + grid - 1) / grid;
  const size_t smem = sizeof(float) * ((size_t)s * s + (size_t)s * cols +
                                       (size_t)kWarps * kRowChunk * s);
  void* args[] = {(void*)&vt, (void*)&w, (void*)&tin, (void*)&q,
                  (void*)&part, (void*)&rows, (void*)&n, (void*)&cols};
  e = launch_plain(kernel, grid, smem, args, stream);
  if (e != cudaSuccess) return e;
  return launch_reduce_partials(part, grid, m1 * s, rows * s, m1 * s, c,
                                stream);
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
// part holds (m1 * s + s * (s + 1) / 2) * part_blocks floats.
extern "C" int repro_block_gs_pass(const void* v, int v_bf16, const float* w,
                                   const float* tin, float* c, float* w_out,
                                   float* g, float* part, int part_blocks,
                                   int m1, int n, int s, int rows,
                                   int blocks_per_sm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_block_gs<repro::bf16>(
                      v, w, tin, c, w_out, g, part, part_blocks, m1, n, s,
                      rows, blocks_per_sm, st)
                : repro::launch_block_gs<float>(
                      v, w, tin, c, w_out, g, part, part_blocks, m1, n, s,
                      rows, blocks_per_sm, st);
}

// The launch shape repro_block_gs_pass would use: out = {grid, cols, smem}.
extern "C" int repro_block_gs_pass_shape(int v_bf16, int m1, int n, int s,
                                         int blocks_per_sm, int* out) {
  const void* kernel = nullptr;
  int g = 0;
  const cudaError_t e =
      v_bf16 ? repro::block_gs_grid<repro::bf16>(m1, n, s, blocks_per_sm,
                                                 &kernel, &g)
             : repro::block_gs_grid<float>(m1, n, s, blocks_per_sm, &kernel,
                                           &g);
  out[0] = g;
  out[1] = g ? (n + g - 1) / g : 0;
  out[2] = (int)repro::block_gs_smem_bytes(m1, s);
  return e;
}

// v (m1, n) f32 or bf16, row-major (every row is read); w (s, n), tin
// (s, s) f32; q (s, n) f32 out; out (m1 + s, s) f32 = [C_hat; M]; part
// holds (m1 + s) s grid floats.
extern "C" int repro_block_gs_project_gram(const void* v, int v_bf16,
                                           const float* w, const float* tin,
                                           float* q, float* out, float* part,
                                           int grid, int m1, int n, int s,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_project_gram<repro::bf16>(
                      v, w, tin, q, out, part, grid, m1, n, s, st)
                : repro::launch_project_gram<float>(v, w, tin, q, out, part,
                                                    grid, m1, n, s, st);
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
// (s, s) f32; q (s, n) and c (m1, s) f32 out; part holds rows s grid floats.
extern "C" int repro_block_gs_project(const void* v, int v_bf16,
                                      const float* w, const float* tin,
                                      float* q, float* c, float* part,
                                      int grid, int m1, int rows, int n,
                                      int s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_block_project<repro::bf16>(
                      v, w, tin, q, c, part, grid, m1, rows, n, s, st)
                : repro::launch_block_project<float>(
                      v, w, tin, q, c, part, grid, m1, rows, n, s, st);
}
