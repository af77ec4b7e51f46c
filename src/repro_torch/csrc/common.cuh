// Device helpers shared by the port's kernels (matvec.cu, cgs2.cu,
// arnoldi_fused.cu, spmv.cu, batched_cgs2.cu, matrix_powers.cu,
// block_gs.cu, sr_payload.cu, trisolve.cu, attention.cu, ssd.cu,
// gated_norm.cu): storage-type conversion, 16-byte row
// streaming with a warp, block sums in a fixed order, the grid-synchronised
// classical Gram-Schmidt pass with the basis slice in shared memory
// (stream_gs.cuh streams it from global memory), partials of a plain
// launch and their reduction by a second one, and the grid of a
// persistent cooperative kernel.
//
// Storage types are float and __nv_bfloat16; every sum is taken in float.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// Block shape of the cooperative kernels (cgs2.cu, arnoldi_fused.cu).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// A float as storage type T (round to nearest even for bf16).
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float to storage type T and widen it back (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of storage type T, widened to floats in registers.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(uint4 r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec16<bf16> {
  static constexpr int N = 8;
  // bf16 is the high half of a float: widening is a shift (little endian,
  // element 0 in the low 16 bits of each word).
  __device__ __forceinline__ static void unpack(uint4 r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// V consecutive elements of T at p, widened to floats, in vector loads.
// p must be aligned to min(16, V * sizeof(T)) bytes.
template <typename T, int V>
__device__ __forceinline__ void load_floats(const T* p, float* o) {
  constexpr int B = V * (int)sizeof(T);
  if constexpr (B == 8) {   // four bf16
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(r.x << 16);
    o[1] = __uint_as_float(r.x & 0xffff0000u);
    o[2] = __uint_as_float(r.y << 16);
    o[3] = __uint_as_float(r.y & 0xffff0000u);
  } else {
    static_assert(B % 16 == 0, "vector of whole 16-byte words");
#pragma unroll
    for (int q = 0; q < B / 16; ++q)
      Vec16<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p) + q),
                       o + q * Vec16<T>::N);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Sum of one float per thread over a block of kThreads, in a fixed order
// (warp shuffles, then the warps in order); every thread gets the sum.
// `red` holds kWarps floats of shared memory.
__device__ inline float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();   // a previous call may still be reading red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) s += red[q];
  return s;
}

// Diagonal offsets of a banded matrix, passed by value in a kernel's
// parameters (spmv.cu, matrix_powers.cu).  Read them at constant indices
// (a loop unrolled to kMaxBands): indexed at run time the struct goes to
// local memory in every thread.
constexpr int kMaxBands = 32;
struct BandOffsets {
  int off[kMaxBands];
};

// acc[k] += sum_c row[c] * x(c, k) for one row of length n, split over the
// 32 lanes of a warp.  The row is read in 16-byte vectors, neighbouring
// lanes on neighbouring addresses, four deep.  Rows need not start on a
// 16-byte boundary (n need not be a multiple of the vector width): up to
// one vector's worth of leading and trailing elements is read one by one,
// masked by the row length, instead of padding the matrix.
//
// X supplies the other operand: fma(acc, a, c) for one column, and, where
// vec_ok(head) says the columns line up with the vector loads of the row,
// fma_vec<V>(acc, a, c0) for V columns at once from vector loads of its own.
template <typename T, int K, typename X>
__device__ __forceinline__ void row_dot(const T* __restrict__ row, int n,
                                        int lane, const X& x,
                                        float (&acc)[K]) {
  constexpr int V = Vec16<T>::N;
  int head = (int)(((16u - ((uintptr_t)row & 15u)) & 15u) / sizeof(T));
  if (head > n) head = n;
  if (lane < head) x.fma(acc, to_f(row[lane]), lane);
  const int nvec = (n - head) / V;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  if (x.vec_ok(head)) {
#pragma unroll 4
    for (int t = lane; t < nvec; t += 32) {
      float a[V];
      Vec16<T>::unpack(__ldg(body + t), a);
      x.template fma_vec<V>(acc, a, head + t * V);
    }
  } else {
#pragma unroll 4
    for (int t = lane; t < nvec; t += 32) {
      float a[V];
      Vec16<T>::unpack(__ldg(body + t), a);
      const int c0 = head + t * V;
#pragma unroll
      for (int e = 0; e < V; ++e) x.fma(acc, a[e], c0 + e);
    }
  }
  for (int c = head + nvec * V + lane; c < n; c += 32)
    x.fma(acc, to_f(row[c]), c);
}

// ---------------------------------------------------------------------------
// Grid-synchronised classical Gram-Schmidt (one launch, cooperative grid).
//
// Block b owns the column slice [b*cols, b*cols + len) of the basis V
// (rows 0..rows-1 valid) and of the vector w.  Its dynamic shared memory:
//
//   vs[m1 * cols]     its V slice, widened to float, loaded once per launch
//   ws[cols]          its slice of w, updated in place by every pass
//   hs[m1]            this pass's h, identical in every block after the sync
//   htot[m1]          h summed over the passes
//   ps[cols * kWarps] per-warp partial sums (arnoldi_fused.cu's phase 0)
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t gs_smem_bytes(int m1, int cols) {
  return sizeof(float) *
         ((size_t)m1 * cols + cols + 2 * (size_t)m1 + (size_t)cols * kWarps);
}

struct GsSmem {
  float* vs;
  float* ws;
  float* hs;
  float* htot;
  float* ps;
  __device__ GsSmem(float* base, int m1, int cols)
      : vs(base),
        ws(base + (size_t)m1 * cols),
        hs(ws + cols),
        htot(hs + m1),
        ps(htot + m1) {}
};

template <typename TV>
__device__ void load_basis_slice(const TV* __restrict__ v, int n, int rows,
                                 int c0, int len, int cols, float* vs) {
  const int total = rows * len;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = idx / len, c = idx - i * len;
    vs[(size_t)i * cols + c] = to_f(v[(size_t)i * n + c0 + c]);
  }
}

// One pass: h = V w over the valid rows, w -= h^T V, htot += h.
//
// Each block writes its partial h (one float per row) to part[row][block],
// the grid syncs once, and every block then sums all partials itself, in
// the same order, so all blocks hold the same h without a second sync.
// Every block reads all grid * rows partials; stored row-major by block
// index, a warp's reads of one row are contiguous (stored the other way
// round, each lane hit its own sector and the pass grew with the square of
// the grid).  A second pass must use another `part` buffer: a slow block
// may still be reading this one.
__device__ inline void gs_pass(cg::grid_group& grid, GsSmem s, float* part,
                               int rows, int len, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nb = gridDim.x;
  for (int i = warp; i < rows; i += nw) {
    float acc = 0.f;
    for (int c = lane; c < len; c += 32)
      acc = fmaf(s.vs[(size_t)i * cols + c], s.ws[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) part[(size_t)i * nb + blockIdx.x] = acc;
  }
  grid.sync();
  for (int i = warp; i < rows; i += nw) {
    float acc = 0.f;
    for (int b = lane; b < nb; b += 32)
      acc += __ldcg(part + (size_t)i * nb + b);   // written by other SMs
    acc = warp_sum(acc);
    if (lane == 0) s.hs[i] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < len; c += blockDim.x) {
    float u = 0.f;
    for (int i = 0; i < rows; ++i)
      u = fmaf(s.hs[i], s.vs[(size_t)i * cols + c], u);
    s.ws[c] -= u;
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) s.htot[i] += s.hs[i];
  __syncthreads();
}

// The cooperative grid: the most blocks per SM (at most `blocks_per_sm`,
// never more blocks than columns) whose column slice fits in `smem_cap`
// bytes and that the occupancy calculator says are co-resident.  A
// cooperative launch with more blocks than can be resident is refused.
// The answer for the last (kernel, device, shape) is kept per host thread,
// so a solve's repeated launches skip the occupancy queries.
struct CoopShape {
  int grid = 0;
  int cols = 0;
  size_t smem = 0;
};

template <typename Kernel>
cudaError_t coop_shape(Kernel kernel, int m1, int n, int smem_cap,
                       int blocks_per_sm, CoopShape* out) {
  struct Key {
    const void* kernel;
    int dev, m1, n, cap, bps;
  };
  thread_local Key last{nullptr, -1, 0, 0, 0, 0};
  thread_local CoopShape last_shape;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const Key key{(const void*)kernel, dev, m1, n, smem_cap, blocks_per_sm};
  if (key.kernel == last.kernel && key.dev == last.dev && key.m1 == last.m1 &&
      key.n == last.n && key.cap == last.cap && key.bps == last.bps) {
    *out = last_shape;
    return cudaSuccess;
  }
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_cap);
  if (e != cudaSuccess) return e;
  for (int bps = blocks_per_sm; bps >= 1; --bps) {
    const int g = bps * sms < n ? bps * sms : n;
    const int c = (n + g - 1) / g;
    const size_t sb = gs_smem_bytes(m1, c);
    if (sb > (size_t)smem_cap) continue;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                      sb);
    if (e != cudaSuccess) return e;
    if ((size_t)occ * sms >= (size_t)g) {
      out->grid = g;
      out->cols = c;
      out->smem = sb;
      last = key;
      last_shape = *out;
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// Basis rows a thread of block_gs.cu's update sums at once: eight loads of
// V in flight a thread.
constexpr int kRowChunk = 8;

// ---------------------------------------------------------------------------
// Partials of a plain (non-cooperative) launch, reduced by a second launch
// (sr_payload.cu's projections, block_gs.cu's single-reduce pair and
// block_gs_project).  Entry e of block b is stored at part[e * nb + b],
// [entry][block] as in gs_pass, so a warp's reads of one entry are
// contiguous; no float atomics anywhere, so the sums come out in one fixed
// order and the same bits every run.
// ---------------------------------------------------------------------------

// Sum each of the K per-thread accumulators over the block (warp shuffles,
// then the warps in order) and store the first `kvalid` block sums at
// part[(e0 + k) * nb + blockIdx.x].  `red` holds kWarps * K floats of
// shared memory.  Every thread of the block must call it.
template <int K>
__device__ inline void block_partials(const float (&acc)[K], float* red,
                                      float* part, int e0, int kvalid,
                                      int nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float t = warp_sum(acc[k]);
    if (lane == 0) red[warp * K + k] = t;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kvalid; k += blockDim.x) {
    float t = 0.f;
    for (int q = 0; q < kWarps; ++q) t += red[q * K + k];
    part[(size_t)(e0 + k) * nb + blockIdx.x] = t;
  }
  __syncthreads();
}

// The second launch: out[e] = sum_b part[e * nb + b] for e < n_out, one
// warp per entry (lanes stride the blocks, then shuffles), entries in
// [zero_lo, zero_hi) written as 0 without reading.  Its grid is
// ceil(n_out / kWarps) blocks of kThreads.  (A template, so that every
// source that launches it compiles its own copy.)
template <int Unused = 0>
__global__ void __launch_bounds__(kThreads)
    reduce_partials_kernel(const float* __restrict__ part, int nb, int n_out,
                           int zero_lo, int zero_hi, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= n_out) return;
  if (e >= zero_lo && e < zero_hi) {
    if (lane == 0) out[e] = 0.f;
    return;
  }
  float t = 0.f;
  for (int b = lane; b < nb; b += 32) t += part[(size_t)e * nb + b];
  t = warp_sum(t);
  if (lane == 0) out[e] = t;
}

inline cudaError_t launch_reduce_partials(const float* part, int nb,
                                          int n_out, int zero_lo,
                                          int zero_hi, float* out,
                                          cudaStream_t stream) {
  const int grid = (n_out + kWarps - 1) / kWarps;
  reduce_partials_kernel<0><<<grid, kThreads, 0, stream>>>(
      part, nb, n_out, zero_lo, zero_hi, out);
  return cudaGetLastError();
}

// Dynamic shared memory above the default 48 KB must be allowed per kernel
// before the launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The grid of a persistent cooperative kernel (matrix_powers.cu,
// block_gs.cu): `blocks_per_sm` blocks on every SM, fewer where the
// occupancy calculator says fewer are co-resident, and never more than
// `max_grid`.  A cooperative launch with more blocks than can be resident
// is refused, so the grid never exceeds what the calculator allows.  The
// answers are kept per host thread, a few (kernel, device, shared memory)
// entries, so a solve's alternating launches skip the queries.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int blocks_per_sm,
                            int max_grid, int* grid) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int per_sm, sms;
  };
  constexpr int kEntries = 8;
  thread_local Entry cache[kEntries] = {};
  thread_local int next = 0;
  if (blocks_per_sm < 1 || max_grid < 1) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const Entry* hit = nullptr;
  for (const Entry& c : cache)
    if (c.kernel == (const void*)kernel && c.dev == dev && c.smem == smem)
      hit = &c;
  if (hit == nullptr) {
    Entry c{(const void*)kernel, dev, smem, 0, 0};
    e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
    cache[next] = c;
    hit = &cache[next];
    next = (next + 1) % kEntries;
  }
  if (hit->per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int per_sm = hit->per_sm < blocks_per_sm ? hit->per_sm : blocks_per_sm;
  const int g = per_sm * hit->sms;
  *grid = g < max_grid ? g : max_grid;
  return cudaSuccess;
}

}  // namespace repro
