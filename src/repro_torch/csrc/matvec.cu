// Dense GEMV / skinny GEMM: Y (m, k) = A (m, n) X (n, k), f32 accumulation.
//
// Replaces repro/kernels/matvec.py::block_matvec (and `matvec`, its k = 1
// wrapper), the Pallas kernel that streams A through VMEM in (bm, bn) tiles.
//
// Bound: memory.  Each element of A is used for k multiply-adds, so at the
// solver's k = 1 the kernel does 2 flops per 4 bytes (f32) and only the rate
// at which A streams from HBM matters: at n = 10,000, f32, A is 400 MB, and
// 400 MB / 3.35 TB/s = 0.119 ms is the floor.
//
// The first design: one warp per row, eight rows a block, so
// 1,250 blocks at n = 10,000 (1.18 waves of the 1,056 that fit: the
// second wave fills 18% of the card), and every warp re-read its own copy
// of x through L1, one x piece per A piece: 16 bytes of x per 16 bytes of
// f32 A, 32 per 16 of bf16 A (x stays float32).  0.146 ms f32, 0.077 bf16
// at n = 10,000 on an H100 80GB HBM3 at 700 W (torch.mv 0.155 / 0.075).
//
// Design: a warp takes R rows at once.  Each lane loads one x piece (the
// 16-byte A piece's columns, times k) and then the R rows' 16-byte A
// pieces, all before any FMA, U pieces deep, so the load units carry A
// and x once per R rows; A is read evict-first (__ldcs: the streamed rows
// do not push x out of L1) or through the read-only path (__ldg).  A
// persistent grid of a few blocks an SM of kThreads threads: warp w of W
// takes rows [w m / W, (w + 1) m / W), R at a time, so the rows split
// evenly and there is no second wave.  (R, blocks an SM, U, evict-first)
// come from tuning.GEMV_SHAPES by k and A's type, the fastest of a sweep
// on the card (at n = 10^4: (2, 6, 4, no) for k = 1, (4, 4, 2, no) for
// f32 and (8, 2, 2, yes) for bf16 at k = 4).  Rows whose starts differ in
// their offset from a 16-byte boundary (n * sizeof(T) % 16 != 0) cannot
// share x pieces: there a warp takes one row at a time with its own
// masked head and tail (R = 1, common.cuh::row_dot).  Each lane keeps
// R x k accumulators; a warp-shuffle reduction per row ends the group.
// bf16 A widens to float in registers; f32 accumulation.
#include "common.cuh"

namespace repro {

template <int K>
struct DenseX {
  const float* __restrict__ x;   // (n, K) row-major
  __device__ __forceinline__ void fma(float (&acc)[K], float a, int c) const {
    const float* p = x + (size_t)c * K;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = fmaf(a, __ldg(p + k), acc[k]);
  }
  // Columns head + t*V start on 16-byte boundaries of x (V*K*4 bytes apart).
  __device__ __forceinline__ bool vec_ok(int head) const {
    return (((uintptr_t)(x + (size_t)head * K)) & 15u) == 0;
  }
  template <int V>
  __device__ __forceinline__ void fma_vec(float (&acc)[K], const float* a,
                                          int c0) const {
    float xs[V * K];
    load_floats<float, V * K>(x + (size_t)c0 * K, xs);
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(a[e], xs[e * K + k], acc[k]);
  }
};

// A 16-byte piece of a row of A: evict-first (__ldcs: the streamed rows
// do not push x out of L1) or read-only cached (__ldg).
template <bool CS>
__device__ __forceinline__ uint4 load_piece(const uint4* p) {
  if constexpr (CS)
    return __ldcs(p);
  else
    return __ldg(p);
}

// acc[r][k] += sum_c A[r0 + r, c] x(c, k) for the nr <= R rows from row0,
// split over the 32 lanes of a warp, U pieces of each row in flight (one
// where x's piece is more than 16 floats: registers).  Every row starts at
// the same offset from a 16-byte boundary (n * sizeof(T) % 16 == 0): the
// same masked head, the same 16-byte pieces, one x piece for all the rows.
template <typename T, int K, int R, int U0, bool CS>
__device__ __forceinline__ void rows_dot(const T* __restrict__ row0, int n,
                                         int nr, int lane, const DenseX<K>& x,
                                         float (&acc)[R][K]) {
  constexpr int V = Vec16<T>::N;
  constexpr int U = V * K <= 16 ? U0 : 1;
  int head = (int)(((16u - ((uintptr_t)row0 & 15u)) & 15u) / sizeof(T));
  if (head > n) head = n;
  if (lane < head) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) x.fma(acc[r], to_f(row0[(size_t)r * n + lane]), lane);
  }
  const int nvec = (n - head) / V;
  const bool xv = x.vec_ok(head);
  for (int t0 = lane; t0 < nvec; t0 += 32 * U) {
    uint4 raw[U][R];
    float xs[U][V * K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + 32 * u;
      if (t >= nvec) continue;
      if (xv)
        load_floats<float, V * K>(x.x + (size_t)(head + t * V) * K, xs[u]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr)
          raw[u][r] = load_piece<CS>(
              reinterpret_cast<const uint4*>(row0 + (size_t)r * n + head) +
              t);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + 32 * u;
      if (t >= nvec) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) continue;
        float f[V];
        Vec16<T>::unpack(raw[u][r], f);
        if (xv) {
#pragma unroll
          for (int e = 0; e < V; ++e)
#pragma unroll
            for (int k = 0; k < K; ++k)
              acc[r][k] = fmaf(f[e], xs[u][e * K + k], acc[r][k]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) x.fma(acc[r], f[e], head + t * V + e);
        }
      }
    }
  }
  for (int c = head + nvec * V + lane; c < n; c += 32) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) x.fma(acc[r], to_f(row0[(size_t)r * n + c]), c);
  }
}

template <typename T, int K, int R, int U, bool CS>
__global__ void __launch_bounds__(kThreads)
    block_matvec_kernel(const T* __restrict__ a, const float* __restrict__ x,
                        float* __restrict__ y, int m, int n) {
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  const long long warps = (long long)gridDim.x * wpb;
  const long long gw = (long long)blockIdx.x * wpb + (threadIdx.x >> 5);
  const int lo = (int)(gw * m / warps), hi = (int)((gw + 1) * m / warps);
  const DenseX<K> xd{x};
  for (int r0 = lo; r0 < hi; r0 += R) {   // uniform across the warp
    const int nr = hi - r0 < R ? hi - r0 : R;
    float acc[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[r][k] = 0.f;
    if constexpr (R == 1)
      row_dot<T, K>(a + (size_t)r0 * n, n, lane, xd, acc[0]);
    else
      rows_dot<T, K, R, U, CS>(a + (size_t)r0 * n, n, nr, lane, xd, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) continue;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float s = warp_sum(acc[r][k]);
        if (lane == 0) y[(size_t)(r0 + r) * K + k] = s;
      }
    }
  }
}

// The launch for R rows a warp, U pieces in flight, CS evict-first A
// loads; (U, CS) other than (2, 1) only for k = 1 and 4 (the solver's and
// the batched dense solve's widths).
template <typename T, int K, int R>
static cudaError_t launch_matvec_r(const T* a, const float* x, float* y,
                                   int m, int n, int unroll, int cs,
                                   int grid, int threads,
                                   cudaStream_t stream) {
  if (R == 1 || !(K == 1 || K == 4)) {
    if (!(unroll == 2 && cs == 1)) return cudaErrorInvalidValue;
    block_matvec_kernel<T, K, R, 2, true>
        <<<grid, threads, 0, stream>>>(a, x, y, m, n);
    return cudaGetLastError();
  }
  if (unroll == 2 && cs)
    block_matvec_kernel<T, K, R, 2, true>
        <<<grid, threads, 0, stream>>>(a, x, y, m, n);
  else if (unroll == 2)
    block_matvec_kernel<T, K, R, 2, false>
        <<<grid, threads, 0, stream>>>(a, x, y, m, n);
  else if (unroll == 4 && cs)
    block_matvec_kernel<T, K, R, 4, true>
        <<<grid, threads, 0, stream>>>(a, x, y, m, n);
  else if (unroll == 4)
    block_matvec_kernel<T, K, R, 4, false>
        <<<grid, threads, 0, stream>>>(a, x, y, m, n);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T, int K>
static cudaError_t launch_matvec_rows(const T* a, const float* x, float* y,
                                      int m, int n, int rows, int unroll,
                                      int cs, int grid, int threads,
                                      cudaStream_t stream) {
  switch (rows) {
    case 1:
      return launch_matvec_r<T, K, 1>(a, x, y, m, n, unroll, cs, grid,
                                      threads, stream);
    case 2:
      return launch_matvec_r<T, K, 2>(a, x, y, m, n, unroll, cs, grid,
                                      threads, stream);
    case 4:
      return launch_matvec_r<T, K, 4>(a, x, y, m, n, unroll, cs, grid,
                                      threads, stream);
    case 8:
      return launch_matvec_r<T, K, 8>(a, x, y, m, n, unroll, cs, grid,
                                      threads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
static cudaError_t launch_block_matvec(const void* a, const float* x,
                                       float* y, int m, int n, int k,
                                       int rows, int unroll, int cs,
                                       int grid, int threads,
                                       cudaStream_t stream) {
  // R > 1 shares x pieces between rows: every row must start at the same
  // offset from a 16-byte boundary
  if (m <= 0 || n <= 0 || grid <= 0 || threads <= 0 || threads % 32 != 0 ||
      threads > kThreads || (rows > 1 && (n * (int)sizeof(T)) % 16 != 0))
    return cudaErrorInvalidValue;
  const T* at = static_cast<const T*>(a);
#define REPRO_MATVEC_CASE(K)                                               \
  case K:                                                                  \
    return launch_matvec_rows<T, K>(at, x, y, m, n, rows, unroll, cs, grid, \
                                    threads, stream);
  switch (k) {
    REPRO_MATVEC_CASE(1)
    REPRO_MATVEC_CASE(2)
    REPRO_MATVEC_CASE(3)
    REPRO_MATVEC_CASE(4)
    REPRO_MATVEC_CASE(5)
    REPRO_MATVEC_CASE(6)
    REPRO_MATVEC_CASE(7)
    REPRO_MATVEC_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_MATVEC_CASE
}

}  // namespace repro

// rows: the rows a warp takes at once (1, 2, 4, 8; above 1 only where
// n * sizeof(T) % 16 == 0); unroll: pieces of each row in flight (2 or
// 4); cs: evict-first A loads; grid x threads: the persistent grid
// (tuning.gemv_rows_shape).
extern "C" int repro_block_matvec(const void* a, int a_bf16, const float* x,
                                  float* y, int m, int n, int k, int rows,
                                  int unroll, int cs, int grid, int threads,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? repro::launch_block_matvec<repro::bf16>(
                      a, x, y, m, n, k, rows, unroll, cs, grid, threads, s)
                : repro::launch_block_matvec<float>(a, x, y, m, n, k, rows,
                                                    unroll, cs, grid,
                                                    threads, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
