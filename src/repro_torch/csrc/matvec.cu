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
// Design: one warp per row, eight rows (warps) per block, so every SM holds
// many independent row streams in flight.  A lane reads 16 bytes at a time
// (4 f32 or 8 bf16), neighbouring lanes on neighbouring addresses, unrolled
// four deep; bf16 A widens to float in registers.  X (n*k*4 bytes) is reused
// by every row and stays in L1/L2; wherever a row's columns line up with its
// vector loads, X is read in vector loads too, so that the load units carry
// A and not X.  Each lane keeps k <= 8 accumulators in registers (k is a
// template parameter); a warp-shuffle reduction ends the row.  Rows of any
// length are handled by masking (common.cuh::row_dot), not padding.
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

template <typename T, int K>
__global__ void __launch_bounds__(256)
    block_matvec_kernel(const T* __restrict__ a, const float* __restrict__ x,
                        float* __restrict__ y, int m, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= m) return;   // whole warp leaves together
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  row_dot<T, K>(a + (size_t)row * n, n, lane, DenseX<K>{x}, acc);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float s = warp_sum(acc[k]);
    if (lane == 0) y[(size_t)row * K + k] = s;
  }
}

template <typename T>
static cudaError_t launch_block_matvec(const void* a, const float* x,
                                       float* y, int m, int n, int k,
                                       int grid, int threads,
                                       cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
#define REPRO_MATVEC_CASE(K)                                               \
  case K:                                                                  \
    block_matvec_kernel<T, K><<<grid, threads, 0, stream>>>(at, x, y, m, n); \
    break;
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
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_block_matvec(const void* a, int a_bf16, const float* x,
                                  float* y, int m, int n, int k, int grid,
                                  int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? repro::launch_block_matvec<repro::bf16>(a, x, y, m, n, k,
                                                          grid, threads, s)
                : repro::launch_block_matvec<float>(a, x, y, m, n, k, grid,
                                                    threads, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
