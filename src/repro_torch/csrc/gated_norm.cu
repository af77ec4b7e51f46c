// Fused SiLU gate + RMSNorm, the Mamba2 block's tail:
//
//   out[r, c] = g[r, c] * rsqrt(mean_c g[r, c]^2 + eps) * w[c],
//   g = y * silu(z) = y * z * sigmoid(z).
//
// Replaces repro/kernels/gated_norm.py::gated_rmsnorm, the Pallas kernel
// that loads a (bt, d) tile of y and z into VMEM once and gates, reduces
// and normalises it there.
//
// Bound: memory.  Each element is read twice (y, z) and written once, with
// a handful of flops: at zamba2's prefill, (1024, 7168) in float32, that is
// 88 MB, 0.026 ms at 3.35 TB/s.
//
// Design: one block of kThreads per row (any number of rows, any width;
// no padding).  Each thread gates its columns, reading y and z once,
// 16 bytes at a time (4 floats or 8 bf16; neighbouring threads on
// neighbouring addresses) where the row's width and addresses allow it,
// else one element at a time; it keeps g in shared memory (d floats: 28 KB
// at d = 7168, written and read back as 16-byte vectors, so the block's
// accesses fall in distinct banks) and its sum of squares in a register.
// A fixed-order block sum (common.cuh::block_sum) gives the mean; the same
// thread then scales its own columns of g, so g is never re-read from
// device memory and needs no barrier of its own.  Everything is float
// inside; out is stored in y's type.
#include "common.cuh"

namespace repro {

// V consecutive floats as storage type T at p (16-byte aligned).
template <typename T, int V>
__device__ __forceinline__ void store_floats(T* p, const float* v);
template <>
__device__ __forceinline__ void store_floats<float, 4>(float* p,
                                                       const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_floats<bf16, 8>(bf16* p,
                                                      const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float gate(float y, float z) {
  return y * (z / (1.f + expf(-z)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gated_rmsnorm_kernel(const T* __restrict__ y, const T* __restrict__ z,
                         const float* __restrict__ w, T* __restrict__ out,
                         int d, float eps) {
  constexpr int V = Vec16<T>::N;        // elements in 16 bytes
  extern __shared__ float4 g4[];        // d floats
  float* g = reinterpret_cast<float*>(g4);
  __shared__ float red[kWarps];
  const size_t base = (size_t)blockIdx.x * d;
  const T* yr = y + base;
  const T* zr = z + base;
  T* orow = out + base;
  const bool vec = d % V == 0 &&
                   (((uintptr_t)yr | (uintptr_t)zr | (uintptr_t)orow |
                     (uintptr_t)w) & 15u) == 0;
  float ss = 0.f;
  if (vec) {
    for (int c0 = threadIdx.x * V; c0 < d; c0 += kThreads * V) {
      float yv[V], zv[V];
      load_floats<T, V>(yr + c0, yv);
      load_floats<T, V>(zr + c0, zv);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 gv = make_float4(
            gate(yv[e], zv[e]), gate(yv[e + 1], zv[e + 1]),
            gate(yv[e + 2], zv[e + 2]), gate(yv[e + 3], zv[e + 3]));
        g4[(c0 + e) / 4] = gv;
        ss = fmaf(gv.x, gv.x, ss);
        ss = fmaf(gv.y, gv.y, ss);
        ss = fmaf(gv.z, gv.z, ss);
        ss = fmaf(gv.w, gv.w, ss);
      }
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float gv = gate(to_f(yr[c]), to_f(zr[c]));
      g[c] = gv;
      ss = fmaf(gv, gv, ss);
    }
  }
  const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);
  if (vec) {
    for (int c0 = threadIdx.x * V; c0 < d; c0 += kThreads * V) {
      float wv[V], o[V];
      load_floats<float, V>(w + c0, wv);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 gv = g4[(c0 + e) / 4];
        o[e] = gv.x * inv * wv[e];
        o[e + 1] = gv.y * inv * wv[e + 1];
        o[e + 2] = gv.z * inv * wv[e + 2];
        o[e + 3] = gv.w * inv * wv[e + 3];
      }
      store_floats<T, V>(orow + c0, o);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kThreads)
      orow[c] = from_f<T>(g[c] * inv * w[c]);
  }
}

template <typename T>
static cudaError_t launch_gated_rmsnorm(const void* y, const void* z,
                                        const float* w, void* out, int rows,
                                        int d, float eps,
                                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d;
  cudaError_t e = allow_smem(gated_rmsnorm_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  gated_rmsnorm_kernel<T><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(z), w,
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_gated_rmsnorm(const void* y, const void* z, int bf16,
                                   const float* w, void* out, int rows, int d,
                                   float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? repro::launch_gated_rmsnorm<repro::bf16>(y, z, w, out, rows,
                                                         d, eps, s)
              : repro::launch_gated_rmsnorm<float>(y, z, w, out, rows, d,
                                                   eps, s);
}
