// Blockwise (online-softmax) attention with GQA, causal masking and a
// sliding window, for float32 q, k and v, in full float32 on the CUDA
// cores (bfloat16 calls go to attention_sm90.cu's tensor-core kernel):
//
//   o[b, h, i] = softmax_k(scale q[b, h, i] . k[b, h / g, k]  over the
//                          keys inside row i's mask) v[b, h / g, k]
//
// q is (b, hq, sq, d), k and v (b, hkv, skv, d), g = hq / hkv.  Queries are
// aligned to the END of the key axis: query row i sits at absolute
// position skv - sq + i.  The causal mask keeps kpos <= qpos, the window
// kpos > qpos - window.  A row with no key inside its mask is 0.
//
// Replaces repro/kernels/attention.py::attention for float32 storage, the
// Pallas kernel that walks a (b*hq, q tile, k tile) grid with the running
// max, normaliser and accumulator in VMEM scratch, front-padding queries
// and back-padding keys to whole tiles.  Float32 keeps this kernel: TF32
// tensor-core products would keep three decimal digits, and the float32
// prefill is held to its plain version within 1e-3 of max|logit|.
//
// Bound: at zamba2's prefill shape, (2, 32, 512, 112) float32 causal, q,
// k, v and o are 58.7 MB (0.018 ms at 3.35 TB/s) and the causal half of
// the products is 3.76 GFLOP (0.056 ms at 67 TFLOP/s float32): operations
// bound on the CUDA cores.  Measured (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py phase 24, cold L2): 0.313 ms, 5.6x that bound; the float32
// prefill runs its 13 launches.
//
// Design: one block of kThreads per (64-query tile, batch * query head).
// The block walks only the 64-key tiles inside its tile's causal / window
// horizon (the others are never loaded), so no padding is needed: ragged
// sq and skv are masked inside the tile.  Q, K and V tiles are widened to
// float in shared memory (rows of Q and K padded by one float, so the 16
// rows a half-warp reads at one column fall in 16 banks); each thread
// holds a 4 x 4 register tile of the scores (query rows ty + 16 i, keys
// tx + 16 j) and a 4 x DJ tile of the output (columns tx + 16 j, d <= 128),
// with the running max and sum of its 4 rows.  Row max and sum are
// shuffles over the 16 lanes that share a row.  The probabilities go
// through shared memory into the P V product.  GQA: query head h reads kv
// head h / g in place, no copy.  Strides are passed per tensor (the last
// axis contiguous), so the model's head-transposed views need no copy.
#include <math.h>

#include "common.cuh"

namespace repro {

constexpr int kAttnBQ = 64;    // query rows of a block
constexpr int kAttnBK = 64;    // keys of a tile
constexpr int kAttnMaxD = 128;

struct AttnStrides {
  long long b, h, s;   // elements between batch rows, heads, positions
};

__host__ __device__ inline size_t attn_smem_floats(int d) {
  return (size_t)kAttnBQ * (d + 1) + (size_t)kAttnBK * (d + 1) +
         (size_t)kAttnBK * d + (size_t)kAttnBQ * (kAttnBK + 1);
}

template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int hq,
                     int group, int sq, int skv, int d, AttnStrides qs_,
                     AttnStrides ks_, AttnStrides vs_, AttnStrides os_,
                     float scale, int causal, int window) {
  extern __shared__ float sm[];
  const int ds = d + 1, ps_stride = kAttnBK + 1;
  float* qs = sm;                                  // kAttnBQ * ds
  float* ks = qs + (size_t)kAttnBQ * ds;           // kAttnBK * ds
  float* vs = ks + (size_t)kAttnBK * ds;           // kAttnBK * d
  float* ps = vs + (size_t)kAttnBK * d;            // kAttnBQ * ps_stride

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int bi = bh / hq, h = bh - bi * hq, hk = h / group;
  const int q0 = blockIdx.x * kAttnBQ;
  const int qn = min(kAttnBQ, sq - q0);
  const int qlo = skv - sq + q0;                   // absolute positions
  const int qhi = qlo + qn - 1;
  int klo = 0, khi = skv - 1;                      // keys any row may see
  if (causal) khi = min(khi, qhi);
  if (window > 0) klo = max(klo, qlo - window + 1);

  const T* qb = q + bi * qs_.b + h * qs_.h;
  const T* kb = k + bi * ks_.b + hk * ks_.h;
  const T* vb = v + bi * vs_.b + hk * vs_.h;
  T* ob = o + bi * os_.b + h * os_.h;

  for (int e = tid; e < qn * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    qs[r * ds + c] = to_f(qb[(q0 + r) * qs_.s + c]);
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kstart = klo <= khi ? klo / kAttnBK * kAttnBK : skv;
  for (int k0 = kstart; k0 <= khi; k0 += kAttnBK) {
    const int kn = min(kAttnBK, skv - k0);
    __syncthreads();   // the last tile's ks, vs and ps are read
    for (int e = tid; e < kn * d; e += kThreads) {
      const int r = e / d, c = e - r * d;
      ks[r * ds + c] = to_f(kb[(k0 + r) * ks_.s + c]);
      vs[r * d + c] = to_f(vb[(k0 + r) * vs_.s + c]);
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ds + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ds + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = qlo + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = tx + 16 * j, kpos = k0 + u;
        bool ok = r < qn && u < kn;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[i][j] = ok ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);
      // a row that has seen no key yet keeps p = 0 and its zero sums
      const float corr = mnew == -INFINITY ? 1.f : expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = mnew == -INFINITY ? 0.f : expf(sc[i][j] - mnew);
        ps[r * ps_stride + tx + 16 * j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = fmaf(l[i], corr, rs);
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int u = 0; u < kn; ++u) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * ps_stride + u];
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        vv[j] = tx + 16 * j < d ? vs[u * d + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= qn) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[(q0 + r) * os_.s + c] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
static cudaError_t launch_attention(const void* q, const void* k,
                                    const void* v, void* o, int b, int hq,
                                    int hkv, int sq, int skv, int d,
                                    const long long* strides, float scale,
                                    int causal, int window,
                                    cudaStream_t stream) {
  if (d < 1 || d > kAttnMaxD || hkv < 1 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  const AttnStrides st[4] = {{strides[0], strides[1], strides[2]},
                             {strides[3], strides[4], strides[5]},
                             {strides[6], strides[7], strides[8]},
                             {strides[9], strides[10], strides[11]}};
  const size_t smem = sizeof(float) * attn_smem_floats(d);
  const dim3 grid((sq + kAttnBQ - 1) / kAttnBQ, b * hq);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  const int group = hq / hkv;
  cudaError_t e;
#define REPRO_ATTN_CASE(DJ)                                                   \
  case DJ:                                                                   \
    e = allow_smem(attention_kernel<T, DJ>, smem);                            \
    if (e != cudaSuccess) return e;                                           \
    attention_kernel<T, DJ><<<grid, kThreads, smem, stream>>>(                \
        qt, kt, vt, ot, hq, group, sq, skv, d, st[0], st[1], st[2], st[3],    \
        scale, causal, window);                                               \
    break;
  switch ((d + 15) / 16) {
    REPRO_ATTN_CASE(1)
    REPRO_ATTN_CASE(2)
    REPRO_ATTN_CASE(3)
    REPRO_ATTN_CASE(4)
    REPRO_ATTN_CASE(5)
    REPRO_ATTN_CASE(6)
    REPRO_ATTN_CASE(7)
    REPRO_ATTN_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_ATTN_CASE
  return cudaGetLastError();
}

}  // namespace repro

// strides: 12 long longs, (batch, head, position) for q, k, v, o in turn.
extern "C" int repro_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int hq, int hkv, int sq,
                               int skv, int d, const long long* strides,
                               float scale, int causal, int window,
                               void* stream) {
  return repro::launch_attention<float>(q, k, v, o, b, hq, hkv, sq, skv, d,
                                        strides, scale, causal, window,
                                        static_cast<cudaStream_t>(stream));
}
