// Mamba2 SSD chunked scan: for each row bh = (batch, head) of x, with the
// state H (N, P) carried from chunk to chunk (chunk length Q):
//
//   cum_t   = sum_{u <= t} lg_u                      (inclusive, per chunk)
//   y_t     = sum_{u <= t} (C_t . B_u) e^{cum_t - cum_u} dt_u x_u
//           + e^{cum_t} C_t H                        (the entering state)
//   H'      = e^{cum_Q} H + sum_u B_u^T e^{cum_Q - cum_u} dt_u x_u
//
// B and C are shared by the `heads` rows of a batch row (bh / heads).
//
// Replaces repro/kernels/ssd.py::ssd_scan, the Pallas kernel whose grid
// walks (bh, chunk) with H in VMEM scratch across the sequential chunk
// axis and the (Q, Q) score matrix built whole in VMEM.
//
// Bound: at zamba2's prefill (BH = 224, S = 512, P = N = 64, Q = 256) the
// inputs and output are 60 MB (0.018 ms at 3.35 TB/s) and the arithmetic
// the triangles need is 5.6 GFLOP (0.084 ms at 67 TFLOP/s, float32 outside
// the tensor cores): operations bound.
//
// Design.  Hopper's blocks run in no order, so the sequential chunk axis
// becomes a loop inside one block per row bh, with H (N x P floats, 16 KB)
// in shared memory for the whole row.  A (256, 256) float score tile is
// 256 KB, over the 227 KB a block may have, so each chunk is cut into
// 64-row tiles of t and of u: per (t, u) tile pair the 64 x 64 scores are
// built in shared memory from C and B tiles (upper-triangle pairs are not
// computed at all, and inside a diagonal tile the log-decay is masked
// before its exp, which would overflow above the diagonal), then applied
// to the x tile.  Each thread holds a 4 x PJ register tile of y (rows
// ty + 16 i, columns tx + 16 j) and later of the state update, so each
// shared-memory load feeds four or more multiply-adds.  Row strides of the
// B, C and score tiles are padded by one float, so the 16 rows a warp
// reads at one column fall in 16 banks.  The chunk's cumulative sum of lg
// is one warp's scan, in double: the decays are exps of DIFFERENCES of
// these sums, which reach -10^3 within a zamba2 chunk (|lg| up to 16 dt per
// step), so a float sum would lose four of its seven digits to
// cancellation, and the rounding of the sums, not the inputs, would set
// y to about 1e-4.  The differences are taken in double and rounded once.
// Everything else is float; x, B, C and y are stored as T.
// Limits: N <= 64, P <= 128; any Q with S a multiple of Q.
#include "common.cuh"

namespace repro {

constexpr int kSsdTile = 64;   // rows of a t tile and of a u tile
constexpr int kSsdMaxN = 64;
constexpr int kSsdMaxP = 128;

// Bytes of dynamic shared memory: cum (q doubles), then floats.
__host__ __device__ inline size_t ssd_smem_bytes(int q, int n, int p) {
  const int ns = n + 1, us = kSsdTile + 1;
  return sizeof(double) * (size_t)q +
         sizeof(float) * ((size_t)n * p + (size_t)q +
                          2 * (size_t)kSsdTile * ns + (size_t)kSsdTile * p +
                          (size_t)kSsdTile * us);
}

// cum[0..q) = inclusive prefix sum of cum[0..q), by warp 0: each lane sums
// a run of consecutive entries, a shuffle scan offsets the runs.
__device__ inline void warp_prefix_sum(double* cum, int q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (q + 31) / 32;
  const int lo = lane * per, hi = min(lo + per, q);
  double run = 0.0;
  for (int u = lo; u < hi; ++u) run += cum[u];
  double inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  double a = inc - run;
  for (int u = lo; u < hi; ++u) {
    a += cum[u];
    cum[u] = a;
  }
}

template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ lg, const T* __restrict__ bm,
                    const T* __restrict__ cm, T* __restrict__ y, int s, int p,
                    int n, int heads, int q) {
  extern __shared__ double sm[];
  const int ns = n + 1, us = kSsdTile + 1;
  double* cum = sm;                        // q, the chunk's sums of lg
  float* hs = reinterpret_cast<float*>(cum + q);   // n * p, the state
  float* dts = hs + (size_t)n * p;         // q
  float* cs = dts + q;                     // kSsdTile * ns, C tile
  float* bs = cs + kSsdTile * ns;          // kSsdTile * ns, B tile
  float* xs = bs + kSsdTile * ns;          // kSsdTile * p, x tile
  float* ss = xs + (size_t)kSsdTile * p;   // kSsdTile * us, scores

  const int row = blockIdx.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* xr = x + (size_t)row * s * p;
  const float* dtr = dt + (size_t)row * s;
  const float* lgr = lg + (size_t)row * s;
  const T* br = bm + (size_t)(row / heads) * s * n;
  const T* cr = cm + (size_t)(row / heads) * s * n;
  T* yr = y + (size_t)row * s * p;

  for (int e = tid; e < n * p; e += kThreads) hs[e] = 0.f;

  for (int c0 = 0; c0 < s; c0 += q) {
    __syncthreads();   // the last chunk is done with cum, dts and hs
    for (int u = tid; u < q; u += kThreads) {
      dts[u] = dtr[c0 + u];
      cum[u] = lgr[c0 + u];
    }
    __syncthreads();
    warp_prefix_sum(cum, q);
    __syncthreads();
    const double total = cum[q - 1];

    for (int t0 = 0; t0 < q; t0 += kSsdTile) {
      const int tn = min(kSsdTile, q - t0);
      for (int e = tid; e < tn * n; e += kThreads) {
        const int t = e / n, c = e - t * n;
        cs[t * ns + c] = to_f(cr[(size_t)(c0 + t0 + t) * n + c]);
      }
      __syncthreads();
      // the entering state: acc = e^{cum_t} C_t H
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
      for (int c = 0; c < n; ++c) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ns + c];
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          hv[j] = tx + 16 * j < p ? hs[c * p + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float e = t < tn ? expf((float)cum[t0 + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
      }
      // the chunk's own inputs, u tiles up to the t tile's last row
      for (int u0 = 0; u0 < t0 + tn; u0 += kSsdTile) {
        const int un = min(kSsdTile, q - u0);
        __syncthreads();   // the last u tile's bs, xs and ss are read
        for (int e = tid; e < un * n; e += kThreads) {
          const int u = e / n, c = e - u * n;
          bs[u * ns + c] = to_f(br[(size_t)(c0 + u0 + u) * n + c]);
        }
        for (int e = tid; e < un * p; e += kThreads)
          xs[e] = to_f(xr[(size_t)(c0 + u0) * p + e]);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int c = 0; c < n; ++c) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ns + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * ns + c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = ty + 16 * i, u = tx + 16 * j;
            const int tt = t0 + t, uu = u0 + u;
            float w = 0.f;
            if (t < tn && u < un && uu <= tt)   // masked before the exp
              w = sc[i][j] * expf((float)(cum[tt] - cum[uu])) * dts[uu];
            ss[t * us + u] = w;
          }
        __syncthreads();
        for (int u = 0; u < un; ++u) {
          float sv[4], xv[PJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = ss[(ty + 16 * i) * us + u];
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            xv[j] = tx + 16 * j < p ? xs[u * p + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j)
              acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= tn) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int c = tx + 16 * j;
          if (c < p) yr[(size_t)(c0 + t0 + t) * p + c] = from_f<T>(acc[i][j]);
        }
      }
      __syncthreads();   // cs is reloaded by the next t tile
    }

    // the state update: H' = e^{total} H + B^T (e^{total - cum} dt x)
    float hacc[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) hacc[i][j] = 0.f;
    for (int u0 = 0; u0 < q; u0 += kSsdTile) {
      const int un = min(kSsdTile, q - u0);
      __syncthreads();
      for (int e = tid; e < un * n; e += kThreads) {
        const int u = e / n, c = e - u * n;
        bs[u * ns + c] = to_f(br[(size_t)(c0 + u0 + u) * n + c]);
      }
      for (int e = tid; e < un * p; e += kThreads)
        xs[e] = to_f(xr[(size_t)(c0 + u0) * p + e]);
      for (int u = tid; u < un; u += kThreads)
        ss[u] = expf((float)(total - cum[u0 + u])) * dts[u0 + u];
      __syncthreads();
      for (int u = 0; u < un; ++u) {
        const float wu = ss[u];
        float bv[4], wx[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bv[i] = ty + 16 * i < n ? bs[u * ns + ty + 16 * i] : 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          wx[j] = tx + 16 * j < p ? wu * xs[u * p + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) hacc[i][j] = fmaf(bv[i], wx[j], hacc[i][j]);
      }
    }
    // hs was last read by the t tiles, before the syncs above; each thread
    // now updates only its own entries.
    const float et = expf((float)total);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int c = tx + 16 * j;
        if (c < p) hs[r * p + c] = fmaf(et, hs[r * p + c], hacc[i][j]);
      }
    }
  }
}

template <typename T>
static cudaError_t launch_ssd_scan(const void* x, const float* dt,
                                   const float* lg, const void* b,
                                   const void* c, void* y, int bh, int s,
                                   int p, int n, int heads, int q,
                                   cudaStream_t stream) {
  if (n > kSsdMaxN || p > kSsdMaxP || q < 1 || s % q != 0)
    return cudaErrorInvalidValue;
  const size_t smem = ssd_smem_bytes(q, n, p);
  const int pj = (p + 15) / 16;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  T* yt = static_cast<T*>(y);
  cudaError_t e;
#define REPRO_SSD_CASE(PJ)                                                   \
  case PJ:                                                                  \
    e = allow_smem(ssd_scan_kernel<T, PJ>, smem);                            \
    if (e != cudaSuccess) return e;                                          \
    ssd_scan_kernel<T, PJ><<<bh, kThreads, smem, stream>>>(                  \
        xt, dt, lg, bt, ct, yt, s, p, n, heads, q);                          \
    break;
  switch (pj) {
    REPRO_SSD_CASE(1)
    REPRO_SSD_CASE(2)
    REPRO_SSD_CASE(3)
    REPRO_SSD_CASE(4)
    REPRO_SSD_CASE(5)
    REPRO_SSD_CASE(6)
    REPRO_SSD_CASE(7)
    REPRO_SSD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_CASE
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_ssd_scan(const void* x, int bf16, const float* dt,
                              const float* lg, const void* b, const void* c,
                              void* y, int bh, int s, int p, int n, int heads,
                              int q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? repro::launch_ssd_scan<repro::bf16>(x, dt, lg, b, c, y, bh, s,
                                                    p, n, heads, q, st)
              : repro::launch_ssd_scan<float>(x, dt, lg, b, c, y, bh, s, p, n,
                                              heads, q, st);
}

