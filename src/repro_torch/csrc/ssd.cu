// Mamba2 SSD chunked scan: for each row r = (batch, head) of x, with the
// state H (N, P) carried from chunk to chunk (chunk length Q):
//
//   cum_t   = sum_{u <= t} lg_u                      (inclusive, per chunk)
//   y_t     = sum_{u <= t} (C_t . B_u) e^{cum_t - cum_u} dt_u x_u
//           + e^{cum_t} C_t H                        (the entering state)
//   H'      = e^{cum_Q} H + sum_u B_u^T e^{cum_Q - cum_u} dt_u x_u
//
// B and C are shared by the `heads` rows of a batch row (r / heads).
//
// Replaces repro/kernels/ssd.py::ssd_scan, the Pallas kernel whose grid
// walks (row, chunk) with H in VMEM scratch across the sequential chunk
// axis and the (Q, Q) score matrix built whole in VMEM.
//
// Bound: at zamba2's prefill (224 rows, S = 512, P = N = 64, Q = 256) the
// inputs and output are 60.2 MB (0.018 ms at 3.35 TB/s).  With C B^T formed
// once per (batch row, chunk), no C H in the first chunk (its entering
// state is 0) and no state update in the last (never read), the products
// are 2.84 GFLOP: three TF32 passes of them at 495 TFLOP/s take 0.017 ms,
// so the bound is bytes.  bf16 storage: 30.5 MB (0.0091 ms), and operands
// from storage skip a pass (6.14 G TF32 operations, 0.0124 ms: operations).
//
// Design.  The chunk axis is not walked in order.  Two launches:
//
// 1. ssd_state_kernel, a block per (row, chunk), all in parallel: the
//    chunk's cumulative sums of lg (one warp's scan, in double: the decays
//    are exps of DIFFERENCES of these sums, which reach -10^3 within a
//    zamba2 chunk, so a float sum would lose four of its seven digits),
//    written with a copy of dt to scratch padded to whole tiles; the chunk's
//    total; and, for every chunk but the last, its own contribution to the
//    state, S = B^T diag(e^{total - cum_u} dt_u) x (N x P).
//    With three chunks or more, ssd_pass_kernel then runs the pass
//    H_{c+1} = e^{total_c} H_c + S_c over each row's chunks in place (with
//    two, H_1 = S_0 and it is not launched).
// 2. ssd_scan_kernel, a block per (batch row, chunk, pair of t tiles, head
//    group).  The block forms G = C_t B_u^T for its t tile (64 rows)
//    and every u up to the tile's end once, in shared memory, and then, for
//    each head of its group, y_t = W x + (e^{cum_t} C_t) H with
//    W = G (.) e^{cum_t - cum_u} dt_u, the exps masked to u <= t BEFORE they
//    are taken (above the diagonal cum_t - cum_u > 0 overflows).  The decay
//    is never factored into e^{cum_t} e^{-cum_u}: e^{+10^3} overflows.
//    The t tiles of a chunk reach 1, 2, ... u tiles, so a block takes tile
//    i and tile nt - 1 - i, and every block of a launch does the same work
//    (a middle tile alone when nt is odd).  Eight warps: four row tiles of
//    16 t times two halves of P (each half forms W for its rows, so W is
//    formed twice: the price of 16 warps an SM where 114 KB of shared
//    memory allow two blocks).
//
// Every product runs on the tensor cores: mma.sync.m16n8k8 in TF32, each
// float operand split as a = hi + lo (hi = a rounded to TF32, lo = the
// rest rounded to TF32) and the product summed as lo.hi + hi.lo + hi.hi in
// float (the small terms and hi . hi in two accumulators, so two chains of
// dependent mma a column tile): about float32's digits, where one TF32
// pass keeps three.  bf16 storage is exact in TF32 (its lo is 0), so
// products with an operand from storage skip that operand's lo pass; W, H
// and w x are float in both.  N is padded to 64 and P to whole column
// tiles (64, or 128 above 64), zero-filled, and rows past Q are zero, so a
// stage's k-steps and column tiles unroll into one basic block that the
// compiler interleaves.  Fragments are read from shared memory with
// strides that put the 32 lanes of a fragment load in 32 banks.  Operands
// are staged 32 rows at a time through a ring of two slots: the next
// stage's 16-byte pieces are in flight (cp.async) while the current one is
// multiplied (a third slot was slower at zamba2's shape).  Float storage
// with N and P multiples of 4 takes cp.async ("vec"); bf16 storage on that
// route is loaded 16 bytes at a time and widened in registers; any other
// shape or alignment element by element ("scalar").  Scratch (cum, dt,
// totals, states) comes from the wrapper.  No atomics: two calls give the
// same bits.  Limits: N <= 64, P <= 128, any Q dividing S; above Q = 256 G
// is kept for a window of 256 u at a time and a block takes one head.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kSsdThreads = 256;   // eight warps: 4 row tiles x 2 column halves
constexpr int kSsdTile = 64;       // rows of a t tile: 16 a warp
constexpr int kSsdStage = 32;      // rows of a ring stage
constexpr int kSsdSlots = 2;       // ring slots: the next stage in flight
constexpr int kSsdWin = 256;       // u columns of G kept: a window
constexpr double kSsdLog2e = 1.4426950408889634;
constexpr int kSsdN = 64;          // N, padded: the state's rows
constexpr int kSsdMaxP = 128;
constexpr int kSsdSide = 896;  // a slot's tcum[64], ucum[32] (double), udt[32]

__host__ __device__ constexpr int ssd_up(int a, int b) {
  return (a + b - 1) / b * b;
}
// Row strides (floats).  Lane (g, t) = (lane / 4, lane % 4) of a fragment
// load reads element (g, t) of an 8 x 4 block: stored [g][t] it wants a
// stride of 4 mod 8, stored [t][g] one of 8 mod 16.
__host__ __device__ constexpr int ssd_stride_gt(int w) {
  return ssd_up(w, 8) + 4;
}
__host__ __device__ constexpr int ssd_stride_tg(int w) {
  return ssd_up(w, 16) + 8;
}

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* lg;
  const void* b;
  const void* c;
  void* y;
  double* cum;     // (rows, nc, qp): the chunk's cumulative sums x log2(e)
  float* dtp;      // (rows, nc, qp): dt, padded like cum
  float* tot;      // (rows, nc): each chunk's total
  float* states;   // (rows, nc - 1, 64, pc): S, then H (ssd_pass_kernel)
  int rows, s, p, n, heads, q;
  int nc, qp, pc;       // chunks, q padded to 64, p to the column tiles
  int hg, vec;          // heads a block, 16-byte route
};

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from 0, on
// the magnitude's bits: cvt.rna's rounding in two integer operations, where
// cvt.rna.tf32.f32 compiles to a longer sequence), lo = v - hi exactly (a
// float of at most 13 significant bits, which the tensor core reads as TF32
// by dropping the low 13 bits of its mantissa: 2^-21 |v| at most).  Exact:
// v is TF32 already (bf16 storage), lo = 0.
template <bool Exact>
__device__ __forceinline__ void ssd_split(float v, uint32_t& hi,
                                          uint32_t& lo) {
  if constexpr (Exact) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void ssd_mma(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b in split TF32: the small terms into dl, hi . hi into d (two
// accumulators: two chains of dependent mma, not one of three).
template <bool ExactA, bool ExactB>
__device__ __forceinline__ void ssd_mma3(float (&d)[4], float (&dl)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  if constexpr (!ExactA) ssd_mma(dl, al, bh);
  if constexpr (!ExactB) ssd_mma(dl, ah, bl);
  ssd_mma(d, ah, bh);
}

template <int NT>
__device__ __forceinline__ void ssd_zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// An A fragment (16 x 8) from four floats: rows g, g + 8; columns t, t + 4.
template <bool Exact>
__device__ __forceinline__ void ssd_split4(const float (&v)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ssd_split<Exact>(v[i], hi[i], lo[i]);
}

__device__ __forceinline__ void ssd_cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void ssd_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void ssd_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, nrows) x columns [0, width) of a shared tile (row stride ld):
// src[r * src_ld + col] where r < rows and col < len, else 0.  vec: 16-byte
// pieces (len a multiple of one, src 16-byte aligned): cp.async for float,
// loaded and widened in registers for bf16; width a multiple of 8.
template <typename T>
__device__ __forceinline__ void ssd_load_rows(float* dst, int ld, int width,
                                              int nrows, const T* src,
                                              size_t src_ld, int rows,
                                              int len, bool vec) {
  if (vec) {
    constexpr int V = 16 / (int)sizeof(T);
    const int per = width / V;
    for (int e = threadIdx.x; e < nrows * per; e += kSsdThreads) {
      const int r = e / per, col = (e - r * per) * V;
      float* d = dst + r * ld + col;
      const bool in = r < rows && col < len;
      if constexpr (sizeof(T) == 4) {
        if (in)
          ssd_cp16(d, src + r * src_ld + col);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (in)
          Vec16<T>::unpack(
              __ldg(reinterpret_cast<const uint4*>(src + r * src_ld + col)),
              v);
        reinterpret_cast<float4*>(d)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(d)[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < nrows * width; e += kSsdThreads) {
      const int r = e / width, col = e - r * width;
      dst[r * ld + col] =
          r < rows && col < len ? to_f(src[(size_t)r * src_ld + col]) : 0.f;
    }
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned scratch, with cp.async,
// by the threads from `first` on.
__device__ __forceinline__ void ssd_copy(void* dst, const void* src,
                                         int bytes, int first) {
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < bytes / 16)
    ssd_cp16(static_cast<char*>(dst) + 16 * i,
             static_cast<const char*>(src) + 16 * i);
}

// cum[0..q) = inclusive prefix sum of cum[0..q), by warp 0: each lane sums
// a run of consecutive entries, a shuffle scan offsets the runs.
__device__ inline void ssd_prefix_sum(double* cum, int q) {
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

__host__ __device__ inline size_t ssd_state_smem(int qp, int pc) {
  return (size_t)qp * 16 + kSsdSlots * sizeof(float) * kSsdStage *
                               (size_t)(ssd_stride_tg(kSsdN) +
                                        ssd_stride_tg(pc));
}

// Launch 1: a block per (row, chunk), the rows of a chunk adjacent (one
// grid axis: gridDim.y would cap the chunks at 65,535).
template <typename T, int NT>
__global__ void __launch_bounds__(kSsdThreads, NT <= 8 ? 2 : 1)
    ssd_state_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int r = blockIdx.x % a.rows, ch = blockIdx.x / a.rows;
  const int q = a.q, qp = a.qp;
  double* cum = reinterpret_cast<double*>(ssd_smem);
  float* dts = reinterpret_cast<float*>(cum + qp);
  float* ws = dts + qp;
  constexpr int sb = ssd_stride_tg(kSsdN), xs = ssd_stride_tg(8 * NT);
  float* ring = ws + qp;   // the slots: B (32 x sb), then x (32 x xs)
  const int slot = kSsdStage * (sb + xs);

  const size_t row0 = (size_t)r * a.s + (size_t)ch * q;
  for (int u = threadIdx.x; u < qp; u += kSsdThreads) {
    cum[u] = u < q ? (double)a.lg[row0 + u] : 0.0;
    dts[u] = u < q ? a.dt[row0 + u] : 0.f;
  }
  __syncthreads();
  ssd_prefix_sum(cum, q);
  __syncthreads();
  const double total = cum[q - 1];
  const size_t pad0 = ((size_t)r * a.nc + ch) * qp;
  for (int u = threadIdx.x; u < qp; u += kSsdThreads) {
    a.cum[pad0 + u] = u < q ? cum[u] * kSsdLog2e : 0.0;   // exp2's exponent
    a.dtp[pad0 + u] = dts[u];
    ws[u] = u < q ? expf((float)(total - cum[u])) * dts[u] : 0.f;
  }
  if (threadIdx.x == 0) a.tot[(size_t)r * a.nc + ch] = (float)total;
  if (ch == a.nc - 1) return;   // the last chunk's state is never read

  // S = B^T (w x): warp w the state rows [16 (w % 4), + 16), column half
  // w / 4
  const T* xr = static_cast<const T*>(a.x) + row0 * a.p;
  const T* br = static_cast<const T*>(a.b) +
                ((size_t)(r / a.heads) * a.s + (size_t)ch * q) * a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, m0 = 16 * (warp & 3);
  constexpr int NH = NT / 2;              // a warp's column tiles
  const int pcol = 8 * NH * (warp >> 2);  // its first column
  const int stages = (q + kSsdStage - 1) / kSsdStage;
  constexpr bool kExact = sizeof(T) == 2;
  float acc[NH][4], accl[NH][4];
  ssd_zero<NH>(acc);
  ssd_zero<NH>(accl);

  auto prefetch = [&](int st, float* dst) {
    const int u0 = st * kSsdStage, rows = min(kSsdStage, q - u0);
    ssd_load_rows<T>(dst, sb, kSsdN, kSsdStage, br + (size_t)u0 * a.n, a.n,
                     rows, a.n, a.vec);
    ssd_load_rows<T>(dst + kSsdStage * sb, xs, 8 * NT, kSsdStage,
                     xr + (size_t)u0 * a.p, a.p, rows, a.p, a.vec);
    ssd_commit();
  };
  prefetch(0, ring);
  for (int st = 0; st < stages; ++st) {
    const float* bs = ring + (st & 1) * slot;
    const float* xsm = bs + kSsdStage * sb;
    if (st + 1 < stages) {
      prefetch(st + 1, ring + ((st + 1) & 1) * slot);
      ssd_wait<1>();
    } else {
      ssd_wait<0>();
    }
    __syncthreads();
    // rows past Q are zero (B, x and w): no k-step is skipped
    {
#pragma unroll
      for (int ks = 0; ks < kSsdStage / 8; ++ks) {
        const int ub = st * kSsdStage + 8 * ks;
        // A = B^T: element (state row m0 + g (+8), u ub + tq (+4))
        const float* b0 = bs + (8 * ks + tq) * sb + m0 + g;
        const float av[4] = {b0[0], b0[8], b0[4 * sb], b0[4 * sb + 8]};
        uint32_t ah[4], al[4];
        ssd_split4<kExact>(av, ah, al);
        const float w0 = ws[ub + tq], w1 = ws[ub + tq + 4];
        const float* x0 = xsm + (8 * ks + tq) * xs + pcol + g;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          uint32_t bh[2], bl[2];
          ssd_split<false>(w0 * x0[8 * j], bh[0], bl[0]);
          ssd_split<false>(w1 * x0[4 * xs + 8 * j], bh[1], bl[1]);
          ssd_mma3<kExact, false>(acc[j], accl[j], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();
  }
  float* sr = a.states + ((size_t)r * (a.nc - 1) + ch) * kSsdN * (8 * NT);
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    const int col = pcol + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(sr + (size_t)(m0 + g) * (8 * NT) + col) =
        make_float2(acc[j][0] + accl[j][0], acc[j][1] + accl[j][1]);
    *reinterpret_cast<float2*>(sr + (size_t)(m0 + g + 8) * (8 * NT) + col) =
        make_float2(acc[j][2] + accl[j][2], acc[j][3] + accl[j][3]);
  }
}

// Launch 1b, where there are three chunks or more: the pass over each
// row's chunks in place, states[c] = H_{c+1} = e^{total_c} H_c + S_c from
// H_0 = 0 (with two chunks H_1 = S_0 and nothing is launched).  A thread
// per four entries of a row's N x P state: pc / 16 blocks a row.
__global__ void __launch_bounds__(kSsdThreads) ssd_pass_kernel(SsdArgs a) {
  const int per = a.pc / 16;
  const int r = blockIdx.x / per;
  const int e = 4 * ((blockIdx.x % per) * kSsdThreads + threadIdx.x);
  const int size = kSsdN * a.pc;
  if (e >= size) return;
  float4* st = reinterpret_cast<float4*>(a.states +
                                         (size_t)r * (a.nc - 1) * size + e);
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < a.nc - 1; ++c) {
    const float d = expf(a.tot[(size_t)r * a.nc + c]);
    const float4 v = st[(size_t)c * size / 4];
    h = make_float4(d * h.x + v.x, d * h.y + v.y, d * h.z + v.z,
                    d * h.w + v.w);
    st[(size_t)c * size / 4] = h;
  }
}

// The output kernel's stage: phase H (32 rows of the entering state), B
// (32 rows of B, forming G's columns; the group's first head only) or X
// (32 rows of x, with their cum and dt).  Per (tile, head): H, then for
// each window of G: B, X.
enum { kSsdH = 0, kSsdB = 1, kSsdX = 2 };
struct SsdStep {
  int tile, head, phase, win, chunk;
};

__host__ __device__ inline size_t ssd_scan_smem(int pc) {
  const int sw = max(ssd_stride_gt(kSsdN), ssd_stride_tg(pc));
  return kSsdSlots * ((size_t)kSsdSide + sizeof(float) * kSsdStage * sw) +
         sizeof(float) * kSsdTile *
             (size_t)(ssd_stride_gt(kSsdWin) + ssd_stride_gt(kSsdN));
}

template <typename T>
__device__ __forceinline__ void ssd_store2(T* y, int col, int p, float v0,
                                           float v1) {
  if (col + 1 < p && (p & 1) == 0) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(y + col) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(y + col) =
          __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < p) y[col] = from_f<T>(v0);
    if (col + 1 < p) y[col + 1] = from_f<T>(v1);
  }
}

// W's element (t, u): G e^{cum_t - cum_u} dt_u, with ct, cu the sums
// times log2(e) (the difference taken in double and rounded once), and
// e^x as ex2.approx (about 2^-22 relative, and 6e-8 |x| from the
// exponent's rounding: negligible beside the bar, and beside the terms
// that large decays leave).  Masked (stages that cross the diagonal or Q):
// the exponent is -inf above the diagonal BEFORE the exp (2^{-inf} = 0),
// and the element selected, without a branch.
template <bool Masked>
__device__ __forceinline__ float ssd_weight(float gv, int t, int u, int q,
                                            double ct, double cu, float dtu) {
  const bool in = !Masked || (u <= t && t < q);
  const float d = in ? (float)(ct - cu) : -INFINITY;
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(d));
  return in ? gv * e * dtu : 0.f;
}

// Launch 2: a block per (pair of t tiles, head group), chunk, batch row,
// in that order on one grid axis.
template <typename T, int NT>
__global__ void __launch_bounds__(kSsdThreads, NT <= 8 ? 2 : 1)
    ssd_scan_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  constexpr int kCols = 8 * NT;
  constexpr int ns = ssd_stride_gt(kSsdN), xs = ssd_stride_tg(kCols);
  constexpr int sw = ns > xs ? ns : xs;
  constexpr int gsw = ssd_stride_gt(kSsdWin), wu = kSsdWin;
  const int q = a.q;
  const size_t slot_bytes = kSsdSide + sizeof(float) * kSsdStage * sw;
  float* gs = reinterpret_cast<float*>(ssd_smem + kSsdSlots * slot_bytes);
  float* cs = gs + kSsdTile * gsw;

  const int nt = (q + kSsdTile - 1) / kSsdTile, npair = (nt + 1) / 2;
  const int gp = (a.heads + a.hg - 1) / a.hg * npair;   // blocks a chunk
  const int pair = blockIdx.x % npair, h0 = blockIdx.x % gp / npair * a.hg;
  const int ch = blockIdx.x / gp % a.nc, bat = blockIdx.x / gp / a.nc;
  const int nhd = min(a.hg, a.heads - h0);
  const int ntile = nt - 1 - pair == pair ? 1 : 2;
  const int nh = ch > 0 ? kSsdN / kSsdStage : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3;                // the warp's 16 rows of the tile
  const int g = lane >> 2, tq = lane & 3, trow = 16 * wr + g;
  constexpr int NH = NT / 2;              // and its half of the columns
  const int pcol = 8 * NH * (warp >> 2);
  constexpr bool kExact = sizeof(T) == 2;
  // the small terms' own accumulators where registers allow (P <= 64)
  constexpr bool kSplitAcc = NH <= 4;

  const T* xg = static_cast<const T*>(a.x);
  const T* bg = static_cast<const T*>(a.b);
  const T* cg = static_cast<const T*>(a.c);
  const size_t bc0 = (size_t)bat * a.s + (size_t)ch * q;   // chunk's B/C row
  // a block's tiles: the pair's later tile first
  auto tile_of = [&](int ti) { return ti == 0 ? nt - 1 - pair : pair; };
  auto span = [&](int ti) {
    return min(tile_of(ti) * kSsdTile + kSsdTile, q);
  };
  auto wins = [&](int ti) { return (span(ti) + wu - 1) / wu; };
  auto chunks = [&](int ti, int w) {
    return (min(wu, span(ti) - w * wu) + kSsdStage - 1) / kSsdStage;
  };
  // the next stage; false past the block's last
  auto advance = [&](SsdStep& st) {
    ++st.chunk;
    for (;;) {
      const int len = st.phase == kSsdH   ? nh
                      : st.phase == kSsdB ? (st.head == 0
                                                 ? chunks(st.tile, st.win)
                                                 : 0)
                                          : chunks(st.tile, st.win);
      if (st.chunk < len) return true;
      st.chunk = 0;
      if (st.phase == kSsdH) {
        st.phase = kSsdB;
        st.win = 0;
      } else if (st.phase == kSsdB) {
        st.phase = kSsdX;
      } else if (++st.win < wins(st.tile)) {
        st.phase = kSsdB;
      } else {
        st.win = 0;
        st.phase = kSsdH;
        if (++st.head == nhd) {
          st.head = 0;
          if (++st.tile == ntile) return false;
        }
      }
    }
  };
  auto side = [&](int sl, double*& tcum, double*& ucum, float*& udt,
                  float*& tile) {
    unsigned char* base = ssd_smem + sl * slot_bytes;
    tcum = reinterpret_cast<double*>(base);
    ucum = tcum + kSsdTile;
    udt = reinterpret_cast<float*>(ucum + kSsdStage);
    tile = udt + kSsdStage;
  };
  auto load_c = [&](int ti) {   // the tile's C rows, with the next group
    const int t0 = tile_of(ti) * kSsdTile;
    ssd_load_rows<T>(cs, ns, kSsdN, kSsdTile, cg + (bc0 + t0) * a.n, a.n,
                     min(kSsdTile, q - t0), a.n, a.vec);
  };
  auto prefetch = [&](const SsdStep& st, int sl) {
    double *tcum, *ucum;
    float *udt, *tile;
    side(sl, tcum, ucum, udt, tile);
    const int t0 = tile_of(st.tile) * kSsdTile;
    const int r = bat * a.heads + h0 + st.head;
    const size_t pad0 = ((size_t)r * a.nc + ch) * a.qp;
    if (st.phase != kSsdB)
      ssd_copy(tcum, a.cum + pad0 + t0, 8 * kSsdTile, 0);
    if (st.phase == kSsdH) {   // H_ch = states[ch - 1] (ssd_pass_kernel)
      const int n0 = st.chunk * kSsdStage;
      const float* h = a.states + ((size_t)r * (a.nc - 1) + ch - 1) * kSsdN *
                                      kCols;
      ssd_load_rows<float>(tile, xs, kCols, kSsdStage, h + n0 * kCols, kCols,
                           kSsdStage, kCols, true);
    } else {
      const int u0 = st.win * wu + st.chunk * kSsdStage;
      const int rows = min(kSsdStage, q - u0);
      if (st.phase == kSsdB) {
        ssd_load_rows<T>(tile, ns, kSsdN, kSsdStage, bg + (bc0 + u0) * a.n,
                         a.n, rows, a.n, a.vec);
      } else {
        ssd_load_rows<T>(tile, xs, kCols, kSsdStage,
                         xg + ((size_t)r * a.s + (size_t)ch * q + u0) * a.p,
                         a.p, rows, a.p, a.vec);
        ssd_copy(ucum, a.cum + pad0 + u0, 8 * kSsdStage, 32);
        ssd_copy(udt, a.dtp + pad0 + u0, 4 * kSsdStage, 48);
      }
    }
    ssd_commit();
  };

  // the next stage is in flight while cur is multiplied; the second
  // tile's C rows replace the first's once its stages are done (one wait a
  // block)
  float acc[NH][4], accl[NH][4];
  SsdStep cur{0, 0, kSsdH, 0, -1};
  advance(cur);
  load_c(0);
  prefetch(cur, 0);
  for (int sl = 0;; sl ^= 1) {
    SsdStep nxt = cur;
    const bool more = advance(nxt);
    if (more) {
      prefetch(nxt, sl ^ 1);
      ssd_wait<1>();
    } else {
      ssd_wait<0>();
    }
    __syncthreads();
    double *tcum, *ucum;
    float *udt, *tile;
    side(sl, tcum, ucum, udt, tile);
    const int t0 = tile_of(cur.tile) * kSsdTile;
    const int tlast = t0 + 16 * wr + 15;   // the warp's last t
    if (cur.phase == kSsdB) {
      // G's columns [u0, u0 + 32) of the window: C_t (64 x N) B_u^T, a
      // warp 16 of them
      const int u0 = cur.win * wu + cur.chunk * kSsdStage;
      const int uh = 16 * (warp >> 2);
      if (u0 + uh <= tlast) {
        float gacc[2][4], gaccl[2][4];
        ssd_zero<2>(gacc);
        ssd_zero<2>(gaccl);
#pragma unroll
        for (int kk = 0; kk < kSsdN; kk += 8) {
          const float* c0 = cs + trow * ns + kk + tq;
          const float av[4] = {c0[0], c0[8 * ns], c0[4], c0[8 * ns + 4]};
          uint32_t ah[4], al[4];
          ssd_split4<kExact>(av, ah, al);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float* b0 = tile + (uh + 8 * j + g) * ns + kk + tq;
            uint32_t bh[2], bl[2];
            ssd_split<kExact>(b0[0], bh[0], bl[0]);
            ssd_split<kExact>(b0[4], bh[1], bl[1]);
            ssd_mma3<kExact, kExact>(gacc[j], gaccl[j], ah, al, bh, bl);
          }
        }
        const int gc = cur.chunk * kSsdStage + uh + 2 * tq;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* g0 = gs + trow * gsw + gc + 8 * j;
          g0[0] = gacc[j][0] + gaccl[j][0];
          g0[1] = gacc[j][1] + gaccl[j][1];
          g0[8 * gsw] = gacc[j][2] + gaccl[j][2];
          g0[8 * gsw + 1] = gacc[j][3] + gaccl[j][3];
        }
      }
    } else {
      if (cur.chunk == 0 &&
          (cur.phase == kSsdH || (nh == 0 && cur.win == 0))) {
        ssd_zero<NH>(acc);   // the head's first stage
        ssd_zero<NH>(accl);
      }
      const int ta = t0 + trow, tb = ta + 8;   // the thread's two rows
      if (cur.phase == kSsdH) {
        // (e^{cum_t} C_t) H over state rows [n0, n0 + 32)
        const float e0 = ta < q ? exp2f((float)tcum[trow]) : 0.f;
        const float e1 = tb < q ? exp2f((float)tcum[trow + 8]) : 0.f;
#pragma unroll
        for (int ks = 0; ks < kSsdStage / 8; ++ks) {
          const int kb = cur.chunk * kSsdStage + 8 * ks;
          const float* c0 = cs + trow * ns + kb + tq;
          const float av[4] = {c0[0] * e0, c0[8 * ns] * e1, c0[4] * e0,
                               c0[8 * ns + 4] * e1};
          uint32_t ah[4], al[4];
          ssd_split4<false>(av, ah, al);
          const float* h0p = tile + (8 * ks + tq) * xs + pcol + g;
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            uint32_t bh[2], bl[2];
            ssd_split<false>(h0p[8 * j], bh[0], bl[0]);
            ssd_split<false>(h0p[4 * xs + 8 * j], bh[1], bl[1]);
            ssd_mma3<false, false>(acc[j], kSplitAcc ? accl[j] : acc[j], ah,
                                   al, bh, bl);
          }
        }
      } else {
        // W x over u rows [u0, u0 + 32): W from G, cum and dt; a warp
        // whose rows all lie above the stage skips it, the others run
        // every k-step (rows past the diagonal or Q weigh 0)
        const int u0 = cur.win * wu + cur.chunk * kSsdStage;
        const double ct0 = tcum[trow], ct1 = tcum[trow + 8];
        // k-steps of the stage; masked where it crosses the diagonal or Q
        auto x_steps = [&](auto masked) {
          constexpr bool M = decltype(masked)::value;
#pragma unroll
          for (int ks = 0; ks < kSsdStage / 8; ++ks) {
            const int ua = u0 + 8 * ks + tq, uc = ua + 4, k0 = 8 * ks + tq;
            const float* g0 =
                gs + trow * gsw + cur.chunk * kSsdStage + 8 * ks + tq;
            const float av[4] = {
                ssd_weight<M>(g0[0], ta, ua, q, ct0, ucum[k0], udt[k0]),
                ssd_weight<M>(g0[8 * gsw], tb, ua, q, ct1, ucum[k0], udt[k0]),
                ssd_weight<M>(g0[4], ta, uc, q, ct0, ucum[k0 + 4],
                              udt[k0 + 4]),
                ssd_weight<M>(g0[8 * gsw + 4], tb, uc, q, ct1, ucum[k0 + 4],
                              udt[k0 + 4])};
            uint32_t ah[4], al[4];
            ssd_split4<false>(av, ah, al);
            const float* x0 = tile + k0 * xs + pcol + g;
#pragma unroll
            for (int j = 0; j < NH; ++j) {
              uint32_t bh[2], bl[2];
              ssd_split<kExact>(x0[8 * j], bh[0], bl[0]);
              ssd_split<kExact>(x0[4 * xs + 8 * j], bh[1], bl[1]);
              ssd_mma3<false, kExact>(acc[j], kSplitAcc ? accl[j] : acc[j],
                                      ah, al, bh, bl);
            }
          }
        };
        if (u0 + kSsdStage - 1 <= t0 + 16 * wr && tlast < q)
          x_steps(std::false_type{});   // wholly below the warp's rows
        else if (u0 <= tlast)
          x_steps(std::true_type{});
      }
      if (!more || nxt.tile != cur.tile || nxt.head != cur.head) {
        const int r = bat * a.heads + h0 + cur.head;
        T* yr = static_cast<T*>(a.y) +
                ((size_t)r * a.s + (size_t)ch * q) * a.p;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int col = pcol + 8 * j + 2 * tq;
          if (col >= a.p) continue;
          if (ta < q)
            ssd_store2<T>(yr + (size_t)ta * a.p, col, a.p,
                          acc[j][0] + accl[j][0], acc[j][1] + accl[j][1]);
          if (tb < q)
            ssd_store2<T>(yr + (size_t)tb * a.p, col, a.p,
                          acc[j][2] + accl[j][2], acc[j][3] + accl[j][3]);
        }
      }
    }
    __syncthreads();
    if (!more) break;
    if (nxt.tile != cur.tile) {
      load_c(nxt.tile);
      ssd_commit();
      ssd_wait<0>();
      __syncthreads();
    }
    cur = nxt;
  }
}

// The three grids (one axis each), or 0 where one passes 2^31 - 1 blocks.
static bool ssd_grids(const SsdArgs& a, long long (&g)[3]) {
  const long long nt = (a.q + kSsdTile - 1) / kSsdTile;
  g[0] = (long long)a.rows * a.nc;
  g[1] = (long long)a.rows * (a.pc / 16);
  g[2] = (a.heads + a.hg - 1) / a.hg * ((nt + 1) / 2) * (long long)a.nc *
         (a.rows / a.heads);
  return g[0] <= INT_MAX && g[1] <= INT_MAX && g[2] <= INT_MAX;
}

template <typename T, int NT>
static cudaError_t launch_ssd(const SsdArgs& a, cudaStream_t stream) {
  long long g[3];
  if (!ssd_grids(a, g)) return cudaErrorInvalidConfiguration;
  const size_t s1 = ssd_state_smem(a.qp, a.pc);
  const size_t s2 = ssd_scan_smem(a.pc);
  cudaError_t e = allow_smem(ssd_state_kernel<T, NT>, s1);
  if (e != cudaSuccess) return e;
  e = allow_smem(ssd_scan_kernel<T, NT>, s2);
  if (e != cudaSuccess) return e;
  ssd_state_kernel<T, NT><<<(unsigned)g[0], kSsdThreads, s1, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.nc > 2) {
    ssd_pass_kernel<<<(unsigned)g[1], kSsdThreads, 0, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  ssd_scan_kernel<T, NT><<<(unsigned)g[2], kSsdThreads, s2, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace repro

// The shared memory of ssd_state_kernel (out[0]) and ssd_scan_kernel
// (out[1]) at the padded widths pc and qp.
extern "C" int repro_ssd_smem(int pc, int qp, int* out) {
  out[0] = (int)repro::ssd_state_smem(qp, pc);
  out[1] = (int)repro::ssd_scan_smem(pc);
  return 0;
}

// Scratch (the wrapper's torch.empty, laid out by tuning.ssd_plan): cum
// (bh, nc, qp) double, dtp (bh, nc, qp) float, tot (bh, nc) float, states
// (bh, nc - 1, 64, pc) float: qp is Q padded to 64, N is padded to 64 and
// pc, the kernels' column tiles, is 64 or 128 and at least P.  hg heads a
// block (1 where Q > 256: G by windows); vec: x, b, c 16-byte aligned and
// N, P multiples of a 16-byte piece.  Launches: ssd_state_kernel,
// ssd_pass_kernel where there are three chunks or more, ssd_scan_kernel.
extern "C" int repro_ssd_scan(const void* x, int is_bf16, const float* dt,
                              const float* lg, const void* b, const void* c,
                              void* y, void* cum, void* dtp, void* tot,
                              void* states, int bh, int s, int p, int n,
                              int heads, int q, int pc, int qp, int hg,
                              int vec, void* stream) {
  namespace r = repro;
  if (n < 1 || p < 1 || n > r::kSsdN || p > r::kSsdMaxP || q < 1 ||
      s % q != 0 || heads < 1 || bh % heads != 0 || hg < 1 ||
      (q > r::kSsdWin && hg != 1) || (pc != 64 && pc != 128) || pc < p ||
      qp % r::kSsdTile != 0 || qp < q)
    return cudaErrorInvalidValue;
  const r::SsdArgs a{x, dt, lg, b, c, y,
                     static_cast<double*>(cum), static_cast<float*>(dtp),
                     static_cast<float*>(tot), static_cast<float*>(states),
                     bh, s, p, n, heads, q,
                     s / q, qp, pc,
                     hg, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pc == 64)
    return is_bf16 ? r::launch_ssd<r::bf16, 8>(a, st)
                   : r::launch_ssd<float, 8>(a, st);
  return is_bf16 ? r::launch_ssd<r::bf16, 16>(a, st)
                 : r::launch_ssd<float, 16>(a, st);
}
