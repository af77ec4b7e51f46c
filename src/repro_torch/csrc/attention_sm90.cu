// Blockwise (online-softmax) attention with GQA, causal masking and a
// sliding window, for bfloat16 q, k and v, on the tensor cores:
//
//   o[b, h, i] = softmax_k(scale q[b, h, i] . k[b, h / g, k]  over the
//                          keys inside row i's mask) v[b, h / g, k]
//
// The conventions are attention.cu's (queries aligned to the END of the
// key axis, kpos <= qpos causal, kpos > qpos - window, a row with no key
// writes 0, the output laid out as (b, sq, hq, d)); float32 calls keep
// that file's kernel, which computes in full float32 on the CUDA cores.
//
// Replaces repro/kernels/attention.py::attention for bf16 storage, the
// Pallas kernel that walks a (b*hq, q tile, k tile) grid with the running
// max, normaliser and accumulator in VMEM scratch.
//
// Bound: at zamba2's prefill, (2, 32, 512, 112) bf16 causal, q, k, v and o
// are 29.4 MB (0.0088 ms at 3.35 TB/s) and the causal half of the products
// is 3.76 GFLOP (0.0038 ms at 989 TFLOP/s bf16): bytes bound, and only
// wgmma reaches the bf16 rate (the float32 kernel's floor is 0.056 ms at
// 67 TFLOP/s).
//
// Design: one consumer warpgroup on 64-row query tiles, two CTAs an SM
// (at zamba2's prefill, 512 CTAs).  Two consumer warpgroups on 128-row
// tiles with a producer warpgroup that gives up registers (setmaxnreg)
// were built and ran slower on the H100 without ping-pong scheduling
// between the warpgroups (PERF.md), so this shape stays.
// A CTA of 160 threads per (64-query tile, batch x query head): warps 0-3
// are the consumer warpgroup, warp 4 the producer.  The grid's y axis runs
// the query tiles from the last (the heaviest under a causal mask) to the
// first, so the first wave takes the longest tiles.
//   - Loads: TMA, one lane of the producer warp.  Each of q, k and v has a
//     4-D tensor map (d, s, h, b) over its own strides (the model's
//     head-transposed views (b, h, s, d) of a (b, s, h, d) buffer need no
//     copy), with a box of 64 columns x 64 positions and the 128-byte
//     swizzle.  The Q tile is loaded once; K and V tiles of 64 keys go
//     through two rings of kStages = 2 stages, each stage with a `full`
//     mbarrier (the copies' bytes) and an `empty` one (the 128 consumer
//     threads' arrivals).  The rings are apart because a K stage frees as
//     soon as its S is computed, a V stage only after its P V: the
//     producer has the next tiles' copies in flight while the consumers
//     compute.  Key tiles outside the causal or window horizon are never
//     loaded; rows past sq or skv are zero-filled by TMA and masked in
//     registers.  GQA: query head h reads kv head h / g in place.
//   - Overlap: tile t's S = Q K_t^T is issued with O += P_{t-1} V_{t-1}
//     as two wgmma groups; the consumers wait for the first alone (groups
//     complete in order) and run tile t's softmax while the tensor cores
//     finish P V.  On the H100 this ran faster than waiting for each
//     product in turn, and a variant with one V stage (three CTAs an SM)
//     spilled registers and ran slower (PERF.md).
//   - S = Q K^T: 4 d_pad / 64 wgmma m64n64k16 per tile, bf16 in, f32
//     accumulators, both operands in shared memory and K-major (each
//     K row is a key, its depth contiguous): the descriptor's start moves
//     32 bytes per 16 columns inside a 128-byte swizzle row, and 8 KB to
//     the second box.
//   - The online softmax runs on the accumulator registers: a thread holds
//     two rows (r and r + 8) of 16 scores; row max and sum are the quad
//     shuffles; scale * log2(e) is folded into one multiply and exp2f.
//     The row sum stays a per-thread partial (its rescaling is uniform
//     across the quad) and is reduced once, in the epilogue.  Interior
//     tiles (every key inside every row's mask) skip the per-entry mask.
//   - P is rounded to bf16 in registers: the S accumulator layout of 16
//     columns is the A-fragment layout of a k16 step, so P needs no trip
//     through shared memory.  O += P V runs on wgmma m64n{d_pad}k16 with A
//     from registers and V MN-major in shared memory (the depth
//     contiguous; the descriptor's imm-trans-b bit transposes it): leading
//     byte offset 8 KB (the next 64 columns, the second box), stride byte
//     offset 1 KB (the next 8 keys).  P rounded to bf16 before P V is a
//     deliberate difference from the JAX kernel, which keeps P in float32
//     (ROADMAP queue 3); the bf16 bar (2e-2) holds.
//   - Epilogue: O / l by rows, bf16 pairs stored from registers; columns
//     past d and rows past sq are not stored.
// Traps, handled:
//   - d = 112: a bf16 row is 224 bytes, more than the 128-byte swizzle
//     span.  Every tile is two 64-column boxes; the second covers columns
//     64-127, and TMA zero-fills 112-127 because they lie past the map's
//     inner dimension (d), so the products over the padded depth are exact.
//     d_pad = 128 for P V; the same for every 64 < d <= 128, one box for
//     d <= 64.
//   - TMA needs a 16-byte-aligned base and strides that are multiples of
//     16 bytes.  The model's views satisfy it (zamba2: position stride
//     7,168 bytes, head stride 224); where a caller's tensor does not, the
//     wrapper copies it into a zero-padded aligned layout first (a layout
//     copy, counted in attention.layout_copies; never another kernel).
//   - cuTensorMapEncodeTiled lives in libcuda, not the runtime: it is
//     fetched once through cudaGetDriverEntryPoint(ByVersion), so nothing
//     links -lcuda; the maps go to the kernel as __grid_constant__
//     parameters.
//   - wgmma exists only for sm_90a (the build's target).
//   - Shared memory: every tile starts on a 1 KB boundary (the swizzle's
//     period); 80 KB a CTA at d_pad = 128, so two CTAs fit an SM.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 24, cold
// L2): 0.029 ms at zamba2's prefill shape against the float32 kernel's
// 0.313 and scaled_dot_product_attention's 0.024-0.028 (PERF.md, row 20).
// What holds it back: latency, not bytes or products (it runs at 3.3x
// its byte bound); each CTA waits on its first Q load, on each short
// chain of wgmma and on its softmax, with two CTAs an SM to hide them.
#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace repro {
namespace sm90 {

constexpr int kBQ = 64;            // query rows of a CTA
constexpr int kBK = 64;            // keys of a tile
constexpr int kBox = 64;           // bf16 columns of a TMA box (128 bytes)
constexpr int kStages = 2;         // K/V ring depth
constexpr int kConsumers = 128;    // one consumer warpgroup
constexpr int kCtaThreads = kConsumers + 32;   // + the producer warp
constexpr uint32_t kTileBytes = kBQ * kBox * 2;   // one box: 8 KB

template <int NB>
struct Smem {                      // every tile 1 KB aligned
  bf16 q[NB][kBQ * kBox];
  bf16 k[kStages][NB][kBK * kBox];
  bf16 v[kStages][NB][kBK * kBox];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];   // K and V rings apart: a K
  uint64_t v_full[kStages], v_empty[kStages];   // stage frees before its V
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map into shared memory; coordinates innermost
// first (column, position, head, batch).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (bytes, stored in 16-byte units).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are in flight (groups
// complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from touching accumulators across the async wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// S (64 x 64, f32) {+}= A (64 x 16, shared) B (16 x 64, shared), both K-major
// (the depth contiguous), bf16 in, f32 accumulators; scale_d = 0 drops d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64, shared,
// MN-major: the imm-trans-b bit transposes it in the tensor core).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128, f32) += A (64 x 16, bf16 in registers) B (16 x 128, shared,
// MN-major: the imm-trans-b bit transposes it in the tensor core).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NB>
__device__ __forceinline__ void pv_wgmma(float (&o)[32 * NB],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (NB == 1)
    wgmma_m64n64k16_rs(o, a, db);
  else
    wgmma_m64n128k16_rs(o, a, db);
}

// O += P V over one tile of 64 keys: 4 k16 steps, V MN-major (leading
// byte offset 8 KB to the second box of columns, stride 1 KB per 8 keys).
template <int NB>
__device__ __forceinline__ void pv_step(float (&o)[32 * NB],
                                        const uint32_t (&pa)[4][4],
                                        const bf16* v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    pv_wgmma<NB>(o, pa[kk], make_desc(v + kk * 16 * kBox, kTileBytes, 1024));
}

// The online softmax of one tile on the S accumulators: sc[4 c + 2 i + j]
// is row r0 + 8 i, key 8 c + cq + j of the tile.  Updates the running max
// (log2 units) and the thread's partial row sums, leaves P in sc, and
// returns each row's rescaling of O in corr.  kMask: test every entry
// against the rows, skv, the causal and the window masks.
template <bool kMask>
__device__ __forceinline__ void online_softmax(
    float (&sc)[32], float (&m_run)[2], float (&l_run)[2], float (&corr)[2],
    float scale_log2, int r0, int cq, int qn, int qlo, int k0, int skv,
    int causal, int window) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const int qpos = qlo + r;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        if constexpr (kMask) {
          const int kpos = k0 + 8 * c + cq + j;
          bool ok = r < qn && kpos < skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          sc[e] = ok ? sc[e] * scale_log2 : -INFINITY;
        } else {
          sc[e] *= scale_log2;
        }
        mx = fmaxf(mx, sc[e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mnew = fmaxf(m_run[i], mx);
    // a row that has seen no key yet keeps p = 0 and its zero sums
    corr[i] = mnew == -INFINITY ? 1.f : exp2f(m_run[i] - mnew);
    const float mref = mnew == -INFINITY ? 0.f : mnew;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * c + 2 * i + j;
        const float p = exp2f(sc[e] - mref);   // exp2(-inf) = 0
        sc[e] = p;
        rs += p;
      }
    }
    l_run[i] = fmaf(l_run[i], corr[i], rs);
    m_run[i] = mnew;
  }
}

// NB: 64-column boxes per row (d_pad = 64 NB).
template <int NB>
__global__ void __launch_bounds__(kCtaThreads, 2)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           bf16* __restrict__ o, long long os_b,
                           long long os_h, long long os_s, int hq, int group,
                           int sq, int skv, int d, float scale_log2,
                           int causal, int window) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<NB>& sm = *reinterpret_cast<Smem<NB>*>(smem_raw + pad);

  const int bh = blockIdx.x;
  const int bi = bh / hq, h = bh - bi * hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest first
  const int qn = min(kBQ, sq - q0);
  const int qlo = skv - sq + q0;                        // absolute positions
  const int qhi = qlo + qn - 1;
  int klo = 0, khi = skv - 1;                           // keys any row sees
  if (causal) khi = min(khi, qhi);
  if (window > 0) klo = max(klo, qlo - window + 1);
  const int kstart = klo / kBK * kBK;
  const int ntiles = klo <= khi ? (khi - kstart) / kBK + 1 : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers);
      mbar_init(&sm.v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one lane issues every copy --------------------------
    if (tid == kConsumers) {
      mbar_expect_tx(&sm.q_full, NB * kTileBytes);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_4d(sm.q[c], &tq, &sm.q_full, c * kBox, q0, h, bi);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages, k0 = kstart + t * kBK;
        const uint32_t freed = (t / kStages - 1) & 1;
        if (t >= kStages) mbar_wait(&sm.k_empty[s], freed);
        mbar_expect_tx(&sm.k_full[s], NB * kTileBytes);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_4d(sm.k[s][c], &tk, &sm.k_full[s], c * kBox, k0, hk, bi);
        if (t >= kStages) mbar_wait(&sm.v_empty[s], freed);
        mbar_expect_tx(&sm.v_full[s], NB * kTileBytes);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_4d(sm.v[s][c], &tv, &sm.v_full[s], c * kBox, k0, hk, bi);
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, rows r0 and r0 + 8 of each thread -------
  // Tile t's S = Q K_t^T is issued together with O += P_{t-1} V_{t-1}, and
  // the softmax of S_t runs while the tensor cores finish P V: the two
  // wgmma groups complete in order, so waiting for all but one is waiting
  // for S_t alone.
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);        // the thread's column pair in a chunk
  float oacc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) oacc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float sc[32], corr[2];
  uint32_t pa[4][4];                    // P_{t-1}, the A operand of P V

  mbar_wait(&sm.q_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages, sp = (t + kStages - 1) % kStages;
    const int k0 = kstart + t * kBK;
    mbar_wait(&sm.k_full[s], (t / kStages) & 1);
    if (t > 0) mbar_wait(&sm.v_full[sp], ((t - 1) / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const int c = kk / 4, col = (kk % 4) * 16;
      wgmma_m64n64k16_ss(sc, make_desc(&sm.q[c][col], 16, 1024),
                         make_desc(&sm.k[s][c][col], 16, 1024), kk > 0);
    }
    wgmma_commit();
    if (t > 0) {
      pv_step<NB>(oacc, pa, sm.v[sp][0]);
      wgmma_commit();
      wgmma_wait<1>();                  // S_t done; P_{t-1} V_{t-1} flying
    } else {
      wgmma_wait<0>();
    }
    fence_regs(sc);
    mbar_arrive(&sm.k_empty[s]);
    // Interior tiles (every key inside every row's mask, every row and key
    // in range) skip the per-element mask.
    const bool interior = qn == kBQ && k0 + kBK <= skv &&
                          (!causal || k0 + kBK - 1 <= qlo) &&
                          (window <= 0 || k0 > qhi - window);
    if (interior)
      online_softmax<false>(sc, m_run, l_run, corr, scale_log2, r0, cq, qn,
                            qlo, k0, skv, causal, window);
    else
      online_softmax<true>(sc, m_run, l_run, corr, scale_log2, r0, cq, qn,
                           qlo, k0, skv, causal, window);
    if (t > 0) {
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pa);
      mbar_arrive(&sm.v_empty[sp]);
    }
#pragma unroll
    for (int c = 0; c < 8 * NB; ++c) {
      oacc[4 * c] *= corr[0];
      oacc[4 * c + 1] *= corr[0];
      oacc[4 * c + 2] *= corr[1];
      oacc[4 * c + 3] *= corr[1];
    }
    // P (bf16) as the A operand of 4 k16 steps: keys 16 kk .. 16 kk + 15
    // are accumulator chunks 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
  if (ntiles > 0) {                     // the last tile's P V
    const int sp = (ntiles - 1) % kStages;
    mbar_wait(&sm.v_full[sp], ((ntiles - 1) / kStages) & 1);
    wgmma_fence();
    pv_step<NB>(oacc, pa, sm.v[sp][0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pa);
  }

  // ---- epilogue: O / l, rows past sq and columns past d not stored ------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + 8 * i;
    if (r >= qn) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;   // no key: 0
    bf16* orow = o + bi * os_b + h * os_h + (long long)(q0 + r) * os_s;
#pragma unroll
    for (int c = 0; c < 8 * NB; ++c) {
      const int col = 8 * c + cq;
      const float v0 = oacc[4 * c + 2 * i] * inv;
      const float v1 = oacc[4 * c + 2 * i + 1] * inv;
      if (col + 1 < d &&
          (reinterpret_cast<uintptr_t>(orow + col) & 3) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(v0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// ---- host: tensor maps and the launch -----------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (b, h, s, d) bf16 tensor with element strides (sb, sh, ss, 1) as a 4-D
// map, innermost first; a box is 64 columns x 64 positions, 128-byte
// swizzle, zero fill past every edge.
static bool make_map(EncodeTiledFn encode, CUtensorMap* map,
                     const void* base, int b, int h, int s, int d,
                     const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {kBox, kBK, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
static cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                          const CUtensorMap& tv, bf16* o,
                          const long long* os, int b, int hq, int hkv,
                          int sq, int skv, int d, float scale, int causal,
                          int window, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<NB>) + 1024;
  cudaError_t e = allow_smem(attention_wgmma_kernel<NB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  attention_wgmma_kernel<NB><<<grid, kCtaThreads, smem, stream>>>(
      tq, tk, tv, o, os[0], os[1], os[2], hq, hq / hkv, sq, skv, d,
      scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace repro

// bf16 q (b, hq, sq, d), k and v (b, hkv, skv, d), o (b, hq, sq, d) laid
// out by its strides; strides: 12 long longs, (batch, head, position) of
// q, k, v, o in turn, the last axis contiguous.  q, k and v: 16-byte
// aligned, their strides multiples of 8 elements (the wrapper's plan copies
// a tensor that is not).
extern "C" int repro_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* o, int b, int hq,
                                     int hkv, int sq, int skv, int d,
                                     const long long* strides, float scale,
                                     int causal, int window, void* stream) {
  using namespace repro::sm90;
  if (d < 1 || d > 2 * kBox || hkv < 1 || hq % hkv != 0 || b < 1 ||
      sq < 1 || skv < 1 || (sq + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, b, hq, sq, d, strides) ||
      !make_map(encode, &tk, k, b, hkv, skv, d, strides + 3) ||
      !make_map(encode, &tv, v, b, hkv, skv, d, strides + 6))
    return cudaErrorInvalidValue;
  repro::bf16* ot = static_cast<repro::bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d > kBox ? launch<2>(tq, tk, tv, ot, strides + 9, b, hq, hkv, sq,
                              skv, d, scale, causal, window, s)
                  : launch<1>(tq, tk, tv, ot, strides + 9, b, hq, hkv, sq,
                              skv, d, scale, causal, window, s);
}
