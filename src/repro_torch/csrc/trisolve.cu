// Banded ILU(0): the triangular sweeps of its apply, and its setup.
//
// (1) The sweep.  For a band stack (nbands, n) with offsets all <= 0
//     (lower) or all >= 0 (upper), solve L z = v row by row:
//
//       z_i = (v_i - sum_{off != 0} b_{off,i} z_{i+off}) / b_{0,i}
//
//     (no division with a unit diagonal), forward for lower, backward for
//     upper; terms whose column is outside [0, n) count as zero.  v and z
//     are (k, n): k right-hand sides.  An upper sweep is the lower one read
//     back to front (logical row p is physical row n - 1 - p): no flipped
//     copies.
//
//     Replaces repro/kernels/trisolve.py::banded_trisweep_kernel (body
//     _trisweep_kernel).  The TPU kernel walks the rows one at a time in
//     sequential row blocks, the last K = max|off| solved entries carried
//     in a VMEM ring, and runs an upper sweep as the lower sweep of flipped
//     copies of the bands and v.
//
//     Row i's map: z_i = a_i z_{i-1} + b_i, a_i = -b_{-1,i} / d_i and
//     b_i = (v_i - sum_far b_{off,i} z_{i+off}) / d_i (far: |off| >= 2).
//     Maps compose, (a2 a1, a2 b1 + b2), so a run of rows whose far terms
//     are already solved is one scan.  Two routes, picked by the wrapper
//     (kernels/tuning.py::trisweep_plan) and counted by it:
//
//     Bound: bytes, nbands * n * s + 8 n per right-hand side (bands, v, z):
//     16.8 MB for the five-point stencil's ILU(0) L and 21.0 MB for its U
//     at n = 2^20 (0.0050 and 0.0063 ms at 3.35 TB/s); 12.6 / 16.8 MB for
//     line-Jacobi's (0.0038 / 0.0050 ms).
//
//     The first design was one block of 1,024 threads per
//     right-hand side walking n / c chunks of c = min(nearest far offset,
//     1,024) rows, or n / 1,024 chunks without a far band: each chunk
//     loaded its bands and v only when it started (an HBM round trip on
//     the chain), read its far terms back through L2, and took three block
//     barriers around a two-level shuffle scan: 1.5-2 us a chunk, 1.09-2.05
//     ms a sweep at 1024^2, 131 SMs idle (PERF.md section 6, row 19).
//
//     Route "scan" (no far band: every |off| <= 1, line-Jacobi's factors,
//     any bi- or tridiagonal one): all n rows are one inclusive scan of
//     maps, shared by every SM.  A persistent cooperative grid (at most
//     tuning.TRISWEEP_SCAN_BLOCKS_PER_SM blocks an SM of kThreads) walks
//     tiles of kScanTile rows, k right-hand sides as k x tiles tiles of one
//     launch.  A thread holds the maps of 8 consecutive rows (its bands
//     and v in 16-byte loads where aligned), composes them, and a warp
//     shuffle scan and the warps in order give the tile's aggregate, which
//     goes to agg[tile].  One grid barrier; then each tile folds the
//     aggregates of the tiles before it in a fixed order (a warp scan of
//     each 32, the warps applied to the carry in order), reads its rows
//     again (from L2) and applies its prefix to them.  (At 1024^2 two
//     blocks an SM, which read again, measured faster than the four that
//     gave every tile its own block and kept its rows in registers across
//     the barrier; PERF.md section 6.)  Not
//     decoupled look-back: there the prefix of a tile composes whichever
//     predecessors have published, so the bits can change from run to run;
//     here every association is fixed by (n, k) alone, and the one grid
//     barrier costs about what a look-back chain would, since every tile's
//     aggregate is ready at the same time.
//
//     Route "chunk" (far bands: ILU(0)'s (-1024, -1) and (0, 1, 1024), the
//     random (-2, -1, 0)): chunks of L rows (L = min(c, 1024), halved
//     where a far offset is neither a multiple of L nor at least 2L), so
//     a chunk's far terms are solved in earlier chunks, one block per
//     right-hand side walks the chain of n / L chunks, and each link is
//     made cheap:
//     (a) the bands and v of the next stages - 1 chunks are in flight
//         (cp.async into a ring of up to kChunkMaxStages stages in shared
//         memory; each thread copies and reads only its own rows, in
//         vector loads, so no barrier guards them); misaligned operands
//         (tuning.trisweep_plan's vec = 0) load one chunk at a time;
//     (b) a far term L back (ILU(0)'s) is the thread's own z of the
//         previous chunk, in registers; others come from a ring of the
//         last `ring` solved entries in shared memory (a power of two >=
//         max|off| + L) or, where it does not fit, from z itself through
//         L2 (route "chunk_l2"), read once every warp has finished the
//         chunk two back: no warp is then more than two chunks ahead of
//         another, so no ring entry is written again before it is read;
//     (c) no block barrier: the chunk is cut into strips of 32 R rows, a
//         warp each, R = kChunkRows consecutive rows a lane.  A warp composes its
//         lanes' maps and scans them (one 5-level shuffle scan), then
//         takes the carry (z before its strip) from the warp before it
//         through shared memory, solves its rows and hands its own carry
//         on; warps work on different chunks at once, so the chain costs
//         about chunks x one warp's step + strips x one hand-off.  The
//         first warp waits for the last warp's carry of the previous
//         chunk only where the chunk's first map couples to it (a != 0):
//         a grid stencil's factors have no near entry at a grid row's
//         start, and there 0 x carry changes no bit.
//     A first version of this route kept a block-wide scan, one barrier a
//     chunk: 1.34 / 1.94 ms for ILU(0)'s L / U, its chain with nothing
//     loaded 1.07 / 1.45 ms (H100 80GB HBM3, 700 W), so the scan, not the
//     loads, set the pace (PERF.md section 6).
//     The chain floor: chunks x the latency of one link with nothing
//     loaded (repro_trisweep_probe runs the same warps on register data),
//     measured in chip_smoke.py beside the byte bound (PERF.md).
//
//     Both routes sum in another order than the sequential substitution
//     and the plain version; every association is fixed, so two runs give
//     the same bits.
//
// (2) The setup.  ILU(0) of a band stack restricted to its own pattern:
//     row i eliminates its lower entries l (most negative first) against
//     the factored row i + l (rows before 0 are unit-diagonal rows),
//
//       l_i = a_{i,l} / u_{i+l,0};  a_{i,u+l} -= l_i u_{i+l,u}
//
//     for each upper offset u with u + l on the pattern, then guards its
//     pivot: |p| < max(max_j |a_{i,j}| eps, tiny^(1/2)) becomes that floor
//     with p's sign.  Out-of-range entries are zeroed first.  The factors
//     are written in f32, (nbands, n) in the offsets' order.
//
//     Replaces repro/kernels/trisolve.py::_ilu0_factor, a lax.scan with no
//     Pallas in it that carries the last K factored rows in a ring.
//
//     Bound: bytes, nbands * n * (s + 4) (20.9 MB at the 1024 x 1024
//     five-point stencil, 0.0063 ms), but it is a recurrence over all n
//     rows: row i needs rows i - 1 and i - K.
//
//     Design: one thread walks the rows.  The offset combinatorics are
//     resolved on the host into an IluPlan passed by value (the lower
//     offsets in order, and for each the (upper band, target band) pairs
//     it updates), read at constant indices in unrolled loops, and the
//     row is held in registers, kMaxIluBands floats read and written only
//     at constant indices.  The ring is the output itself: row i + l is
//     read back from the factors the thread wrote.  (A shared-memory ring
//     of the last K rows was no faster: the single thread's chain of
//     dependent instructions, not the ring, sets the pace; PERF.md.)
//     Every product and sum is rounded as the plain version rounds it (no
//     fused multiply-add), and the division is IEEE, so the factors match
//     the plain version's bits.
#include "common.cuh"

#include <algorithm>
#include <vector>

namespace repro {

constexpr int kMaxIluBands = 16;

// ---------------------------------------------------------------------------
// Maps x -> a x + b, composed in a fixed order.
// ---------------------------------------------------------------------------

// (a2, b2) after (a1, b1): x -> a2 (a1 x + b1) + b2.
__device__ __forceinline__ void compose(float a1, float b1, float* a2,
                                        float* b2) {
  *b2 = fmaf(*a2, b1, *b2);
  *a2 = *a2 * a1;
}

// (A, B) followed by (a, b): A, B become the composite.
__device__ __forceinline__ void then(float& A, float& B, float a, float b) {
  B = fmaf(a, B, b);
  A = a * A;
}

// Inclusive scan of one map per lane over the warp (lane 0 first), and the
// exclusive prefix of each lane (the identity for lane 0).
__device__ __forceinline__ void warp_scan(float& a, float& b, float& ea,
                                          float& eb, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float ua = __shfl_up_sync(0xffffffffu, a, o);
    const float ub = __shfl_up_sync(0xffffffffu, b, o);
    if (lane >= o) compose(ua, ub, &a, &b);
  }
  ea = __shfl_up_sync(0xffffffffu, a, 1);
  eb = __shfl_up_sync(0xffffffffu, b, 1);
  if (lane == 0) {
    ea = 1.f;
    eb = 0.f;
  }
}

// ---------------------------------------------------------------------------
// Route "scan": no far band, one device-wide scan.
// ---------------------------------------------------------------------------
constexpr int kScanRows = 8;                      // rows a thread holds
constexpr int kScanTile = kThreads * kScanRows;   // rows a tile

// The maps of physical rows 8 pg .. 8 pg + 7 in logical order (back to
// front for an upper sweep); rows past n are identities (they come after
// the last row of a lower sweep and before the first of an upper one).
template <typename T>
__device__ __forceinline__ void scan_maps(const T* __restrict__ near,
                                          const T* __restrict__ diag,
                                          const float* __restrict__ vr,
                                          int pg, int n, int unit,
                                          int reverse, int vec,
                                          float (&a)[kScanRows],
                                          float (&b)[kScanRows]) {
  float vv[kScanRows], nn[kScanRows], dd[kScanRows];
  const int r0 = pg * kScanRows;
  if (vec) {   // n % 8 == 0: the group is whole and 16-byte aligned
    load_floats<float, kScanRows>(vr + r0, vv);
    if (near) {
      load_floats<T, kScanRows>(near + r0, nn);
    } else {
#pragma unroll
      for (int j = 0; j < kScanRows; ++j) nn[j] = 0.f;
    }
    if (diag) {
      load_floats<T, kScanRows>(diag + r0, dd);
    } else {
#pragma unroll
      for (int j = 0; j < kScanRows; ++j) dd[j] = 1.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kScanRows; ++j) {
      const int row = r0 + j;
      const bool ok = row < n;
      vv[j] = ok ? __ldg(vr + row) : 0.f;
      nn[j] = ok && near ? to_f(near[row]) : 0.f;
      dd[j] = ok && diag ? to_f(diag[row]) : 1.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kScanRows; ++i) {
    const int j = reverse ? kScanRows - 1 - i : i;
    const int row = r0 + j;
    if (row >= n) {
      a[i] = 1.f;
      b[i] = 0.f;
      continue;
    }
    // the near term's column (row - 1, or row + 1 back to front) outside
    // [0, n) is the zero halo
    const bool edge = reverse ? row == n - 1 : row == 0;
    float ai = edge ? 0.f : -nn[j], bi = vv[j];
    if (!unit) {
      ai = ai / dd[j];
      bi = bi / dd[j];
    }
    a[i] = ai;
    b[i] = bi;
  }
}

// A tile's scan: each thread composes its rows, a warp scan gives the
// thread's exclusive prefix (ea, eb) inside its warp, the warp totals go
// to shared memory, and every thread composes those of the warps before
// its own (pa, pb).  Thread 0 writes the tile's aggregate to agg (when
// given).  Ends with a barrier: wa, wb are free again.
__device__ __forceinline__ void scan_tile(const float (&a)[kScanRows],
                                          const float (&b)[kScanRows],
                                          float& ea, float& eb, float& pa,
                                          float& pb, float* wa, float* wb,
                                          float* agg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ta = 1.f, tb = 0.f;
#pragma unroll
  for (int i = 0; i < kScanRows; ++i) then(ta, tb, a[i], b[i]);
  warp_scan(ta, tb, ea, eb, lane);
  if (lane == 31) {
    wa[warp] = ta;
    wb[warp] = tb;
  }
  __syncthreads();
  float A = 1.f, B = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      pa = A;
      pb = B;
    }
    then(A, B, wa[w], wb[w]);
  }
  if (agg != nullptr && threadIdx.x == 0) {
    agg[0] = A;
    agg[1] = B;
  }
  __syncthreads();
}

// z entering tile u of a right-hand side: the aggregates of its tiles 0 ..
// u - 1 applied to 0, kThreads at a time (a warp scan each 32, the warps'
// totals applied to the carry in order).  The same operations in every
// thread and every block: a fixed order.
__device__ __forceinline__ float scan_prefix(const float* agg, int u,
                                             float* wa, float* wb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < u; base += kThreads) {
    const int j = base + threadIdx.x;
    float A = 1.f, B = 0.f, ea, eb;
    if (j < u) {
      A = __ldcg(agg + 2 * (size_t)j);   // written by other SMs
      B = __ldcg(agg + 2 * (size_t)j + 1);
    }
    warp_scan(A, B, ea, eb, lane);
    if (lane == 31) {
      wa[warp] = A;
      wb[warp] = B;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) carry = fmaf(wa[w], carry, wb[w]);
    __syncthreads();
  }
  return carry;
}

// Tiles q = t * tiles + u: right-hand side t, rows [u kScanTile, (u + 1)
// kScanTile) in logical order.  agg holds 2 floats a tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    trisweep_scan_kernel(const T* __restrict__ near,
                         const T* __restrict__ diag,
                         const float* __restrict__ v, float* __restrict__ z,
                         float* __restrict__ agg, int n, int tiles,
                         int ntiles, int unit, int reverse, int vec) {
  __shared__ float wa[kWarps], wb[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int ngroups = (n + kScanRows - 1) / kScanRows;
  float a[kScanRows], b[kScanRows];
  float ea = 1.f, eb = 0.f, pa = 1.f, pb = 0.f;
  auto group_of = [&](int u) {   // the thread's physical group, or -1
    const int lg = u * kThreads + threadIdx.x;
    if (lg >= ngroups) return -1;
    return reverse ? ngroups - 1 - lg : lg;
  };
  auto maps = [&](int q) {
    const int t = q / tiles, pg = group_of(q - t * tiles);
    if (pg < 0) {
#pragma unroll
      for (int i = 0; i < kScanRows; ++i) {
        a[i] = 1.f;
        b[i] = 0.f;
      }
    } else {
      scan_maps<T>(near, diag, v + (size_t)t * n, pg, n, unit, reverse, vec,
                   a, b);
    }
  };
  for (int q = blockIdx.x; q < ntiles; q += gridDim.x) {
    maps(q);
    scan_tile(a, b, ea, eb, pa, pb, wa, wb, agg + 2 * (size_t)q);
  }
  grid.sync();
  for (int q = blockIdx.x; q < ntiles; q += gridDim.x) {
    const int t = q / tiles, u = q - t * tiles;
    const float carry = scan_prefix(agg + 2 * (size_t)t * tiles, u, wa, wb);
    maps(q);
    scan_tile(a, b, ea, eb, pa, pb, wa, wb, nullptr);
    const int pg = group_of(u);
    if (pg < 0) continue;
    float zt = fmaf(ea, fmaf(pa, carry, pb), eb);
    float zs[kScanRows];   // physical order
#pragma unroll
    for (int i = 0; i < kScanRows; ++i) {
      zt = fmaf(a[i], zt, b[i]);
      zs[reverse ? kScanRows - 1 - i : i] = zt;
    }
    float* zr = z + (size_t)t * n + (size_t)pg * kScanRows;
    if (vec) {
#pragma unroll
      for (int q4 = 0; q4 < kScanRows / 4; ++q4)
        reinterpret_cast<float4*>(zr)[q4] =
            make_float4(zs[4 * q4], zs[4 * q4 + 1], zs[4 * q4 + 2],
                        zs[4 * q4 + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < kScanRows; ++j)
        if (pg * kScanRows + j < n) zr[j] = zs[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Route "chunk": far bands, a chain of chunks of L rows.
// ---------------------------------------------------------------------------
constexpr int kChunkMaxStages = 8;     // chunks whose loads are in flight
constexpr int kChunkMaxThreads = 256;  // 8 warps, a strip each
constexpr int kChunkMaxWarps = kChunkMaxThreads / 32;
constexpr int kCarrySlots = 4;         // carries in flight between warps
// Rows a lane (R): 8 and 16 were slower at 1024^2 (PERF.md section 6).
constexpr int kChunkRows = 4;

template <int B>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(B)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n - 1 of the thread's copy groups are pending (n
// the stages in flight: 1, 2, 4 or 8).
__device__ __forceinline__ void cp_async_wait_stages(int n) {
  switch (n) {
    case 8:
      asm volatile("cp.async.wait_group 7;\n" ::: "memory");
      break;
    case 4:
      asm volatile("cp.async.wait_group 3;\n" ::: "memory");
      break;
    case 2:
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      break;
    default:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// R consecutive elements of T, global to shared, in 16-byte copies (one
// 8- or 4-byte copy where R elements are fewer bytes).
template <typename T, int R>
__device__ __forceinline__ void cp_async_rows(T* smem, const T* gmem) {
  constexpr int B = R * (int)sizeof(T);
  if constexpr (B >= 16) {
    constexpr int E = 16 / (int)sizeof(T);
#pragma unroll
    for (int q = 0; q < B / 16; ++q) cp_async<16>(smem + q * E, gmem + q * E);
  } else {
    cp_async<B>(smem, gmem);
  }
}

// R consecutive elements of T in shared memory (aligned to their size,
// at most 16 bytes), widened, in vector loads: a warp's lanes read
// neighbouring pieces, so R = 4 has no bank conflict.
template <typename T, int R>
__device__ __forceinline__ void lds_rows(const T* p, float (&o)[R]) {
  constexpr int B = R * (int)sizeof(T);
  if constexpr (B == 8) {   // four bf16
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    o[0] = __uint_as_float(r.x << 16);
    o[1] = __uint_as_float(r.x & 0xffff0000u);
    o[2] = __uint_as_float(r.y << 16);
    o[3] = __uint_as_float(r.y & 0xffff0000u);
  } else {
    static_assert(B % 16 == 0, "whole 16-byte words");
#pragma unroll
    for (int q = 0; q < B / 16; ++q)
      Vec16<T>::unpack(reinterpret_cast<const uint4*>(p)[q],
                       o + q * Vec16<T>::N);
  }
}

// A carry slot: the chunk it belongs to, plus one (0: none yet), in the
// high half and the carry's bits in the low half of one 8-byte word,
// written and read whole, so a reader that sees the tag sees the value
// with it and no fence is needed.
using Slot = unsigned long long;

__device__ __forceinline__ Slot make_slot(float value, int tag) {
  return ((Slot)(unsigned)tag << 32) | (Slot)__float_as_uint(value);
}

__device__ __forceinline__ int slot_tag(Slot s) { return (int)(s >> 32); }

__device__ __forceinline__ float slot_value(Slot s) {
  return __uint_as_float((unsigned)(s & 0xffffffffull));
}

// The slot once its tag is at least `tag` (spinning only where it is
// not yet).
__device__ __forceinline__ Slot wait_slot(const volatile Slot* slot,
                                          int tag) {
  Slot s = *slot;
  if (slot_tag(s) < tag) {
    do {
      s = *slot;
    } while (slot_tag(s) < tag);
  }
  return s;
}

// One block per right-hand side, a pipeline of warps over the strips of a
// chunk: warp s owns positions [32 s R, 32 (s + 1) R) of every chunk, lane
// l of it R consecutive ones (cap = blockDim.x R >= L).  Warp s solves its
// strip of chunk q once it has the carry (z of the row before the strip)
// from warp s - 1 for the same chunk, and hands its own on: no block
// barrier, and warps work on different chunks at once.  Warp 0 takes the
// carry of the last warp for the previous chunk, unless the chunk's first
// map has a = 0 (a grid stencil's row start: no near coupling), where the
// carry cannot change a bit (0 x carry) and it does not wait.  Carries go
// through tagged slots (value and chunk in one 8-byte word), kCarrySlots a
// warp; a warp writes a slot again only once its reader has finished the
// chunk it was for.  The host resolves the bands' roles: the diagonal
// `dd` (-1 for a unit diagonal), the near band `dn`, the far band one
// chunk back `dl` (the thread's own z of the previous chunk, in
// registers); any other far band (back[d] >= 2, != L) comes from the ring
// (or z), read once every warp has finished the chunk two back (fenced
// hand-offs): the entry read is then written, and warp 0, which waits
// too, is at most two chunks ahead of any warp, so the ring (>= max|off|
// + L entries) still holds it, whether or not warp 0 waits for carries.
// Dynamic shared memory (floats first, all 16-byte aligned):
//   ring[ring]               the last solved entries, logical row p at
//                            p & (ring - 1) (0: none, or z read instead)
//   vst[stages][cap]         v of the chunks in flight
//   bst[stages][nbands][cap] their bands, in storage type T
// Stage slot j of a thread's group holds its physical row ps + j (ps the
// lowest), so logical row i is slot i, or R - 1 - i back to front.
// PROBE: no global memory (constants in registers with a stencil's
// structure: no near coupling at a chunk's first row; the registers, the
// scans and the hand-offs as in a sweep) and z[blockIdx.x] = the last
// carry: the chain's floor.
template <typename T, bool PROBE>
__global__ void __launch_bounds__(kChunkMaxThreads)
    trisweep_chunk_kernel(const T* __restrict__ bands, BandOffsets offs,
                          int nbands, int dd, int dn, int dl,
                          const float* __restrict__ v, float* z, int n,
                          int len, int reverse, int ring, int far_l2,
                          int stages, int vec) {
  constexpr int R = kChunkRows;
  extern __shared__ __align__(16) float smem[];
  __shared__ int back[kMaxBands];          // logical distance of each band
  __shared__ Slot cslot[kChunkMaxWarps * kCarrySlots];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int cap = blockDim.x * R;
  const int nst = PROBE ? 0 : stages;
  float* rb = smem;
  float* vst = rb + ring;
  T* bst = reinterpret_cast<T*>(vst + (size_t)nst * cap);
  const float* vr = v + (size_t)blockIdx.x * n;
  float* zr = z + (size_t)blockIdx.x * n;
  const int nchunks = (n + len - 1) / len;
  const int g0 = tid * R;   // the thread's first position in each chunk
  if (tid < nbands) {
#pragma unroll
    for (int d = 0; d < kMaxBands; ++d)   // offs at constant indices
      if (d == tid) back[d] = reverse ? offs.off[d] : -offs.off[d];
  }
  if (tid < kChunkMaxWarps * kCarrySlots) cslot[tid] = 0ull;
  __syncthreads();
  bool far_other = false;
  for (int d = 0; d < nbands; ++d) {
    const int bk = back[d];
    if (bk >= 2 && bk != len) far_other = true;
  }
  volatile Slot* vslot = cslot;

  // the thread's rows of chunk q into stage s: cp.async (vec: len % R ==
  // 0 and n % R == 0, so a group is whole or absent), else loads
  auto fetch = [&](int q, int s) {
    if constexpr (!PROBE) {
      float* vs = vst + (size_t)s * cap + g0;
      T* bs = bst + (size_t)s * nbands * cap + g0;
      if (vec) {
        const int p0 = q * len + g0;
        if (g0 >= len || p0 >= n) return;
        const int ps = reverse ? n - p0 - R : p0;
        cp_async_rows<float, R>(vs, vr + ps);
        for (int d = 0; d < nbands; ++d)
          cp_async_rows<T, R>(bs + (size_t)d * cap, bands + (size_t)d * n + ps);
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int i = reverse ? R - 1 - j : j;
          const int p = q * len + g0 + i;
          const bool ok = g0 + i < len && p < n;
          const int ps = reverse ? n - 1 - p : p;
          vs[j] = ok ? __ldg(vr + ps) : 0.f;
          for (int d = 0; d < nbands; ++d)
            bs[(size_t)d * cap + j] = ok ? bands[(size_t)d * n + ps]
                                         : from_f<T>(0.f);
        }
      }
    }
  };
  // R values of band d (or of v, d < 0) for the thread's rows of stage s,
  // in logical order
  auto stage_rows = [&](int s, int d, float (&o)[R]) {
    float t[R];
    if (d < 0)
      lds_rows<float, R>(vst + (size_t)s * cap + g0, t);
    else
      lds_rows<T, R>(bst + ((size_t)s * nbands + d) * cap + g0, t);
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] = t[reverse ? R - 1 - i : i];
  };

  if (!PROBE && vec) {
    for (int s = 0; s < nst - 1; ++s) {
      if (s < nchunks) fetch(s, s);
      cp_async_commit();
    }
  }
  float zprev[R];   // the thread's z in the previous chunk
#pragma unroll
  for (int i = 0; i < R; ++i) zprev[i] = 0.f;
  for (int q = 0; q < nchunks; ++q) {
    int s = 0;
    if (!PROBE) {
      if (vec) {
        const int qn = q + nst - 1;
        if (qn < nchunks) fetch(qn, qn % nst);
        cp_async_commit();
        cp_async_wait_stages(nst);   // chunk q's copies are in
        s = q % nst;
      } else {
        fetch(q, 0);
      }
    }
    const int p0 = q * len + g0;
    float rhs[R], nr[R], dg[R], cl[R];
    if constexpr (PROBE) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        rhs[i] = 1.f + 0.001f * i;
        nr[i] = g0 + i == 0 ? 0.f : 0.25f;
        dg[i] = 4.f;
        cl[i] = 0.25f;
      }
    } else {
      stage_rows(s, -1, rhs);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        nr[i] = 0.f;
        dg[i] = 1.f;
        cl[i] = 0.f;
      }
      if (dn >= 0) stage_rows(s, dn, nr);
      if (dd >= 0) stage_rows(s, dd, dg);
      if (dl >= 0) stage_rows(s, dl, cl);
    }
    // far terms other than L back: from the ring (or z), once every warp
    // has finished chunk q - 2
    if (far_other) {
      if (q >= 2) {
        for (int w = 0; w < warps; ++w)
          wait_slot(vslot + w * kCarrySlots + (q - 2) % kCarrySlots, q - 1);
        __threadfence_block();
      }
      for (int d = 0; d < nbands; ++d) {
        const int bk = back[d];
        if (bk < 2 || bk == len) continue;
        float c[R];
        if constexpr (PROBE) {
#pragma unroll
          for (int i = 0; i < R; ++i) c[i] = 0.25f;
        } else {
          stage_rows(s, d, c);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int p = p0 + i;
          if (p < bk) continue;   // the zero halo
          const int src = p - bk;
          const float zf = far_l2 ? __ldcg(zr + (reverse ? n - 1 - src : src))
                                  : rb[src & (ring - 1)];
          rhs[i] = rhs[i] - c[i] * zf;
        }
      }
    }
    // the maps; a far term one chunk back is the thread's own z
    float a[R], b[R];
    float ta = 1.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = p0 + i;
      if (g0 + i >= len || p >= n) {   // past the chunk: identity
        a[i] = 1.f;
        b[i] = 0.f;
        continue;
      }
      const float near = p >= 1 ? nr[i] : 0.f;
      float bi = q > 0 ? fmaf(-cl[i], zprev[i], rhs[i]) : rhs[i];
      float ai = -near;
      if (dd >= 0) {   // off the chain: a reciprocal of loaded data
        const float inv = __fdividef(1.f, dg[i]);
        ai = ai * inv;
        bi = bi * inv;
      }
      a[i] = ai;
      b[i] = bi;
      then(ta, tb, ai, bi);
    }
    float ea, eb;
    warp_scan(ta, tb, ea, eb, lane);
    const float wa = __shfl_sync(0xffffffffu, ta, 31);
    const float wb = __shfl_sync(0xffffffffu, tb, 31);
    // the carry: z of the row before the strip
    float carry = 0.f;
    if (warp > 0) {
      carry = slot_value(wait_slot(
          vslot + (warp - 1) * kCarrySlots + q % kCarrySlots, q + 1));
    } else if (q > 0) {
      const float a0 = __shfl_sync(0xffffffffu, a[0], 0);
      if (a0 != 0.f)
        carry = slot_value(wait_slot(
            vslot + (warps - 1) * kCarrySlots + (q - 1) % kCarrySlots, q));
    }
    float zt = fmaf(ea, carry, eb);
    float zs[R];   // physical order
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool ok = g0 + i < len && p0 + i < n;
      zt = fmaf(a[i], zt, b[i]);
      zs[reverse ? R - 1 - i : i] = zt;
      if (ok) {
        zprev[i] = zt;
        if (ring) rb[(p0 + i) & (ring - 1)] = zt;
      }
    }
    if (!PROBE) {
      if (vec) {
        if (g0 < len && p0 < n) {
          float* zo = zr + (reverse ? n - p0 - R : p0);
#pragma unroll
          for (int q4 = 0; q4 < R / 4; ++q4)
            reinterpret_cast<float4*>(zo)[q4] =
                make_float4(zs[4 * q4], zs[4 * q4 + 1], zs[4 * q4 + 2],
                            zs[4 * q4 + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int p = p0 + i;
          if (g0 + i < len && p < n)
            zr[reverse ? n - 1 - p : p] = zs[reverse ? R - 1 - i : i];
        }
      }
    }
    // hand the strip's carry on, once the slot's reader has finished the
    // chunk kCarrySlots back: warp s + 1 for this chunk, or warp 0 for the
    // next
    const float cout = fmaf(wa, carry, wb);
    const int x = q % kCarrySlots;
    if (q >= kCarrySlots) {
      if (warp < warps - 1)
        wait_slot(vslot + (warp + 1) * kCarrySlots + x, q - kCarrySlots + 1);
      else
        wait_slot(vslot + (q - kCarrySlots + 1) % kCarrySlots,
                  q - kCarrySlots + 2);
    }
    if (far_other) {   // this warp's z and ring before its tag
      __threadfence_block();
      __syncwarp();
    }
    if (lane == 0)
      vslot[warp * kCarrySlots + x] = make_slot(cout, q + 1);
    if (PROBE && q == nchunks - 1 && warp == warps - 1 && lane == 0)
      z[blockIdx.x] = cout;
  }
}

struct IluPlan {
  int nbands, idx0, nlower;
  int off[kMaxIluBands];             // every band's offset (the OOB mask)
  int l_off[kMaxIluBands];           // lower offsets, most negative first
  int l_band[kMaxIluBands];          // their bands
  int npair[kMaxIluBands];           // per lower offset: the updates,
  int pair_u[kMaxIluBands][kMaxIluBands];   // upper band read from row k
  int pair_t[kMaxIluBands][kMaxIluBands];   // band of row i it updates
};

// row[d] at a run-time d, the row held in registers (constant indices).
__device__ __forceinline__ float get(const float (&row)[kMaxIluBands],
                                     int d) {
  float x = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxIluBands; ++q)
    if (q == d) x = row[q];
  return x;
}

__device__ __forceinline__ void put(float (&row)[kMaxIluBands], int d,
                                    float x) {
#pragma unroll
  for (int q = 0; q < kMaxIluBands; ++q)
    if (q == d) row[q] = x;
}

template <typename T>
__global__ void ilu0_kernel(const T* __restrict__ bands, IluPlan plan,
                            float* fact, int n, float eps, float guard) {
  const int nb = plan.nbands;
  for (int i = 0; i < n; ++i) {
    float row[kMaxIluBands];
#pragma unroll
    for (int d = 0; d < kMaxIluBands; ++d) {
      row[d] = 0.f;
      if (d < nb) {
        const int col = i + plan.off[d];
        if (col >= 0 && col < n)
          row[d] = to_f(__ldg(bands + (size_t)d * n + i));
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxIluBands; ++j) {   // the plan at constant indices
      if (j >= plan.nlower) break;
      const int k = i + plan.l_off[j];
      const int lb = plan.l_band[j];
      // row k of the factors, or a unit-diagonal row before row 0
      const float kd = k < 0 ? 1.f : fact[(size_t)plan.idx0 * n + k];
      const float lik = __fdiv_rn(get(row, lb), kd);
      put(row, lb, lik);
#pragma unroll
      for (int q = 0; q < kMaxIluBands; ++q) {
        if (q >= plan.npair[j]) break;
        const int u = plan.pair_u[j][q], t = plan.pair_t[j][q];
        const float ku = k < 0 ? (u == plan.idx0 ? 1.f : 0.f)
                               : fact[(size_t)u * n + k];
        put(row, t, __fadd_rn(get(row, t), __fmul_rn(-lik, ku)));
      }
    }
    float mx = 0.f;
#pragma unroll
    for (int d = 0; d < kMaxIluBands; ++d) mx = fmaxf(mx, fabsf(row[d]));
    const float floor = fmaxf(__fmul_rn(mx, eps), guard);
    const float piv = get(row, plan.idx0);
    if (!(fabsf(piv) >= floor))
      put(row, plan.idx0, piv < 0.f ? -floor : floor);
#pragma unroll
    for (int d = 0; d < kMaxIluBands; ++d)
      if (d < nb) fact[(size_t)d * n + i] = row[d];
  }
}

// The plan of offsets (host memory, nbands ints; must include 0).
static cudaError_t ilu_plan(const int* offsets, int nbands, IluPlan* plan) {
  if (nbands <= 0 || nbands > kMaxIluBands) return cudaErrorInvalidValue;
  *plan = IluPlan{};
  plan->nbands = nbands;
  plan->idx0 = -1;
  auto band_of = [&](int off) {
    for (int d = 0; d < nbands; ++d)
      if (offsets[d] == off) return d;
    return -1;
  };
  std::vector<int> lower, upper;
  for (int d = 0; d < nbands; ++d) {
    plan->off[d] = offsets[d];
    if (offsets[d] == 0) plan->idx0 = d;
    if (offsets[d] < 0) lower.push_back(offsets[d]);
    if (offsets[d] > 0) upper.push_back(offsets[d]);
  }
  if (plan->idx0 < 0) return cudaErrorInvalidValue;
  std::sort(lower.begin(), lower.end());
  std::sort(upper.begin(), upper.end());
  plan->nlower = (int)lower.size();
  for (int j = 0; j < plan->nlower; ++j) {
    plan->l_off[j] = lower[j];
    plan->l_band[j] = band_of(lower[j]);
    int q = 0;
    for (int u : upper) {
      const int t = band_of(u + lower[j]);
      if (t < 0) continue;
      plan->pair_u[j][q] = band_of(u);
      plan->pair_t[j][q] = t;
      ++q;
    }
    plan->npair[j] = q;
  }
  return cudaSuccess;
}

// Route "scan": the near band (|off| = 1) and the diagonal, looked up on
// the host; a cooperative launch over k x tiles tiles.
template <typename T>
static cudaError_t launch_trisweep_scan(const void* bands, const int* offsets,
                                        int nbands, const float* v, float* z,
                                        float* agg, int n, int k, int unit,
                                        int reverse, int vec,
                                        int blocks_per_sm,
                                        cudaStream_t stream) {
  const T* bt = static_cast<const T*>(bands);
  const T* near = nullptr;
  const T* diag = nullptr;
  for (int d = 0; d < nbands; ++d) {
    if (offsets[d] == (reverse ? 1 : -1))
      near = bt + (size_t)d * n;
    else if (offsets[d] == 0)
      diag = unit ? nullptr : bt + (size_t)d * n;
    else
      return cudaErrorInvalidValue;   // a far band: the chunk route's
  }
  if (!unit && diag == nullptr) return cudaErrorInvalidValue;
  const int ngroups = (n + kScanRows - 1) / kScanRows;
  int tiles = (ngroups + kThreads - 1) / kThreads;
  int ntiles = tiles * k;
  auto kernel = trisweep_scan_kernel<T>;
  int grid = 0;
  cudaError_t e = persistent_grid(kernel, 0, blocks_per_sm, ntiles, &grid);
  if (e != cudaSuccess) return e;
  void* args[] = {(void*)&near,  (void*)&diag,   (void*)&v,
                  (void*)&z,     (void*)&agg,    (void*)&n,
                  (void*)&tiles, (void*)&ntiles, (void*)&unit,
                  (void*)&reverse, (void*)&vec};
  e = cudaLaunchCooperativeKernel((const void*)kernel, grid, kThreads, args,
                                  0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Dynamic shared memory of the chunk route (trisweep_chunk_kernel's
// layout; kernels/tuning.py::trisweep_smem_bytes computes the same).
__host__ inline size_t chunk_smem_bytes(int threads, int nbands, int elem,
                                        int ring, int stages) {
  const size_t cap = (size_t)threads * kChunkRows;
  return sizeof(float) * (size_t)ring +
         (size_t)stages * cap * (sizeof(float) + (size_t)nbands * elem);
}

template <typename T, bool PROBE>
static cudaError_t launch_trisweep_chunk(const void* bands,
                                         const int* offsets, int nbands,
                                         const float* v, float* z, int n,
                                         int k, int len, int threads,
                                         int ring, int far_l2,
                                         int stages, int vec, int unit,
                                         int reverse,
                                         cudaStream_t stream) {
  if (len <= 0 || threads <= 0 || threads % 32 != 0 ||
      threads > kChunkMaxThreads || threads * kChunkRows < len ||
      ring < 0 || (ring & (ring - 1)) != 0 || (ring != 0 && ring < 4) ||
      (vec && stages != 2 && stages != 4 && stages != kChunkMaxStages) ||
      (!vec && stages != 1))
    return cudaErrorInvalidValue;
  if (vec && (len % kChunkRows != 0 || n % kChunkRows != 0))
    return cudaErrorInvalidValue;
  int far_max = 0, dd = -1, dn = -1, dl = -1;
  bool far_other = false;
  BandOffsets offs{};
  for (int d = 0; d < nbands; ++d) {
    const int o = offsets[d];
    if (reverse ? o < 0 : o > 0) return cudaErrorInvalidValue;
    const int bk = o < 0 ? -o : o;
    // a far term inside the chunk, or in the previous one at another
    // thread's position, would race with its solve
    if (bk >= 2 && (bk < len || (bk % len != 0 && bk < 2 * len)))
      return cudaErrorInvalidValue;
    // each role once: the diagonal, the near band, the far band L back
    if ((bk == 0 && dd >= 0) || (bk == 1 && dn >= 0) ||
        (bk == len && bk >= 2 && dl >= 0))
      return cudaErrorInvalidValue;
    if (bk == 0)
      dd = d;
    else if (bk == 1)
      dn = d;
    else if (bk == len)
      dl = d;
    else
      far_other = true;
    far_max = bk > far_max ? bk : far_max;
    offs.off[d] = o;
  }
  if (unit) dd = -1;
  // far terms other than L back come from the ring or, with far_l2, z
  if (far_other && !far_l2 && ring < far_max) return cudaErrorInvalidValue;
  if (far_l2 && ring != 0) return cudaErrorInvalidValue;
  const int st = PROBE ? 0 : stages;
  const size_t smem = chunk_smem_bytes(threads, PROBE ? 0 : nbands,
                                       (int)sizeof(T), ring, st);
  const T* bt = static_cast<const T*>(bands);
  auto kernel = trisweep_chunk_kernel<T, PROBE>;
  // set even under 48 KB: the static arrays count against the default
  // limit
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<k, threads, smem, stream>>>(bt, offs, nbands, dd, dn, dl, v, z, n,
                                       len, reverse, ring, far_l2, stages,
                                       vec);
  return cudaGetLastError();
}

}  // namespace repro

// bands (nbands, n) row-major, offsets host memory (all <= 0 for a forward
// sweep, all >= 0 with reverse = 1 for a backward one); v and z (k, n) f32.
// chunk = 0: route "scan" (no far band; agg holds 2 k ceil(n / kScanTile)
// floats, blocks_per_sm caps the cooperative grid); else route "chunk"
// with chunks of `chunk` rows, kChunkRows a thread, `threads` a block, a
// ring of `ring` entries for far terms other than `chunk` back (far_l2 =
// 1: read from z instead), vec = 1 for the cp.async pipeline of `stages`
// chunks (16-byte aligned operands, chunk and n multiples of kChunkRows;
// else stages = 1).  The shape is kernels/tuning.py::trisweep_plan's.
extern "C" int repro_banded_trisweep(const void* bands, int b_bf16,
                                     const int* offsets, int nbands,
                                     const float* v, float* z, float* agg,
                                     int n, int k, int chunk, int threads,
                                     int ring, int far_l2,
                                     int stages, int vec, int unit,
                                     int reverse, int blocks_per_sm,
                                     void* stream) {
  if (n <= 0 || k <= 0 || chunk < 0 || nbands <= 0 ||
      nbands > repro::kMaxBands)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk == 0)
    return b_bf16 ? repro::launch_trisweep_scan<repro::bf16>(
                        bands, offsets, nbands, v, z, agg, n, k, unit,
                        reverse, vec, blocks_per_sm, st)
                  : repro::launch_trisweep_scan<float>(
                        bands, offsets, nbands, v, z, agg, n, k, unit,
                        reverse, vec, blocks_per_sm, st);
  return b_bf16 ? repro::launch_trisweep_chunk<repro::bf16, false>(
                      bands, offsets, nbands, v, z, n, k, chunk, threads,
                      ring, far_l2, stages, vec, unit, reverse, st)
                : repro::launch_trisweep_chunk<float, false>(
                      bands, offsets, nbands, v, z, n, k, chunk, threads,
                      ring, far_l2, stages, vec, unit, reverse, st);
}

// The chunk route's chain with nothing loaded (trisweep_chunk_kernel's
// PROBE form): one block walks the n / chunk chunks of the pattern
// `offsets` with the same registers, ring, scans and hand-offs; out[0] =
// the last carry.
extern "C" int repro_trisweep_probe(const int* offsets, int nbands,
                                    float* out, int n, int chunk,
                                    int threads, int ring, int far_l2,
                                    int unit, int reverse, void* stream) {
  if (n <= 0 || chunk <= 0 || nbands <= 0 || nbands > repro::kMaxBands)
    return cudaErrorInvalidValue;
  return repro::launch_trisweep_chunk<float, true>(
      nullptr, offsets, nbands, nullptr, out, n, 1, chunk, threads, ring,
      far_l2, 1, 0, unit, reverse, static_cast<cudaStream_t>(stream));
}

// bands (nbands, n) row-major, offsets host memory (with 0); fact (nbands,
// n) f32 out; eps and guard the pivot floor's terms.
extern "C" int repro_ilu0_factor(const void* bands, int b_bf16,
                                 const int* offsets, int nbands, float* fact,
                                 int n, float eps, float guard,
                                 void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  repro::IluPlan plan;
  cudaError_t e = repro::ilu_plan(offsets, nbands, &plan);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_bf16)
    repro::ilu0_kernel<repro::bf16><<<1, 1, 0, st>>>(
        static_cast<const repro::bf16*>(bands), plan, fact, n, eps, guard);
  else
    repro::ilu0_kernel<float><<<1, 1, 0, st>>>(
        static_cast<const float*>(bands), plan, fact, n, eps, guard);
  return cudaGetLastError();
}
