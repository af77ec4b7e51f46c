// Sparse mat-vec, y (rows, k) = A x (n, k) with f32 accumulation, in three
// storage formats:
//
//   ELL         values/cols (rows, width), row-major; padding slots hold
//               value 0 at column 0.
//   sliced ELL  a table of such rectangles (width bins) over one x, rows
//               sorted by nonzero count; the bins' rows follow each other
//               in the output, or land at y[perm[r]] with a permutation.
//   banded      bands (nbands, n), row-major, y[i] = sum_d bands[d, i] *
//               x[i + off_d], out-of-range reads counting as zero.
//
// Replaces repro/kernels/spmv.py::_ell_pallas (behind `ell_matvec`, and
// behind `sell_matvec` once per width bin) and ::_banded_pallas (behind
// `banded_matvec`).  The TPU kernels keep x whole in VMEM and cut the rows
// into (bm, width) / (bm, nbands) tiles; the banded one pads x with `halo`
// zeros on both sides so every shifted window is a plain slice.
//
// Bound: bytes.  Each stored entry is used for k multiply-adds, so at the
// solver's k = 1 the kernels do 2 flops per 8 bytes (ELL f32: value + int32
// column) or per 4 bytes (banded f32), far below the card's 20 flops per
// byte.  HBM bytes per call, s the storage size of a value, E the stored
// entries (rows x width summed over the bins):
//   ELL, sliced ELL  E (s + 4) + 8 n k          (values, cols, x, y)
//   banded           nbands n s + 8 n k         (bands, x, y)
// At the 1024 x 1024 five-point stencil (n = 2^20, f32) that is 50 MB for
// ELL (0.015 ms at 3.35 TB/s) and 29 MB banded (0.009 ms); the PageRank
// operator of pagerank_system(8192) stores 93,824 entries: 0.8 MB at
// k = 1 (0.00024 ms), so a launch's fixed cost is its floor there.
//
// Design, ELL: one thread per output row, 256 threads a block, and up to
// kMaxK accumulators per thread (x's columns; a wider x is cut into chunks
// of kMaxK columns, one launch each, by the host launcher).  x stays in
// global memory: the 4 MB operand at n = 2^20 sits in the 50 MB L2, and
// its rows are gathered through the read-only path.  Storage is f32 or
// bf16 (widened in registers); x and y are f32.  A thread walks its row's
// `width` slots in order: value, column, then the column's row of x.
// Padding slots read x[0] in bounds and add 0.  The row-major table is
// read at stride `width` across a warp, which is uncoalesced; the sectors
// are reused by the same warp on the next slots through L1, so for the
// stencil's width 5 little is wasted, but a column-major or SELL-C layout
// (slot s of 32 neighbouring rows contiguous) is the lever for a faster
// version.
//
// Design, sliced ELL (`sell_kernel`): ONE launch per call and chunk of kMaxK
// columns, over a table of bins passed by value in the parameters (at most
// kMaxSellBins; the host raises beyond).  Each bin carries its values and
// cols pointers, rows, width, first output row, first block and threads per
// row; the grid is the bins' blocks end to end, and a block finds its bin by
// comparing blockIdx.x with each bin's first block in a loop unrolled over
// constant indices, so the table is read from the parameter bank and never
// indexed at run time (a parameter struct indexed at run time goes to local
// memory: the banded kernel below ran at a sixth of its bound that way).
// Threads per row follow the width (kernels/spmv.py::threads_per_row): a
// power of two so that each lane walks at most 4 slots, a thread per row up
// to width 8 (most rows of the PageRank graph and every row of the stencil:
// the ELL loop above), and up to a whole block of 256 per row for the widest
// bins.  The lanes of a row read consecutive slots of the row-major table,
// so their loads coalesce; shuffles reduce a row's K accumulators inside a
// warp, and shared memory across the warps of a row wider than a warp.  With
// a thread per row, the PageRank operator's 64 rows of width 689 (47% of its
// entries) would be 64 threads on one SM, 689 dependent gathers each.  The
// permutation is applied in the kernel: with `perm`, row r of the sorted
// frame is written to y[perm[r]], so the operator's mat-vec is one launch
// and no scatter.  Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// phase 9, cold L2 by CUDA events, warm by the profiler): PageRank k = 1
// 0.0089 ms cold, 0.0028 warm, against cuSPARSE's CSR product 0.0169
// cold; k = 8 0.0116 cold against torch.sparse.mm's 0.0251; the 1024^2 stencil
// 0.0276 cold in one launch, the ELL kernel's 0.0267 in the same run.  The
// hub bin (64 rows of width 689) warm at 32 / 64 / 128 / 256 threads a row:
// 0.0074 / 0.0050 / 0.0036 / 0.0027 ms, so the rule gives it a whole block.
//
// Design, banded: band d at row i is bands[d * n + i], so a warp's reads
// of one band are contiguous, and so are its reads of the shifted x
// window.  The offsets come by value in the kernel's parameters, read at
// constant indices (an unrolled loop; indexed at run time the struct went
// to local memory, and on an H100 the kernel ran at a sixth of its bound);
// an out-of-range neighbour is skipped, which is the TPU's zero halo
// without padding x.  With the bands read from HBM (not left in L2 by a
// previous call) a thread per row reaches about half the bound: its five
// 4-byte loads in flight are too few, and several rows per thread in
// vector loads is the lever (PERF.md).
//
// Halo modes, for one shard of a row-sharded solve (replace the same two
// TPU kernels behind repro/kernels/spmv.py::banded_matvec_halo and
// ::ell_matvec_halo).  The operand is the shard's rows with `halo`
// neighbour rows exchanged on each side, (n_local + 2 halo, k):
//   banded  row i reads x[i + halo + off_d]: every read is in range (the
//           edge ranks' halos hold zeros), so no range test;
//   ELL     the column indices are remapped into the padded frame by the
//           caller; the gather kernel is the same, over an operand longer
//           than the row count.
// Each mode has its own C entry point.  Bound: bytes, as above, with the
// operand's 2 halo k extra rows read once.
#include "common.cuh"

namespace repro {

constexpr int kSpmvMaxK = 8;       // accumulators per thread

template <typename T, int K>
__global__ void __launch_bounds__(256)
    ell_kernel(const T* __restrict__ values, const int* __restrict__ cols,
               const float* __restrict__ x, int ldx, float* __restrict__ y,
               int ldy, int rows, int width) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const T* vr = values + (size_t)row * width;
  const int* cr = cols + (size_t)row * width;
#pragma unroll 4
  for (int s = 0; s < width; ++s) {
    const float a = to_f(vr[s]);
    const float* xp = x + (size_t)__ldg(cr + s) * ldx;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = fmaf(a, __ldg(xp + k), acc[k]);
  }
  float* yp = y + (size_t)row * ldy;
#pragma unroll
  for (int k = 0; k < K; ++k) yp[k] = acc[k];
}

// The sliced-ELL bin table, passed by value in the kernel's parameters.
constexpr int kSellThreads = 256;  // threads of a sliced-ELL block
constexpr int kMaxSellBins = 16;   // bins of one launch (the host checks)

struct SellBin {
  const void* values;  // (rows, width) row-major, storage type T
  const int* cols;     // (rows, width) row-major, global columns of x
  int rows, width;
  int row0;            // first output row (sorted frame)
  int block0;          // first block of the grid
  int tpr;             // threads per row: a power of two, <= kSellThreads
};
struct SellTable {
  SellBin bin[kMaxSellBins];
};

__host__ __device__ inline int sell_blocks(int rows, int tpr) {
  const int per_block = kSellThreads / tpr;
  return (rows + per_block - 1) / per_block;
}

// One launch over every bin: a block works on `kSellThreads / tpr` rows of
// one bin, `tpr` lanes a row.  With `perm`, row r of the sorted frame is
// written to y[perm[r]].
template <typename T, int K>
__global__ void __launch_bounds__(kSellThreads)
    sell_kernel(const SellTable tab, int nbins, const float* __restrict__ x,
                int ldx, float* __restrict__ y, int ldy,
                const int* __restrict__ perm) {
  __shared__ float red[kSellThreads / 32][K];
  // The block's bin, the last whose first block is <= blockIdx.x: every
  // field is read at a constant index (the loop is unrolled), so the table
  // stays in the parameter bank.
  SellBin b = tab.bin[0];
#pragma unroll
  for (int i = 1; i < kMaxSellBins; ++i)
    if (i < nbins && (int)blockIdx.x >= tab.bin[i].block0) b = tab.bin[i];
  const int tpr = b.tpr;
  const int g = threadIdx.x / tpr, lane = threadIdx.x & (tpr - 1);
  const int r = ((int)blockIdx.x - b.block0) * (kSellThreads / tpr) + g;
  const bool live = r < b.rows;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  if (live) {
    const T* vr = static_cast<const T*>(b.values) + (size_t)r * b.width;
    const int* cr = b.cols + (size_t)r * b.width;
    if (tpr == 1) {
#pragma unroll 4
      for (int s = 0; s < b.width; ++s) {
        const float a = to_f(vr[s]);
        const float* xp = x + (size_t)__ldg(cr + s) * ldx;
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fmaf(a, __ldg(xp + k), acc[k]);
      }
    } else {
      for (int s = lane; s < b.width; s += tpr) {
        const float a = to_f(vr[s]);
        const float* xp = x + (size_t)__ldg(cr + s) * ldx;
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fmaf(a, __ldg(xp + k), acc[k]);
      }
    }
  }
  // tpr is the same in the whole block, so every branch below is uniform.
  if (tpr > 1) {
    const int width = tpr < 32 ? tpr : 32;
    for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
    if (tpr > 32) {   // the row's warps meet in shared memory, in order
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) red[warp][k] = acc[k];
      }
      __syncthreads();
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float s = 0.f;
          for (int w = 0; w < (tpr >> 5); ++w) s += red[warp + w][k];
          acc[k] = s;
        }
      }
    }
  }
  if (live && lane == 0) {
    const int out = b.row0 + r;
    float* yp = y + (size_t)(perm ? __ldg(perm + out) : out) * ldy;
#pragma unroll
    for (int k = 0; k < K; ++k) yp[k] = acc[k];
  }
}

// kHalo: x holds n + 2 halo rows and row i reads x[i + halo + off].
template <typename T, int K, bool kHalo>
__global__ void __launch_bounds__(256)
    banded_kernel(const T* __restrict__ bands, BandOffsets offs, int nbands,
                  const float* __restrict__ x, int ldx, float* __restrict__ y,
                  int ldy, int n, int halo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  // Unrolled over the largest band count so every offset is read at a
  // constant index from the parameters: a loop to `nbands` indexes the
  // struct at run time, which copies it to local memory in every thread.
#pragma unroll
  for (int d = 0; d < kMaxBands; ++d) {
    if (d >= nbands) break;
    int c = i + offs.off[d];
    if constexpr (kHalo) {
      c += halo;                       // exchanged rows: always in range
    } else if (c < 0 || c >= n) {
      continue;                        // the zero halo
    }
    const float a = to_f(bands[(size_t)d * n + i]);
    const float* xp = x + (size_t)c * ldx;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = fmaf(a, __ldg(xp + k), acc[k]);
  }
  float* yp = y + (size_t)i * ldy;
#pragma unroll
  for (int k = 0; k < K; ++k) yp[k] = acc[k];
}

#define REPRO_SPMV_SWITCH(KC, LAUNCH) \
  switch (KC) {                       \
    case 1: LAUNCH(1); break;         \
    case 2: LAUNCH(2); break;         \
    case 3: LAUNCH(3); break;         \
    case 4: LAUNCH(4); break;         \
    case 5: LAUNCH(5); break;         \
    case 6: LAUNCH(6); break;         \
    case 7: LAUNCH(7); break;         \
    case 8: LAUNCH(8); break;         \
    default: return cudaErrorInvalidValue; \
  }

// One launch per chunk of kSpmvMaxK columns of x; x and y are (., k)
// row-major and chunk c0 starts at column c0 of both.
template <typename T>
static cudaError_t launch_ell(const void* values, const int* cols,
                              const float* x, float* y, int rows, int width,
                              int k, int threads, cudaStream_t stream) {
  if (rows <= 0 || width <= 0 || k <= 0 || threads <= 0)
    return cudaErrorInvalidValue;
  const T* vt = static_cast<const T*>(values);
  const int grid = (rows + threads - 1) / threads;
  for (int c0 = 0; c0 < k; c0 += kSpmvMaxK) {
    const int kc = k - c0 < kSpmvMaxK ? k - c0 : kSpmvMaxK;
#define REPRO_ELL_LAUNCH(K)                                         \
  ell_kernel<T, K><<<grid, threads, 0, stream>>>(vt, cols, x + c0, k, \
                                                 y + c0, k, rows, width)
    REPRO_SPMV_SWITCH(kc, REPRO_ELL_LAUNCH)
#undef REPRO_ELL_LAUNCH
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// One launch per chunk of kSpmvMaxK columns of x over the whole bin table.
// meta holds 5 ints a bin: rows, width, first output row, first block,
// threads per row; the host's plan is checked here (the rows and blocks
// must follow each other), so a table the kernel would misread is refused.
template <typename T>
static cudaError_t launch_sell(const void* const* values,
                               const int* const* cols, const int* meta,
                               int nbins, const float* x, float* y, int k,
                               const int* perm, cudaStream_t stream) {
  if (nbins < 1 || nbins > kMaxSellBins || k <= 0)
    return cudaErrorInvalidValue;
  SellTable tab{};
  int row0 = 0, block0 = 0;
  for (int i = 0; i < nbins; ++i) {
    const int* m = meta + 5 * i;
    const int rows = m[0], width = m[1], tpr = m[4];
    if (rows < 0 || width < 1 || tpr < 1 || tpr > kSellThreads ||
        (tpr & (tpr - 1)) || m[2] != row0 || m[3] != block0)
      return cudaErrorInvalidValue;
    tab.bin[i] = SellBin{values[i], cols[i], rows, width, row0, block0, tpr};
    row0 += rows;
    block0 += sell_blocks(rows, tpr);
  }
  if (block0 == 0) return cudaSuccess;
  for (int c0 = 0; c0 < k; c0 += kSpmvMaxK) {
    const int kc = k - c0 < kSpmvMaxK ? k - c0 : kSpmvMaxK;
#define REPRO_SELL_LAUNCH(K)                                              \
  sell_kernel<T, K><<<block0, kSellThreads, 0, stream>>>(tab, nbins, x + c0, \
                                                         k, y + c0, k, perm)
    REPRO_SPMV_SWITCH(kc, REPRO_SELL_LAUNCH)
#undef REPRO_SELL_LAUNCH
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// halo < 0: the zero-halo product over x (n, k); halo >= 0: the halo mode
// over x (n + 2 halo, k), every |offset| <= halo.
template <typename T>
static cudaError_t launch_banded(const void* bands, const int* offsets,
                                 int nbands, const float* x, float* y, int n,
                                 int halo, int k, int threads,
                                 cudaStream_t stream) {
  if (n <= 0 || nbands <= 0 || nbands > kMaxBands || k <= 0 || threads <= 0)
    return cudaErrorInvalidValue;
  BandOffsets offs{};
  for (int d = 0; d < nbands; ++d) {
    offs.off[d] = offsets[d];
    if (halo >= 0 && (offsets[d] > halo || offsets[d] < -halo))
      return cudaErrorInvalidValue;
  }
  const T* bt = static_cast<const T*>(bands);
  const int grid = (n + threads - 1) / threads;
  for (int c0 = 0; c0 < k; c0 += kSpmvMaxK) {
    const int kc = k - c0 < kSpmvMaxK ? k - c0 : kSpmvMaxK;
#define REPRO_BANDED_LAUNCH(K)                                              \
  if (halo >= 0)                                                             \
    banded_kernel<T, K, true><<<grid, threads, 0, stream>>>(                 \
        bt, offs, nbands, x + c0, k, y + c0, k, n, halo);                    \
  else                                                                       \
    banded_kernel<T, K, false><<<grid, threads, 0, stream>>>(                \
        bt, offs, nbands, x + c0, k, y + c0, k, n, 0)
    REPRO_SPMV_SWITCH(kc, REPRO_BANDED_LAUNCH)
#undef REPRO_BANDED_LAUNCH
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

#undef REPRO_SPMV_SWITCH

}  // namespace repro

extern "C" int repro_ell_matvec(const void* values, int v_bf16,
                                const int* cols, const float* x, float* y,
                                int rows, int width, int k, int threads,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_ell<repro::bf16>(values, cols, x, y, rows,
                                                 width, k, threads, s)
                : repro::launch_ell<float>(values, cols, x, y, rows, width, k,
                                           threads, s);
}

// Sliced ELL, one launch a chunk: values / cols are host arrays of nbins
// device pointers, meta host int[5 nbins] (see launch_sell), x (n, k) f32,
// y (rows, k) f32, perm a device int[rows] or null (the sorted frame).
extern "C" int repro_sell_matvec(const void* const* values, int v_bf16,
                                 const int* const* cols, const int* meta,
                                 int nbins, const float* x, float* y, int k,
                                 const int* perm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? repro::launch_sell<repro::bf16>(values, cols, meta, nbins,
                                                  x, y, k, perm, s)
                : repro::launch_sell<float>(values, cols, meta, nbins, x, y,
                                            k, perm, s);
}

// `offsets` is host memory (nbands ints); it is copied into the launch's
// parameters.
extern "C" int repro_banded_matvec(const void* bands, int b_bf16,
                                   const int* offsets, int nbands,
                                   const float* x, float* y, int n, int k,
                                   int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b_bf16 ? repro::launch_banded<repro::bf16>(bands, offsets, nbands, x,
                                                    y, n, -1, k, threads, s)
                : repro::launch_banded<float>(bands, offsets, nbands, x, y, n,
                                              -1, k, threads, s);
}

// The halo mode: x (n + 2 halo, k) f32, y (n, k) f32.
extern "C" int repro_banded_matvec_halo(const void* bands, int b_bf16,
                                        const int* offsets, int nbands,
                                        const float* x, float* y, int n,
                                        int halo, int k, int threads,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (halo < 0) return cudaErrorInvalidValue;
  return b_bf16 ? repro::launch_banded<repro::bf16>(bands, offsets, nbands, x,
                                                    y, n, halo, k, threads, s)
                : repro::launch_banded<float>(bands, offsets, nbands, x, y, n,
                                              halo, k, threads, s);
}

// The halo mode of the ELL product: x (x_rows, k) f32 with x_rows >= rows,
// the columns already in x's frame; y (rows, k) f32.
extern "C" int repro_ell_matvec_halo(const void* values, int v_bf16,
                                     const int* cols, const float* x,
                                     int x_rows, float* y, int rows,
                                     int width, int k, int threads,
                                     void* stream) {
  if (x_rows < rows) return cudaErrorInvalidValue;
  return repro_ell_matvec(values, v_bf16, cols, x, y, rows, width, k,
                          threads, stream);
}
