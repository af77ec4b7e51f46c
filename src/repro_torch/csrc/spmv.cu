// Sparse mat-vec, y (rows, k) = A x (n, k) with f32 accumulation, in two
// storage formats:
//
//   ELL     values/cols (rows, width), row-major; padding slots hold value 0
//           at column 0.  Also one width bin of sliced ELL.
//   banded  bands (nbands, n), row-major, y[i] = sum_d bands[d, i] *
//           x[i + off_d], out-of-range reads counting as zero.
//
// Replaces repro/kernels/spmv.py::_ell_pallas (behind `ell_matvec` and
// `sell_matvec`, one launch per width bin) and ::_banded_pallas (behind
// `banded_matvec`).  The TPU kernels keep x whole in VMEM and cut the rows
// into (bm, width) / (bm, nbands) tiles; the banded one pads x with `halo`
// zeros on both sides so every shifted window is a plain slice.
//
// Bound: bytes.  Each stored entry is used for k multiply-adds, so at the
// solver's k = 1 the kernels do 2 flops per 8 bytes (ELL f32: value + int32
// column) or per 4 bytes (banded f32), far below the card's 20 flops per
// byte.  HBM bytes per call, s the storage size of a value:
//   ELL     rows * width * (s + 4) + 8 n      (values, cols, x, y; k = 1)
//   banded  nbands * n * s + 8 n              (bands, x, y)
// At the 1024 x 1024 five-point stencil (n = 2^20, f32) that is 50 MB for
// ELL (0.015 ms at 3.35 TB/s) and 29 MB banded (0.009 ms).
//
// Design: one thread per output row, eight rows' worth of warps per block,
// and up to kMaxK accumulators per thread (x's columns; a wider x is cut
// into chunks of kMaxK columns, one launch each, by the host launcher).
// x stays in global memory: the 4 MB operand at n = 2^20 sits in the 50 MB
// L2, and its rows are gathered through the read-only path.  Storage is
// f32 or bf16 (widened in registers); x and y are f32.
//   ELL     a thread walks its row's `width` slots in order: value, column,
//           then the column's row of x.  Padding slots read x[0] in bounds
//           and add 0.  The row-major table is read at stride `width`
//           across a warp, which is uncoalesced; the sectors are reused by
//           the same warp on the next slots through L1, so for the
//           stencil's width 5 little is wasted, but a column-major or
//           SELL-C layout (slot s of 32 neighbouring rows contiguous) is
//           the first lever for a faster version.  Wide sliced-ELL hub
//           bins leave most of a warp's time on few long rows; the per-bin
//           times are recorded (PERF.md), not tuned here.
//   banded  band d at row i is bands[d * n + i], so a warp's reads of one
//           band are contiguous, and so are its reads of the shifted x
//           window.  The offsets come by value in the kernel's parameters,
//           read at constant indices (an unrolled loop; indexed at run time
//           the struct went to local memory, and on an H100 the kernel
//           ran at a sixth of its bound); an out-of-range neighbour is
//           skipped, which is the TPU's zero halo without padding x.  With
//           the bands read from HBM (not left in L2 by a previous call) a
//           thread per row reaches about half the bound: its five 4-byte
//           loads in flight are too few, and several rows per thread in
//           vector loads is the lever (PERF.md).
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
