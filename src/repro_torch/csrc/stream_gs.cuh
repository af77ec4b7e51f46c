// The streamed classical Gram-Schmidt sweeps over a Krylov basis V (m1, n)
// in global memory, shared by batched_cgs2.cu (a lane per right-hand side)
// and cgs2.cu (the scalar solver's streamed cgs2 / gs_project: one lane,
// the whole grid):
//
//   sweep 1  project         part[r][block] = sum_c V[r, c] w[c]
//   sweep 2  update-project  w1 = w - V^T h1, and the h2 partials from the
//                            same V values
//   sweep 3  update          w'' = w1 - V^T h2
//
// A thread of a lane takes 16-byte pieces of its lane's columns (pieces
// t, t + U g, ... of the lane's g threads, U at a time), with up to
// kBcSlots rows' loads of V in flight and no barrier per row chunk; the
// ragged tail (or every column, pieces = 0: the scalar route) a column at
// a time.  Partials are [row][block], summed by every block of the lane in
// one fixed order (bc_reduce): no float atomics, the same bits every run.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kBcThreads = 128;
constexpr int kBcWarps = kBcThreads / 32;
constexpr int kBcSlots = 16;     // 16-byte loads of V a thread holds
constexpr int kBcMaxRows = 32;   // rows of the largest bucket
constexpr int kBcBlocksPerSm = 2;

// The bucket of rows a lane of `rows` rows runs in: 2, or the largest
// (kBcMaxRows rows at a time).
__host__ __device__ constexpr int bc_bucket(int rows) {
  return rows <= 2 ? 2 : kBcMaxRows;
}

// Pieces a thread takes at once for a bucket of R rows (tuning's
// batched_unroll): U min(R, kBcSlots) <= kBcSlots loads of V and
// U VEC <= 32 columns of w.
__host__ __device__ constexpr int bc_unroll(int r, int vec) {
  return r >= kBcSlots ? 1 : (kBcSlots / r < 32 / vec ? kBcSlots / r
                                                       : 32 / vec);
}

// One lane's share of the work, as one thread sees it.
template <typename TV>
struct BcLane {
  const TV* v;      // the lane's basis (m1, n)
  const float* w;   // its w
  float* wo;        // its w'' (w1 after sweep 2)
  int rows, n, pieces;
  int t;            // this thread among the lane's threads
  int g;            // the lane's threads
};

// 16 bytes of floats at p (plain loads: w1 is written in this launch).
__device__ __forceinline__ void load_f4(const float* p, float* o) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}

template <int VEC>
__device__ __forceinline__ void load_piece(const float* p, float* o) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) load_f4(p + 4 * q, o + 4 * q);
}

template <int VEC>
__device__ __forceinline__ void store_piece(float* p, const float* x) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// The next row of V: p + n, behind an empty asm so that the compiler
// does not hoist every row's address out of the piece loop (a 64-bit
// address a row held across it).
template <typename TV>
__device__ __forceinline__ const TV* next_row(const TV* p, int n) {
  p += n;
  asm volatile("" : "+l"(p));
  return p;
}

// raw[u][r] = the 16-byte piece p0 + u g of rows r0 .. r0 + nr - 1 (r <
// C), every load issued before any is used.
template <typename TV, int U, int C>
__device__ __forceinline__ void load_rows(const BcLane<TV>& a, int p0,
                                          const bool (&ok)[U], int r0,
                                          int nr, uint4 (&raw)[U][C]) {
  constexpr int VEC = Vec16<TV>::N;
  const TV* q = a.v + (size_t)r0 * a.n + (size_t)p0 * VEC;
#pragma unroll
  for (int r = 0; r < C; ++r) {
    if (r < nr) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u])
          raw[u][r] = __ldg(
              reinterpret_cast<const uint4*>(q + (size_t)u * a.g * VEC));
    }
    q = next_row(q, a.n);
  }
}

// part[(r0 + r) * G + blockIdx.x] = the block's sum of acc[r0 + r],
// r < nr: warp shuffles, then the warps in order.  Every thread must
// call it.
template <int R>
__device__ __forceinline__ void bc_partials(const float (&acc)[R],
                                            float* red, float* part, int r0,
                                            int nr, int G) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nr) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) red[warp * kBcMaxRows + r] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kBcWarps; ++q) s += red[q * kBcMaxRows + threadIdx.x];
    part[(size_t)(r0 + threadIdx.x) * G + blockIdx.x] = s;
  }
  __syncthreads();
}

// hs[r] = sum of the lane's partials of row r over its blocks, in one
// fixed order (a warp a row), the same in every block of the lane.
__device__ __forceinline__ void bc_reduce(const float* part, int rows,
                                          int G, int b0, int nb,
                                          float* hs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kBcWarps) {
    float acc = 0.f;
    for (int b = lane; b < nb; b += 32)
      acc += __ldcg(part + (size_t)r * G + b0 + b);   // other SMs wrote it
    acc = warp_sum(acc);
    if (lane == 0) hs[r] = acc;
  }
  __syncthreads();
}

// The sweeps of a lane in the bucket of R rows: rows <= R (R = 32: any
// number of rows, R at a time where a sum per row is kept).  C = min(R,
// kBcSlots) rows' loads are in flight at once, U pieces at once.
//
// Sweep 1, and sweep 2's projection when the rows exceed the largest
// bucket: part[r][block] = sum over the thread's columns of V[r, c] x[c].
template <typename TV, int R>
__device__ __forceinline__ void bc_project(const BcLane<TV>& a,
                                           const float* x, float* part,
                                           int G, float* red) {
  constexpr int VEC = Vec16<TV>::N;
  constexpr int U = bc_unroll(R, VEC);
  constexpr int C = R < kBcSlots ? R : kBcSlots;
  for (int r0 = 0; r0 < a.rows; r0 += R) {
    const int nr = min(R, a.rows - r0);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int p0 = a.t; p0 < a.pieces; p0 += U * a.g) {
      bool ok[U];
      float xv[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = p0 + u * a.g < a.pieces;
        if (ok[u]) load_piece<VEC>(x + (size_t)(p0 + u * a.g) * VEC, xv[u]);
      }
#pragma unroll
      for (int c0 = 0; c0 < R; c0 += C) {
        if (c0 >= nr) break;
        uint4 raw[U][C];
        load_rows<TV, U, C>(a, p0, ok, r0 + c0, nr - c0, raw);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!ok[u]) continue;
#pragma unroll
          for (int r = 0; r < C; ++r) {
            if (c0 + r < nr) {
              float f[VEC];
              Vec16<TV>::unpack(raw[u][r], f);
#pragma unroll
              for (int c = 0; c < VEC; ++c)
                acc[c0 + r] = fmaf(f[c], xv[u][c], acc[c0 + r]);
            }
          }
        }
      }
    }
    for (int c = a.pieces * VEC + a.t; c < a.n; c += a.g) {
      const float xc = x[c];
      const TV* q = a.v + (size_t)r0 * a.n + c;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) acc[r] = fmaf(to_f(*q), xc, acc[r]);
        q = next_row(q, a.n);
      }
    }
    bc_partials<R>(acc, red, part, r0, nr, G);
  }
}

// Sweep 3, and sweep 2's update when the rows exceed the largest bucket:
// out[c] = x[c] - sum_r h[r] V[r, c], the sum in row order from 0.  out
// may be x (each thread reads its piece before it writes it).
template <typename TV, int R>
__device__ __forceinline__ void bc_update(const BcLane<TV>& a,
                                          const float* x, const float* h,
                                          float* out) {
  constexpr int VEC = Vec16<TV>::N;
  constexpr int U = bc_unroll(R, VEC);
  constexpr int C = R < kBcSlots ? R : kBcSlots;
  for (int p0 = a.t; p0 < a.pieces; p0 += U * a.g) {
    bool ok[U];
    float xv[U][VEC], s[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = p0 + u * a.g < a.pieces;
      if (ok[u]) load_piece<VEC>(x + (size_t)(p0 + u * a.g) * VEC, xv[u]);
#pragma unroll
      for (int c = 0; c < VEC; ++c) s[u][c] = 0.f;
    }
    for (int r0 = 0; r0 < a.rows; r0 += C) {
      uint4 raw[U][C];
      const int nr = min(C, a.rows - r0);
      load_rows<TV, U, C>(a, p0, ok, r0, nr, raw);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int r = 0; r < C; ++r) {
          if (r < nr) {
            float f[VEC];
            Vec16<TV>::unpack(raw[u][r], f);
            const float hr = h[r0 + r];
#pragma unroll
            for (int c = 0; c < VEC; ++c) s[u][c] = fmaf(hr, f[c], s[u][c]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float o[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) o[c] = xv[u][c] - s[u][c];
      store_piece<VEC>(out + (size_t)(p0 + u * a.g) * VEC, o);
    }
  }
  for (int c = a.pieces * VEC + a.t; c < a.n; c += a.g) {
    float s = 0.f;
    const float xc = x[c];
    const TV* q = a.v + c;
    for (int r0 = 0; r0 < a.rows; r0 += C) {
      float vv[C];
#pragma unroll
      for (int r = 0; r < C; ++r) {
        if (r0 + r < a.rows) vv[r] = to_f(*q);
        q = next_row(q, a.n);
      }
#pragma unroll
      for (int r = 0; r < C; ++r)
        if (r0 + r < a.rows) s = fmaf(h[r0 + r], vv[r], s);
    }
    out[c] = xc - s;
  }
}

// Sweep 2 for rows <= R: w1 = w - V^T h1 written to wo, and the h2
// partials sum V[r, c] w1[c] from the same V values: still in registers
// where the rows fit one chunk of C, else the last chunk's are and the
// first C rows' piece is loaded again.
template <typename TV, int R>
__device__ __forceinline__ void bc_update_project(const BcLane<TV>& a,
                                                  const float* h1,
                                                  float* part, int G,
                                                  float* red) {
  constexpr int VEC = Vec16<TV>::N;
  constexpr int U = bc_unroll(R, VEC);
  constexpr int C = R < kBcSlots ? R : kBcSlots;
  const int nr = a.rows;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int p0 = a.t; p0 < a.pieces; p0 += U * a.g) {
    bool ok[U];
    float xv[U][VEC], s[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = p0 + u * a.g < a.pieces;
      if (ok[u]) load_piece<VEC>(a.w + (size_t)(p0 + u * a.g) * VEC, xv[u]);
#pragma unroll
      for (int c = 0; c < VEC; ++c) s[u][c] = 0.f;
    }
    uint4 raw[U][C];
#pragma unroll
    for (int c0 = 0; c0 < R; c0 += C) {
      if (c0 >= nr) break;
      load_rows<TV, U, C>(a, p0, ok, c0, nr - c0, raw);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int r = 0; r < C; ++r) {
          if (c0 + r < nr) {
            float f[VEC];
            Vec16<TV>::unpack(raw[u][r], f);
            const float hr = h1[c0 + r];
#pragma unroll
            for (int c = 0; c < VEC; ++c) s[u][c] = fmaf(hr, f[c], s[u][c]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int c = 0; c < VEC; ++c) s[u][c] = xv[u][c] - s[u][c];   // w1
      store_piece<VEC>(a.wo + (size_t)(p0 + u * a.g) * VEC, s[u]);
    }
    // last chunk first: the first loop left it in raw; an earlier one (a
    // lane of more than C rows: its first C rows) is loaded again
#pragma unroll
    for (int c0 = (R - 1) / C * C; c0 >= 0; c0 -= C) {
      if (c0 >= nr) continue;
      if (R > C && c0 + C < nr)
        load_rows<TV, U, C>(a, p0, ok, c0, nr - c0, raw);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int r = 0; r < C; ++r) {
          if (c0 + r < nr) {
            float f[VEC];
            Vec16<TV>::unpack(raw[u][r], f);
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[c0 + r] = fmaf(f[c], s[u][c], acc[c0 + r]);
          }
        }
      }
    }
  }
  for (int c = a.pieces * VEC + a.t; c < a.n; c += a.g) {
    const float wc = a.w[c];
    const TV* q = a.v + c;
    float sc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) sc = fmaf(h1[r], to_f(*q), sc);
      q = next_row(q, a.n);
    }
    const float w1 = wc - sc;
    a.wo[c] = w1;
    q = a.v + c;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) acc[r] = fmaf(to_f(*q), w1, acc[r]);
      q = next_row(q, a.n);
    }
  }
  bc_partials<R>(acc, red, part, 0, nr, G);
}

// Sweep `pass` of CGS2 (1 project, 2 update-project, 3 update in place)
// for a lane in the bucket of R rows.
template <typename TV, int R>
__device__ __forceinline__ void bc_sweep(int pass, const BcLane<TV>& a,
                                         const float* hs, float* part,
                                         int G, float* red) {
  if (pass == 1) {
    bc_project<TV, R>(a, a.w, part, G, red);
  } else if (pass == 2) {
    if (a.rows <= R) {
      bc_update_project<TV, R>(a, hs, part, G, red);
    } else {   // more rows than the largest bucket: V twice in this pass
      bc_update<TV, R>(a, a.w, hs, a.wo);
      bc_project<TV, R>(a, a.wo, part, G, red);
    }
  } else {
    bc_update<TV, R>(a, a.wo, hs, a.wo);
  }
}

// The lane's sweep with its bucket of rows (block-uniform): a lane of at
// most 2 rows takes 8 pieces at once (4 for bf16 V), a larger one a piece
// at a time with up to 16 rows' loads in flight (bc_bucket, bc_unroll).
// Each bucket is a copy of the three sweeps in a kernel; more buckets
// pushed batched_cgs2's kernel past 255 registers.
template <typename TV>
__device__ __forceinline__ void bc_dispatch(int pass, const BcLane<TV>& a,
                                            const float* hs, float* part,
                                            int G, float* red) {
  if (bc_bucket(a.rows) == 2)
    bc_sweep<TV, 2>(pass, a, hs, part, G, red);
  else
    bc_sweep<TV, kBcMaxRows>(pass, a, hs, part, G, red);
}

// Shared memory of a kernel over these sweeps: hs1[m1], hs2[m1],
// red[kBcWarps * kBcMaxRows].
__host__ __device__ inline size_t bc_smem_bytes(int m1) {
  return sizeof(float) * (2 * (size_t)m1 + (size_t)kBcWarps * kBcMaxRows);
}

}  // namespace repro
