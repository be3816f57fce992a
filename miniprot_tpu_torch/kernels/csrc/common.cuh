// Shared device helpers of the kernels: warp-level max scans over the
// protein positions a problem holds (each thread owns P consecutive
// positions, so lane order is position order), the named barrier of a
// multi-warp problem, the per-thread profile slots, the prefetched row
// streams and the int16 clip.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// saturating int16 arithmetic on int32 values (nasw_cigar_pallas._sadd16)
__device__ __forceinline__ int sat16(int x) { return imin(imax(x, -32768), 32767); }

// ---------------------------------------------------------------------------
// A problem spread over NWP warps of one block (NWP * 32 threads).  The
// warps of one problem meet at a named barrier of their own (id 1 + the
// problem's slot in the block), never at __syncthreads: problems of one
// block stop at different rows.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Inclusive max scans across the warp, in lane order.  A plain max
// scan needs no lane guard: __shfl_up_sync hands lanes below the
// distance their own value back.  A segmented scan takes nothing from
// lanes below `head`, the lane (possibly negative: an earlier warp) that
// holds the start of the segment of this lane's last position; a lane
// holding a segment start passes head = its own lane, so its value is
// already "max since that start".  seg_steps(head) gives the steps
// (bit k: distance 1 << k) that combine, fixed for a problem.
__device__ __forceinline__ unsigned seg_steps(int head) {
  const int lane = threadIdx.x & 31;
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) m |= (unsigned)(lane - (1 << k) >= head) << k;
  return m;
}

// the segmented (s) and plain (m) scans in one 5-step shuffle loop
__device__ __forceinline__ void warp_incl_max2(int& s, unsigned steps, int& m) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int us = __shfl_up_sync(FULL_MASK, s, 1 << k);
    m = imax(m, __shfl_up_sync(FULL_MASK, m, 1 << k));
    if (steps & (1u << k)) s = imax(s, us);
  }
}

__device__ __forceinline__ int warp_incl_max(int v) {
#pragma unroll
  for (int k = 0; k < 5; ++k) v = imax(v, __shfl_up_sync(FULL_MASK, v, 1 << k));
  return v;
}

__device__ __forceinline__ int warp_incl_seg_max(int v, unsigned steps) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int u = __shfl_up_sync(FULL_MASK, v, 1 << k);
    if (steps & (1u << k)) v = imax(v, u);
  }
  return v;
}

// The P int8 profile scores of one thread's positions as one word: each
// thread stores and reads only its own slots, so the profile needs no
// barrier.
template <int P>
struct Pack;
template <>
struct Pack<1> {
  using T = int8_t;
  __device__ static int at(T v, int) { return v; }
};
template <>
struct Pack<2> {
  using T = uint16_t;
  __device__ static int at(T v, int p) { return (int)(int8_t)(v >> (8 * p)); }
};
template <>
struct Pack<4> {
  using T = uint32_t;
  __device__ static int at(T v, int p) { return (int)(int8_t)(v >> (8 * p)); }
};
template <>
struct Pack<8> {
  using T = uint2;
  __device__ static int at(T v, int p) {
    return (int)(int8_t)((p < 4 ? v.x : v.y) >> (8 * (p & 3)));
  }
};

// P int16 values stored with one store (P = 2: 4 bytes, P = 4: 8).
template <int P>
__device__ __forceinline__ void store16(int16_t* dst, const int* v) {
  if constexpr (P == 1) {
    dst[0] = (int16_t)v[0];
  } else if constexpr (P == 2) {
    *reinterpret_cast<unsigned*>(dst) =
        (unsigned)(uint16_t)v[0] | ((unsigned)(uint16_t)v[1] << 16);
  } else {
    static_assert(P == 4, "store16: P is 1, 2 or 4");
    const unsigned lo = (unsigned)(uint16_t)v[0] | ((unsigned)(uint16_t)v[1] << 16);
    const unsigned hi = (unsigned)(uint16_t)v[2] | ((unsigned)(uint16_t)v[3] << 16);
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  }
}

// ---------------------------------------------------------------------------
// The per-row streams of one problem, which do not depend on the DP: the
// aa code, the donor and acceptor scores and (K1 only, LP) the log
// penalty.  Each warp keeps a tile of 32 genome rows in shared memory
// and has the next tile's global loads in flight in registers, issued
// 32 rows ahead, so a row reads its values from shared memory.
// ---------------------------------------------------------------------------

// rows i0..i0+31: aa code and log penalty, donor rows i0-1..i0+32,
// acceptor rows i0-2..i0+31
template <bool LP>
struct RowTile {
  int8_t c[32];
  int lp[LP ? 32 : 1];
  int D[34];
  int A[34];
};

// one row i's values: aa code, log penalty (0 without LP), donor at rows
// i-1, i, i+1 and acceptor at rows i-2, i-1, i
struct RowVals {
  int c, lp, dm1, d0, dp1, am2, am1, a0;
};

template <bool LP>
class RowStream {
 public:
  // nas, lp: (R,) rows of the problem; D, A: (RD,)
  __device__ __forceinline__ RowStream(RowTile<LP>& t, const int8_t* nas,
                                       const int32_t* lp, const int32_t* D,
                                       const int32_t* A, int R, int RD)
      : t_(t), nas_(nas), lp_(lp), D_(D), A_(A), R_(R), RD_(RD) {
    fetch(2);
    store();
    fetch(34);
  }
  // row 2's values
  __device__ __forceinline__ RowVals first() const { return at(0); }
  // row j's values, for j = 3, 4, ... in turn
  __device__ __forceinline__ RowVals next(int j) {
    const int k = (j - 2) & 31;
    if (k == 0) {
      store();
      fetch(j + 32);
    }
    return at(k);
  }

 private:
  // issue the global loads of the tile starting at row i0: lane k loads
  // entry k (and 32 + k for k < 2)
  __device__ __forceinline__ void fetch(int i0) {
    const int lane = threadIdx.x & 31;
    const bool in = i0 + lane < R_;
    c_ = in ? nas_[i0 + lane] : 0;
    if constexpr (LP) l_ = in ? lp_[i0 + lane] : 0;
    d_ = i0 - 1 + lane < RD_ ? D_[i0 - 1 + lane] : 0;
    a_ = i0 - 2 + lane < RD_ ? A_[i0 - 2 + lane] : 0;
    d2_ = lane < 2 && i0 + 31 + lane < RD_ ? D_[i0 + 31 + lane] : 0;
    a2_ = lane < 2 && i0 + 30 + lane < RD_ ? A_[i0 + 30 + lane] : 0;
  }
  __device__ __forceinline__ void store() {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    t_.c[lane] = (int8_t)c_;
    if constexpr (LP) t_.lp[lane] = l_;
    t_.D[lane] = d_;
    t_.A[lane] = a_;
    if (lane < 2) {
      t_.D[32 + lane] = d2_;
      t_.A[32 + lane] = a2_;
    }
    __syncwarp();
  }
  __device__ __forceinline__ RowVals at(int k) const {
    int l = 0;
    if constexpr (LP) l = t_.lp[k];
    return RowVals{t_.c[k], l, t_.D[k], t_.D[k + 1], t_.D[k + 2],
                   t_.A[k], t_.A[k + 1], t_.A[k + 2]};
  }

  RowTile<LP>& t_;
  const int8_t* nas_;
  const int32_t *lp_, *D_, *A_;
  int R_, RD_;
  int c_ = 0, l_ = 0, d_ = 0, a_ = 0, d2_ = 0, a2_ = 0;  // the tile in flight
};

// Segmented operator on (flag, value): flag = a segment starts inside
// the right operand, so the left operand's value is dropped.  Folds the
// per-warp totals of a multi-warp problem.
struct Seg {
  int f, v;
};
__device__ __forceinline__ Seg seg_combine(Seg l, Seg r) {
  return Seg{l.f | r.f, r.f ? r.v : imax(l.v, r.v)};
}
