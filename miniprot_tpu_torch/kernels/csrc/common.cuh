// Shared device helpers of the DP kernels: block-wide max scans over the
// protein positions a block holds (each thread owns P consecutive
// positions, so thread order is position order).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// saturating int16 arithmetic on int32 values (nasw_cigar_pallas._sadd16)
__device__ __forceinline__ int sat16(int x) { return imin(imax(x, -32768), 32767); }

// Exclusive max scan of one value per thread across the block, in
// thread order.  s_warp holds NW ints; the caller syncs nothing: this
// helper contains the one __syncthreads it needs, and s_warp may be
// rewritten only after the next block-wide barrier.
template <int NW>
__device__ __forceinline__ int block_excl_max(int v, int ident, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int u = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v = imax(v, u);
  }
  int ex = __shfl_up_sync(FULL_MASK, v, 1);
  if (lane == 0) ex = ident;
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int wp = ident;
  for (int w = 0; w < warp; ++w) wp = imax(wp, s_warp[w]);
  return imax(wp, ex);
}

// Segmented operator on (flag, value): flag = a segment starts inside
// the right operand, so the left operand's value is dropped.
struct Seg {
  int f, v;
};
__device__ __forceinline__ Seg seg_combine(Seg l, Seg r) {
  return Seg{l.f | r.f, r.f ? r.v : imax(l.v, r.v)};
}

// Exclusive segmented max scan (Seg per thread) together with a plain
// exclusive max scan (int per thread), one barrier for both.
template <int NW>
__device__ __forceinline__ void block_excl_seg_and_max(Seg& s, int& m, int ident,
                                                       int* s_f, int* s_v, int* s_m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int uf = __shfl_up_sync(FULL_MASK, s.f, d);
    int uv = __shfl_up_sync(FULL_MASK, s.v, d);
    int um = __shfl_up_sync(FULL_MASK, m, d);
    if (lane >= d) {
      s = seg_combine(Seg{uf, uv}, s);
      m = imax(m, um);
    }
  }
  Seg ex{__shfl_up_sync(FULL_MASK, s.f, 1), __shfl_up_sync(FULL_MASK, s.v, 1)};
  int exm = __shfl_up_sync(FULL_MASK, m, 1);
  if (lane == 0) {
    ex = Seg{0, ident};
    exm = ident;
  }
  if (lane == 31) {
    s_f[warp] = s.f;
    s_v[warp] = s.v;
    s_m[warp] = m;
  }
  __syncthreads();
  Seg wp{0, ident};
  int wm = ident;
  for (int w = 0; w < warp; ++w) {
    wp = seg_combine(wp, Seg{s_f[w], s_v[w]});
    wm = imax(wm, s_m[w]);
  }
  s = seg_combine(wp, ex);
  m = imax(wm, exm);
}

// Block-wide max (all threads get it); contains one __syncthreads.
template <int NW>
__device__ __forceinline__ int block_max(int v, int* s_warp) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = imax(v, __shfl_xor_sync(FULL_MASK, v, d));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = s_warp[0];
  for (int w = 1; w < NW; ++w) r = imax(r, s_warp[w]);
  return r;
}

// Value of the thread to the left (thread t-1's `v`), `edge` for
// thread 0.  s_edge holds NW ints; contains one __syncthreads.
template <int NW>
__device__ __forceinline__ int from_left(int v, int edge, int* s_edge) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int u = __shfl_up_sync(FULL_MASK, v, 1);
  if (lane == 31) s_edge[warp] = v;
  __syncthreads();
  if (lane == 0) u = warp > 0 ? s_edge[warp - 1] : edge;
  return u;
}

// from_left for two values with one barrier (s_a, s_b: NW ints each).
template <int NW>
__device__ __forceinline__ void from_left2(int va, int vb, int ea, int eb, int& ua,
                                           int& ub, int* s_a, int* s_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ua = __shfl_up_sync(FULL_MASK, va, 1);
  ub = __shfl_up_sync(FULL_MASK, vb, 1);
  if (lane == 31) {
    s_a[warp] = va;
    s_b[warp] = vb;
  }
  __syncthreads();
  if (lane == 0) {
    ua = warp > 0 ? s_a[warp - 1] : ea;
    ub = warp > 0 ? s_b[warp - 1] : eb;
  }
}
