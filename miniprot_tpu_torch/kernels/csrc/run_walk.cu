// K3: run-walk over K2's traceback words and run-length hints.
//
// Replaces miniprot_tpu/kernels/nasw_cigar_scan.py:_run_backtrack (an
// XLA while_loop in the JAX package, not Pallas).  Each round reads
// (word, hint) at (i, j), emits (state, count = hint + 1) and steps a
// whole run: di = count*DIM[s] + DIC[s], dj = count*DJM[s] + DJC[s],
// until i < 2 or j < 0 or the round cap; unused rounds are (15, 0).
// The host expands the runs and decodes them with the native
// cigar_from_states, and redoes a problem whose walk hit the cap.
//
// What bounds it: latency.  Each round is a dependent pair of global
// loads (the next cell depends on this one), a few dozen to a few
// hundred rounds per problem; the padding of the round streams (up to
// 2048 rounds of 3 bytes) is the only bulk traffic.
//
// Design: one warp per problem in a one-warp block (as K5, cell_walk.cu),
// so a batch's walks spread over the SMs.  Every lane runs the walk (the
// same loads, one transaction each: nothing is broadcast), issuing the
// word and hint loads together; lane l keeps round l of each 32, and
// the warp stores 32 rounds at a time with one coalesced store per
// stream.  The padding goes out as 16-byte stores across the warp.
#include "common.cuh"

namespace {

// per-state steps (states 10..15 never occur on a path; their steps are
// 0): DIM = {3, 0, 3, 1, 1, 1, 0, 0, 0, 0} and DIC = {0, 0, 0, 0, 0, 0,
// 1, 2, 1, 2}, two bits each; DJM = {1, 1, 0, ...} and DJC = {0, 0, 0, 0,
// 1, 1, 0, 0, 1, 1}, one bit each
constexpr unsigned kDIM = 3u | 3u << 4 | 1u << 6 | 1u << 8 | 1u << 10;
constexpr unsigned kDIC = 1u << 12 | 2u << 14 | 1u << 16 | 2u << 18;
constexpr unsigned kDJM = 0x3u;
constexpr unsigned kDJC = 0x330u;

// bytes [p, e) set to v (v4: v in each byte) by the warp: 16-byte stores
// where aligned, single bytes at the two ends
__device__ __forceinline__ void warp_fill(uint8_t* p, uint8_t* const e, uint8_t v,
                                          unsigned v4, int lane) {
  const int head = imin((int)((16 - ((uintptr_t)p & 15)) & 15), (int)(e - p));
  if (lane < head) p[lane] = v;
  p += head;
  const int nv = (int)(e - p) / 16;
  const uint4 f = make_uint4(v4, v4, v4, v4);
  for (int q = lane; q < nv; q += 32) reinterpret_cast<uint4*>(p)[q] = f;
  p += 16 * nv;
  if (lane < e - p) p[lane] = v;
}

}  // namespace

__global__ void __launch_bounds__(32) run_walk_kernel(
    const int16_t* __restrict__ tb, const int16_t* __restrict__ hint,
    const int32_t* __restrict__ nlv, const int32_t* __restrict__ alv,
    int8_t* __restrict__ states, int16_t* __restrict__ counts, int32_t* __restrict__ fi,
    int32_t* __restrict__ fj, int TR, int W, int rounds) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const int16_t* tbb = tb + (size_t)b * TR * W;
  const int16_t* hib = hint + (size_t)b * TR * W;
  int8_t* so = states + (size_t)b * rounds;
  int16_t* co = counts + (size_t)b * rounds;
  int i = nlv[b] - 1, j = alv[b] - 1, k = 0;
  int my_s = 15, my_e = 0;  // round k of the group where k % 32 == lane
  while (k < rounds && i >= 2 && j >= 0) {
    const size_t off = (size_t)i * W + j;
    const int x = tbb[off];
    const int h = hib[off];
    const int s = x & 0xF;
    const int e = (h & 0xFFFF) + 1;
    if ((k & 31) == lane) {
      my_s = s;
      my_e = e;
    }
    i -= e * (int)((kDIM >> (2 * s)) & 3) + (int)((kDIC >> (2 * s)) & 3);
    j -= e * (int)((kDJM >> s) & 1) + (int)((kDJC >> s) & 1);
    if ((++k & 31) == 0) {
      so[k - 32 + lane] = (int8_t)my_s;
      co[k - 32 + lane] = (int16_t)my_e;
    }
  }
  const int kb = k & ~31;
  if (lane < k - kb) {
    so[kb + lane] = (int8_t)my_s;
    co[kb + lane] = (int16_t)my_e;
  }
  warp_fill(reinterpret_cast<uint8_t*>(so + k), reinterpret_cast<uint8_t*>(so + rounds), 15,
            0x0f0f0f0fu, lane);
  warp_fill(reinterpret_cast<uint8_t*>(co + k), reinterpret_cast<uint8_t*>(co + rounds), 0, 0u,
            lane);
  if (lane == 0) {
    fi[b] = i;
    fj[b] = j;
  }
}

extern "C" int mp_run_walk(const void* tb, const void* hint, const void* nl,
                           const void* al, void* states, void* counts, void* fi,
                           void* fj, int n, int TR, int W, int rounds, void* stream) {
  run_walk_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(
      (const int16_t*)tb, (const int16_t*)hint, (const int32_t*)nl, (const int32_t*)al,
      (int8_t*)states, (int16_t*)counts, (int32_t*)fi, (int32_t*)fj, TR, W, rounds);
  return (int)cudaGetLastError();
}
