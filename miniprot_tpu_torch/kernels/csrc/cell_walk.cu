// K5: per-cell walk of K4's striped traceback words into a state stream.
//
// Replaces miniprot_tpu/kernels/nasw_cigar_pallas.py:_device_backtrack
// (an XLA while_loop in the JAX package, not Pallas), which follows the
// host engine's dp_backtrack_st step for step: from (nl-1, al-1), read
// the word of cell (i, j) at striped column (j % slen)*8 + j / slen; a
// set bit 9 (lazy-F overwrote H with I) makes it state 1 with the
// extension bits kept; a gap run carries its state; states 4/5 consume
// a query column only when the cell is not a gap continuation.  One
// state (int8) per step until i < 2 or j < 0, then 15 to the end of the
// stream; the final (i, j) go out beside it.  The host replays the
// stream with native.cigar_from_states.
//
// Design: one thread per problem.  What bounds it: latency — each step
// is a dependent global load (the next cell depends on this one's
// word), about nl/3 + gaps steps per problem.
#include "common.cuh"

// per-state genome rows and query columns consumed (bt_step in
// native/mpnative.c); states 10..15 never occur on a path
__constant__ int kDI[16] = {3, 0, 3, 1, 1, 1, 1, 2, 1, 2};
__constant__ int kDJ[16] = {1, 1, 0, 0, 1, 1, 0, 0, 1, 1};

constexpr int kVL = 8;  // K4's saturating form: 8 lanes per stripe

__global__ void cell_walk_kernel(const int16_t* __restrict__ tb,
                                 const int32_t* __restrict__ nlv,
                                 const int32_t* __restrict__ alv,
                                 int8_t* __restrict__ states, int32_t* __restrict__ fi,
                                 int32_t* __restrict__ fj, int n, int TR, int W, int steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int16_t* tbb = tb + (size_t)b * TR * W;
  int8_t* so = states + (size_t)b * steps;
  const int al = alv[b];
  const int sl = imax((al + kVL - 1) / kVL, 1);
  int i = nlv[b] - 1, j = al - 1, last = 0, k = 0;
  for (; k < steps && i >= 2 && j >= 0; ++k) {
    int x = tbb[(size_t)i * W + (j % sl) * kVL + j / sl];
    if ((x >> 9) & 1) x = 1 | ((x >> 4) << 4);
    const int state = last == 0 ? (x & 0xF) : last;
    const int is_gap = state >= 1 && state <= 5;
    const int ext = is_gap ? (x >> (state + 3)) & 1 : 0;
    so[k] = (int8_t)state;
    i -= kDI[state];
    j -= (state == 4 || state == 5) ? 1 - ext : kDJ[state];
    last = is_gap && ext ? state : 0;
  }
  for (; k < steps; ++k) so[k] = 15;
  fi[b] = i;
  fj[b] = j;
}

extern "C" int mp_cell_walk(const void* tb, const void* nl, const void* al, void* states,
                            void* fi, void* fj, int n, int TR, int W, int steps,
                            void* stream) {
  const int nt = 128;
  cell_walk_kernel<<<(n + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      (const int16_t*)tb, (const int32_t*)nl, (const int32_t*)al, (int8_t*)states,
      (int32_t*)fi, (int32_t*)fj, n, TR, W, steps);
  return (int)cudaGetLastError();
}
