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
// Design: one thread per problem.  What bounds it: latency — each round
// is a dependent pair of global loads (the next cell depends on this
// one), a few hundred rounds per problem on real paths; one round on
// the device costs one load latency, where a torch loop would pay a
// host sync per round.
#include "common.cuh"

// states 10..15 never occur on a path; their steps are 0
__constant__ int kDIM[16] = {3, 0, 3, 1, 1, 1, 0, 0, 0, 0};
__constant__ int kDIC[16] = {0, 0, 0, 0, 0, 0, 1, 2, 1, 2};
__constant__ int kDJM[16] = {1, 1, 0, 0, 0, 0, 0, 0, 0, 0};
__constant__ int kDJC[16] = {0, 0, 0, 0, 1, 1, 0, 0, 1, 1};

__global__ void run_walk_kernel(const int16_t* __restrict__ tb,
                                const int16_t* __restrict__ hint,
                                const int32_t* __restrict__ nlv,
                                const int32_t* __restrict__ alv, int8_t* __restrict__ states,
                                int16_t* __restrict__ counts, int32_t* __restrict__ fi,
                                int32_t* __restrict__ fj, int n, int TR, int W, int rounds) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int16_t* tbb = tb + (size_t)b * TR * W;
  const int16_t* hib = hint + (size_t)b * TR * W;
  int8_t* so = states + (size_t)b * rounds;
  int16_t* co = counts + (size_t)b * rounds;
  int i = nlv[b] - 1, j = alv[b] - 1;
  int k = 0;
  for (; k < rounds && i >= 2 && j >= 0; ++k) {
    const size_t off = (size_t)i * W + j;
    const int s = tbb[off] & 0xF;
    const int e = ((int)hib[off] & 0xFFFF) + 1;
    so[k] = (int8_t)s;
    co[k] = (int16_t)e;
    i -= e * kDIM[s] + kDIC[s];
    j -= e * kDJM[s] + kDJC[s];
  }
  for (; k < rounds; ++k) {
    so[k] = 15;
    co[k] = 0;
  }
  fi[b] = i;
  fj[b] = j;
}

extern "C" int mp_run_walk(const void* tb, const void* hint, const void* nl,
                           const void* al, void* states, void* counts, void* fi,
                           void* fj, int n, int TR, int W, int rounds, void* stream) {
  const int nt = 128;
  run_walk_kernel<<<(n + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      (const int16_t*)tb, (const int16_t*)hint, (const int32_t*)nl, (const int32_t*)al,
      (int8_t*)states, (int16_t*)counts, (int32_t*)fi, (int32_t*)fj, n, TR, W, rounds);
  return (int)cudaGetLastError();
}
