// K5: per-cell walk of K4's striped traceback words into a state stream.
//
// Replaces miniprot_tpu/kernels/nasw_cigar_pallas.py:_device_backtrack
// (an XLA while_loop in the JAX package, not Pallas), which follows the
// host engine's dp_backtrack_st step for step: from (nl-1, al-1), read
// the word of cell (i, j) at striped column (j % slen)*8 + j / slen; a
// set bit 9 (lazy-F overwrote H with I) makes it state 1 with the
// extension bits kept; a gap run carries its state; states 4/5 consume
// a query column only when the cell is not a gap continuation.  One
// state (int8) per step until i < 2 or j < 0 or `steps` states, then 15
// to the end of the stream; the final (i, j) go out beside it.  The host
// replays the stream with native.cigar_from_states.
//
// What bounds it: latency.  The next cell depends on this one's word,
// so a walk is a chain of about nl/3 + gap steps (up to ~22k in the
// 65536-row bucket); at one dependent global load per step (~0.5 us) a
// walk would take milliseconds.
//
// Design: one warp per problem (a one-warp block, so a batch's walks
// spread over the SMs), reading from a tile of the words in shared
// memory.  The path only moves up and left, by 0-3 rows and 0-1
// positions per step, so the tile covers rows (i0 - RT, i0] x
// positions (j0 - CT, j0], up and left of the cell (i0, j0) where it
// was filled; lane l fetches position j0 - l of all RT rows: RT
// asynchronous 4-byte copies (cp.async) of the aligned word holding the
// cell, issued back to back and waited for once, so a refill costs about
// one memory latency and no registers (loads into registers went out a
// few at a time: ptxas gave 96 of them 68 registers).  RT =
// 96, CT = 32: a 32-step match run (3 rows per step) or I run, or a
// 96-step intron run, per refill.  Inside the tile the warp walks up to
// 32 steps of one state per round: from the state s at (i, j), lane l
// takes the l-th cell along s's move (the diagonal for matches, the row
// or column of a gap), and ballots find where the walk leaves state s:
// for matches and gap states 1-3 (whose move does not depend on the
// extension bit), the first cell that the previous cell's extension bit
// does not carry and whose own state is not s; for B/C (4, 5), the cell
// after the first one whose extension bit is 0; or the first cell
// outside the walk's bounds, its step budget or the tile (the next
// round refills around it).  The lanes before it write the states with
// one store.  Frameshift states take one step per round.  Every lane
// runs the walk (the same values), so nothing is broadcast.
#include <cuda_pipeline_primitives.h>

#include "common.cuh"

namespace {

constexpr int kVL = 8;   // K4's saturating form: 8 lanes per stripe
constexpr int kRT = 96;  // tile rows
constexpr int kCT = 32;  // tile positions, one per lane

// per-state genome rows (two bits each) and query columns (one bit each)
// a step consumes (bt_step in native/mpnative.c); states 10..15 never
// occur on a path: DI = {3, 0, 3, 1, 1, 1, 1, 2, 1, 2},
// DJ = {1, 1, 0, 0, 1, 1, 0, 0, 1, 1}
constexpr unsigned kDI = 3u | 0u << 2 | 3u << 4 | 1u << 6 | 1u << 8 | 1u << 10 |
                         1u << 12 | 2u << 14 | 1u << 16 | 2u << 18;
constexpr unsigned kDJ = 0x333u;

// the walk's reading of a word: bit 9 makes it state 1, bits 4-8 kept
__device__ __forceinline__ int walk_word(int x) {
  return (x >> 9) & 1 ? 1 | ((x >> 4) << 4) : x;
}

}  // namespace

__global__ void __launch_bounds__(32) cell_walk_kernel(const int16_t* __restrict__ tb,
                                                       const int32_t* __restrict__ nlv,
                                                       const int32_t* __restrict__ alv,
                                                       int8_t* __restrict__ states,
                                                       int32_t* __restrict__ fi,
                                                       int32_t* __restrict__ fj, int TR,
                                                       int W, int steps) {
  // the 4-byte word of each cell's column pair; bit c of par: the cell of
  // tile column c is its word's high half
  __shared__ uint32_t tile[kRT][kCT];
  unsigned par = 0;
  const int b = blockIdx.x, lane = threadIdx.x;
  const int16_t* tbb = tb + (size_t)b * TR * W;
  int8_t* so = states + (size_t)b * steps;
  const int al = alv[b];
  const int sl = imax((al + kVL - 1) / kVL, 1);
  int i = nlv[b] - 1, j = al - 1, last = 0, k = 0;
  int i0 = 1 << 30, j0 = 0;  // the tile's corner (none yet)
  while (k < steps && i >= 2 && j >= 0) {
    if (i <= i0 - kRT || j <= j0 - kCT) {
      // refill around (i, j): lane l copies position j - l of rows i,
      // i-1, ..., i-RT+1 (rows < 2 and positions < 0 are never read)
      i0 = i;
      j0 = j;
      const int q = j - lane;
      const int c = q >= 0 ? (q % sl) * kVL + q / sl : 0;
      par = __ballot_sync(FULL_MASK, c & 1);
      const int16_t* src = tbb + (c & ~1);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRT; ++r)
        if (q >= 0 && i - r >= 2) __pipeline_memcpy_async(&tile[r][lane], src + (size_t)(i - r) * W, 4);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
    }
    // the word of tile cell (r, c)
    auto cell = [&](int r, int c) { return (int)(tile[r][c] >> (16 * ((par >> c) & 1))) & 0xFFFF; };
    // the state at (i, j), and the move from the run's l-th cell to the
    // next: the diagonal for a match run, a gap's extension move
    const int x0 = walk_word(cell(i0 - i, j0 - j));
    const int s = last ? last : x0 & 15;
    const int gap = s >= 1 && s <= 5;
    const int di = s == 0 ? 3 : gap ? (s == 1 ? 0 : s == 2 ? 3 : 1) : (kDI >> (2 * s)) & 3;
    const int dj = s <= 1 ? 1 : gap ? 0 : (kDJ >> s) & 1;
    // lane l's cell; whether the walk can reach it in this round
    const int il = i - lane * di, jl = j - lane * dj;
    const bool in = il >= 2 && jl >= 0 && k + lane < steps && i0 - il < kRT && j0 - jl < kCT;
    const int x = in ? walk_word(cell(i0 - il, j0 - jl)) : 0;
    // the run's length L: cells 0..L-1 emit s
    int L;
    bool ended = false;  // a B/C run ended at cell L-1 (extension bit 0)
    if (s <= 3) {
      // matches and gap states 1-3 move the same way on every step: the
      // walk goes on in state s into a cell that the previous cell's
      // extension bit carries or whose own state is s
      const unsigned ext = __ballot_sync(FULL_MASK, in && s > 0 && ((x >> (s + 3)) & 1));
      const bool carried = lane > 0 && ((ext >> (lane - 1)) & 1);
      const unsigned brk =
          __ballot_sync(FULL_MASK, lane > 0 && (!in || (!carried && (x & 15) != s)));
      L = brk ? __ffs(brk) - 1 : 32;
      last = (ext >> (L - 1)) & 1 ? s : 0;
    } else if (gap) {
      // a B/C run goes on after each cell whose extension bit is set
      const unsigned out = __ballot_sync(FULL_MASK, !in);
      const unsigned end = __ballot_sync(FULL_MASK, in && !((x >> (s + 3)) & 1));
      const int lo = out ? __ffs(out) - 1 : 32;
      const int le = end ? __ffs(end) : 33;
      ended = le <= lo;
      L = ended ? le : lo;
      last = ended ? 0 : s;
    } else {
      L = 1;  // a frameshift move
      last = 0;
    }
    if (lane < L) so[k + lane] = (int8_t)s;
    k += L;
    i -= L * di;
    j -= L * dj + (ended ? 1 : 0);  // a B/C run ends on a diagonal step
  }
  // the end of the stream: 15, by 16-byte stores where aligned
  int8_t* p = so + k;
  int8_t* const e = so + steps;
  const int head = imin((int)((16 - ((uintptr_t)p & 15)) & 15), (int)(e - p));
  if (lane < head) p[lane] = 15;
  p += head;
  const int nv = (int)(e - p) / 16;
  const uint4 f = make_uint4(0x0f0f0f0fu, 0x0f0f0f0fu, 0x0f0f0f0fu, 0x0f0f0f0fu);
  for (int v = lane; v < nv; v += 32) reinterpret_cast<uint4*>(p)[v] = f;
  p += 16 * nv;
  if (lane < e - p) p[lane] = 15;
  if (lane == 0) {
    fi[b] = i;
    fj[b] = j;
  }
}

extern "C" int mp_cell_walk(const void* tb, const void* nl, const void* al, void* states,
                            void* fi, void* fj, int n, int TR, int W, int steps,
                            void* stream) {
  cell_walk_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(
      (const int16_t*)tb, (const int32_t*)nl, (const int32_t*)al, (int8_t*)states,
      (int32_t*)fi, (int32_t*)fj, TR, W, steps);
  return (int)cudaGetLastError();
}
