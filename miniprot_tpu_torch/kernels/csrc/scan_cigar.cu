// K2: full splice/frameshift DP with traceback words, saturating int16
// (ns_global_gs16b with NS_F_CIGAR, nasw-sse.c:444-541).
//
// Replaces miniprot_tpu/kernels/nasw_cigar_scan.py:_scan_kernel, both
// its SUB=1 form (al <= 512) and its SUB=4 stacked small class
// (al <= 32).  Same words: the state nibble from the strict-> priority
// chain with the pass-1 (segmented) I, bit 4 from the segmented scan,
// bits 5-8 from the D/A/B/C extend tests, bit 9 from the full-row scan,
// and the run-length hint plane (diagonal ring and D ring of period
// i-3, A/B/C carries, I runs inside one stripe segment).  Saturating
// int16 is a clip on int32.  Needs go >= 1 (the wrapper checks).
//
// Design.  A problem runs on NWP warps of a 128-thread block, P
// consecutive positions per thread (W = 32 * NWP * P), and the block
// holds 4 / NWP problems, each running its own nl.  The wrapper picks
// the geometry per launch (nasw_cigar_scan.scan_warps): one warp per
// problem (W=32: P=1; W=128: P=4) when the launch holds enough problems
// to give every scheduler of the card work, else the problem spread
// over more warps (W=128: 2 warps at P=2; W=512 always 4 warps at
// P=4) to shorten each row's chain.  Genome rows loop inside
// the warp; per row:
//   1. each thread computes its P positions' order-free candidates,
//      the extension bits 5-8 and, for the priority chain, the first
//      maximum among D, A, B, C and the four frameshift moves as a
//      tree of depth 3 (so the chain needs only match, I and that pair
//      once I is known);
//   2. the segmented and the full prefix max of u = sat(base - go) +
//      q*ge run as one 5-step shuffle scan (segments by lane index
//      arithmetic: no flags travel; every segment test is a bit mask
//      computed once per problem);
//   3. I, H, the state nibble and bits 4 and 9 per position, bit 4's
//      left neighbour by one shuffle;
//   4. the I-run length (distance to the last position without bit 4)
//      by one ballot and one shuffle instead of a scan;
//   5. branchless run-length hints; each thread stores its P tb and P
//      hint values with one store per plane (8 B at P = 4) and hands H
//      and the match-run counter to the right by shuffle.
// Steps 1-3 are common.cuh's NS_F_CIGAR row (CigRow, warp_carry, row_i,
// pass1), which K4 (striped_cigar.cu) computes too; the run
// counters, the hints and bit 9's state rewrite are K2's own.
// A one-warp problem has no barrier at all.  A multi-warp problem meets
// once per row at its own named barrier (bar.sync 1 + slot, 32 * NWP),
// in a buffer that alternates with the row's parity: each warp leaves
// its scan totals and its last position's local prefixes and base, from
// which the next warp rebuilds its left neighbour's I, t4 and H; the
// match-run counter of that position and the warp's last position
// without bit 4 travel with the next row's exchange, so a row's hints
// are stored one row late (and once more after the loop).  The per-row
// streams (the aa code, three donor and three acceptor values) come
// from common.cuh's RowStream, a per-warp tile of 32 rows in shared
// memory with the next tile's loads in flight; each row's values and
// profile word are read at the end of the row before.  The profile
// sits in shared memory in per-thread slots of P bytes, written and
// read only by its own thread.
//
// What bounds it on an H100: it writes 4 bytes per cell (tb + hint)
// and reads almost nothing per cell (9 track bytes per row), so the
// bound is memory, 4 B/cell at 3.35 TB/s.  The recurrence itself needs
// ~64 int16 operations per cell (chip_smoke.py computes both bounds).
// The kernel keeps int32 registers with the int16 clips: a clipped add
// is two instructions per position (VIADDMNMX, VIMNMX).  Two positions
// per register (int16x2) would halve the maxima (__vmaxs2 and
// __vimax3_s16x2 are one instruction each), but the saturating add
// __vaddss2 takes six and __viaddmax_s16x2 wraps at the int16 floor
// that the sentinels sit on (chip_smoke.py's int16x2 probe prints the
// SASS); a packed form of the max chains is not tried yet (ROADMAP).
// Each warp issues its row in order, so a warp alone on its
// scheduler is latency-bound: a row is a chain of ~5 dependent
// shuffles plus a few hundred instructions.  Launches of hundreds of
// problems (device.cig_capacity) fill the card's 528 schedulers and
// reach its throughput; the e2e map's W=128 launches hold few problems
// and stay latency-bound (PERF.md).
#include "common.cuh"

template <int P, int NWP>
__global__ void __launch_bounds__(128) scan_cigar_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, const int8_t* __restrict__ prof,
    int16_t* __restrict__ tb, int16_t* __restrict__ hint, int32_t* __restrict__ score,
    int n, int R, int RD, int TR, int go, int ge, int fs) {
  constexpr int PPB = 4 / NWP;  // problems per block
  constexpr int NT = 32 * NWP;  // threads per problem
  constexpr int W = P * NT;
  using Pk = typename Pack<P>::T;
  __shared__ Pk s_prof[PPB][22][NT];
  __shared__ RowTile<false> s_row[4];
  __shared__ CigX s_sx[2][PPB][NWP];  // by row parity
  const int g = threadIdx.x / NT;
  const int b = blockIdx.x * PPB + g;
  if (b >= n) return;  // whole problems leave together
  const int tp = threadIdx.x % NT, lane = threadIdx.x & 31, wp = tp >> 5;
  const int q0 = tp * P, qw = wp * 32 * P;
  const int nl = imin(nlv[b], TR), al = alv[b];
  const int slen = imax((al + 7) / 8, 1);
  const SegMasks<P> m(q0, wp, slen);
  const int8_t* pb = prof + (size_t)b * 22 * W;
  for (int c = 0; c < 22; ++c)
    s_prof[g][c][tp] = *reinterpret_cast<const Pk*>(pb + c * W + q0);
  int16_t* tbb = tb + (size_t)b * TR * W;
  int16_t* hib = hint + (size_t)b * TR * W;
  RowStream<false> rs(s_row[threadIdx.x >> 5], nas + (size_t)b * R, nullptr,
                      Dtr + (size_t)b * RD, Atr + (size_t)b * RD, R, RD);
  RowVals rv = rs.first();
  Pk sp = s_prof[g][rv.c][tp];

  CigRow<P> r(tp, fs);
  // run counters: match runs of rows i-1..i-3 (and of position q0 - 1),
  // D runs of rows i-1..i-3, A/B/C runs
  int C01[P], C02[P], C03[P], CD1[P], CD2[P], CD3[P], CA[P], CB[P], CC[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    C01[p] = C02[p] = C03[p] = CD1[p] = CD2[p] = CD3[p] = 0;
    CA[p] = CB[p] = CC[p] = 0;
  }
  int LC1 = 0, LC2 = 0, LC3 = 0;
  int scv = NEG16;
  // a multi-warp problem stores a row's hints one row late: a hint of an
  // I run that starts in an earlier warp waits for that warp's last
  // position without bit 4 (bit p of pend: the value is q - that)
  int hvp[P], pend = 0, c0_last = 0, x1_last = -1;
  size_t offp = 0;

  for (int i = 2; i < nl; ++i) {
    const int gei = rv.c == 20 ? fs : ge;
    // 1. order-free candidates
    int S[P];
#pragma unroll
    for (int p = 0; p < P; ++p) S[p] = q0 + p < al ? Pack<P>::at(sp, p) : NEG16;
    // the D and A/B/C run counters need only bits 5-8: computed with the
    // candidates, they fill the issue slots of the scan's shuffles below
    RowTerms<P> t;
    int cntD[P];
    r.candidates(S, rv, q0, m.stm, go, ge, gei, fs, t, [&](int p, int bt) {
      cntD[p] = (bt >> 5) & 1 ? CD3[p] + 1 : 0;
      CA[p] = (bt >> 6) & 1 ? CA[p] + 1 : 0;
      CB[p] = (bt >> 7) & 1 ? CB[p] + 1 : 0;
      CC[p] = (bt >> 8) & 1 ? CC[p] + 1 : 0;
    });
    // 2. segmented and full prefix max of u
    int svi = t.sv, fmi = t.fm;
    warp_incl_max2(svi, m.steps, fmi);
    int exs = __shfl_up_sync(FULL_MASK, svi, 1);
    int exf = __shfl_up_sync(FULL_MASK, fmi, 1);
    if (lane == 0) exs = exf = NEGI;
    int carry_s = NEGI, carry_f = NEGI;  // up to position qw - 1
    int il = NEGI, tl = 0;               // (Iused, t4) at q0 - 1 for lane 0
    int hedge = NEG16;                   // H at q0 - 1 for lane 0
    if constexpr (NWP > 1) {
      CigX(*sx)[NWP] = s_sx[i & 1];
      if (lane == 31)
        sx[g][wp] = CigX{svi, fmi, m.vl_own ? t.svl : imax(exs, t.svl),
                          imax(exf, t.fml), t.base[P - 1], c0_last, x1_last};
      bar_sync(1 + g, NT);
      const WarpCarry c = warp_carry<P, NWP, true>(sx[g], wp, m, go, ge);
      carry_s = c.seg;
      carry_f = c.full;
      if (wp > 0) {
        il = c.il;
        tl = c.tl;
        hedge = c.hedge;
      }
      // the previous row's hints, now that the I-run carry is known
      if (i > 2) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          if ((pend >> p) & 1) hvp[p] = q0 + p - c.x1;
        store16<P>(hib + offp, hvp);
      }
      if (lane == 0 && wp > 0) {
        LC3 = LC2;
        LC2 = LC1;
        LC1 = c.x0;
      }
    }
    const int segc = m.s0start < qw ? imax(exs, carry_s) : exs;
    const int fullc = imax(exf, carry_f);
    // 3. I, H and the word
    int Iused[P], hp1[P], t4[P], Hfin[P], b9[P];
    row_i<P, true>(t, m.stm, q0, segc, fullc, go, ge, Iused, hp1, t4, Hfin, b9);
    {
      const int iu = __shfl_up_sync(FULL_MASK, Iused[P - 1], 1);
      const int tu = __shfl_up_sync(FULL_MASK, t4[P - 1], 1);
      if (lane != 0) {
        il = iu;
        tl = tu;
      }
    }
    int wd[P], s0[P], cnt0[P], x1 = -1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      int y, b4;
      pass1(t, p, Iused[p], p ? Iused[p - 1] : il, p ? t4[p - 1] : tl, (m.stm >> p) & 1,
            y, b4);
      // the walk's state: 1 where lazy-F overwrote H with I
      s0[p] = b9[p] ? 1 : y;
      wd[p] = (t.wd[p] & ~15) | s0[p] | (b4 << 4) | (b9[p] << 9);
      x1 = imax(x1, b4 ? -1 : q);
      const int c03m1 = p ? C03[p - 1] : LC3;
      cnt0[p] = s0[p] == 0 ? c03m1 + 1 : 0;
    }
    // 4. hand H and the match-run counter to the right; the last
    // position without bit 4 before this thread (-1: none in this warp)
    int hl = __shfl_up_sync(FULL_MASK, Hfin[P - 1], 1);
    const int cl = __shfl_up_sync(FULL_MASK, cnt0[P - 1], 1);
    if constexpr (NWP > 1) {
      x1_last = __reduce_max_sync(FULL_MASK, x1);
      c0_last = cnt0[P - 1];
      if (lane == 0 && wp > 0) hl = hedge;
    }
    const unsigned mb = __ballot_sync(FULL_MASK, x1 >= 0) & lanemask_lt();
    const int xv = __shfl_sync(FULL_MASK, x1, mb ? 31 - __clz(mb) : 0);
    int lz = mb ? xv : -1;
    pend = 0;
    // 5. hints, stores, rings
    int hv[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      const int bits = wd[p];
      lz = imax(lz, (bits >> 4) & 1 ? -1 : q);
      const int cnt1 = q - lz;
      const int sp0 = s0[p];
      // an I run from an earlier warp: finished at the next barrier
      if (NWP > 1 && sp0 == 1 && lz < 0) pend |= 1u << p;
      // the run length of the cell's own state (selects, no branches)
      int v = sp0 == 0 ? cnt0[p] - 1 : 0;
      v = sp0 == 1 ? cnt1 : v;
      v = sp0 == 2 ? cntD[p] : v;
      v = sp0 == 3 ? CA[p] : v;
      v = sp0 == 4 ? CB[p] : v;
      v = sp0 == 5 ? CC[p] : v;
      hv[p] = v;
      if (i == nl - 1 && q == al - 1) scv = Hfin[p];
      CD3[p] = CD2[p];
      CD2[p] = CD1[p];
      CD1[p] = cntD[p];
      C03[p] = C02[p];
      C02[p] = C01[p];
      C01[p] = cnt0[p];
    }
    r.advance(Hfin, t.Dn);
    const size_t off = (size_t)i * W + q0;
    store16<P>(tbb + off, wd);
    if constexpr (NWP > 1) {
#pragma unroll
      for (int p = 0; p < P; ++p) hvp[p] = hv[p];
      offp = off;
    } else {
      store16<P>(hib + off, hv);
    }
    // the next row's streams and profile word
    rv = rs.next(i + 1);
    sp = s_prof[g][rv.c][tp];
    // boundary column: NEG from row 3 on (the -fs values are cleared
    // once row 2 consumed them), match-run counter 0
    r.advance_left(tp, hl);
    if (tp != 0 && (NWP == 1 || lane != 0)) {  // lane 0 of a later warp: one row late
      LC3 = LC2;
      LC2 = LC1;
      LC1 = cl;
    }
  }
  if constexpr (NWP > 1) {
    // the last row's hints: one more exchange of the I-run carry
    if (nl > 2) {
      CigX(*sx)[NWP] = s_sx[nl & 1];
      if (lane == 31) sx[g][wp].x1 = x1_last;
      bar_sync(1 + g, NT);
      int xcarry = -1;
#pragma unroll
      for (int w = 0; w < NWP - 1; ++w)
        if (w < wp) xcarry = imax(xcarry, sx[g][w].x1);
#pragma unroll
      for (int p = 0; p < P; ++p)
        if ((pend >> p) & 1) hvp[p] = q0 + p - xcarry;
      store16<P>(hib + offp, hvp);
    }
  }
  if (q0 <= al - 1 && al - 1 < q0 + P) score[b] = scv;
}

template <int P, int NWP>
static void launch(const int8_t* nas, const int32_t* D, const int32_t* A,
                   const int32_t* nl, const int32_t* al, const int8_t* prof,
                   int16_t* tb, int16_t* hint, int32_t* score, int n, int R, int RD,
                   int TR, int go, int ge, int fs, cudaStream_t st) {
  constexpr int PPB = 4 / NWP;
  scan_cigar_kernel<P, NWP><<<(n + PPB - 1) / PPB, 128, 0, st>>>(
      nas, D, A, nl, al, prof, tb, hint, score, n, R, RD, TR, go, ge, fs);
}

extern "C" int mp_scan_cigar(const void* nas, const void* D, const void* A,
                             const void* nl, const void* al, const void* prof,
                             void* tb, void* hint, void* score, int n, int R, int RD,
                             int W, int TR, int go, int ge, int fs, int nwp,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto a = (const int8_t*)nas;
  auto d = (const int32_t*)D;
  auto ac = (const int32_t*)A;
  auto nv = (const int32_t*)nl;
  auto av = (const int32_t*)al;
  auto pr = (const int8_t*)prof;
  auto t = (int16_t*)tb;
  auto h = (int16_t*)hint;
  auto s = (int32_t*)score;
  // nwp: warps per problem (kernels/nasw_cigar_scan.py:scan_warps)
#define MP_SCAN(P, NWP) launch<P, NWP>(a, d, ac, nv, av, pr, t, h, s, n, R, RD, TR, go, ge, fs, st)
  switch (W) {
    case 32:
      if (nwp == 1) MP_SCAN(1, 1);
      else return (int)cudaErrorInvalidValue;
      break;
    case 128:
      if (nwp == 1) MP_SCAN(4, 1);
      else if (nwp == 2) MP_SCAN(2, 2);
      else return (int)cudaErrorInvalidValue;
      break;
    case 512:
      if (nwp == 4) MP_SCAN(4, 4);
      else return (int)cudaErrorInvalidValue;
      break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MP_SCAN
  return (int)cudaGetLastError();
}
