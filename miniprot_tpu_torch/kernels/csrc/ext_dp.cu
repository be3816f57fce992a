// K1: score-only splice/frameshift extension DP (nasw-sse.c:340-443).
//
// Replaces miniprot_tpu/kernels/nasw_pallas.py:_ext_kernel (the Pallas
// TPU kernel built by _make_ext_call).  Same arithmetic: int32 without
// saturation (exact under device.ext_fits_int16), the I state as an
// exact prefix max over protein positions, the row max plus end bonus,
// the log-length-adjusted best row, x-drop termination and the final
// aa_len pass.  At go == 0 the I state follows the host engine instead
// (the reference's lazy-F breaks at its first step there): a prefix max
// inside each SSE lane's run of ceil(al/8) positions, then one step
// from each lane's last position into the next lane's first
// (kernels/nasw_ext.py's docstring).
//
// Design.  A problem runs on NWP warps of a 128-thread block, P
// consecutive positions per thread (AL = 32 * NWP * P): AL = 128 one
// warp at P = 4; AL = 512 four warps at P = 4; AL = 1024 four warps at
// P = 8 (nasw_ext.EXT_WARPS).  The block holds 4 / NWP problems;
// each problem stops at its own x-drop or its own nl.  The go == 0 form
// is a separate instantiation (GO0), so the go >= 1 form carries none of
// its per-problem masks.
// Per row each thread computes its P positions with Hopper's DPX
// instructions (__viaddmax_s32 for the max(a + b, c) steps of D, A, B,
// C and a depth-2 candidate tree, __vimax3_s32 for the three-way
// maxima), then the I state is one 5-step shuffle scan (segmented by
// lane arithmetic at go == 0, its bit masks computed once per problem,
// plus one shuffle for the lazy-F step), the row max one
// __reduce_max_sync, and H of the thread's first position comes from
// its left neighbour by shuffle.  A one-warp problem has no barrier; a
// multi-warp problem meets once per row at its own named barrier
// (bar.sync 1 + slot, 32 * NWP), where each warp leaves its local scan
// total, row max and last H: every warp then adds the carry of the
// warps before it to its own H, rebuilds the row max (max over warps of
// the local max and carry + max_q(end bonus - q*ge) - go) and its left
// neighbour's H.  At go == 0 the lazy-F step makes a warp's first H
// depend on the warp before it, so that form meets a second time.  The
// exchange buffer alternates with the row's parity.  The row streams (aa
// code, three donor, three acceptor and the log-penalty values) come
// from common.cuh's RowStream, a per-warp tile of 32 rows in shared
// memory with the next tile's loads in flight; each row's values and
// profile word are read at the end of the row before.  The
// profile sits in per-thread shared slots of P bytes, written and read
// only by its own thread.
//
// What bounds it on an H100: per cell it reads nothing from device
// memory (the row streams are 8 words per ROW), so the bound is the
// integer pipe: the recurrence needs 32 operations per cell (the host
// engine's dp16_ext_w inner loop), done here on int32 in ~20
// instructions with the DPX fusions.  Each warp issues its row in
// order, so a warp alone on its scheduler is latency-bound (a row is a
// chain of ~7 dependent shuffles and a reduction); the engine's batches
// put up to 1024 problems in a launch (device.ext_capacity) so that
// every scheduler has several warps to switch between.
#include "common.cuh"

#define NEG (-(1 << 29))

namespace {

// per-warp values a multi-warp problem exchanges at its first barrier of
// a row, all local to the warp (without the earlier warps' carry)
struct ScanX {
  int t;   // go > 0: max of h + q*ge; go == 0: segmented max
  int v;   // go > 0: the row max with the end bonus; go == 0: segmented
           // max before the warp's last position
  int hl;  // H at the warp's last position (go == 0: before I)
};
struct RowX {
  int rm;  // the warp's row max (+ end bonus)
  int h;   // H at the warp's last position
};

}  // namespace

// GO0: the go == 0 form (8-lane lazy-F), which the launch picks for
// go <= 0 as ext_dp_plain does
template <int P, int NWP, bool GO0>
__global__ void __launch_bounds__(128) ext_dp_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ logpen,
    const int32_t* __restrict__ nlv, const int32_t* __restrict__ alv,
    const int8_t* __restrict__ prof, int32_t* __restrict__ out, int n, int R, int RD,
    int go, int ge, int fs, int xdrop, int end_bonus) {
  constexpr int PPB = 4 / NWP;  // problems per block
  constexpr int NT = 32 * NWP;  // threads per problem
  constexpr int AL = P * NT;
  using Pk = typename Pack<P>::T;
  __shared__ Pk s_prof[PPB][22][NT];
  __shared__ RowTile<true> s_row[4];
  __shared__ ScanX s_sx[2][PPB][NWP];  // by row parity
  __shared__ RowX s_rx[PPB][NWP];
  __shared__ int s_fin[PPB][NWP];
  const int g = threadIdx.x / NT;
  const int b = blockIdx.x * PPB + g;
  if (b >= n) return;  // whole problems leave together
  const int tp = threadIdx.x % NT, lane = threadIdx.x & 31, wp = tp >> 5;
  const int q0 = tp * P, qw = wp * 32 * P;
  const int nl = nlv[b], al = alv[b];
  const int sl = imax((al + 7) / 8, 1);  // SSE lane length (go == 0)
  const unsigned steps = seg_steps((((q0 + P - 1) / sl) * sl) / P - wp * 32);
  const int s0start = (q0 / sl) * sl;
  // go == 0 geometry, fixed for the problem (no division in the row
  // loop): SSE-lane starts among this thread's positions (bit p) and
  // those of lanes 1..7 (the lazy-F step); whether a start lies before
  // the thread's last position; per earlier warp w (bit w): a start
  // inside it, one before its last position, its last position a start
  unsigned stm = 0, lsm = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int q = q0 + p;
    stm |= (unsigned)(q % sl == 0) << p;
    lsm |= (unsigned)(q % sl == 0 && q / sl >= 1 && q / sl < 8) << p;
  }
  const int vl_own = (q0 + P - 2) / sl * sl >= q0;
  unsigned wf_in = 0, wf_pre = 0, wf_last = 0;
#pragma unroll 1
  for (int w = 0; w < wp; ++w) {
    const int qa = w * 32 * P, qL = qa + 32 * P - 1;
    wf_in |= (unsigned)(qL / sl * sl >= qa) << w;
    wf_pre |= (unsigned)((qL - 1) / sl * sl >= qa) << w;
    wf_last |= (unsigned)(qL % sl == 0) << w;
  }
  // per warp w: max over its positions q of (end bonus at q) - q*ge,
  // which turns a warp's I carry into its share of the row max
  int ew[NWP];
#pragma unroll
  for (int w = 0; w < NWP; ++w) {
    const int qa = w * 32 * P, qb = qa + 32 * P - 1;
    ew[w] = imax(-qa * ge, -qb * ge);
    if (qa <= al - 1 && al - 1 <= qb) ew[w] = imax(ew[w], end_bonus - (al - 1) * ge);
  }
  const int8_t* pb = prof + (size_t)b * 22 * AL;
  for (int c = 0; c < 22; ++c)
    s_prof[g][c][tp] = *reinterpret_cast<const Pk*>(pb + c * AL + q0);
  RowStream<true> rs(s_row[threadIdx.x >> 5], nas + (size_t)b * R, logpen + (size_t)b * R,
                     Dtr + (size_t)b * RD, Atr + (size_t)b * RD, R, RD);
  RowVals rv = rs.first();
  Pk sp = s_prof[g][rv.c][tp];

  int H1[P], H2[P], H3[P], D1[P], D2[P], D3[P], Ac[P], Bc[P], Cc[P], Hmax[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    H1[p] = H2[p] = H3[p] = D1[p] = D2[p] = D3[p] = NEG;
    Ac[p] = Bc[p] = Cc[p] = Hmax[p] = NEG;
  }
  // H(i-1..i-3, q0-1): the left neighbour's last position, or the
  // [-1] boundary column for thread 0 (H(-1,-1)=0, H(0,-1)=H(1,-1)=-fs
  // at row 2, NEG from row 3 on; nasw-sse.c:267-271 and the host
  // engine's dp16_ext_w)
  int L1 = NEG, L2 = NEG, L3 = NEG;
  if (tp == 0) {
    L1 = -fs;
    L2 = -fs;
    L3 = 0;
  }
  int msc = NEG, mscl = NEG, mi = -1;

  for (int i = 2; i < nl; ++i) {
    const int gei = rv.c == 20 ? fs : ge;
    int h[P], Dn[P];
    int tot = NEG, sv = NEG, svl = NEG;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      const int h3m1 = p ? H3[p - 1] : L3;
      const int h1m1 = p ? H1[p - 1] : L1;
      const int h2m1 = p ? H2[p - 1] : L2;
      const int S = q < al ? Pack<P>::at(sp, p) : NEG;
      Dn[p] = __viaddmax_s32(H3[p], -go, D3[p]) - gei;
      Ac[p] = __viaddmax_s32(H1[p], -rv.dm1, Ac[p]);
      Bc[p] = __viaddmax_s32(h1m1, -rv.d0, Bc[p]);
      Cc[p] = __viaddmax_s32(h1m1, -rv.dp1, Cc[p]);
      // the max of the candidates as a tree of depth 2
      const int v1 = __viaddmax_s32(Ac[p], -rv.a0, h3m1 + S);
      const int v2 = __viaddmax_s32(Bc[p], -rv.am2, Dn[p]);
      const int v3 = __viaddmax_s32(__vimax3_s32(H1[p], H2[p], imax(h1m1, h2m1)),
                                    -fs, Cc[p] - rv.am1);
      const int v = __vimax3_s32(v1, v2, v3);
      h[p] = v;
      tot = imax(tot, v + q * ge);
      if constexpr (GO0) {
        if (p == P - 1) svl = sv;
        sv = (stm >> p) & 1 ? v + q * ge : imax(sv, v + q * ge);
      }
    }
    ScanX(*sx)[NWP] = s_sx[i & 1];
    int tmp_sc, newL;
    if constexpr (!GO0) {
      // I(q) = max_{k<q}(h(k) + k*ge) - q*ge - go  (exclusive prefix
      // max), first within the warp
      const int inc = warp_incl_max(tot);
      int carry = __shfl_up_sync(FULL_MASK, inc, 1);
      if (lane == 0) carry = NEG;
      int rowmax = NEG;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = q0 + p;
        const int hp = h[p];
        h[p] = __viaddmax_s32(carry, -(q * ge + go), hp);
        carry = imax(carry, hp + q * ge);
        rowmax = imax(rowmax, h[p] + (q == al - 1 ? end_bonus : 0));
      }
      tmp_sc = __reduce_max_sync(FULL_MASK, rowmax);
      newL = __shfl_up_sync(FULL_MASK, h[P - 1], 1);
      if constexpr (NWP > 1) {
        // one barrier: each warp adds the carry c of the warps before it
        // to H (max(h, c - q*ge - go)), to its row max (max(rm, c +
        // ew - go)) and to its left neighbour's last H
        if (lane == 31) sx[g][wp] = ScanX{inc, tmp_sc, h[P - 1]};
        bar_sync(1 + g, NT);
        int cw = NEG, cme = NEG, rm = NEG, edge = NEG;
#pragma unroll
        for (int w = 0; w < NWP; ++w) {
          const ScanX x = sx[g][w];
          rm = imax(rm, imax(x.v, cw + ew[w] - go));
          if (w == wp - 1) edge = imax(x.hl, cw - ((w + 1) * 32 * P - 1) * ge - go);
          if (w == wp) cme = cw;
          cw = imax(cw, x.t);
        }
        tmp_sc = rm;
        if (lane == 0 && wp > 0) newL = edge;
#pragma unroll
        for (int p = 0; p < P; ++p) h[p] = __viaddmax_s32(cme, -((q0 + p) * ge + go), h[p]);
      }
    } else {
      // go == 0: the prefix max restarts at every lane start
      const int inc = warp_incl_seg_max(sv, steps);
      int exs = __shfl_up_sync(FULL_MASK, inc, 1);
      if (lane == 0) exs = NEG;
      int carry = NEG, edge = NEG;  // edge: hp1 at q0 - 1 for lane 0
      if constexpr (NWP > 1) {
        if (lane == 31) sx[g][wp] = ScanX{inc, vl_own ? svl : imax(exs, svl), h[P - 1]};
        bar_sync(1 + g, NT);
        Seg cs{0, NEG};
#pragma unroll
        for (int w = 0; w < NWP - 1; ++w) {
          if (w < wp) {
            const ScanX x = sx[g][w];
            if (w == wp - 1) {
              const int qL = (w + 1) * 32 * P - 1;
              const int sv_ = (wf_pre >> w) & 1 ? x.v : imax(cs.v, x.v);
              edge = imax(x.hl, ((wf_last >> w) & 1 ? NEG : sv_) - qL * ge);
            }
            cs = seg_combine(cs, Seg{(int)((wf_in >> w) & 1), x.t});
          }
        }
        carry = cs.v;
      }
      int segc = s0start < qw ? imax(exs, carry) : exs;
      int hp1[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = q0 + p;
        const int st = (stm >> p) & 1;
        hp1[p] = imax(h[p], (st ? NEG : segc) - q * ge);
        segc = st ? h[p] + q * ge : imax(segc, h[p] + q * ge);
      }
      // the one lazy-F step: lanes 1..7 start from the previous lane's end
      int lh = __shfl_up_sync(FULL_MASK, hp1[P - 1], 1);
      if (lane == 0) lh = edge;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int prev = p ? hp1[p - 1] : lh;
        h[p] = (lsm >> p) & 1 ? imax(hp1[p], prev - ge) : hp1[p];
      }
      int rowmax = NEG;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = q0 + p;
        rowmax = imax(rowmax, h[p] + (q == al - 1 ? end_bonus : 0));
      }
      tmp_sc = __reduce_max_sync(FULL_MASK, rowmax);
      newL = __shfl_up_sync(FULL_MASK, h[P - 1], 1);
      if constexpr (NWP > 1) {
        // a second barrier: the lazy-F step makes H at a warp's first
        // position depend on the warp before it
        if (lane == 31) s_rx[g][wp] = RowX{tmp_sc, h[P - 1]};
        bar_sync(1 + g, NT);
        for (int w = 0; w < NWP; ++w) tmp_sc = imax(tmp_sc, s_rx[g][w].rm);
        if (lane == 0 && wp > 0) newL = s_rx[g][wp - 1].h;
      }
    }
    const int tmp_log = tmp_sc - rv.lp;
    // the next row's streams and profile word
    rv = rs.next(i + 1);
    sp = s_prof[g][rv.c][tp];
    if (tmp_log > mscl) {
      msc = tmp_sc;
      mscl = tmp_log;
      mi = i;
#pragma unroll
      for (int p = 0; p < P; ++p) Hmax[p] = h[p];
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      H3[p] = H2[p];
      H2[p] = H1[p];
      H1[p] = h[p];
      D3[p] = D2[p];
      D2[p] = D1[p];
      D1[p] = Dn[p];
    }
    if (tp == 0) {
      // the -fs/0 boundary values are seen at row 2 only: from row 3 on
      // the reference rebuilds the [-1] column with NEG at lane 0
      L1 = L2 = L3 = NEG;
    } else {
      L3 = L2;
      L2 = L1;
      L1 = newL;
    }
    if (mscl - tmp_log > xdrop) break;  // uniform across the problem
  }
  // aa_len: first real position whose Hmax + end bonus reaches max_sc
  int jm = 1 << 30;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    const int q = q0 + p;
    if (q < al && Hmax[p] + (q == al - 1 ? end_bonus : 0) == msc) jm = q;
  }
  jm = __reduce_min_sync(FULL_MASK, jm);
  if constexpr (NWP > 1) {
    if (lane == 0) s_fin[g][wp] = jm;
    bar_sync(1 + g, NT);
    for (int w = 0; w < NWP; ++w) jm = imin(jm, s_fin[g][w]);
  }
  if (tp == 0) {
    out[3 * b + 0] = msc;
    out[3 * b + 1] = mi;
    out[3 * b + 2] = jm == (1 << 30) ? al - 1 : jm;
  }
}

template <int P, int NWP>
static void launch(const int8_t* nas, const int32_t* D, const int32_t* A,
                   const int32_t* logpen, const int32_t* nl, const int32_t* al,
                   const int8_t* prof, int32_t* out, int n, int R, int RD, int go,
                   int ge, int fs, int xdrop, int endb, cudaStream_t st) {
  constexpr int PPB = 4 / NWP;
  const int nb = (n + PPB - 1) / PPB;
  if (go > 0)
    ext_dp_kernel<P, NWP, false><<<nb, 128, 0, st>>>(nas, D, A, logpen, nl, al, prof, out, n,
                                                    R, RD, go, ge, fs, xdrop, endb);
  else
    ext_dp_kernel<P, NWP, true><<<nb, 128, 0, st>>>(nas, D, A, logpen, nl, al, prof, out, n,
                                                   R, RD, go, ge, fs, xdrop, endb);
}

extern "C" int mp_ext_dp(const void* nas, const void* D, const void* A,
                         const void* logpen, const void* nl, const void* al,
                         const void* prof, void* out, int n, int R, int RD, int AL,
                         int go, int ge, int fs, int xdrop, int endb, int nwp,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto a = (const int8_t*)nas;
  auto d = (const int32_t*)D;
  auto ac = (const int32_t*)A;
  auto lp = (const int32_t*)logpen;
  auto nv = (const int32_t*)nl;
  auto av = (const int32_t*)al;
  auto pr = (const int8_t*)prof;
  auto o = (int32_t*)out;
  // nwp: warps per problem (kernels/nasw_ext.py:EXT_WARPS)
#define MP_EXT(P, NWP) launch<P, NWP>(a, d, ac, lp, nv, av, pr, o, n, R, RD, go, ge, fs, xdrop, endb, st)
  switch (AL) {
    case 128:
      if (nwp == 1) MP_EXT(4, 1);
      else return (int)cudaErrorInvalidValue;
      break;
    case 512:
      if (nwp == 4) MP_EXT(4, 4);
      else return (int)cudaErrorInvalidValue;
      break;
    case 1024:
      if (nwp == 4) MP_EXT(8, 4);
      else return (int)cudaErrorInvalidValue;
      break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MP_EXT
  return (int)cudaGetLastError();
}
