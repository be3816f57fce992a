// Shared device helpers of the kernels: warp-level max scans over the
// protein positions a problem holds (each thread owns P consecutive
// positions, so lane order is position order), the named barrier of a
// multi-warp problem, the per-thread profile slots, the prefetched row
// streams, the int16 clip, and the NS_F_CIGAR row in position order
// that K2 (scan_cigar.cu) and K4 (striped_cigar.cu) both compute.
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

// the segmented (s) and plain (m) scans in one 5-step shuffle loop.  The
// plain scan's shuffle goes first: in the other order ptxas ran the two
// chains one after the other in K2's one-warp W=32 form (10 dependent
// shuffles instead of ~6; 8% slower, PERF.md)
__device__ __forceinline__ void warp_incl_max2(int& s, unsigned steps, int& m) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int um = __shfl_up_sync(FULL_MASK, m, 1 << k);
    const int us = __shfl_up_sync(FULL_MASK, s, 1 << k);
    m = imax(m, um);
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

// ---------------------------------------------------------------------------
// The NS_F_CIGAR row in position order (K2 and K4).  A problem's W
// positions are spread over NWP warps, P consecutive positions per
// thread; per genome row:
//   1. CigRow::candidates: each position's order-free candidates (match,
//      D, A, B, C, the four frameshift moves), the extension bits 5-8,
//      the first maximum after I in the strict-> priority order, base
//      and the scan input u = sat(base - go) + q*ge;
//   2. the segmented (stripe segments of slen positions: the pass-1 I
//      of the reference's stripe loop) and, at go >= 1, the full (the
//      lazy-F fixpoint) prefix max of u (warp_incl_max2; a multi-warp
//      problem adds its earlier warps' totals, warp_carry);
//   3. row_i: Iused and t4 = sat(hp1 - go) and, with the full scan,
//      bit 9 and the final H; pass1: the state nibble and bit 4.
// (nasw_cigar_scan.py's docstring has the equivalence with the striped
// schedule.)  The value policy is a template parameter (Pol): I16, the
// saturating int16 of K2 and K4's B4 (a clip on int32 registers), the
// default; W32, the wrapping int32 of K4's B4' (gs32b).
// ---------------------------------------------------------------------------

#define NEG16 (-32768)
#define NEGI (-(1 << 29))
#define NEG32 (-0x40000000)

// Saturating int16: the scan value of position q is u = sat(base - go) +
// q*ge, I = max(scan - q*ge, NEG16), and NEGI (below every u) is the
// scan's "no value".
struct I16 {
  static constexpr bool WRAP = false;
  static constexpr int VL = 8, NEG = NEG16, SENT = NEGI, QOFF = 0;
  // the full scan's value left of position 0
  __device__ static __forceinline__ int fseed(int) { return NEGI; }
  __device__ static __forceinline__ int add(int a, int b) { return sat16(a + b); }
  __device__ static __forceinline__ int sub(int a, int b) { return sat16(a - b); }
};

// Wrapping int32 (gs32b: paddd / psubd, so adds go through unsigned).
// Every H is at least its pass-1 I floor NEG32 - (j+1)*ge >= NEG32 -
// 256*ge (j < slen <= 256), so D, and with it base, is at least NEG32 -
// 256*ge - go - max(ge, fs), and v = base - go does not wrap; at a pad
// position (q >= al) match = H(q-1) + NEG32 wraps to near INT_MAX when
// H(q-1) < NEG32.  So the scan value carries its position as (q - QOFF)
// * ge with QOFF = 1024, the widest class: u = v + (q - QOFF)*ge lies in
// [NEG32 - 1280*ge - 2*go - max(ge, fs), INT_MAX - ge], I = scan - (q -
// QOFF)*ge <= v, and SENT = -(3 << 29) lies below every u (2^29 to
// spare) while SENT + 1024*ge does not wrap.  The I floors are folded
// in: I(q) = NEG32 - ge at a segment start, whose own u is raised to at
// least (NEG32 - ge) + (q - QOFF)*ge, which carries NEG32 - (j+1)*ge
// down the segment; the full scan starts from NEG32 - QOFF*ge, the NEG32
// that the lazy-F fixup shifts into lane 0 (NEG32 - q*ge at q).
struct W32 {
  static constexpr bool WRAP = true;
  static constexpr int VL = 4, NEG = NEG32, SENT = -(3 << 29), QOFF = 1024;
  __device__ static __forceinline__ int fseed(int ge) { return NEG32 - QOFF * ge; }
  __device__ static __forceinline__ int add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
  }
  __device__ static __forceinline__ int sub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
  }
};

// first maximum of two (value, code) pairs: ties keep the left one
__device__ __forceinline__ void first_max(int a, int ya, int b, int yb, int& m, int& y) {
  m = imax(a, b);
  y = a >= b ? ya : yb;
}

// The segment tests of a thread's positions q0..q0+P-1 in warp wp of its
// problem, fixed for the problem (so no division in the row loop).
template <int P>
struct SegMasks {
  unsigned steps;  // the segmented scan's combine steps (seg_steps)
  int s0start;     // start of q0's segment
  unsigned stm;    // bit p: q0 + p starts a segment
  int vl_own;      // a segment starts in [q0, q0 + P - 2]
  // per earlier warp w (bit w): a segment start inside it, one before its
  // last position, its last position a start
  unsigned wf_in, wf_pre, wf_last;

  __device__ __forceinline__ SegMasks(int q0, int wp, int slen) {
    steps = seg_steps((((q0 + P - 1) / slen) * slen) / P - wp * 32);
    s0start = (q0 / slen) * slen;
    stm = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) stm |= (unsigned)((q0 + p) % slen == 0) << p;
    vl_own = (q0 + P - 2) / slen * slen >= q0;
    wf_in = wf_pre = wf_last = 0;
#pragma unroll 1
    for (int w = 0; w < wp; ++w) {
      const int qa = w * 32 * P, qL = qa + 32 * P - 1;
      wf_in |= (unsigned)(qL / slen * slen >= qa) << w;
      wf_pre |= (unsigned)((qL - 1) / slen * slen >= qa) << w;
      wf_last |= (unsigned)(qL % slen == 0) << w;
    }
  }
};

// A thread's terms of one row (CigRow::candidates).
template <int P>
struct RowTerms {
  // per position: match, the first maximum of the candidates after I
  // (cm; its code in wd's nibble, bits 5-8 above it), base, u, D
  int match[P], cm[P], wd[P], base[P], u[P], Dn[P];
  // segmented and plain max of u over the thread's positions, the same
  // before its last position, and the segmented one before the position
  // before that
  int sv, fm, svl, fml, svl2;
};

// A thread's DP state across rows.
template <int P, class Pol = I16>
struct CigRow {
  // per position: H and D of rows i-1..i-3, the A/B/C intron carries
  int H1[P], H2[P], H3[P], D1[P], D2[P], D3[P], Ac[P], Bc[P], Cc[P];
  // H of position q0 - 1 in rows i-1..i-3.  Thread 0 holds the [-1]
  // column: H(-1,-1)=0, H(0,-1)=H(1,-1)=-fs, seen at row 2 only
  // (nasw_cigar_scan.py:333-343)
  int LH1, LH2, LH3;

  __device__ __forceinline__ CigRow(int tp, int fs) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      H1[p] = H2[p] = H3[p] = D1[p] = D2[p] = D3[p] = Pol::NEG;
      Ac[p] = Bc[p] = Cc[p] = Pol::NEG;
    }
    LH1 = LH2 = LH3 = Pol::NEG;
    if (tp == 0) {
      LH1 = -fs;
      LH2 = -fs;
      LH3 = 0;
    }
  }

  // 1. the order-free candidates of a row whose scores are S (Pol::NEG
  // past al) and whose streams are rv, into t; each position's extension
  // bits (bt, bits 5-8) also go to ext(p, bt) as soon as they are known
  template <typename Ext>
  __device__ __forceinline__ void candidates(const int* S, const RowVals& rv, int q0,
                                             unsigned stm, int go, int ge, int gei,
                                             int fs, RowTerms<P>& t, Ext&& ext) {
    int sv = Pol::SENT, fm = Pol::SENT;
    t.svl = t.fml = t.svl2 = Pol::SENT;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      const int h3m1 = p ? H3[p - 1] : LH3;
      const int h1m1 = p ? H1[p - 1] : LH1;
      const int h2m1 = p ? H2[p - 1] : LH2;
      t.match[p] = Pol::add(h3m1, S[p]);
      const int ud = Pol::sub(H3[p], go);
      int bt = (D3[p] > ud) << 5;
      t.Dn[p] = Pol::sub(imax(ud, D3[p]), gei);
      const int ua = Pol::sub(H1[p], rv.dm1);
      bt |= (Ac[p] > ua) << 6;
      Ac[p] = imax(ua, Ac[p]);
      const int ub = Pol::sub(h1m1, rv.d0);
      bt |= (Bc[p] > ub) << 7;
      Bc[p] = imax(ub, Bc[p]);
      const int uc = Pol::sub(h1m1, rv.dp1);
      bt |= (Cc[p] > uc) << 8;
      Cc[p] = imax(uc, Cc[p]);
      // first maximum of the candidates after I in the priority order
      // (D, A, B, C, fs1..fs4 = codes 2..9), as a tree of depth 3
      int m01, y01, m23, y23, m45, y45, m67, y67, m, y;
      first_max(t.Dn[p], 2, Pol::sub(Ac[p], rv.a0), 3, m01, y01);
      first_max(Pol::sub(Bc[p], rv.am2), 4, Pol::sub(Cc[p], rv.am1), 5, m23, y23);
      first_max(Pol::sub(H1[p], fs), 6, Pol::sub(H2[p], fs), 7, m45, y45);
      first_max(Pol::sub(h1m1, fs), 8, Pol::sub(h2m1, fs), 9, m67, y67);
      first_max(m01, y01, m23, y23, m01, y01);
      first_max(m45, y45, m67, y67, m45, y45);
      first_max(m01, y01, m45, y45, m, y);
      t.cm[p] = m;
      t.wd[p] = bt | y;
      ext(p, bt);
      t.base[p] = imax(t.match[p], m);
      if constexpr (Pol::WRAP) {
        // a segment start's value carries the segment's I floor (W32)
        const int v = Pol::sub(t.base[p], go);
        t.u[p] = ((stm >> p) & 1 ? imax(v, NEG32 - ge) : v) + (q - Pol::QOFF) * ge;
      } else {
        t.u[p] = sat16(t.base[p] - go) + q * ge;
      }
      if (p == P - 2) t.svl2 = sv;
      if (p == P - 1) {  // before the last position
        t.svl = sv;
        t.fml = fm;
      }
      sv = (stm >> p) & 1 ? t.u[p] : imax(sv, t.u[p]);
      fm = imax(fm, t.u[p]);
    }
    t.sv = sv;
    t.fm = fm;
  }

  // the row's final H and D become row i-1's
  __device__ __forceinline__ void advance(const int* Hfin, const int* Dn) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      H3[p] = H2[p];
      H2[p] = H1[p];
      H1[p] = Hfin[p];
      D3[p] = D2[p];
      D2[p] = D1[p];
      D1[p] = Dn[p];
    }
  }

  // and hl, the final H of position q0 - 1, becomes its row i-1 value
  // (thread 0: the [-1] column, NEG from row 3 on)
  __device__ __forceinline__ void advance_left(int tp, int hl) {
    if (tp == 0) {
      LH1 = LH2 = LH3 = Pol::NEG;
    } else {
      LH3 = LH2;
      LH2 = LH1;
      LH1 = hl;
    }
  }
};

// per-warp values a multi-warp problem exchanges at its one barrier of a
// row, all local to the warp (without the earlier warps' carry)
struct CigX {
  int sv;  // segmented inclusive max of u over the warp
  int fm;  // plain max of u over the warp
  int vl;  // segmented max over the warp's positions before its last
  int fl;  // plain max over the warp's positions before its last
  int bl;  // base at the warp's last position
  int x0, x1;  // the kernel's own: x0 read from the left warp, x1 max-folded
};

// What a later warp of a multi-warp problem takes from its earlier warps
// at the row's barrier.
struct WarpCarry {
  int seg, full;  // segmented and plain max of u up to the warp's first position - 1
  int il, tl;     // Iused and t4 of position q0 - 1 (for the warp's lane 0)
  int hedge;      // final H of position q0 - 1
  int x0, x1;     // the left warp's x0; max of x1 over the earlier warps
};

// Fold the CigX of warps 0..wp-1 (sx: the problem's row of them).  FULL:
// the final H of the left warp's last position qL is max(base, Istar)
// (W32: max(hp1, Istar)); otherwise (K4 at go == 0) it is hp1 raised,
// when qL starts a segment, by the one lazy-F step the left warp left in
// x0.
template <int P, int NWP, bool FULL, class Pol = I16>
__device__ __forceinline__ WarpCarry warp_carry(const CigX* sx, int wp,
                                                const SegMasks<P>& m, int go, int ge) {
  WarpCarry c{Pol::SENT, Pol::fseed(ge), Pol::SENT, 0, Pol::NEG, 0, -1};
  Seg cs{0, Pol::SENT};
#pragma unroll
  for (int w = 0; w < NWP - 1; ++w) {
    if (w < wp) {
      const CigX x = sx[w];
      if (w == wp - 1) {
        // the left neighbour's I, t4 and H, from its local prefix maxima
        // and the carry of the warps before it
        const int qL = (w + 1) * 32 * P - 1;
        const int sxv = (m.wf_pre >> w) & 1 ? x.vl : imax(cs.v, x.vl);
        if constexpr (Pol::WRAP) {
          const int qg = (qL - Pol::QOFF) * ge;
          c.il = (m.wf_last >> w) & 1 ? NEG32 - ge : sxv - qg;
          const int hp1 = imax(x.bl, c.il);
          c.tl = Pol::sub(hp1, go);
          if constexpr (FULL)
            c.hedge = imax(hp1, imax(c.full, x.fl) - qg);
          else
            c.hedge = imax(hp1, (m.wf_last >> w) & 1 ? x.x0 : Pol::SENT);
        } else {
          c.il = imax(((m.wf_last >> w) & 1 ? NEGI : sxv) - qL * ge, NEG16);
          const int hp1 = imax(x.bl, c.il);
          c.tl = sat16(hp1 - go);
          if constexpr (FULL)
            c.hedge = imax(x.bl, imax(imax(c.full, x.fl) - qL * ge, NEG16));
          else
            c.hedge = imax(hp1, (m.wf_last >> w) & 1 ? x.x0 : NEG16);
        }
        c.x0 = x.x0;
      }
      cs = seg_combine(cs, Seg{(int)((m.wf_in >> w) & 1), x.sv});
      if constexpr (FULL) c.full = imax(c.full, x.fm);
      c.x1 = imax(c.x1, x.x1);
    }
  }
  c.seg = cs.v;
  return c;
}

// 3. Iused, hp1 and t4 = sub(hp1, go) per position from the carries
// into q0 (segc: segmented, fullc: plain) and, with FULL, Istar's bit 9
// and the final H.
template <int P, bool FULL, class Pol = I16>
__device__ __forceinline__ void row_i(const RowTerms<P>& t, unsigned stm, int q0, int segc,
                                      int fullc, int go, int ge, int* Iused, int* hp1,
                                      int* t4, int* Hfin, int* b9) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int q = q0 + p;
    const int st = (stm >> p) & 1;
    if constexpr (Pol::WRAP) {
      // W32: Istar may lie below a segment start's floor NEG32 - ge, so H
      // is max(hp1, Istar)
      const int qg = (q - Pol::QOFF) * ge;
      Iused[p] = st ? NEG32 - ge : segc - qg;
      segc = st ? t.u[p] : imax(segc, t.u[p]);
      hp1[p] = imax(t.base[p], Iused[p]);
      if constexpr (FULL) {
        const int Istar = fullc - qg;
        fullc = imax(fullc, t.u[p]);
        Hfin[p] = imax(hp1[p], Istar);
        b9[p] = Istar > hp1[p];
      }
      t4[p] = Pol::sub(hp1[p], go);
    } else {
      Iused[p] = imax((st ? NEGI : segc) - q * ge, NEG16);
      segc = st ? t.u[p] : imax(segc, t.u[p]);
      hp1[p] = imax(t.base[p], Iused[p]);
      if constexpr (FULL) {
        const int Istar = imax(fullc - q * ge, NEG16);
        fullc = imax(fullc, t.u[p]);
        Hfin[p] = imax(t.base[p], Istar);
        b9[p] = Istar > hp1[p];
      }
      t4[p] = sat16(hp1[p] - go);
    }
  }
}

// Position p's pass-1 state nibble y (the first maximum of (match, I,
// D, A, B, C, fs1..fs4) under the strict-> chain, I = Iused) and bit 4
// (Iused(q-1) > t4(q-1): I extended; ip, tq = Iused, t4 of q - 1).  At a
// segment start bit 4 compares the stripe loop's initial NEG with NEG -
// go: never set in saturating int16, set where go > 0 in W32.
template <int P, class Pol = I16>
__device__ __forceinline__ void pass1(const RowTerms<P>& t, int p, int Iused, int ip, int tq,
                                      int st, int& y, int& b4, int go = 0) {
  if constexpr (Pol::WRAP)
    b4 = st ? go > 0 : ip > tq;
  else
    b4 = !st && ip > tq;
  y = t.cm[p] > imax(t.match[p], Iused) ? (t.wd[p] & 15) : (Iused > t.match[p] ? 1 : 0);
}
