// K4: full splice/frameshift DP with traceback words in the reference's
// striped (Farrar) order: ns_global_gs16b with NS_F_CIGAR
// (nasw-sse.c:444-541) and the 32-bit library variant ns_global_gs32b
// (nasw-sse.c:558-750).  Bit targets: the host engine's mx_dp16 CIGAR
// loop and mx_dp32 (native/mpnative.c).
//
// Replaces miniprot_tpu/kernels/nasw_cigar_pallas.py:_cigar_kernel, both
// its sat=True form (8 saturating int16 lanes per stripe, B4) and its
// sat=False/NEG32 form (4 plain int32 lanes, the gs32b kernel, B4').
//
// The striped schedule runs a row's stripes in sequence, then a lazy-F
// fixup that re-walks them for up to VL passes and breaks once every
// lane has I <= H - (go + ge).  Its words are those of the
// position-order row (nasw_cigar_scan.py's docstring; held against the
// striped plain version in tests/test_torch_striped.py):
//   - pass 1 is the I chain inside each stripe segment of slen =
//     ceil(al / VL) positions: the segmented prefix max (Iused), which
//     gives the state nibble and bit 4;
//   - at go >= 1 the fixup reaches the full-row fixpoint (Istar): bit 9
//     where Istar > hp1 = max(base, Iused), final H = max(hp1, Istar);
//   - at go == 0 the break test holds after the fixup's first step, so
//     only the segment starts q = k * slen (k = 1..VL-1) take one I, the
//     one leaving the left lane: H(q) = max(hp1(q), hp1(q-1) - ge), bit
//     9 where the second term is larger.  This is a template
//     instantiation of its own (GO0) without the full scan.
// So K4 runs K2's position-parallel row (common.cuh: CigRow, the
// segmented and full shuffle scans, warp_carry, row_i, pass1):
// NWP warps per problem, P consecutive positions per thread, the per-row
// streams in RowStream tiles, 4 / NWP problems per 128-thread block, one
// geometry per width.  What it does not share with K2: no hint plane and
// no run counters (K5 walks cells), the pass-1 nibble kept where bit 9
// is set (K2 writes the walk's state 1 there), the profile built in
// shared memory from the query codes, and the striped column order of
// the store: position q goes to column (q % slen) * VL + q / slen.  A
// thread's positions land VL columns apart, so each row is staged in
// shared memory (the class width of int16 per problem, two buffers by
// row parity) and stored as 16-byte vectors of whole stripes: a
// one-warp problem loads its vectors after a __syncwarp and stores them
// in the next row, a multi-warp problem stores a row one row late, after
// the next row's barrier (and once more after the loop).  At go == 0 the
// multi-warp exchange carries, from each warp's last lane, the I its
// last position takes when that position starts a segment (the segment
// before it then lies in the same warp).
//
// B4 (striped_cigar_kernel): saturating int16 (common.cuh's I16), VL =
// 8, class widths 32 / 128 / 512 (nasw_cigar_striped.STRIPED_WARPS: K2's
// spread forms, 1 warp at P=1, 2 at P=2, 4 at P=4).
//
// B4' (striped32_kernel): the same row in wrapping int32 (W32), VL = 4,
// at any W that is a multiple of 4 up to 1024, on the geometry of the
// class width above W (nasw_cigar_striped.DP32_WARPS: 1 warp at P=1
// for W <= 32, 2 at P=2 to 128, 4 at P=4 to 512, 4 at P=8 to 1024); W
// itself is the row stride of the query and of the words.  gs32b's
// differences are the policy's (common.cuh): no clip, I floors of NEG32
// - (j+1)*ge that move with the stripe j (one constant per segment,
// folded into its first scan value), the NEG32 that the fixup shifts
// into lane 0 (the full scan's seed; at go == 0 it raises position 0),
// bit 4 at segment starts where go > 0, and scan values offset by the
// widest class so that pad positions (al <= q < 4 * slen, whose match
// term wraps as paddd does) never overflow them.  Its 4-pass fixup cap
// cuts nothing: every lane's start I reaches every later lane by pass 3
// (tests/test_torch_striped.py).  A row of W = 4 mod 8 is only 8-byte
// aligned, so such rows go out one stripe (8 bytes) per store.
//
// What bounds K4 on an H100: it writes 2 bytes per cell and reads ~9
// track bytes per row, against ~64 operations per cell (chip_smoke.py
// counts both, at the int16 rate for B4 and the int32 rate for B4'); the
// chain of a row is a few hundred in-order instructions per warp, so
// launches of few problems are latency-bound, and the engine sizes
// striped batches as it does scan batches (device.cig_capacity).
#include "common.cuh"

namespace {

// a staged row's first nvec 16-byte vectors (whole stripes of 8
// columns) from shared memory to the traceback plane
template <int NT>
__device__ __forceinline__ void store_row(int16_t* dst, const int16_t* src, int nvec,
                                          int tp) {
  for (int v = tp; v < nvec; v += NT)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
}

// B4': a staged row's stripes j < slen (4 columns, 8 bytes each), as
// 16-byte vectors of two stripes where the row stride W is a multiple of
// 8, else one stripe per 8-byte store
template <int NT>
__device__ __forceinline__ void store_row32(int16_t* dst, const int16_t* src, int slen,
                                            bool v16, int tp) {
  if (v16) {
    store_row<NT>(dst, src, (slen + 1) / 2, tp);
  } else {
    for (int v = tp; v < slen; v += NT)
      reinterpret_cast<uint2*>(dst)[v] = reinterpret_cast<const uint2*>(src)[v];
  }
}

// The row loop of both forms: Pol = I16 (B4; rows of the class width)
// or W32 (B4'; rows of Wr <= the class width, a multiple of 4).
template <class Pol, int P, int NWP, bool GO0>
__device__ __forceinline__ void striped_dp(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, const int8_t* __restrict__ aas,
    const int8_t* __restrict__ mat, int16_t* __restrict__ tb,
    int32_t* __restrict__ score, int n, int R, int RD, int Wr, int TR, int go_arg, int ge,
    int fs) {
  constexpr int VL = Pol::VL;
  constexpr int PPB = 4 / NWP;  // problems per block
  constexpr int NT = 32 * NWP;  // threads per problem
  constexpr int W = P * NT;     // class width
  using Pk = typename Pack<P>::T;
  __shared__ Pk s_prof[PPB][22][NT];
  __shared__ RowTile<false> s_row[4];
  __shared__ CigX s_sx[2][PPB][NWP];                // by row parity
  __shared__ __align__(16) int16_t s_tb[2][PPB][W];  // staged rows, by parity
  const int go = GO0 ? 0 : go_arg;
  const int ws = Pol::WRAP ? Wr : W;  // row stride of aas and tb
  const int g = threadIdx.x / NT;
  const int b = blockIdx.x * PPB + g;
  if (b >= n) return;  // whole problems leave together
  const int tp = threadIdx.x % NT, lane = threadIdx.x & 31, wp = tp >> 5;
  const int q0 = tp * P, qw = wp * 32 * P;
  const int nl = imin(nlv[b], TR), al = alv[b];
  const int slen = imax((al + VL - 1) / VL, 1);
  const SegMasks<P> m(q0, wp, slen);
  // the profile slots from the query codes (past al: masked per row; B4'
  // reads no code past al, its rows being shorter than the class width)
  {
    int a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if constexpr (Pol::WRAP)
        a[p] = q0 + p < al ? imax(aas[(size_t)b * ws + q0 + p], 0) : 0;
      else
        a[p] = imax(aas[(size_t)b * W + q0 + p], 0);
    }
    for (int c = 0; c < 22; ++c) {
      if constexpr (P == 8) {
        unsigned lo = 0, hi = 0;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          lo |= (unsigned)(uint8_t)mat[c * 22 + a[p]] << (8 * p);
          hi |= (unsigned)(uint8_t)mat[c * 22 + a[p + 4]] << (8 * p);
        }
        s_prof[g][c][tp] = make_uint2(lo, hi);
      } else {
        unsigned v = 0;
#pragma unroll
        for (int p = 0; p < P; ++p) v |= (unsigned)(uint8_t)mat[c * 22 + a[p]] << (8 * p);
        s_prof[g][c][tp] = (Pk)v;
      }
    }
  }
  // each position's striped column; keep: the positions of stripes
  // j < slen (q < VL * slen), which the row stores; fix: go == 0's one
  // lazy-F step, at the segment starts of lanes 1..VL-1 (and in B4' at
  // position 0, where the fixup's NEG32 enters lane 0)
  int col[P];
  unsigned keep = 0, fix = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int q = q0 + p;
    col[p] = (q % slen) * VL + q / slen;
    keep |= (unsigned)(q < VL * slen) << p;
    fix |= (unsigned)(((m.stm >> p) & 1) && (Pol::WRAP || q > 0) && q < VL * slen) << p;
  }
  int16_t* tbb = tb + (size_t)b * TR * ws;
  RowStream<false> rs(s_row[threadIdx.x >> 5], nas + (size_t)b * R, nullptr,
                      Dtr + (size_t)b * RD, Atr + (size_t)b * RD, R, RD);
  RowVals rv = rs.first();
  Pk sp = s_prof[g][rv.c][tp];
  CigRow<P, Pol> r(tp, fs);
  int scv = Pol::NEG;
  // a one-warp problem's stored row is nvec <= 32 vectors (stripes j <
  // slen), lane tp's vector tp; it loads the vector from the stage at the
  // end of a row and stores it after the next row's candidates, so the
  // shared-memory latency stays off its chain (storing at once cost W=32
  // 15%; the multi-warp forms ran slower deferred: PERF.md).  B4' rows
  // of W = 4 mod 8 take 8-byte vectors (one stripe).
  const bool v16 = !Pol::WRAP || ws % 8 == 0;
  const int nvec = !Pol::WRAP ? slen : v16 ? (slen + 1) / 2 : slen;
  uint4 vec = make_uint4(0, 0, 0, 0);
  auto put = [&](int row) {
    int16_t* dst = tbb + (size_t)row * ws;
    if (v16)
      reinterpret_cast<uint4*>(dst)[tp] = vec;
    else
      reinterpret_cast<uint2*>(dst)[tp] = make_uint2(vec.x, vec.y);
  };

  for (int i = 2; i < nl; ++i) {
    const int gei = rv.c == 20 ? fs : ge;
    // 1. order-free candidates
    int S[P];
#pragma unroll
    for (int p = 0; p < P; ++p) S[p] = q0 + p < al ? Pack<P>::at(sp, p) : Pol::NEG;
    RowTerms<P> t;
    r.candidates(S, rv, q0, m.stm, go, ge, gei, fs, t, [](int, int) {});
    if (NWP == 1 && i > 2 && tp < nvec) put(i - 1);  // loaded at the end of row i-1
    // 2. segmented (and at go >= 1 full) prefix max of u
    int svi = t.sv, fmi = t.fm;
    if constexpr (GO0)
      svi = warp_incl_seg_max(svi, m.steps);
    else
      warp_incl_max2(svi, m.steps, fmi);
    int exs = __shfl_up_sync(FULL_MASK, svi, 1);
    int exf = GO0 ? Pol::SENT : __shfl_up_sync(FULL_MASK, fmi, 1);
    if (lane == 0) exs = exf = Pol::SENT;
    // up to position qw - 1 (W32's full scan starts from the fixup's NEG32)
    int carry_s = Pol::SENT, carry_f = Pol::fseed(ge);
    // (Iused, t4) at q0 - 1 for lane 0; B4' at go == 0 takes the one
    // lazy-F step at q = 0 as t4(-1) - ge = NEG32
    int il = Pol::SENT, tl = Pol::WRAP ? NEG32 + ge : 0;
    int hedge = Pol::NEG;                // H at q0 - 1 for lane 0
    if constexpr (NWP > 1) {
      CigX(*sx)[NWP] = s_sx[i & 1];
      if (lane == 31) {
        int x0 = 0;
        if constexpr (GO0) {
          // hp1(qL - 1) - ge for this warp's last position qL.  It
          // counts only where qL starts a segment of the striped region
          // (qL < VL * slen, so slen > 32 * P / VL): the segment of qL - 1
          // then starts in this warp, before this thread
          const int qm = q0 + P - 2;
          if constexpr (Pol::WRAP)
            x0 = Pol::sub(imax(t.base[P - 2], imax(exs, t.svl2) - (qm - Pol::QOFF) * ge), ge);
          else
            x0 = sat16(imax(t.base[P - 2], imax(imax(exs, t.svl2) - qm * ge, NEG16)) - ge);
        }
        sx[g][wp] = CigX{svi, fmi, m.vl_own ? t.svl : imax(exs, t.svl),
                          imax(exf, t.fml), t.base[P - 1], x0, 0};
      }
      bar_sync(1 + g, NT);
      const WarpCarry c = warp_carry<P, NWP, !GO0, Pol>(sx[g], wp, m, go, ge);
      carry_s = c.seg;
      carry_f = c.full;
      if (wp > 0) {
        il = c.il;
        tl = c.tl;
        hedge = c.hedge;
      }
      // the previous row, staged by every warp before this barrier
      if (i > 2) {
        if constexpr (Pol::WRAP)
          store_row32<NT>(tbb + (size_t)(i - 1) * ws, s_tb[(i - 1) & 1][g], slen, v16, tp);
        else
          store_row<NT>(tbb + (size_t)(i - 1) * W, s_tb[(i - 1) & 1][g], slen, tp);
      }
    }
    const int segc = m.s0start < qw ? imax(exs, carry_s) : exs;
    const int fullc = imax(exf, carry_f);
    // 3. I, H and the word
    int Iused[P], hp1[P], t4[P], Hfin[P], b9[P];
    row_i<P, !GO0, Pol>(t, m.stm, q0, segc, fullc, go, ge, Iused, hp1, t4, Hfin, b9);
    {
      const int iu = __shfl_up_sync(FULL_MASK, Iused[P - 1], 1);
      const int tu = __shfl_up_sync(FULL_MASK, t4[P - 1], 1);
      if (lane != 0) {
        il = iu;
        tl = tu;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int tq = p ? t4[p - 1] : tl;
      int y, b4;
      pass1<P, Pol>(t, p, Iused[p], p ? Iused[p - 1] : il, tq, (m.stm >> p) & 1, y, b4, go);
      if constexpr (GO0) {
        // the I leaving the left lane, hp1(q - 1) - ge (t4 is hp1 at
        // go == 0)
        const int Iin = (fix >> p) & 1 ? Pol::sub(tq, ge) : Pol::WRAP ? Pol::SENT : NEG16;
        b9[p] = Iin > hp1[p];
        Hfin[p] = imax(hp1[p], Iin);
      }
      const int w = (t.wd[p] & ~15) | y | (b4 << 4) | (b9[p] << 9);
      if ((keep >> p) & 1) s_tb[i & 1][g][col[p]] = (int16_t)w;
      if (i == nl - 1 && q0 + p == al - 1) scv = Hfin[p];
    }
    r.advance(Hfin, t.Dn);
    // 4. hand H to the right; a one-warp problem loads its staged row
    int hl = __shfl_up_sync(FULL_MASK, Hfin[P - 1], 1);
    if constexpr (NWP > 1) {
      if (lane == 0 && wp > 0) hl = hedge;
    } else {
      __syncwarp();
      if (tp < nvec) {
        if (v16) {
          vec = reinterpret_cast<const uint4*>(s_tb[i & 1][g])[tp];
        } else {
          const uint2 h = reinterpret_cast<const uint2*>(s_tb[i & 1][g])[tp];
          vec = make_uint4(h.x, h.y, 0, 0);
        }
      }
    }
    // the next row's streams and profile word
    rv = rs.next(i + 1);
    sp = s_prof[g][rv.c][tp];
    r.advance_left(tp, hl);
  }
  if (nl > 2) {  // the last row
    if constexpr (NWP > 1) {
      bar_sync(1 + g, NT);
      if constexpr (Pol::WRAP)
        store_row32<NT>(tbb + (size_t)(nl - 1) * ws, s_tb[(nl - 1) & 1][g], slen, v16, tp);
      else
        store_row<NT>(tbb + (size_t)(nl - 1) * W, s_tb[(nl - 1) & 1][g], slen, tp);
    } else if (tp < nvec) {
      put(nl - 1);
    }
  }
  if (q0 <= al - 1 && al - 1 < q0 + P) score[b] = scv;
}

}  // namespace

template <int P, int NWP, bool GO0>
__global__ void __launch_bounds__(128) striped_cigar_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, const int8_t* __restrict__ aas,
    const int8_t* __restrict__ mat, int16_t* __restrict__ tb,
    int32_t* __restrict__ score, int n, int R, int RD, int TR, int go_arg, int ge,
    int fs) {
  striped_dp<I16, P, NWP, GO0>(nas, Dtr, Atr, nlv, alv, aas, mat, tb, score, n, R, RD,
                               P * 32 * NWP, TR, go_arg, ge, fs);
}

template <int P, int NWP, bool GO0>
__global__ void __launch_bounds__(128) striped32_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, const int8_t* __restrict__ aas,
    const int8_t* __restrict__ mat, int16_t* __restrict__ tb,
    int32_t* __restrict__ score, int n, int R, int RD, int W, int TR, int go_arg, int ge,
    int fs) {
  striped_dp<W32, P, NWP, GO0>(nas, Dtr, Atr, nlv, alv, aas, mat, tb, score, n, R, RD, W,
                               TR, go_arg, ge, fs);
}

namespace {

// WRAP: B4' (striped32_kernel, rows of W), else B4 (rows of P * 32 * NWP)
template <int P, int NWP, bool WRAP>
void launch_b4(const void* nas, const void* D, const void* A, const void* nl,
               const void* al, const void* aas, const void* mat, void* tb, void* score,
               int n, int R, int RD, int W, int TR, int go, int ge, int fs,
               cudaStream_t st) {
  constexpr int PPB = 4 / NWP;
  const int grid = (n + PPB - 1) / PPB;
  if constexpr (WRAP) {
    auto kern = go == 0 ? striped32_kernel<P, NWP, true> : striped32_kernel<P, NWP, false>;
    kern<<<grid, 128, 0, st>>>(
        (const int8_t*)nas, (const int32_t*)D, (const int32_t*)A, (const int32_t*)nl,
        (const int32_t*)al, (const int8_t*)aas, (const int8_t*)mat, (int16_t*)tb,
        (int32_t*)score, n, R, RD, W, TR, go, ge, fs);
  } else {
    auto kern = go == 0 ? striped_cigar_kernel<P, NWP, true>
                        : striped_cigar_kernel<P, NWP, false>;
    kern<<<grid, 128, 0, st>>>(
        (const int8_t*)nas, (const int32_t*)D, (const int32_t*)A, (const int32_t*)nl,
        (const int32_t*)al, (const int8_t*)aas, (const int8_t*)mat, (int16_t*)tb,
        (int32_t*)score, n, R, RD, TR, go, ge, fs);
  }
}

}  // namespace

// B4 at class width W; the width picks the geometry (warps per problem,
// kernels/nasw_cigar_striped.py:STRIPED_WARPS); go == 0 takes its own
// instantiation
extern "C" int mp_striped_cigar(const void* nas, const void* D, const void* A,
                                const void* nl, const void* al, const void* aas,
                                const void* mat, void* tb, void* score, int n, int R,
                                int RD, int W, int TR, int go, int ge, int fs,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define MP_B4(P, NWP)                                                                      \
  launch_b4<P, NWP, false>(nas, D, A, nl, al, aas, mat, tb, score, n, R, RD, W, TR, go, ge, \
                           fs, st)
  switch (W) {
    case 32: MP_B4(1, 1); break;
    case 128: MP_B4(2, 2); break;
    case 512: MP_B4(4, 4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MP_B4
  return (int)cudaGetLastError();
}

// B4' (gs32b) at any W that is a multiple of 4 up to 1024: the geometry
// of the class width above W (kernels/nasw_cigar_striped.py:DP32_WARPS)
extern "C" int mp_striped_cigar32(const void* nas, const void* D, const void* A,
                                  const void* nl, const void* al, const void* aas,
                                  const void* mat, void* tb, void* score, int n, int R,
                                  int RD, int W, int TR, int go, int ge, int fs,
                                  void* stream) {
  if (W % 4 != 0 || W < 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int cls = W <= 32 ? 32 : W <= 128 ? 128 : W <= 512 ? 512 : W <= 1024 ? 1024 : 0;
#define MP_B4P(P, NWP)                                                                    \
  launch_b4<P, NWP, true>(nas, D, A, nl, al, aas, mat, tb, score, n, R, RD, W, TR, go, ge, \
                          fs, st)
  switch (cls) {
    case 32: MP_B4P(1, 1); break;
    case 128: MP_B4P(2, 2); break;
    case 512: MP_B4P(4, 4); break;
    case 1024: MP_B4P(8, 4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MP_B4P
  return (int)cudaGetLastError();
}
