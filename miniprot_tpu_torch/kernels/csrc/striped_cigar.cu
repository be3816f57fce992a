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
// B4 (striped_cigar_kernel).  The striped schedule runs a row's stripes
// in sequence, then a lazy-F fixup that re-walks them for up to 8 passes
// and breaks once every lane has I <= H - (go + ge).  Its words are
// those of the position-order row (nasw_cigar_scan.py's docstring; held
// against the striped plain version in tests/test_torch_striped.py):
//   - pass 1 is the I chain inside each stripe segment of slen =
//     ceil(al / 8) positions: the segmented prefix max (Iused), which
//     gives the state nibble and bit 4;
//   - at go >= 1 the fixup reaches the full-row fixpoint (Istar): bit 9
//     where Istar > hp1 = max(base, Iused), final H = max(base, Istar);
//   - at go == 0 the break test holds after the fixup's first step, so
//     only the segment starts q = k * slen (k = 1..7) take one I, the
//     one leaving the left lane: H(q) = max(hp1(q), sat(hp1(q-1) - ge)),
//     bit 9 where the second term is larger.  This is a template
//     instantiation of its own (GO0) without the full scan.
// So K4 runs K2's position-parallel row (common.cuh: CigRow, the
// segmented and full shuffle scans, warp_carry, row_i, pass1):
// NWP warps per problem, P consecutive positions per thread, the per-row
// streams in RowStream tiles, 4 / NWP problems per 128-thread block, one
// geometry per width (nasw_cigar_striped.STRIPED_WARPS: K2's spread
// forms, W=32 1 warp at P=1, W=128 2 at P=2, W=512 4 at P=4).  What it
// does not share with K2: no hint plane and no run counters (K5 walks
// cells), the pass-1 nibble kept where bit 9 is
// set (K2 writes the walk's state 1 there), the profile built in shared
// memory from the query codes, and the striped column order of the
// store: position q goes to column (q % slen) * 8 + q / slen.  A
// thread's positions land 8 columns apart, so each row is staged in
// shared memory (W int16 per problem, two buffers by row parity) and
// stored as 16-byte vectors of whole stripes (8 * slen columns): a
// one-warp problem loads its vectors after a __syncwarp and stores them
// in the next row, a multi-warp problem stores a row one row late, after
// the next row's barrier (and once more after the loop).  At go == 0 the
// multi-warp exchange carries, from each warp's last lane, the I its
// last position takes when that position starts a segment (the segment
// before it then lies in the same warp).
//
// What bounds B4 on an H100: it writes 2 bytes per cell and reads ~9
// track bytes per row, against ~64 int16 operations per cell
// (chip_smoke.py counts both); the chain of a row is a few hundred
// in-order instructions per warp, so launches of few problems are
// latency-bound, and the engine sizes striped batches as it does scan
// batches (device.cig_capacity).
//
// B4' (striped32_kernel) keeps the striped loop: gs32b wraps instead of
// saturating and stops its fixup after 4 passes, outside the scan
// proof.  One group of 4 threads per problem (thread k = SSE lane k) in
// a one-warp block; lane k owns positions k*slen + j, so every
// stripe-to-stripe dependency stays inside one thread, and the lanes
// meet only at the SSE lane shift (a __shfl_up_sync of width 4) and at
// the lazy-F break (an __all_sync over the group).  Per thread, shared
// memory holds the H ring (4 rows, each with its [-1] stripe), the D
// ring (3 rows), the A/B/C carries and the problem's residue codes.  It
// is latency-bound (a dependent chain of ~80 instructions per stripe
// step, 8 warps per 128-problem launch); the mapper never runs it.
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

}  // namespace

template <int P, int NWP, bool GO0>
__global__ void __launch_bounds__(128) striped_cigar_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, const int8_t* __restrict__ aas,
    const int8_t* __restrict__ mat, int16_t* __restrict__ tb,
    int32_t* __restrict__ score, int n, int R, int RD, int TR, int go_arg, int ge,
    int fs) {
  constexpr int PPB = 4 / NWP;  // problems per block
  constexpr int NT = 32 * NWP;  // threads per problem
  constexpr int W = P * NT;
  using Pk = typename Pack<P>::T;
  __shared__ Pk s_prof[PPB][22][NT];
  __shared__ RowTile<false> s_row[4];
  __shared__ CigX s_sx[2][PPB][NWP];                // by row parity
  __shared__ __align__(16) int16_t s_tb[2][PPB][W];  // staged rows, by parity
  const int go = GO0 ? 0 : go_arg;
  const int g = threadIdx.x / NT;
  const int b = blockIdx.x * PPB + g;
  if (b >= n) return;  // whole problems leave together
  const int tp = threadIdx.x % NT, lane = threadIdx.x & 31, wp = tp >> 5;
  const int q0 = tp * P, qw = wp * 32 * P;
  const int nl = imin(nlv[b], TR), al = alv[b];
  const int slen = imax((al + 7) / 8, 1);
  const SegMasks<P> m(q0, wp, slen);
  // the profile slots from the query codes (past al: masked per row)
  {
    int a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) a[p] = imax(aas[(size_t)b * W + q0 + p], 0);
    for (int c = 0; c < 22; ++c) {
      unsigned v = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) v |= (unsigned)(uint8_t)mat[c * 22 + a[p]] << (8 * p);
      s_prof[g][c][tp] = (Pk)v;
    }
  }
  // each position's striped column; keep: the positions of stripes
  // j < slen (q < 8 * slen), which the row stores; fix: the segment
  // starts of lanes 1-7 (go == 0's one lazy-F step)
  int col[P];
  unsigned keep = 0, fix = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int q = q0 + p;
    col[p] = (q % slen) * 8 + q / slen;
    keep |= (unsigned)(q < 8 * slen) << p;
    fix |= (unsigned)(((m.stm >> p) & 1) && q > 0 && q < 8 * slen) << p;
  }
  int16_t* tbb = tb + (size_t)b * TR * W;
  RowStream<false> rs(s_row[threadIdx.x >> 5], nas + (size_t)b * R, nullptr,
                      Dtr + (size_t)b * RD, Atr + (size_t)b * RD, R, RD);
  RowVals rv = rs.first();
  Pk sp = s_prof[g][rv.c][tp];
  CigRow<P> r(tp, fs);
  int scv = NEG16;
  // a one-warp problem's stored row is slen <= 32 16-byte vectors
  // (stripes j < slen, 8 columns each), lane tp's vector tp; it loads the
  // vector from the stage at the end of a row and stores it after the
  // next row's candidates, so the shared-memory latency stays off its
  // chain (storing at once cost W=32 15%; the multi-warp forms ran
  // slower deferred: PERF.md)
  uint4 vec = make_uint4(0, 0, 0, 0);
  auto put = [&](int row) { reinterpret_cast<uint4*>(tbb + (size_t)row * W)[tp] = vec; };

  for (int i = 2; i < nl; ++i) {
    const int gei = rv.c == 20 ? fs : ge;
    // 1. order-free candidates
    int S[P];
#pragma unroll
    for (int p = 0; p < P; ++p) S[p] = q0 + p < al ? Pack<P>::at(sp, p) : NEG16;
    RowTerms<P> t;
    r.candidates(S, rv, q0, m.stm, go, ge, gei, fs, t, [](int, int) {});
    if (NWP == 1 && i > 2 && tp < slen) put(i - 1);  // loaded at the end of row i-1
    // 2. segmented (and at go >= 1 full) prefix max of u
    int svi = t.sv, fmi = t.fm;
    if constexpr (GO0)
      svi = warp_incl_seg_max(svi, m.steps);
    else
      warp_incl_max2(svi, m.steps, fmi);
    int exs = __shfl_up_sync(FULL_MASK, svi, 1);
    int exf = GO0 ? NEGI : __shfl_up_sync(FULL_MASK, fmi, 1);
    if (lane == 0) exs = exf = NEGI;
    int carry_s = NEGI, carry_f = NEGI;  // up to position qw - 1
    int il = NEGI, tl = 0;               // (Iused, t4) at q0 - 1 for lane 0
    int hedge = NEG16;                   // H at q0 - 1 for lane 0
    if constexpr (NWP > 1) {
      CigX(*sx)[NWP] = s_sx[i & 1];
      if (lane == 31) {
        int x0 = 0;
        if constexpr (GO0) {
          // sat(hp1(qL - 1) - ge) for this warp's last position qL.  It
          // counts only where qL starts a segment of the striped region
          // (qL < 8 * slen, so slen > 4 * P): the segment of qL - 1 then
          // starts in this warp, before this thread
          const int qm = q0 + P - 2;
          x0 = sat16(imax(t.base[P - 2], imax(imax(exs, t.svl2) - qm * ge, NEG16)) - ge);
        }
        sx[g][wp] = CigX{svi, fmi, m.vl_own ? t.svl : imax(exs, t.svl),
                          imax(exf, t.fml), t.base[P - 1], x0, 0};
      }
      bar_sync(1 + g, NT);
      const WarpCarry c = warp_carry<P, NWP, !GO0>(sx[g], wp, m, go, ge);
      carry_s = c.seg;
      carry_f = c.full;
      if (wp > 0) {
        il = c.il;
        tl = c.tl;
        hedge = c.hedge;
      }
      // the previous row, staged by every warp before this barrier
      if (i > 2) store_row<NT>(tbb + (size_t)(i - 1) * W, s_tb[(i - 1) & 1][g], slen, tp);
    }
    const int segc = m.s0start < qw ? imax(exs, carry_s) : exs;
    const int fullc = imax(exf, carry_f);
    // 3. I, H and the word
    int Iused[P], hp1[P], t4[P], Hfin[P], b9[P];
    row_i<P, !GO0>(t, m.stm, q0, segc, fullc, go, ge, Iused, hp1, t4, Hfin, b9);
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
      pass1(t, p, Iused[p], p ? Iused[p - 1] : il, tq, (m.stm >> p) & 1, y, b4);
      if constexpr (GO0) {
        // the I leaving the left lane, sat(hp1(q - 1) - ge) (t4 is hp1
        // at go == 0)
        const int Iin = (fix >> p) & 1 ? sat16(tq - ge) : NEG16;
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
      if (tp < slen) vec = reinterpret_cast<const uint4*>(s_tb[i & 1][g])[tp];
    }
    // the next row's streams and profile word
    rv = rs.next(i + 1);
    sp = s_prof[g][rv.c][tp];
    r.advance_left(tp, hl);
  }
  if (nl > 2) {  // the last row
    if constexpr (NWP > 1) {
      bar_sync(1 + g, NT);
      store_row<NT>(tbb + (size_t)(nl - 1) * W, s_tb[(nl - 1) & 1][g], slen, tp);
    } else if (tp < slen) {
      put(nl - 1);
    }
  }
  if (q0 <= al - 1 && al - 1 < q0 + P) score[b] = scv;
}

namespace {

constexpr int VL32 = 4;               // B4': 4 int32 lanes per stripe
constexpr int NT32 = 32;              // threads per block (one warp)
constexpr int NEG32 = -0x40000000;    // gs32b's init value

// gs32b adds and subtracts like paddd / psubd: wrapping
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__global__ void __launch_bounds__(NT32) striped32_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, const int8_t* __restrict__ aas,
    const int8_t* __restrict__ mat, int16_t* __restrict__ tb,
    int32_t* __restrict__ score, int n, int R, int RD, int W, int TR, int go, int ge,
    int fs) {
  constexpr int VL = VL32, NT = NT32, NEG = NEG32;
  constexpr int PPB = NT / VL;
  const int S = W / VL;
  extern __shared__ __align__(16) unsigned char smem[];
  int* sH = (int*)smem;              // 4 slots x (S + 1) stripes, [-1] first
  int* sD = sH + 4 * (S + 1) * NT;  // 3 slots x S
  int* sA = sD + 3 * S * NT;
  int* sB = sA + S * NT;
  int* sC = sB + S * NT;
  int8_t* s_mat = (int8_t*)(sC + S * NT);  // 22 x 22
  int8_t* s_aa = s_mat + 512;              // S residue codes per thread
  const int tid = threadIdx.x, g = tid / VL, k = tid % VL;
  for (int x = tid; x < 22 * 22; x += NT) s_mat[x] = mat[x];
  __syncthreads();
  const int b = blockIdx.x * PPB + g;
  if (b >= n) return;  // whole groups leave; no block barrier follows
  const unsigned gmask = ((1u << VL) - 1u) << (g * VL);
  const int nl = imin(nlv[b], TR), al = alv[b];
  const int sl = imax((al + VL - 1) / VL, 1);
  auto H = [&](int s, int j) -> int& { return sH[(s * (S + 1) + j + 1) * NT + tid]; };
  auto Dr = [&](int s, int j) -> int& { return sD[(s * S + j) * NT + tid]; };
  auto Ar = [&](int j) -> int& { return sA[j * NT + tid]; };
  auto Br = [&](int j) -> int& { return sB[j * NT + tid]; };
  auto Cr = [&](int j) -> int& { return sC[j * NT + tid]; };

  for (int s = 0; s < 4; ++s)
    for (int j = -1; j < sl; ++j) H(s, j) = NEG;
  for (int j = 0; j < sl; ++j) {
    Dr(0, j) = Dr(1, j) = Dr(2, j) = NEG;
    Ar(j) = Br(j) = Cr(j) = NEG;
    const int q = k * sl + j;
    s_aa[j * NT + tid] = q < al ? aas[(size_t)b * W + q] : (int8_t)-1;
  }
  // boundary stripe [-1] (nasw-sse.c:253-258), in the slots row 2 reads
  // as H(i-3), H(i-2), H(i-1): H(-1,-1) = 0, H(0,-1) = H(1,-1) = -fs
  if (k == 0) {
    H(3, -1) = 0;
    H(0, -1) = -fs;
    H(1, -1) = -fs;
  }
  const int8_t* nasb = nas + (size_t)b * R;
  const int32_t* Db = Dtr + (size_t)b * RD;
  const int32_t* Ab = Atr + (size_t)b * RD;
  const int goe = go + ge;

  for (int i = 2; i < nl; ++i) {
    const int cur = i & 3, s1 = (i + 3) & 3, s2 = (i + 2) & 3, s3 = (i + 1) & 3;
    const int d3 = i % 3;
    if (i > 2) {
      // [-1] stripe of each history row: that row's last stripe shifted
      // up one lane, NEG into lane 0 (nasw-sse.c:267-271)
      const int ss[3] = {s1, s2, s3};
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int v = __shfl_up_sync(gmask, H(ss[m], sl - 1), 1, VL);
        H(ss[m], -1) = k == 0 ? NEG : v;
      }
    }
    const int c = nasb[i];
    const int gei = c == 20 ? fs : ge;
    const int dm1 = Db[i - 1], d0 = Db[i], dp1 = Db[i + 1];
    const int a0 = Ab[i], am1 = Ab[i - 1], am2 = Ab[i - 2];
    const int8_t* mrow = s_mat + c * 22;
    int16_t* tbi = tb + ((size_t)b * TR + i) * W;
    int I = NEG, last_h = NEG;
    int h3p = H(s3, -1), h1p = H(s1, -1), h2p = H(s2, -1);  // stripe j-1
    for (int j = 0; j < sl; ++j) {
      const int a = s_aa[j * NT + tid];
      const int Sv = a < 0 ? NEG : (int)mrow[a];
      const int h3 = H(s3, j), h1 = H(s1, j), h2 = H(s2, j);
      int h = wadd(h3p, Sv);
      // I
      int t = wsub(last_h, go);
      int z = (I > t) << 4;
      t = imax(t, I);
      I = wsub(t, ge);
      int y = I > h ? 1 : 0;
      h = imax(h, I);
      // D
      int u = wsub(h3, go);
      int v = Dr(d3, j);
      z |= (v > u) << 5;
      t = wsub(imax(u, v), gei);
      Dr(d3, j) = t;
      if (t > h) y = 2;
      h = imax(h, t);
      // A
      u = wsub(h1, dm1);
      v = Ar(j);
      z |= (v > u) << 6;
      t = imax(u, v);
      Ar(j) = t;
      t = wsub(t, a0);
      if (t > h) y = 3;
      h = imax(h, t);
      // B
      u = wsub(h1p, d0);
      v = Br(j);
      z |= (v > u) << 7;
      t = imax(u, v);
      Br(j) = t;
      t = wsub(t, am2);
      if (t > h) y = 4;
      h = imax(h, t);
      // C
      u = wsub(h1p, dp1);
      v = Cr(j);
      z |= (v > u) << 8;
      t = imax(u, v);
      Cr(j) = t;
      t = wsub(t, am1);
      if (t > h) y = 5;
      h = imax(h, t);
      // frameshift transitions
      t = wsub(h1, fs);
      if (t > h) y = 6;
      h = imax(h, t);
      t = wsub(h2, fs);
      if (t > h) y = 7;
      h = imax(h, t);
      t = wsub(h1p, fs);
      if (t > h) y = 8;
      h = imax(h, t);
      t = wsub(h2p, fs);
      if (t > h) y = 9;
      h = imax(h, t);
      tbi[j * VL + k] = (int16_t)(z | y);
      H(cur, j) = h;
      last_h = h;
      h3p = h3;
      h1p = h1;
      h2p = h2;
    }
    // lazy-F fixup (nasw-sse.c:521-537): at most VL passes, each one
    // lane further; stop once all lanes have I <= H - (go + ge)
    I = imax(wsub(last_h, goe), wsub(I, ge));
    bool done = false;
    for (int pass = 0; pass < VL && !done; ++pass) {
      const int up = __shfl_up_sync(gmask, I, 1, VL);
      I = k == 0 ? NEG : up;
      for (int j = 0; j < sl; ++j) {
        int h = H(cur, j);
        if (I > h) {
          tbi[j * VL + k] |= (int16_t)(1 << 9);
          h = I;
          H(cur, j) = h;
        }
        h = wsub(h, goe);
        I = wsub(I, ge);
        if (__all_sync(gmask, I <= h)) {
          done = true;
          break;
        }
      }
    }
  }
  // score: H(nl-1, al-1), NEG when no row was computed
  const int qe = al - 1;
  if (qe >= 0 && k == qe / sl) score[b] = nl >= 3 ? H((nl - 1) & 3, qe % sl) : NEG;
}

template <int P, int NWP>
void launch_b4(const void* nas, const void* D, const void* A, const void* nl,
               const void* al, const void* aas, const void* mat, void* tb, void* score,
               int n, int R, int RD, int TR, int go, int ge, int fs, cudaStream_t st) {
  constexpr int PPB = 4 / NWP;
  auto kern = go == 0 ? striped_cigar_kernel<P, NWP, true>
                      : striped_cigar_kernel<P, NWP, false>;
  kern<<<(n + PPB - 1) / PPB, 128, 0, st>>>(
      (const int8_t*)nas, (const int32_t*)D, (const int32_t*)A, (const int32_t*)nl,
      (const int32_t*)al, (const int8_t*)aas, (const int8_t*)mat, (int16_t*)tb,
      (int32_t*)score, n, R, RD, TR, go, ge, fs);
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
#define MP_B4(P, NWP) \
  launch_b4<P, NWP>(nas, D, A, nl, al, aas, mat, tb, score, n, R, RD, TR, go, ge, fs, st)
  switch (W) {
    case 32: MP_B4(1, 1); break;
    case 128: MP_B4(2, 2); break;
    case 512: MP_B4(4, 4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MP_B4
  return (int)cudaGetLastError();
}

// B4' (gs32b) at any W that is a multiple of 4
extern "C" int mp_striped_cigar32(const void* nas, const void* D, const void* A,
                                  const void* nl, const void* al, const void* aas,
                                  const void* mat, void* tb, void* score, int n, int R,
                                  int RD, int W, int TR, int go, int ge, int fs,
                                  void* stream) {
  if (W % VL32 != 0) return (int)cudaErrorInvalidValue;
  const int S = W / VL32;
  const size_t smem = (size_t)(10 * S + 4) * NT32 * sizeof(int) + 512 + (size_t)S * NT32;
  cudaError_t e = cudaFuncSetAttribute(striped32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int PPB = NT32 / VL32;
  striped32_kernel<<<(n + PPB - 1) / PPB, NT32, smem, (cudaStream_t)stream>>>(
      (const int8_t*)nas, (const int32_t*)D, (const int32_t*)A, (const int32_t*)nl,
      (const int32_t*)al, (const int8_t*)aas, (const int8_t*)mat, (int16_t*)tb,
      (int32_t*)score, n, R, RD, W, TR, go, ge, fs);
  return (int)cudaGetLastError();
}
