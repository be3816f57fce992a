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
// Design.  One thread block per problem, protein positions across
// threads (P consecutive positions per thread, W = P*NT; the al <= 32
// class is one warp per problem), genome rows looped inside the block.
// Per row: one barrier for the segmented + full prefix max (one pass,
// warp shuffles + per-warp totals in shared memory), one to hand the
// neighbour's (Iused, t4) to bit 4, one for the I-run counter scan and
// one to hand H and the match-run counter to the right neighbour.
// The tb and hint planes are written as int16 (rows, W) per problem,
// neighbouring threads on neighbouring positions.
//
// What bounds it on an H100: it writes 4 bytes per cell (tb + hint)
// and reads almost nothing per cell (9 track bytes per row), so the
// bound is memory, 4 B/cell at 3.35 TB/s.  The recurrence itself needs
// ~64 int16 operations per cell, which the int16x2/DPX pipe would do
// faster than that (chip_smoke.py computes both).  This kernel spends
// about 130 int32 operations per cell instead (int16 saturation as
// clips on int32, the prefix-max scan steps) plus four barriers per
// row, so it runs well above the memory bound.
#include "common.cuh"

#define NEG16 (-32768)
#define NEGI (-(1 << 29))

template <int P, int NT>
__global__ void __launch_bounds__(NT) scan_cigar_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, const int8_t* __restrict__ prof,
    int16_t* __restrict__ tb, int16_t* __restrict__ hint, int32_t* __restrict__ score,
    int R, int RD, int TR, int go, int ge, int fs) {
  constexpr int NW = NT / 32;
  constexpr int W = P * NT;
  __shared__ int8_t s_prof[22 * W];
  __shared__ int s_sf[NW], s_sv[NW], s_sm[NW];   // barrier 1: the I scans
  __shared__ int s_ei[NW], s_et[NW];             // barrier 2: bit-4 inputs
  __shared__ int s_c1[NW];                       // barrier 3: I-run scan
  __shared__ int s_eh[NW], s_ec[NW];             // barrier 4: H, match run
  const int b = blockIdx.x, tid = threadIdx.x;
  const int nl = imin(nlv[b], TR), al = alv[b];
  const int slen = imax((al + 7) / 8, 1);
  const int8_t* pb = prof + (size_t)b * 22 * W;
  for (int k = tid; k < 22 * W; k += NT) s_prof[k] = pb[k];
  __syncthreads();
  const int8_t* nasb = nas + (size_t)b * R;
  const int32_t* Db = Dtr + (size_t)b * RD;
  const int32_t* Ab = Atr + (size_t)b * RD;
  int16_t* tbb = tb + (size_t)b * TR * W;
  int16_t* hib = hint + (size_t)b * TR * W;
  const int q0 = tid * P;

  int H1[P], H2[P], H3[P], D1[P], D2[P], D3[P], Ac[P], Bc[P], Cc[P];
  int C01[P], C02[P], C03[P], CD1[P], CD2[P], CD3[P], CA[P], CB[P], CC[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    H1[p] = H2[p] = H3[p] = D1[p] = D2[p] = D3[p] = NEG16;
    Ac[p] = Bc[p] = Cc[p] = NEG16;
    C01[p] = C02[p] = C03[p] = CD1[p] = CD2[p] = CD3[p] = 0;
    CA[p] = CB[p] = CC[p] = 0;
  }
  // left neighbour of position q0 for rows i-1..i-3 (H and match-run
  // counter).  Thread 0 holds the [-1] column: H(-1,-1)=0,
  // H(0,-1)=H(1,-1)=-fs, seen at row 2 only (nasw_cigar_scan.py:333-343)
  int LH1 = NEG16, LH2 = NEG16, LH3 = NEG16, LC1 = 0, LC2 = 0, LC3 = 0;
  if (tid == 0) {
    LH1 = -fs;
    LH2 = -fs;
    LH3 = 0;
  }
  int scv = NEG16;

  for (int i = 2; i < nl; ++i) {
    const int c = nasb[i];
    const int gei = c == 20 ? fs : ge;
    const int dm1 = Db[i - 1], d0 = Db[i], dp1 = Db[i + 1];
    const int a0 = Ab[i], am1 = Ab[i - 1], am2 = Ab[i - 2];
    const int8_t* sp = s_prof + c * W;
    int match[P], Dn[P], cA[P], cB[P], cC[P], f1[P], f2[P], f3[P], f4[P];
    int base[P], u[P], bits[P];
    Seg sg{0, NEGI};
    int fm = NEGI;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      const int h3m1 = p ? H3[p - 1] : LH3;
      const int h1m1 = p ? H1[p - 1] : LH1;
      const int h2m1 = p ? H2[p - 1] : LH2;
      const int S = q < al ? (int)sp[q] : NEG16;
      match[p] = sat16(h3m1 + S);
      const int ud = sat16(H3[p] - go);
      int bt = (D3[p] > ud) << 5;
      Dn[p] = sat16(imax(ud, D3[p]) - gei);
      const int ua = sat16(H1[p] - dm1);
      bt |= (Ac[p] > ua) << 6;
      Ac[p] = imax(ua, Ac[p]);
      cA[p] = sat16(Ac[p] - a0);
      const int ub = sat16(h1m1 - d0);
      bt |= (Bc[p] > ub) << 7;
      Bc[p] = imax(ub, Bc[p]);
      cB[p] = sat16(Bc[p] - am2);
      const int uc = sat16(h1m1 - dp1);
      bt |= (Cc[p] > uc) << 8;
      Cc[p] = imax(uc, Cc[p]);
      cC[p] = sat16(Cc[p] - am1);
      f1[p] = sat16(H1[p] - fs);
      f2[p] = sat16(H2[p] - fs);
      f3[p] = sat16(h1m1 - fs);
      f4[p] = sat16(h2m1 - fs);
      int bs = imax(imax(match[p], Dn[p]), imax(cA[p], cB[p]));
      bs = imax(bs, imax(imax(cC[p], f1[p]), imax(imax(f2[p], f3[p]), f4[p])));
      base[p] = bs;
      bits[p] = bt;
      u[p] = sat16(bs - go) + q * ge;
      const int st = (q % slen) == 0;
      sg = seg_combine(sg, Seg{st, u[p]});
      fm = imax(fm, u[p]);
    }
    // exclusive segmented and full prefix max of u (barrier 1)
    block_excl_seg_and_max<NW>(sg, fm, NEGI, s_sf, s_sv, s_sm);
    int segc = sg.v, fullc = fm;
    int Iused[P], t4[P], Hfin[P], b9[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      const int st = (q % slen) == 0;
      Iused[p] = imax((st ? NEGI : segc) - q * ge, NEG16);
      const int Istar = imax(fullc - q * ge, NEG16);
      segc = st ? u[p] : imax(segc, u[p]);
      fullc = imax(fullc, u[p]);
      const int hp1 = imax(base[p], Iused[p]);
      Hfin[p] = imax(base[p], Istar);
      b9[p] = Istar > hp1;
      t4[p] = sat16(hp1 - go);
    }
    // bit 4 reads (Iused, t4) at q-1 (barrier 2)
    int il, tl;
    from_left2<NW>(Iused[P - 1], t4[P - 1], NEGI, 0, il, tl, s_ei, s_et);
    int s0[P], x1 = -1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      const int ip = p ? Iused[p - 1] : il;
      const int tp = p ? t4[p - 1] : tl;
      const int b4 = (q % slen) != 0 && ip > tp;
      // pass-1 state nibble: strict-> priority chain
      int h = match[p];
      int y = Iused[p] > h ? 1 : 0;
      h = imax(h, Iused[p]);
      if (Dn[p] > h) { y = 2; h = Dn[p]; }
      if (cA[p] > h) { y = 3; h = cA[p]; }
      if (cB[p] > h) { y = 4; h = cB[p]; }
      if (cC[p] > h) { y = 5; h = cC[p]; }
      if (f1[p] > h) { y = 6; h = f1[p]; }
      if (f2[p] > h) { y = 7; h = f2[p]; }
      if (f3[p] > h) { y = 8; h = f3[p]; }
      if (f4[p] > h) { y = 9; h = f4[p]; }
      s0[p] = b9[p] ? 1 : y;
      bits[p] |= s0[p] | (b4 << 4) | (b9[p] << 9);
      x1 = imax(x1, b4 ? -1 : q);
    }
    // I-run length: distance to the last position <= q without bit 4
    // (a segment start never has it, so a plain prefix max is exact;
    // barrier 3)
    int lz = block_excl_max<NW>(x1, -1, s_c1);
    int cnt0[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      const int b4 = (bits[p] >> 4) & 1;
      lz = imax(lz, b4 ? -1 : q);
      const int cnt1 = q - lz;
      const int cntD = (bits[p] >> 5) & 1 ? CD3[p] + 1 : 0;
      CA[p] = (bits[p] >> 6) & 1 ? CA[p] + 1 : 0;
      CB[p] = (bits[p] >> 7) & 1 ? CB[p] + 1 : 0;
      CC[p] = (bits[p] >> 8) & 1 ? CC[p] + 1 : 0;
      const int c03m1 = p ? C03[p - 1] : LC3;
      cnt0[p] = s0[p] == 0 ? c03m1 + 1 : 0;
      int hv = 0;
      switch (s0[p]) {
        case 0: hv = cnt0[p] - 1; break;
        case 1: hv = cnt1; break;
        case 2: hv = cntD; break;
        case 3: hv = CA[p]; break;
        case 4: hv = CB[p]; break;
        case 5: hv = CC[p]; break;
        default: hv = 0;
      }
      const size_t off = (size_t)i * W + q;
      tbb[off] = (int16_t)bits[p];
      hib[off] = (int16_t)hv;
      if (i == nl - 1 && q == al - 1) scv = Hfin[p];
      CD3[p] = CD2[p];
      CD2[p] = CD1[p];
      CD1[p] = cntD;
    }
    // hand H and the match-run counter to the right (barrier 4)
    int hl, cl;
    from_left2<NW>(Hfin[P - 1], cnt0[P - 1], NEG16, 0, hl, cl, s_eh, s_ec);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      H3[p] = H2[p];
      H2[p] = H1[p];
      H1[p] = Hfin[p];
      D3[p] = D2[p];
      D2[p] = D1[p];
      D1[p] = Dn[p];
      C03[p] = C02[p];
      C02[p] = C01[p];
      C01[p] = cnt0[p];
    }
    if (tid == 0) {
      // boundary column: NEG from row 3 on (the -fs values are cleared
      // once row 2 consumed them), match-run counter 0
      LH1 = LH2 = LH3 = NEG16;
    } else {
      LH3 = LH2;
      LH2 = LH1;
      LH1 = hl;
      LC3 = LC2;
      LC2 = LC1;
      LC1 = cl;
    }
  }
  if (q0 <= al - 1 && al - 1 < q0 + P) score[b] = scv;
}

template <int P, int NT>
static void launch(const int8_t* nas, const int32_t* D, const int32_t* A,
                   const int32_t* nl, const int32_t* al, const int8_t* prof,
                   int16_t* tb, int16_t* hint, int32_t* score, int n, int R, int RD,
                   int TR, int go, int ge, int fs, cudaStream_t st) {
  scan_cigar_kernel<P, NT><<<n, NT, 0, st>>>(nas, D, A, nl, al, prof, tb, hint,
                                              score, R, RD, TR, go, ge, fs);
}

extern "C" int mp_scan_cigar(const void* nas, const void* D, const void* A,
                             const void* nl, const void* al, const void* prof,
                             void* tb, void* hint, void* score, int n, int R, int RD,
                             int W, int TR, int go, int ge, int fs, void* stream) {
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
  switch (W) {
    case 32: launch<1, 32>(a, d, ac, nv, av, pr, t, h, s, n, R, RD, TR, go, ge, fs, st); break;
    case 128: launch<1, 128>(a, d, ac, nv, av, pr, t, h, s, n, R, RD, TR, go, ge, fs, st); break;
    case 512: launch<2, 256>(a, d, ac, nv, av, pr, t, h, s, n, R, RD, TR, go, ge, fs, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
