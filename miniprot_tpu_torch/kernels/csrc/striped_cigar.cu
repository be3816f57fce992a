// K4: full splice/frameshift DP with traceback words in the reference's
// striped (Farrar) order: ns_global_gs16b with NS_F_CIGAR
// (nasw-sse.c:444-541) and the 32-bit library variant ns_global_gs32b
// (nasw-sse.c:558-750).  Bit targets: the host engine's mx_dp16 CIGAR
// loop and mx_dp32 (native/mpnative.c).
//
// Replaces miniprot_tpu/kernels/nasw_cigar_pallas.py:_cigar_kernel, both
// its sat=True form (8 saturating int16 lanes per stripe) and its
// sat=False/NEG32 form (4 plain int32 lanes, the gs32b kernel).  One
// template over (lanes per stripe VL, saturating), instantiated twice.
//
// The traceback bits depend on the exact striped evaluation order: the
// stripe loop runs j = 0..slen-1 sequentially for all VL lanes at once,
// then the lazy-F fixup re-walks the stripes, shifting I one lane up
// per pass, for at most VL passes, and breaks as soon as every lane has
// I <= H - (go+ge).  Each problem runs its own slen = ceil(al / VL), as
// the reference derives it from the real protein length.
//
// Design.  One group of VL threads per problem (thread k = SSE lane k),
// one warp per block (32/VL problems).  Lane k owns positions
// k*slen + j, so every stripe-to-stripe dependency stays inside one
// thread; the lanes meet only at the SSE lane shift (a __shfl_up_sync
// of width VL) and at the lazy-F break (an __all_sync over the group).
// Per thread, shared memory holds the H ring (4 rows, each with its
// [-1] stripe), the D ring (3 rows), the A/B/C carries and the
// problem's residue codes: (10*S + 4) values of TS plus S bytes, with
// S = W / VL the batch's stripe capacity (int16 for the saturating
// form: 41 KB per block at W = 512).  The score matrix sits in shared
// memory and is read with the problem's own residue (no profile).
// The lazy-F pass ORs bit 9 into the word already written for the row
// (a read-modify-write by the thread that wrote it, rare).
//
// What bounds it on an H100: 2 bytes of traceback per cell written
// (memory) against ~64 int16 operations per cell (chip_smoke.py counts
// both).  This first kernel is latency-bound instead: each stripe step
// is a dependent chain of ~80 instructions, and a batch of 128 problems
// is only 32 warps on the card.
#include "common.cuh"

namespace {

constexpr int NT = 32;  // threads per block (one warp)

template <bool SAT>
__device__ __forceinline__ int s_add(int a, int b) {
  if (SAT) return sat16(a + b);
  return (int)((unsigned)a + (unsigned)b);  // gs32b wraps like paddd
}

template <bool SAT>
__device__ __forceinline__ int s_sub(int a, int b) {
  if (SAT) return sat16(a - b);
  return (int)((unsigned)a - (unsigned)b);
}

template <int VL, bool SAT, typename TS>
__global__ void __launch_bounds__(NT) striped_cigar_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, const int8_t* __restrict__ aas,
    const int8_t* __restrict__ mat, int16_t* __restrict__ tb,
    int32_t* __restrict__ score, int n, int R, int RD, int W, int TR, int go, int ge,
    int fs) {
  constexpr int NEG = SAT ? -32768 : -0x40000000;
  constexpr int PPB = NT / VL;
  const int S = W / VL;
  extern __shared__ __align__(16) unsigned char smem[];
  TS* sH = (TS*)smem;              // 4 slots x (S + 1) stripes, [-1] first
  TS* sD = sH + 4 * (S + 1) * NT;  // 3 slots x S
  TS* sA = sD + 3 * S * NT;
  TS* sB = sA + S * NT;
  TS* sC = sB + S * NT;
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
  auto H = [&](int s, int j) -> TS& { return sH[(s * (S + 1) + j + 1) * NT + tid]; };
  auto Dr = [&](int s, int j) -> TS& { return sD[(s * S + j) * NT + tid]; };
  auto Ar = [&](int j) -> TS& { return sA[j * NT + tid]; };
  auto Br = [&](int j) -> TS& { return sB[j * NT + tid]; };
  auto Cr = [&](int j) -> TS& { return sC[j * NT + tid]; };

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
        const int v = __shfl_up_sync(gmask, (int)H(ss[m], sl - 1), 1, VL);
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
      int h = s_add<SAT>(h3p, Sv);
      // I
      int t = s_sub<SAT>(last_h, go);
      int z = (I > t) << 4;
      t = imax(t, I);
      I = s_sub<SAT>(t, ge);
      int y = I > h ? 1 : 0;
      h = imax(h, I);
      // D
      int u = s_sub<SAT>(h3, go);
      int v = Dr(d3, j);
      z |= (v > u) << 5;
      t = s_sub<SAT>(imax(u, v), gei);
      Dr(d3, j) = (TS)t;
      if (t > h) y = 2;
      h = imax(h, t);
      // A
      u = s_sub<SAT>(h1, dm1);
      v = Ar(j);
      z |= (v > u) << 6;
      t = imax(u, v);
      Ar(j) = (TS)t;
      t = s_sub<SAT>(t, a0);
      if (t > h) y = 3;
      h = imax(h, t);
      // B
      u = s_sub<SAT>(h1p, d0);
      v = Br(j);
      z |= (v > u) << 7;
      t = imax(u, v);
      Br(j) = (TS)t;
      t = s_sub<SAT>(t, am2);
      if (t > h) y = 4;
      h = imax(h, t);
      // C
      u = s_sub<SAT>(h1p, dp1);
      v = Cr(j);
      z |= (v > u) << 8;
      t = imax(u, v);
      Cr(j) = (TS)t;
      t = s_sub<SAT>(t, am1);
      if (t > h) y = 5;
      h = imax(h, t);
      // frameshift transitions
      t = s_sub<SAT>(h1, fs);
      if (t > h) y = 6;
      h = imax(h, t);
      t = s_sub<SAT>(h2, fs);
      if (t > h) y = 7;
      h = imax(h, t);
      t = s_sub<SAT>(h1p, fs);
      if (t > h) y = 8;
      h = imax(h, t);
      t = s_sub<SAT>(h2p, fs);
      if (t > h) y = 9;
      h = imax(h, t);
      tbi[j * VL + k] = (int16_t)(z | y);
      H(cur, j) = (TS)h;
      last_h = h;
      h3p = h3;
      h1p = h1;
      h2p = h2;
    }
    // lazy-F fixup (nasw-sse.c:521-537): at most VL passes, each one
    // lane further; stop once all lanes have I <= H - (go + ge)
    I = imax(s_sub<SAT>(last_h, goe), s_sub<SAT>(I, ge));
    bool done = false;
    for (int pass = 0; pass < VL && !done; ++pass) {
      const int up = __shfl_up_sync(gmask, I, 1, VL);
      I = k == 0 ? NEG : up;
      for (int j = 0; j < sl; ++j) {
        int h = H(cur, j);
        if (I > h) {
          tbi[j * VL + k] |= (int16_t)(1 << 9);
          h = I;
          H(cur, j) = (TS)h;
        }
        h = s_sub<SAT>(h, goe);
        I = s_sub<SAT>(I, ge);
        if (__all_sync(gmask, I <= h)) {
          done = true;
          break;
        }
      }
    }
  }
  // score: H(nl-1, al-1), NEG when no row was computed
  const int qe = al - 1;
  if (qe >= 0 && k == qe / sl) score[b] = nl >= 3 ? (int)H((nl - 1) & 3, qe % sl) : NEG;
}

template <int VL, bool SAT, typename TS>
int launch(const void* nas, const void* D, const void* A, const void* nl, const void* al,
           const void* aas, const void* mat, void* tb, void* score, int n, int R, int RD,
           int W, int TR, int go, int ge, int fs, cudaStream_t st) {
  if (W % VL != 0) return (int)cudaErrorInvalidValue;
  const int S = W / VL;
  const size_t smem = (size_t)(10 * S + 4) * NT * sizeof(TS) + 512 + (size_t)S * NT;
  auto kern = striped_cigar_kernel<VL, SAT, TS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int PPB = NT / VL;
  striped_cigar_kernel<VL, SAT, TS><<<(n + PPB - 1) / PPB, NT, smem, st>>>(
      (const int8_t*)nas, (const int32_t*)D, (const int32_t*)A, (const int32_t*)nl,
      (const int32_t*)al, (const int8_t*)aas, (const int8_t*)mat, (int16_t*)tb,
      (int32_t*)score, n, R, RD, W, TR, go, ge, fs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mp_striped_cigar(const void* nas, const void* D, const void* A,
                                const void* nl, const void* al, const void* aas,
                                const void* mat, void* tb, void* score, int n, int R,
                                int RD, int W, int TR, int go, int ge, int fs, int vl,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (vl) {
    case 8:
      return launch<8, true, int16_t>(nas, D, A, nl, al, aas, mat, tb, score, n, R, RD, W,
                                      TR, go, ge, fs, st);
    case 4:
      return launch<4, false, int32_t>(nas, D, A, nl, al, aas, mat, tb, score, n, R, RD,
                                       W, TR, go, ge, fs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
