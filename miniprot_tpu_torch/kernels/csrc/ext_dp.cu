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
// Design.  One thread block per problem; protein positions go across
// threads (P consecutive positions per thread, NT threads, AL = P*NT).
// The genome-row loop runs inside the block, so each block stops at its
// own x-drop or its own nl (the TPU grid had to run until the slowest
// of 128 problems stopped).  Per position, the H and D 3-row rings and
// the A/B/C intron carries stay in registers; H(., q-1) of the thread's
// first position comes from the left neighbour (shuffle, shared memory
// across warps).  The profile is an unpacked (22, AL) int8 table in
// shared memory.
//
// What bounds it on an H100: per cell it reads nothing from device
// memory (the row streams are 8 words per ROW, shared by the block), so
// the bound is the integer pipe: the recurrence needs 32 operations per
// cell (the host engine's dp16_ext_w inner loop), done here on int32, plus
// three block barriers per row, which at AL=128 (4 warps) leave the SM
// latency-bound unless enough blocks are resident; the launch puts one
// block per problem and lets up to 16 blocks share an SM.
#include "common.cuh"

#define NEG (-(1 << 29))

template <int P, int NT>
__global__ void __launch_bounds__(NT) ext_dp_kernel(
    const int8_t* __restrict__ nas, const int32_t* __restrict__ Dtr,
    const int32_t* __restrict__ Atr, const int32_t* __restrict__ logpen,
    const int32_t* __restrict__ nlv, const int32_t* __restrict__ alv,
    const int8_t* __restrict__ prof, int32_t* __restrict__ out, int R, int RD,
    int go, int ge, int fs, int xdrop, int end_bonus) {
  constexpr int NW = NT / 32;
  constexpr int AL = P * NT;
  __shared__ int8_t s_prof[22 * AL];
  __shared__ int s_scan[NW], s_max[NW], s_edge[NW], s_fin[NW];
  __shared__ int s_sf[NW], s_sv[NW], s_sm[NW], s_e0[NW];  // go == 0 only
  const int b = blockIdx.x, tid = threadIdx.x;
  const int nl = nlv[b], al = alv[b];
  const int sl = imax((al + 7) / 8, 1);  // SSE lane length (go == 0)
  const int8_t* pb = prof + (size_t)b * 22 * AL;
  for (int k = tid; k < 22 * AL; k += NT) s_prof[k] = pb[k];
  __syncthreads();
  const int8_t* nasb = nas + (size_t)b * R;
  const int32_t* Db = Dtr + (size_t)b * RD;
  const int32_t* Ab = Atr + (size_t)b * RD;
  const int32_t* lpb = logpen + (size_t)b * R;
  const int q0 = tid * P;

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
  if (tid == 0) {
    L1 = -fs;
    L2 = -fs;
    L3 = 0;
  }
  int msc = NEG, mscl = NEG, mi = -1;

  for (int i = 2; i < nl; ++i) {
    const int c = nasb[i];
    const int gei = c == 20 ? fs : ge;
    const int dm1 = Db[i - 1], d0 = Db[i], dp1 = Db[i + 1];
    const int a0 = Ab[i], am1 = Ab[i - 1], am2 = Ab[i - 2];
    const int8_t* sp = s_prof + c * AL;
    int h[P], Dn[P];
    int tot = NEG;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      const int h3m1 = p ? H3[p - 1] : L3;
      const int h1m1 = p ? H1[p - 1] : L1;
      const int h2m1 = p ? H2[p - 1] : L2;
      const int S = q < al ? (int)sp[q] : NEG;
      int v = h3m1 + S;
      const int dn = imax(H3[p] - go, D3[p]) - gei;
      Dn[p] = dn;
      v = imax(v, dn);
      Ac[p] = imax(H1[p] - dm1, Ac[p]);
      v = imax(v, Ac[p] - a0);
      Bc[p] = imax(h1m1 - d0, Bc[p]);
      v = imax(v, Bc[p] - am2);
      Cc[p] = imax(h1m1 - dp1, Cc[p]);
      v = imax(v, Cc[p] - am1);
      v = imax(v, imax(imax(H1[p], H2[p]), imax(h1m1, h2m1)) - fs);
      h[p] = v;
      tot = imax(tot, v + q * ge);
    }
    if (go > 0) {
      // I(q) = max_{k<q}(h(k) + k*ge) - q*ge - go  (exclusive prefix max)
      int carry = block_excl_max<NW>(tot, NEG, s_scan);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = q0 + p;
        const int hp = h[p];
        h[p] = imax(hp, carry - q * ge - go);
        carry = imax(carry, hp + q * ge);
      }
    } else {
      // go == 0: the prefix max restarts at every lane start (uniform
      // branch: go is the same for the whole block)
      Seg sg{0, NEG};
      int unused = NEG;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = q0 + p;
        sg = seg_combine(sg, Seg{q % sl == 0, h[p] + q * ge});
      }
      block_excl_seg_and_max<NW>(sg, unused, NEG, s_sf, s_sv, s_sm);
      int segc = sg.v;
      int hp1[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = q0 + p;
        const int st = q % sl == 0;
        hp1[p] = imax(h[p], (st ? NEG : segc) - q * ge);
        segc = st ? h[p] + q * ge : imax(segc, h[p] + q * ge);
      }
      // the one lazy-F step: lanes 1..7 start from the previous lane's end
      const int lh = from_left<NW>(hp1[P - 1], NEG, s_e0);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = q0 + p;
        const int prev = p ? hp1[p - 1] : lh;
        const int lane = q / sl;
        h[p] = q % sl == 0 && lane >= 1 && lane < 8 ? imax(hp1[p], prev - ge) : hp1[p];
      }
    }
    int rowmax = NEG;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int q = q0 + p;
      rowmax = imax(rowmax, h[p] + (q == al - 1 ? end_bonus : 0));
    }
    const int tmp_sc = block_max<NW>(rowmax, s_max);
    const int newL = from_left<NW>(h[P - 1], NEG, s_edge);
    const int tmp_log = tmp_sc - lpb[i];
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
    if (tid == 0) {
      // the -fs/0 boundary values are seen at row 2 only: from row 3 on
      // the reference rebuilds the [-1] column with NEG at lane 0
      L1 = L2 = L3 = NEG;
    } else {
      L3 = L2;
      L2 = L1;
      L1 = newL;
    }
    if (mscl - tmp_log > xdrop) break;  // uniform across the block
  }
  // aa_len: first real position whose Hmax + end bonus reaches max_sc
  int jm = 1 << 30;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    const int q = q0 + p;
    if (q < al && Hmax[p] + (q == al - 1 ? end_bonus : 0) == msc) jm = q;
  }
  jm = -block_max<NW>(-jm, s_fin);
  if (tid == 0) {
    out[3 * b + 0] = msc;
    out[3 * b + 1] = mi;
    out[3 * b + 2] = jm == (1 << 30) ? al - 1 : jm;
  }
}

template <int P, int NT>
static void launch(const int8_t* nas, const int32_t* D, const int32_t* A,
                   const int32_t* logpen, const int32_t* nl, const int32_t* al,
                   const int8_t* prof, int32_t* out, int n, int R, int RD, int go,
                   int ge, int fs, int xdrop, int endb, cudaStream_t st) {
  ext_dp_kernel<P, NT><<<n, NT, 0, st>>>(nas, D, A, logpen, nl, al, prof, out, R,
                                          RD, go, ge, fs, xdrop, endb);
}

extern "C" int mp_ext_dp(const void* nas, const void* D, const void* A,
                         const void* logpen, const void* nl, const void* al,
                         const void* prof, void* out, int n, int R, int RD, int AL,
                         int go, int ge, int fs, int xdrop, int endb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto a = (const int8_t*)nas;
  auto d = (const int32_t*)D;
  auto ac = (const int32_t*)A;
  auto lp = (const int32_t*)logpen;
  auto nv = (const int32_t*)nl;
  auto av = (const int32_t*)al;
  auto pr = (const int8_t*)prof;
  auto o = (int32_t*)out;
  switch (AL) {
    case 128: launch<1, 128>(a, d, ac, lp, nv, av, pr, o, n, R, RD, go, ge, fs, xdrop, endb, st); break;
    case 512: launch<2, 256>(a, d, ac, lp, nv, av, pr, o, n, R, RD, go, ge, fs, xdrop, endb, st); break;
    case 1024: launch<4, 256>(a, d, ac, lp, nv, av, pr, o, n, R, RD, go, ge, fs, xdrop, endb, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
