// K7: the device prep of a raw batch, nt4 codes -> the DP input tracks.
//
// Replaces miniprot_tpu/kernels/nasw_pallas.py:_prep_seq_device (:638)
// and the log-penalty rows of _prep_tracks_device (:737), XLA code that
// the JAX package fuses into the jitted call of its Pallas kernel; the
// port's plain versions are nasw_ext._prep_seq_device and
// _logpen_device (about 230 small torch ops).  For problem b and row r
// of a batch with R rows (RD = R + 8), from nt = nt8[b] (already
// reversed for a left extension):
//   nas[b, r]  (r < R):  the amino acid of the codon ending at r (the
//              reversed codon, and none past nl - 1, for a left one)
//   D[b, r], A[b, r] (r < RD): the donor track folded with io and the
//              acceptor track (forward, or the reversed sequence's roles
//              for a left problem), 0 past row nl
//   logpen[b, r] (r < R, ext batches): #{thresholds <= r - 3 al}, the
//              reference's (int)(ie_coef * log2(x) + .5) without a float
//              log on the card
// every element exactly as the plain versions give it, pad rows
// included.  A read of nt outside [0, RD) is the code 4 (and no poly-Y
// term), as the plain version's shifts fill.
//
// The codon table, the splice scores and the thresholds come by value in
// the launch's parameter block (the C entry copies a host struct into
// it), so a launch copies nothing to the card and never waits for it.
//
// What bounds it: bytes (1 read + 13 written per row) against ~160
// int32 operations per row; both well under K1's time on the same batch.
// Design: a block of 128 threads takes a strip of 512 rows of one
// problem: it stages the strip's codes plus a 6-row halo below and 7
// above in shared memory, and each thread computes 4 consecutive rows
// from 17 staged codes, storing D, A and logpen as 16-byte vectors (4
// scalars where a row of the batch is not 16-byte aligned).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 4;
constexpr int kStrip = kThreads * kRowsPerThread;
constexpr int kBelow = 6, kAbove = 7;  // halo: nt[r-6 .. r+7]
constexpr int kMaxThr = 160;           // nasw_ext.TRACK_THR_CAP

}  // namespace

// the launch's parameter block (nasw_ext.TRACK_PARAMS, field for field)
struct TrackParams {
  uint8_t codon[64];  // codon index -> amino acid code
  int32_t sp[6];      // splice scores of the model
  int32_t nthr;       // thresholds in use (0: no logpen)
  int32_t thr[kMaxThr];
};

namespace {

// sp[t] for a site type t in {-1..4}; t < 0 scores 0
__device__ __forceinline__ int sp_sel(int t, const int* sp) { return t < 0 ? 0 : sp[t]; }

// the number of thresholds <= x (th ascending)
__device__ __forceinline__ int upper(const int* th, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (th[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

}  // namespace

__global__ void __launch_bounds__(kThreads) track_prep_kernel(
    const int8_t* __restrict__ nt8, const int8_t* __restrict__ leftv,
    const int32_t* __restrict__ iov, const int32_t* __restrict__ nlv,
    const int32_t* __restrict__ alv, int8_t* __restrict__ nas, int32_t* __restrict__ Dout,
    int32_t* __restrict__ Aout, int32_t* __restrict__ logpen, int R,
    const __grid_constant__ TrackParams p) {
  __shared__ int8_t s_nt[kStrip + kBelow + kAbove];  // the code, 4 outside
  __shared__ int8_t s_ny[kStrip + kBelow + kAbove];  // 1: inside and not C/T
  __shared__ int s_codon[64];
  __shared__ int s_sp[6];
  __shared__ int s_thr[kMaxThr];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int RD = R + 8;
  const int r_strip = blockIdx.y * kStrip;
  const int8_t* ntb = nt8 + (size_t)b * RD;
  for (int k = tid; k < kStrip + kBelow + kAbove; k += kThreads) {
    const int r = r_strip - kBelow + k;
    const bool in = r >= 0 && r < RD;
    const int v = in ? ntb[r] : 4;
    s_nt[k] = (int8_t)v;
    s_ny[k] = in && v != 1 && v != 3;
  }
  if (tid < 64) s_codon[tid] = p.codon[tid];
  if (tid < 6) s_sp[tid] = p.sp[tid];
  const bool pen = logpen != nullptr;
  const int nthr = pen ? p.nthr : 0;
  for (int k = tid; k < nthr; k += kThreads) s_thr[k] = p.thr[k];
  __syncthreads();

  const bool left = leftv != nullptr && leftv[b] != 0;
  const int nl = nlv[b], io = iov[b];
  const int sp3 = s_sp[3], sp5 = s_sp[5];
  const int r0 = r_strip + tid * kRowsPerThread;
  if (r0 >= RD) return;
  // codes (and poly-Y terms) of rows r0-6 .. r0+10
  int c[kRowsPerThread + kBelow + kAbove], y[kRowsPerThread + kBelow + kAbove];
#pragma unroll
  for (int k = 0; k < kRowsPerThread + kBelow + kAbove; ++k) {
    c[k] = s_nt[tid * kRowsPerThread + k];
    y[k] = s_ny[tid * kRowsPerThread + k] ? sp5 : 0;
  }
  int o_nas[kRowsPerThread], o_D[kRowsPerThread], o_A[kRowsPerThread];
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const int r = r0 + u, m = kBelow + u;  // row r's code is c[m]
    const int nt = c[m], m1 = c[m - 1], m2 = c[m - 2];
    const int p1 = c[m + 1], p2 = c[m + 2], p3 = c[m + 3];
    // nas: the codon ending at r (a left problem: its reversed codon)
    const bool ok = m2 < 4 && m1 < 4 && nt < 4 && r >= 2 && (!left || r <= nl - 1);
    const int cod = left ? (nt << 4 | m1 << 2 | m2) : (m2 << 4 | m1 << 2 | nt);
    o_nas[u] = ok ? s_codon[cod & 63] : 21;
    int donor, acceptor;
    if (!left) {
      // forward donor (nasw-sse.c:120-127), from nt[r..r+3]
      const bool gt = p1 == 2 && p2 == 3;
      const bool gtr = gt && (p3 == 0 || p3 == 2);
      int t = 3;
      if (p1 == 0 && p2 == 3) t = 2;             // AT.
      if (p1 == 2 && p2 == 1 && nt == 2) t = 1;  // GGC.
      if (gt && !gtr) t = 0;
      if (gtr) t = nt == 2 ? -1 : 4;
      donor = r <= nl - 4 ? sp_sel(t, s_sp) : sp3;
      // forward acceptor (nasw-sse.c:128-137), from nt[r-2..r] and the
      // poly-Y window r-6..r-4
      const bool ag = m1 == 0 && nt == 2;
      const bool yag = ag && r >= 2 && (m2 == 1 || m2 == 3);
      t = 3;
      if (m1 == 0 && nt == 1) t = 2;  // .AC
      if (ag) t = yag ? -1 : 0;
      int acc = sp_sel(t, s_sp);
      if (t <= 0) acc += y[m - 4] + y[m - 5] + y[m - 6];
      acceptor = r >= 1 && r <= nl - 1 ? acc : sp3;
    } else {
      // reversed-sequence donor (acceptor role; nasw-sse.c:171-180)
      const bool ga = p1 == 2 && p2 == 0;
      const bool gay = ga && (p3 == 1 || p3 == 3);
      int t = 3;
      if (p1 == 1 && p2 == 0) t = 2;  // CA.
      if (ga) t = gay ? -1 : 0;
      int dn = sp_sel(t, s_sp);
      if (t <= 0)
        dn += (r + 5 < nl ? y[m + 5] : 0) + (r + 6 < nl ? y[m + 6] : 0) +
              (r + 7 < nl ? y[m + 7] : 0);
      donor = r <= nl - 4 ? dn : sp3;
      // reversed-sequence acceptor (donor role; nasw-sse.c:181-188)
      const bool tg = m1 == 3 && nt == 2;
      const bool tg_ok = tg && r >= 2 && (m2 == 0 || m2 == 2);
      const bool gg = r + 1 < nl && p1 == 2;
      t = 3;
      if (m1 == 3 && nt == 0) t = 2;                        // .TA
      if (m1 == 1 && nt == 2 && r + 1 < nl && p1 == 1) t = 1;  // .CG(C)
      if (tg && !tg_ok) t = 0;
      if (tg_ok) t = gg ? -1 : 4;
      acceptor = r >= 1 && r <= nl - 1 ? sp_sel(t, s_sp) : sp3;
    }
    // rows past nl stay 0; the donor track carries io
    o_D[u] = r <= nl ? donor + io : 0;
    o_A[u] = r <= nl ? acceptor : 0;
  }

  const size_t row = (size_t)b * RD + r0;
  const bool full = r0 + kRowsPerThread <= RD;
  if (full && (row & 3) == 0) {
    *reinterpret_cast<int4*>(Dout + row) = make_int4(o_D[0], o_D[1], o_D[2], o_D[3]);
    *reinterpret_cast<int4*>(Aout + row) = make_int4(o_A[0], o_A[1], o_A[2], o_A[3]);
  } else {
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u)
      if (r0 + u < RD) {
        Dout[row + u] = o_D[u];
        Aout[row + u] = o_A[u];
      }
  }
  if (r0 >= R) return;
  const size_t rr = (size_t)b * R + r0;
  int o_pen[kRowsPerThread] = {0, 0, 0, 0};
  if (pen) {
    const int x0 = r0 - 3 * alv[b];
    o_pen[0] = upper(s_thr, nthr, x0);
#pragma unroll
    for (int u = 1; u < kRowsPerThread; ++u) {
      int k = o_pen[u - 1];
      while (k < nthr && s_thr[k] <= x0 + u) ++k;
      o_pen[u] = k;
    }
  }
  if (r0 + kRowsPerThread <= R && (rr & 3) == 0) {
    *reinterpret_cast<char4*>(nas + rr) =
        make_char4((char)o_nas[0], (char)o_nas[1], (char)o_nas[2], (char)o_nas[3]);
    if (pen)
      *reinterpret_cast<int4*>(logpen + rr) = make_int4(o_pen[0], o_pen[1], o_pen[2], o_pen[3]);
  } else {
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u)
      if (r0 + u < R) {
        nas[rr + u] = (int8_t)o_nas[u];
        if (pen) logpen[rr + u] = o_pen[u];
      }
  }
}

extern "C" int mp_track_prep(const void* nt8, const void* left, const void* io,
                             const void* nl, const void* al, void* nas, void* D, void* A,
                             void* logpen, int n, int R, const void* params, void* stream) {
  // the kernel's by-value copy of the host struct: nothing else to free
  const TrackParams p = *static_cast<const TrackParams*>(params);
  if (p.nthr < 0 || p.nthr > kMaxThr) return (int)cudaErrorInvalidValue;
  const dim3 grid(n, (R + 8 + kStrip - 1) / kStrip);
  track_prep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)nt8, (const int8_t*)left, (const int32_t*)io, (const int32_t*)nl,
      (const int32_t*)al, (int8_t*)nas, (int32_t*)D, (int32_t*)A, (int32_t*)logpen, R, p);
  return (int)cudaGetLastError();
}
