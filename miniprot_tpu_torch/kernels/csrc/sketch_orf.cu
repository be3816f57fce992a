// K6: six-frame ORF modimer sketch of one genome strand, emitted as the
// index's packed entries (the device sketch of the index build,
// --gpu-sketch).
//
// Replaces miniprot_tpu/kernels/sketch_jax.py:sketch_frames (:52, XLA
// device code in the JAX package, not Pallas) and the host compaction of
// its sketch_nt4_device (:99-127); the device form of mp_sketch_nt4 +
// mp_sketch_clean_orf (sketch.c:40-100).  Frame p holds the codons
// starting at p, p+3, ... (slot t ends at base p + 3t + 2).  A slot is
// "sense" when its three bases are ACGT and its codon is not a stop.
// The window of kmer slots ending at slot `last` is kept when the sense
// run holding `last` covers the window (ending >= kmer) and is at least
// min_aa_len codons long (total), and the invertible hash y of the
// window's reduced-alphabet k-mer (4 bits per residue) has its low
// mod_bit bits zero.  Each kept window gives one u64,
//   (y >> mod_bit) << 32 | ((p + 2 + 3 last) >> bbit) + boff,
// written in window order from out + off[p] (off[p]: the windows of the
// frames before p); frame p's count goes to counts[p] (status + 3
// n_tiles + 1).  The three regions, each cut to its count and laid end
// to end, are sketch_nt4_device's output in its order.
//
// Design: a block of 8 warps takes a tile of kSlots slots in each frame
// (3 kSlots bases, which all three frames share), staged in shared
// memory with 16-byte loads (codes above 4 clamped to 4, 4 outside the
// strand) together with a halo of kHalo slots on each side.  Tiles are
// large because each pays a fixed start (ticket, table, staging) and a
// look-back.  Per round a lane evaluates one slot of one frame with one
// lookup (a 512-entry table indexed by the three codes); the warp's
// ballot is the sense mask of 32 consecutive slots, and the lane packs
// its 4-bit code into nibble words from which any window's key is one
// funnel shift.  The run test needs the run lengths only capped at H =
// max(kmer, min_aa_len): if a capped length reaches H the run is long
// enough, else it is exact.  So one warp per frame (a lane: kLaneWords
// mask words) turns the masks into one run-test mask per word: ending
// >= kmer from the word and the one below it, total >= min_aa_len per
// run of the word from its length and the capped runs it joins; those
// come from the last / first lane whose words are not all sense (a
// ballot) and from the carries, the capped runs that end just before
// the tile and start just after it, read from the halo words.  A carry
// longer than the halo (H > kHalo) is walked on in global memory, 32
// slots per step, up to H.  Only a round with a window that passes
// hashes (a warp-uniform branch).  Compaction keeps the window order:
// per (tile, frame) counts from the keep ballots, a decoupled look-back
// over the tiles of each frame in the order blocks take tiles from a
// ticket (so a tile only waits for tiles already running), and each
// kept window, hashed again, written at its frame base + tile prefix +
// rank.  No atomic appends: the output is the same on every run.
//
// What bounds it on an H100: the per-slot pass (shared loads and
// shuffles) and the per-tile latency, more than the operations that
// chip_smoke.py's bound counts (14 per window, 18 more per window whose
// run passes) or the bytes (1 read per base, 8 written per kept
// window).  The tables come by value in the launch's parameter block
// (SketchParams: sketch_gpu.SKETCH_PARAMS), so a launch copies nothing
// to the card and never waits for it.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4096;                    // slots per frame of a tile
constexpr int kWords = kSlots / 32;             // its mask words
constexpr int kLaneWords = kWords / 32;         // words per lane of a frame warp
constexpr int kHalo = 32;                       // staged slots on each side
constexpr int kSpan = kSlots + 2 * kHalo;       // staged slots per frame
constexpr int kStage = (3 * kSpan + 2 + 15) / 16 * 16;  // staged bases
constexpr int kRounds = kWords / kWarps;        // mask words per warp and frame

constexpr unsigned long long kAggregate = 1ull << 62;  // a tile's own count
constexpr unsigned long long kPrefix = 2ull << 62;     // count of tiles <= it
constexpr unsigned long long kValue = kAggregate - 1;

}  // namespace

// the launch's parameter block (sketch_gpu.SKETCH_PARAMS, field for field)
struct SketchParams {
  uint8_t codon[64];    // codon index -> amino acid code (>= 20: stop)
  uint8_t codon13[64];  // codon index -> reduced-alphabet code
};

namespace {

// sketch.c:7-16; key + ~(key << s) = key (1 - 2^s) - 1, one multiply-add
__device__ __forceinline__ uint32_t hash32(uint32_t key, uint32_t mask) {
  key = (key * 0xFFFF8001u + 0xFFFFFFFFu) & mask;
  key = key ^ (key >> 10);
  key = (key * 9u) & mask;
  key = key ^ (key >> 6);
  key = (key * 0xFFFFF801u + 0xFFFFFFFFu) & mask;
  key = key ^ (key >> 16);
  return key;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The codon of bases a b c (each 0-4, 4: not ACGT) through tab[a << 6
// | b << 3 | c]: its reduced code (< 16) when it is a sense codon, 0xFF
// otherwise.  Returns sense; code gets the low nibble (garbage for a
// slot that is not sense, whose windows are never kept).
__device__ __forceinline__ bool slot_sense(unsigned a, unsigned b, unsigned c,
                                           const uint8_t* tab, unsigned& code) {
  const unsigned t = tab[a << 6 | b << 3 | c];
  code = t & 15;
  return t < 16;
}

__device__ __forceinline__ bool sense_at(const uint8_t* seq, long long n, int p, long long t,
                                         const uint8_t* tab) {
  const long long e = p + 3 * t;
  if (t < 0 || e + 2 >= n) return false;
  unsigned code;
  return slot_sense(min(seq[e], 4), min(seq[e + 1], 4), min(seq[e + 2], 4), tab, code);
}

// The sense run from slot `from` on in direction dir (+1 / -1), capped
// at cap, read from global memory 32 slots a step (warp-uniform).
__device__ unsigned walk(const uint8_t* seq, long long n, int p, long long from, int dir,
                         unsigned cap, const uint8_t* tab, int lane) {
  unsigned len = 0;
  while (len < cap) {
    const long long t = from + dir * ((long long)len + lane);
    const unsigned m = __ballot_sync(FULL_MASK, sense_at(seq, n, p, t, tab));
    if (m != FULL_MASK) return min(len + __ffs(~m) - 1, cap);
    len += 32;
  }
  return cap;
}

// The exclusive prefix of tile `tile` in one frame's look-back words
// (one warp): lane l reads tile t - l, waits until every lane sees a
// published word, and sums back to the nearest tile with its prefix.
__device__ unsigned long long look_back(const unsigned long long* st, long long tile,
                                        int lane) {
  unsigned long long excl = 0;
  for (long long t = tile - 1;; t -= 32) {
    const long long i = t - lane;
    unsigned long long s;
    for (int spins = 0;; ++spins) {
      s = i >= 0 ? ld_relaxed(st + i) : kPrefix;
      if (__all_sync(FULL_MASK, s != 0)) break;
      // a tile only waits for tiles that took their ticket earlier and
      // are running: a wait of seconds is a fault, not a slow tile
      if (spins > (1 << 24)) __trap();
      __nanosleep(64);
    }
    const unsigned pm = __ballot_sync(FULL_MASK, s >= kPrefix);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & kValue) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL_MASK, v, d);
    excl += v;
    if (pm) return excl;
  }
}

}  // namespace

__global__ void __launch_bounds__(kThreads) sketch_orf_kernel(
    const uint8_t* __restrict__ seq, unsigned long long* __restrict__ out,
    unsigned long long* status, long long n, long long n_tiles, long long off1, long long off2,
    long long boff, int min_aa_len, int kmer, int mod_bit, int bbit,
    const __grid_constant__ SketchParams prm) {
  __shared__ __align__(16) uint8_t s_seq[kStage];  // nt4 codes, 4 for anything else
  __shared__ uint8_t s_tab[512];                 // slot_sense's table
  __shared__ uint32_t s_mask[3][kWords];        // bit b of word q: slot T0 + 32 q + b
  __shared__ uint32_t s_pack[3][kSpan / 8];     // codes, 8 slots a word, first in bits 28-31
  __shared__ uint32_t s_ok[3][kWords];          // the run test of the windows of word q
  __shared__ uint32_t s_keep[3][kWords];
  __shared__ uint32_t s_woff[3][kWords];        // kept windows of the words before q
  __shared__ unsigned long long s_base[3];
  __shared__ long long s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) s_tile = (long long)atomicAdd(status + 3 * n_tiles, 1ull);
  for (int k = tid; k < 512; k += kThreads) {
    const int a = k >> 6, b = k >> 3 & 7, c = k & 7, cod = a << 4 | b << 2 | c;
    s_tab[k] = a < 4 && b < 4 && c < 4 && prm.codon[cod] < 20 ? prm.codon13[cod] : 0xFF;
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long T0 = tile * kSlots;           // the tile's first slot
  const long long g0 = 3 * (T0 - kHalo);        // the first staged base (16-byte aligned)

  for (int v = tid; v < kStage / 16; v += kThreads) {
    const long long g = g0 + 16 * v;
    if (g >= 0 && g + 16 <= n) {
      uint4 x = *reinterpret_cast<const uint4*>(seq + g);
      x.x = __vminu4(x.x, 0x04040404u), x.y = __vminu4(x.y, 0x04040404u);
      x.z = __vminu4(x.z, 0x04040404u), x.w = __vminu4(x.w, 0x04040404u);
      *reinterpret_cast<uint4*>(s_seq + 16 * v) = x;
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        s_seq[16 * v + k] = g + k >= 0 && g + k < n ? min(seq[g + k], 4) : 4;
    }
  }
  __syncthreads();

  // sense masks and packed codes of the tile's slots (the halo words:
  // below): lane b of round r and warp w holds slot 32 q + b of each
  // frame, q = r kWarps + w, here and in the windows below.  Per lane,
  // its staged bases, mask word and code word sit at fixed offsets from
  // three pointers.
  const int shift = 28 - 4 * (lane & 7);
  const uint8_t* sb = s_seq + 3 * (kHalo + 32 * warp + lane);
  uint32_t* smk = &s_mask[0][warp];
  uint32_t* spk = &s_pack[0][(kHalo + 32 * warp + lane) >> 3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll 4
    for (int r = 0; r < kRounds; ++r) {
      const uint8_t* b = sb + 3 * 32 * kWarps * r + p;
      unsigned code;
      const bool sense = slot_sense(b[0], b[1], b[2], s_tab, code);
      const unsigned m = __ballot_sync(FULL_MASK, sense);
      code <<= shift;
      code |= __shfl_xor_sync(FULL_MASK, code, 1);
      code |= __shfl_xor_sync(FULL_MASK, code, 2);
      code |= __shfl_xor_sync(FULL_MASK, code, 4);
      if (lane == 0) smk[p * kWords + kWarps * r] = m;
      if ((lane & 7) == 0) spk[p * (kSpan / 8) + 4 * kWarps * r] = code;
    }
  }

  // frame p (warp p): the halo words (and the left one's codes) and the
  // carries: the capped runs ending at slot T0 - 1 and starting at slot
  // T0 + kSlots
  const unsigned H = (unsigned)max(kmer, min_aa_len);
  unsigned wl = 0, L = 0, R = 0;
  if (warp < 3) {
    const int p = warp;
    unsigned code;
    const uint8_t* b = s_seq + 3 * lane + p;
    wl = __ballot_sync(FULL_MASK, slot_sense(b[0], b[1], b[2], s_tab, code));
    code <<= shift;
    code |= __shfl_xor_sync(FULL_MASK, code, 1);
    code |= __shfl_xor_sync(FULL_MASK, code, 2);
    code |= __shfl_xor_sync(FULL_MASK, code, 4);
    if ((lane & 7) == 0) s_pack[p][lane >> 3] = code;
    b += 3 * (kHalo + kSlots);
    const unsigned wr = __ballot_sync(FULL_MASK, slot_sense(b[0], b[1], b[2], s_tab, code));
    L = __clz(~wl);
    if (L == 32 && H > 32) L += walk(seq, n, p, T0 - kHalo - 1, -1, H - 32, s_tab, lane);
    R = wr == FULL_MASK ? 32u : __ffs(~wr) - 1;
    if (R == 32 && H > 32) R += walk(seq, n, p, T0 + kSlots + kHalo, 1, H - 32, s_tab, lane);
    L = min(L, H);
    R = min(R, H);
  }
  __syncthreads();

  if (warp < 3) {
    // frame p, lane k: tile words W k .. W k + W - 1 (W = kLaneWords).
    // The capped runs ending at the top (E) and starting at the bottom
    // (S) of the lane's words, from the last / first lane whose words
    // are not all sense; then each word's run-test mask: bit b is set
    // when the window ending at slot 32 w + b passes.  ending >= kmer:
    // the kmer slots up to b are sense (the word and the one below it,
    // kmer <= 8).  total >= min_aa_len: per run in the word, its length
    // plus the capped runs it joins below and above (exact below H; a
    // capped H alone reaches min_aa_len).
    const int p = warp, k = lane;
    uint32_t m[kLaneWords];
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) m[j] = s_mask[p][kLaneWords * k + j];
    unsigned top = 0, bot = 0;  // the runs ending at the top / starting at the bottom
    bool full = true, full_b = true;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) {
      const uint32_t a = m[kLaneWords - 1 - j], c = m[j];
      top += full ? __clz(~a) : 0;
      bot += full_b ? (c == FULL_MASK ? 32u : __ffs(~c) - 1) : 0;
      full = full && a == FULL_MASK;
      full_b = full_b && c == FULL_MASK;
    }
    const unsigned span = 32u * kLaneWords;
    const unsigned part = __ballot_sync(FULL_MASK, !full);
    const unsigned below = part & (FULL_MASK >> (31 - k)), above = part & (FULL_MASK << k);
    const int jb = below ? 31 - __clz(below) : 0;   // the last partial lane <= k
    const int ja = above ? __ffs(above) - 1 : 0;    // the first partial lane >= k
    const unsigned top_j = __shfl_sync(FULL_MASK, top, jb);
    const unsigned bot_j = __shfl_sync(FULL_MASK, bot, ja);
    const unsigned E = min(below ? span * (k - jb) + top_j : span * (k + 1) + L, H);
    const unsigned S = min(above ? span * (ja - k) + bot_j : span * (32 - k) + R, H);
    unsigned ep = __shfl_up_sync(FULL_MASK, E, 1), sn = __shfl_down_sync(FULL_MASK, S, 1);
    unsigned mp = __shfl_up_sync(FULL_MASK, m[kLaneWords - 1], 1);
    if (k == 0) {
      ep = L;
      mp = wl;
    }
    if (k == 31) sn = R;
    // per word: the capped runs below (ew) and above (sw) it
    unsigned sw[kLaneWords];
    sw[kLaneWords - 1] = sn;
#pragma unroll
    for (int j = kLaneWords - 2; j >= 0; --j)
      sw[j] = m[j + 1] == FULL_MASK ? min(sw[j + 1] + 32, H) : __ffs(~m[j + 1]) - 1;
    const unsigned mal = (unsigned)max(min_aa_len, 0);
    unsigned ew = ep;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) {
      const uint32_t mw = m[j], mb = j == 0 ? mp : m[j - 1];
      if (j > 0) ew = mb == FULL_MASK ? min(ew + 32, H) : __clz(~mb);
      unsigned ends = mw;
      for (int d = 1; d < kmer; ++d) ends &= __funnelshift_l(mb, mw, d);
      unsigned runs = 0;
      for (unsigned x = mw; x;) {
        const int s0 = __ffs(x) - 1;
        const unsigned gap = ~x >> s0;             // the run's end: its first zero
        const int len = gap ? __ffs(gap) - 1 : 32 - s0;
        const unsigned bits = (len == 32 ? FULL_MASK : (1u << len) - 1) << s0;
        const bool lo = s0 == 0, hi = s0 + len == 32;
        if ((unsigned long long)len + (lo ? ew : 0) + (hi ? sw[j] : 0) >= mal) runs |= bits;
        x &= ~bits;
      }
      s_ok[p][kLaneWords * k + j] = ends & runs;
    }
  }
  __syncthreads();

  // the windows that pass the run test: keys, hashes and the keep ballot
  // (a round with none skips them; the emit below hashes again)
  const unsigned kmask = kmer >= 8 ? FULL_MASK : (1u << (4 * kmer)) - 1;
  const unsigned low = (1u << mod_bit) - 1;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll 4
    for (int r = 0; r < kRounds; ++r) {
      const int q = r * kWarps + warp;
      const unsigned ok = s_ok[p][q];
      unsigned km = 0;
      if (ok) {
        const uint32_t* w = spk + p * (kSpan / 8) + 4 * kWarps * r;
        const uint32_t y = hash32(__funnelshift_r(w[0], w[-1], shift) & kmask, kmask);
        km = __ballot_sync(FULL_MASK, (ok >> lane & 1) && (y & low) == 0);
      }
      if (lane == 0) s_keep[p][q] = km;
    }
  }
  __syncthreads();

  if (warp < 3) {
    // frame p: word offsets (lane k: words W k ..), then the tile's
    // prefix by look-back
    const int p = warp;
    unsigned c[kLaneWords], sum = 0;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) {
      c[j] = __popc(s_keep[p][kLaneWords * lane + j]);
      sum += c[j];
    }
    unsigned incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned x = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += x;
    }
    unsigned off = incl - sum;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) {
      s_woff[p][kLaneWords * lane + j] = off;
      off += c[j];
    }
    const unsigned long long cnt = __shfl_sync(FULL_MASK, incl, 31);
    unsigned long long* st = status + p * n_tiles;
    unsigned long long excl = 0;
    if (tile > 0) {
      if (lane == 0) st_relaxed(st + tile, kAggregate | cnt);
      excl = look_back(st, tile, lane);
    }
    if (lane == 0) {
      st_relaxed(st + tile, kPrefix | (excl + cnt));
      s_base[p] = excl;
      if (tile == n_tiles - 1) status[3 * n_tiles + 1 + p] = excl + cnt;
    }
  }
  __syncthreads();

#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const unsigned long long base = (p == 0 ? 0 : p == 1 ? off1 : off2) + s_base[p];
#pragma unroll 4
    for (int r = 0; r < kRounds; ++r) {
      const int q = r * kWarps + warp;
      const unsigned km = s_keep[p][q];
      if (km >> lane & 1) {
        const uint32_t* w = spk + p * (kSpan / 8) + 4 * kWarps * r;
        const uint32_t y = hash32(__funnelshift_r(w[0], w[-1], shift) & kmask, kmask);
        const long long pos = p + 2 + 3 * (T0 + 32 * q + lane);
        out[base + s_woff[p][q] + __popc(km & lanemask_lt())] =
            (unsigned long long)(y >> mod_bit) << 32 |
            ((unsigned long long)(pos >> bbit) + (unsigned long long)boff);
      }
    }
  }
}

// seq: n nt4 codes, 16-byte aligned; out: the frames' windows (off1,
// off2: frame 1's and 2's first); status: 3 n_tiles + 4 zeroed u64 (the
// look-back words, the ticket, the three counts).
extern "C" int mp_sketch_orf(const void* seq, void* out, void* status, long long n,
                             long long off1, long long off2, long long boff, int min_aa_len,
                             int kmer, int mod_bit, int bbit, const void* params, void* stream) {
  const long long n_tiles = (n / 3 + kSlots - 1) / kSlots;
  if (n_tiles <= 0) return 0;
  SketchParams prm;
  std::memcpy(&prm, params, sizeof prm);
  sketch_orf_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (unsigned long long*)out, (unsigned long long*)status, n, n_tiles,
      off1, off2, boff, min_aa_len, kmer, mod_bit, bbit, prm);
  return (int)cudaGetLastError();
}
