// K6: six-frame ORF modimer sketch of one genome strand (the device
// sketch of the index build, --gpu-sketch).
//
// Replaces miniprot_tpu/kernels/sketch_jax.py:sketch_frames (XLA device
// code in the JAX package, not Pallas), the device form of
// mp_sketch_nt4 + mp_sketch_clean_orf (sketch.c:40-100).  Frame p holds
// the codons starting at p, p+3, ... (slot t ends at base p + 3t + 2).
// A slot is "sense" when its three bases are ACGT and the codon is not a
// stop.  The window of kmer slots ending at slot `last` is kept when the
// sense run containing `last` has covered the whole window, the run is
// at least min_aa_len codons long, and the invertible hash of the
// window's reduced-alphabet k-mer (4 bits per residue) has its low
// mod_bit bits zero.  Outputs, per window and in sketch_frames' layout
// (frames concatenated, frame p at offset off[p], window w = last -
// kmer + 1): hash >> mod_bit, the end position p + 2 + 3*last, and a
// keep flag; the wrapper zeroes them first and this kernel writes the
// windows of sense runs only.
//
// Design: one thread per slot.  A thread whose slot starts a sense run
// walks the run twice: once for its length, once to roll the k-mer and
// emit its windows; every other thread returns at once.  Total work is
// linear in the strand; a run is walked by one thread (real ORFs are
// tens to thousands of codons).  What bounds it on an H100: memory —
// 1 byte read per base and 9 bytes written per window.
#include "common.cuh"

static __device__ __forceinline__ uint32_t hash32(uint32_t key, uint32_t mask) {
  key = (key + ~(key << 15)) & mask;
  key = key ^ (key >> 10);
  key = (key + (key << 3)) & mask;
  key = key ^ (key >> 6);
  key = (key + ~(key << 11)) & mask;
  key = key ^ (key >> 16);
  return key;
}

// codon index of the slot ending at base e, or -1 when a base is not ACGT
static __device__ __forceinline__ int codon_at(const uint8_t* seq, long long e) {
  const int a = seq[e - 2], b = seq[e - 1], c = seq[e];
  if (a > 3 || b > 3 || c > 3) return -1;
  return a << 4 | b << 2 | c;
}

__global__ void sketch_orf_kernel(const uint8_t* __restrict__ seq,
                                  const uint8_t* __restrict__ codon,
                                  const uint8_t* __restrict__ codon13,
                                  int32_t* __restrict__ hs, int32_t* __restrict__ ps,
                                  int8_t* __restrict__ keep, long long ns0, long long ns1,
                                  long long ns2, long long off1, long long off2,
                                  int min_aa_len, int kmer, int mod_bit) {
  long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int p;
  long long ns, off;
  if (x < ns0) {
    p = 0, ns = ns0, off = 0;
  } else if (x < ns0 + ns1) {
    p = 1, ns = ns1, off = off1, x -= ns0;
  } else if (x < ns0 + ns1 + ns2) {
    p = 2, ns = ns2, off = off2, x -= ns0 + ns1;
  } else {
    return;
  }
  if (ns < kmer) return;  // the frame has no window
  auto sense = [&](long long t) {
    const int c = codon_at(seq, p + 3 * t + 2);
    return c >= 0 && codon[c] < 20;
  };
  const long long t0 = x;
  if (!sense(t0) || (t0 > 0 && sense(t0 - 1))) return;  // not a run start
  long long t1 = t0;
  while (t1 + 1 < ns && sense(t1 + 1)) ++t1;
  const long long len = t1 - t0 + 1;
  if (len < kmer || len < min_aa_len) return;
  const uint32_t mask = (uint32_t)((1ull << (4 * kmer)) - 1);
  const uint32_t low = (1u << mod_bit) - 1;
  uint32_t key = 0;
  for (long long t = t0; t <= t1; ++t) {
    key = ((key << 4) | codon13[codon_at(seq, p + 3 * t + 2)]) & mask;
    if (t - t0 + 1 < kmer) continue;
    const uint32_t y = hash32(key, mask);
    if (y & low) continue;
    const long long w = off + t - (kmer - 1);
    hs[w] = (int32_t)(y >> mod_bit);
    ps[w] = (int32_t)(p + 2 + 3 * t);
    keep[w] = 1;
  }
}

extern "C" int mp_sketch_orf(const void* seq, const void* codon, const void* codon13,
                             void* hs, void* ps, void* keep, long long ns0, long long ns1,
                             long long ns2, long long off1, long long off2, int min_aa_len,
                             int kmer, int mod_bit, void* stream) {
  const long long total = ns0 + ns1 + ns2;
  if (total <= 0) return 0;
  const int nt = 256;
  sketch_orf_kernel<<<(unsigned)((total + nt - 1) / nt), nt, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (const uint8_t*)codon, (const uint8_t*)codon13, (int32_t*)hs,
      (int32_t*)ps, (int8_t*)keep, ns0, ns1, ns2, off1, off2, min_aa_len, kmer, mod_bit);
  return (int)cudaGetLastError();
}
