"""K-mer sketching ("modimers") over proteins and six-frame genome ORFs.

NumPy-vectorized equivalents of the reference sketchers (sketch.c):

- sketch_prot: rolling reduced-alphabet k-mer over a protein, keeping
  k-mers whose invertible 32-bit hash has its low mod_bit bits zero.
- sketch_nt4: per-strand three-frame ORF scan (the caller iterates the
  two strands, giving six frames) emitting modimers of ORFs of at least
  min_aa_len codons, binned into 2^bbit-bp blocks.

Output entries are u64 = (hash >> mod_bit) << 32 | payload where payload
is the query aa position (protein) or the global block id (genome).
The genome variant's output order is undefined (the caller sorts and
dedups), which is what makes it a clean JAX/TPU pipeline: translate via
gather, segment via boolean runs, hash vectorized, sort on device.
"""

from __future__ import annotations

import numpy as np

from . import tables
from .options import BITS_PER_AA
from .workspace import Workspace

_ws = Workspace()


def hash32_mask(key: np.ndarray, mask: int) -> np.ndarray:
    """Invertible integer hash (sketch.c:7-16), vectorized uint32."""
    key = key.astype(np.uint32)
    m = np.uint32(mask)
    key = (key + ~(key << np.uint32(15))) & m
    key ^= key >> np.uint32(10)
    key = (key + (key << np.uint32(3))) & m
    key ^= key >> np.uint32(6)
    key = (key + ~(key << np.uint32(11))) & m
    key ^= key >> np.uint32(16)
    return key


def _rolling_kmers(codes: np.ndarray, ok: np.ndarray, kmer: int):
    """All k-length windows of `codes` packed 4 bits/symbol, plus a mask of
    windows whose symbols are all `ok`.  Window w covers codes[w:w+kmer]."""
    n = len(codes)
    nw = n - kmer + 1
    if nw <= 0:
        return np.empty(0, np.uint32), np.empty(0, bool)
    x = np.zeros(nw, np.uint32)
    valid = np.ones(nw, bool)
    for t in range(kmer):
        x |= codes[t:nw + t].astype(np.uint32) << np.uint32(BITS_PER_AA * (kmer - 1 - t))
        valid &= ok[t:nw + t]
    return x, valid


def sketch_prot(seq: bytes | np.ndarray, kmer: int, mod_bit: int) -> np.ndarray:
    """Protein modimers: u64 = (hash>>mod_bit)<<32 | endpos
    (mp_sketch_prot, sketch.c:18-38).  Entries in query-position order.
    Thin dispatch to the C scan; sketch_prot_numpy is the golden model."""
    if not isinstance(seq, np.ndarray):
        seq = np.frombuffer(seq, dtype=np.uint8)
    from . import native
    aa13 = tables.get_tables(1).aa13  # reduced alphabet is code-independent
    return native.sketch_prot(np.ascontiguousarray(seq), aa13, kmer, mod_bit)


def sketch_prot_numpy(seq: bytes | np.ndarray, kmer: int, mod_bit: int) -> np.ndarray:
    """NumPy golden model for sketch_prot (cross-checked in tests)."""
    if not isinstance(seq, np.ndarray):
        seq = np.frombuffer(seq, dtype=np.uint8)
    aa13 = tables.get_tables(1).aa13  # reduced alphabet is code-independent
    r = aa13[seq]
    x, valid = _rolling_kmers(r, r < 14, kmer)
    if len(x) == 0:
        return np.empty(0, np.uint64)
    mask_k = (1 << (kmer * BITS_PER_AA)) - 1
    y = hash32_mask(x, mask_k)
    keep = valid & ((y & np.uint32((1 << mod_bit) - 1)) == 0)
    idx = np.flatnonzero(keep)
    return (y[idx].astype(np.uint64) >> np.uint64(mod_bit)) << np.uint64(32) \
        | (idx + (kmer - 1)).astype(np.uint64)


def sketch_nt4(seq: np.ndarray, min_aa_len: int, kmer: int, mod_bit: int,
               bbit: int, boff: int, trans_code: int = 1,
               copy: bool = True) -> np.ndarray:
    """Genome-strand modimers over 3-frame ORFs (mp_sketch_nt4 +
    mp_sketch_clean_orf, sketch.c:40-100).  Dispatches to the native C
    scanner; every caller sorts (+dedups) the scalar u64 output, so the
    multiset determines downstream bytes.

    seq: nt4 codes of one contig strand.
    """
    from . import native
    T = tables.get_tables(trans_code)
    return native.sketch_nt4(np.ascontiguousarray(seq, dtype=np.uint8),
                             min_aa_len, kmer, mod_bit, bbit, boff,
                             T.codon, T.codon13, copy=copy)


def sketch_nt4_numpy(seq: np.ndarray, min_aa_len: int, kmer: int, mod_bit: int,
                     bbit: int, boff: int, trans_code: int = 1) -> np.ndarray:
    """NumPy-vectorized golden model for sketch_nt4 (kept for tests and
    as the template the device kernel mirrors)."""
    T = tables.get_tables(trans_code)
    n = len(seq)
    if n < 3:
        return np.empty(0, np.uint64)
    ws = _ws
    # codon ending at i (i >= 2) and its validity/sense; large temporaries
    # come from the reused workspace (first-touch page faults are costly
    # in virtualized environments)
    m = n - 2
    c = ws.buf(m, np.uint8)
    t8 = ws.buf(m, np.uint8)
    np.left_shift(seq[:-2], 4, out=c, casting="unsafe")
    np.left_shift(seq[1:-1], 2, out=t8, casting="unsafe")
    np.bitwise_or(c, t8, out=c)
    np.bitwise_or(c, seq[2:], out=c)
    valid = ws.buf(m, bool)
    tb = ws.buf(m, bool)
    np.less(seq[:-2], 4, out=valid)
    np.less(seq[1:-1], 4, out=tb)
    np.logical_and(valid, tb, out=valid)
    np.less(seq[2:], 4, out=tb)
    np.logical_and(valid, tb, out=valid)
    np.bitwise_and(c, np.uint8(63), out=c)  # clamp ambiguous codons into range
    aa = ws.buf(m, np.uint8)
    np.take(T.codon, c, out=aa)
    sense = ws.buf(m, bool)
    np.less(aa, 20, out=sense)  # in-frame, translatable, non-stop
    np.logical_and(sense, valid, out=sense)
    rc = t8  # reuse: reduced codon codes
    np.take(T.codon13, c, out=rc)
    mask_k = (1 << (kmer * BITS_PER_AA)) - 1
    out = []
    for p_start in (0, 1, 2):  # codon end positions 2,3,4 mod 3
        s = np.ascontiguousarray(sense[p_start::3])
        rcs = rc[p_start::3]
        ns = len(s)
        if ns < kmer:
            continue
        nw = ns - kmer + 1
        # run length ending at slot t via the last-False cummax trick
        ti = ws.buf(ns, np.int64)
        ti[:] = np.arange(ns)
        lastF = ws.buf(ns, np.int64)
        lastF[:] = -1
        np.copyto(lastF, ti, where=~s)
        np.maximum.accumulate(lastF, out=lastF)
        ending = ws.buf(ns, np.int64)
        np.subtract(ti, lastF, out=ending)
        ending[~s] = 0
        # suffix run length via the same trick reversed
        sr = s[::-1]
        lastF[:] = -1
        np.copyto(lastF, ti, where=~sr)
        np.maximum.accumulate(lastF, out=lastF)
        starting_r = ws.buf(ns, np.int64)
        np.subtract(ti, lastF, out=starting_r)
        starting_r[~sr] = 0
        starting = starting_r[::-1]
        # k-mer windows: valid iff the run covers the whole window and the
        # run's total length passes min_aa_len
        x, _ = _rolling_kmers(rcs, s, kmer)
        endw = ending[kmer - 1:]
        ok = ws.buf(nw, bool)
        np.greater_equal(endw, kmer, out=ok)
        totw = ws.buf(nw, np.int64)
        np.add(endw, starting[kmer - 1:], out=totw)
        okb = ws.buf(nw, bool)
        np.greater_equal(totw, min_aa_len + 1, out=okb)  # ending+starting-1 >= min
        np.logical_and(ok, okb, out=ok)
        y = hash32_mask(x, mask_k)
        np.equal(y & np.uint32((1 << mod_bit) - 1), 0, out=okb)
        np.logical_and(ok, okb, out=ok)
        idx = np.flatnonzero(ok)
        if len(idx) == 0:
            continue
        y = y[idx]
        # codon end position of window's last codon: p_start + 2 + 3*last_slot
        pos = (p_start + 2 + 3 * (idx + kmer - 1)).astype(np.uint64)
        blk = (pos >> np.uint64(bbit)) + np.uint64(boff)
        out.append((y.astype(np.uint64) >> np.uint64(mod_bit)) << np.uint64(32) | blk)
    ws.reset()
    if not out:
        return np.empty(0, np.uint64)
    return np.concatenate(out)
