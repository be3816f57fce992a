"""Six-frame ORF modimer sketch of a genome strand on the card (K6, the
device sketch of the index build) and its plain PyTorch version.
Counterpart of miniprot_tpu/kernels/sketch_jax.py.

Same function as sketch.sketch_nt4 (reference sketch.c:40-100):
translate each frame, keep the windows of kmer codons that lie inside
an ORF run of at least min_aa_len sense codons, hash their reduced
k-mer and keep the hashes whose low mod_bit bits are zero.  The strand
is sketched whole: ORF state spans any distance.

Two forms.  The dense one, sketch_frames / sketch_frames_plain, follows
the JAX sketch_frames op for op (run lengths by cummax; the hash in
int64 with an explicit mask, since torch has little uint32 arithmetic):
the specification.  The packed one, sketch_entries, is what the index
takes: one u64 entry (hash >> mod_bit) << 32 | ((pos >> bbit) + boff)
per kept window, frame 0, 1, 2 and each frame in window order (the JAX
sketch_nt4_device's order).  K6 computes the packed form on the card;
its plain version is sketch_entries_plain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..options import BITS_PER_AA
from . import LAUNCHES, call, require, resolve_device, stream_ptr

# slots per frame of one of K6's tiles (sketch_orf.cu kSlots): a tile
# covers 3 * TILE_SLOTS bases
TILE_SLOTS = 4096

# K6's parameter block, passed by value at launch (sketch_orf.cu's
# SketchParams, field for field)
SKETCH_PARAMS = np.dtype([("codon", np.uint8, 64), ("codon13", np.uint8, 64)])


@functools.lru_cache(maxsize=None)
def sketch_params(trans_code: int) -> np.ndarray:
    """K6's parameter block for a translation table: a (1,)
    SKETCH_PARAMS array (cached, so its memory outlives the launch)."""
    T = tables.get_tables(trans_code)
    p = np.zeros(1, SKETCH_PARAMS)
    p["codon"][0] = T.codon
    p["codon13"][0] = T.codon13
    return p


def _frames(n: int, kmer: int):
    """Per frame: (slots, windows, offset of its windows in the output)."""
    out, off = [], 0
    for p in (0, 1, 2):
        ns = max(0, -(-(n - 2 - p) // 3))
        nw = ns - kmer + 1 if ns >= kmer else 0
        out.append((ns, nw, off))
        off += nw
    return out, off


def n_tiles(n: int) -> int:
    """K6's tiles (blocks) for a strand of n bases: frame 0's slots,
    n // 3, in tiles of TILE_SLOTS."""
    return -(-(n // 3) // TILE_SLOTS)


def sketch_frames(seq, min_aa_len: int, kmer: int, mod_bit: int,
                  trans_code: int = 1):
    """Modimer candidates of one strand, dense: the JAX sketch_frames.

    seq: (N,) uint8 nt4 codes.  Returns (hs, ps, keep): hash >> mod_bit
    and end position (int32), and the keep flag (bool), one entry per
    window, frames 0, 1, 2 concatenated (a frame with fewer than kmer
    codons has none).  CPU tensors only: no kernel computes the dense
    form (K6 emits the packed entries, sketch_entries), so a CUDA
    tensor raises; sketch_frames_plain is the specification on any
    device."""
    if seq.is_cuda:
        raise ValueError("sketch_frames: no kernel computes the dense form "
                         "on the card; use sketch_entries (K6) or "
                         "sketch_frames_plain")
    return sketch_frames_plain(seq, min_aa_len, kmer, mod_bit, trans_code)


def _hash32(key, mask: int):
    """sketch.c:7-16 on int64 values (uint32 arithmetic, then masked)."""
    key = (key + ~(key << 15)) & mask
    key = key ^ (key >> 10)
    key = (key + (key << 3)) & mask
    key = key ^ (key >> 6)
    key = (key + ~(key << 11)) & mask
    return key ^ (key >> 16)


def _run_lengths(s):
    """For a boolean run mask: the length of the True-run ending at t,
    and the total length of the run containing t."""
    t_idx = torch.arange(s.shape[0], device=s.device)
    last_false = torch.cummax(torch.where(~s, t_idx, -1), dim=0).values
    ending = torch.where(s, t_idx - last_false, 0)
    sr = torch.flip(s, [0])
    last_false_r = torch.cummax(torch.where(~sr, t_idx, -1), dim=0).values
    starting = torch.flip(torch.where(sr, t_idx - last_false_r, 0), [0])
    return ending, torch.where(s, ending + starting - 1, 0)


def sense_codes(seq, trans_code: int = 1):
    """Per codon end position e >= 2 of seq: (sense, code): the codon
    ending at e is ACGT and not a stop, and its reduced-alphabet code
    (codon13 of codon 0 where a base is not ACGT)."""
    T = tables.get_tables(trans_code)
    codon_t = torch.from_numpy(T.codon.astype(np.int64)).to(seq.device)
    codon13_t = torch.from_numpy(T.codon13.astype(np.int64)).to(seq.device)
    s = seq.to(torch.int64)
    valid = (s[:-2] < 4) & (s[1:-1] < 4) & (s[2:] < 4)
    cod = torch.where(valid, (s[:-2] << 4) | (s[1:-1] << 2) | s[2:], 0)
    sense = valid & (torch.where(valid, codon_t[cod], 255) < 20)
    return sense, codon13_t[cod]


def sketch_frames_plain(seq, min_aa_len: int, kmer: int, mod_bit: int,
                        trans_code: int = 1):
    """Plain PyTorch version of the dense form (the JAX sketch_frames in
    torch ops)."""
    dev = seq.device
    mask_k = (1 << (kmer * BITS_PER_AA)) - 1
    sense, rc = sense_codes(seq, trans_code)
    hs, ps, keeps = [], [], []
    for p in (0, 1, 2):
        ss, rcs = sense[p::3], rc[p::3]
        ns = ss.shape[0]
        if ns < kmer:
            continue
        ending, total = _run_lengths(ss)
        nw = ns - kmer + 1
        x = torch.zeros(nw, dtype=torch.int64, device=dev)
        for t in range(kmer):
            x = x | (rcs[t:nw + t] << (BITS_PER_AA * (kmer - 1 - t)))
        last = torch.arange(nw, device=dev) + (kmer - 1)
        ok = (ending[last] >= kmer) & (total[last] >= min_aa_len)
        y = _hash32(x, mask_k)
        keeps.append(ok & ((y & ((1 << mod_bit) - 1)) == 0))
        hs.append((y >> mod_bit).to(torch.int32))
        ps.append((p + 2 + 3 * last).to(torch.int32))
    if not hs:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty, torch.empty(0, dtype=torch.bool, device=dev)
    return torch.cat(hs), torch.cat(ps), torch.cat(keeps)


def pack_entries(hs, ps, bbit: int, boff: int):
    """int64 index entries (u64 bit patterns) from hashes and end
    positions: hash << 32 | ((pos >> bbit) + boff)."""
    h = hs.to(torch.int64) & 0xFFFFFFFF
    return (h << 32) | ((ps.to(torch.int64) >> bbit) + boff)


def sketch_entries_plain(seq, min_aa_len: int, kmer: int, mod_bit: int,
                         bbit: int, boff: int, trans_code: int = 1):
    """Plain PyTorch version of K6: the kept windows of
    sketch_frames_plain, packed."""
    hs, ps, keep = sketch_frames_plain(seq, min_aa_len, kmer, mod_bit,
                                       trans_code)
    return pack_entries(hs[keep], ps[keep], bbit, boff)


class SketchLaunch:
    """K6's output on the card before its count is read: frame p's
    entries lie in ``buf`` from ``offs[p]``; ``status`` ends with the
    three frames' counts."""

    def __init__(self, buf, status, offs):
        self.buf, self.status, self.offs = buf, status, offs

    def counts(self) -> list[int]:
        """Entries per frame: one 24-byte copy, the launch's only
        synchronization (none when the strand has no window)."""
        if not self.buf.numel():
            return [0, 0, 0]
        return self.status[-3:].tolist()

    def regions(self) -> list:
        """Each frame's entries, in order (views of ``buf``)."""
        return [self.buf[o:o + c] for o, c in zip(self.offs, self.counts())]


def sketch_launch(seq, min_aa_len: int, kmer: int, mod_bit: int, bbit: int,
                  boff: int, trans_code: int = 1) -> SketchLaunch:
    """Launch K6 on a strand on the card (16-byte aligned uint8 nt4
    codes).  Takes nothing from the host but the parameter block, by
    value, and never synchronizes.  1 <= kmer <= 8 and 0 <= mod_bit < 32
    (the key and hash are 32-bit); any min_aa_len."""
    require(seq, torch.uint8, 1, "seq", align=16)
    if not (1 <= kmer <= 8 and 0 <= mod_bit < 32):
        raise ValueError(f"sketch_orf: kmer {kmer}, mod_bit {mod_bit}: the "
                         "kernel takes 1 <= kmer <= 8, 0 <= mod_bit < 32")
    n = seq.shape[0]
    fr, total = _frames(n, kmer)
    dev = seq.device
    buf = torch.empty(total, dtype=torch.int64, device=dev)
    status = torch.zeros(3 * n_tiles(n) + 4, dtype=torch.int64, device=dev)
    if total:
        mal = min(max(min_aa_len, -(1 << 31)), (1 << 31) - 1)
        call("mp_sketch_orf", seq.data_ptr(), buf.data_ptr(),
             status.data_ptr(), n, fr[1][2], fr[2][2], boff, mal, kmer,
             mod_bit, bbit, sketch_params(trans_code).ctypes.data,
             stream_ptr(seq))
        LAUNCHES["sketch_orf"] += 1
    return SketchLaunch(buf, status, [f[2] for f in fr])


def sketch_entries(seq, min_aa_len: int, kmer: int, mod_bit: int, bbit: int,
                   boff: int, trans_code: int = 1):
    """The index entries of one strand, (K,) int64 (u64 bit patterns),
    frame 0, 1, 2 and each frame in window order.  CUDA tensors launch
    K6 (one synchronization: the count read); CPU tensors run
    sketch_entries_plain."""
    if not seq.is_cuda:
        return sketch_entries_plain(seq, min_aa_len, kmer, mod_bit, bbit,
                                    boff, trans_code)
    return torch.cat(sketch_launch(seq, min_aa_len, kmer, mod_bit, bbit,
                                   boff, trans_code).regions())


_pinned: dict = {}


def release_buffers() -> None:
    """Free the pinned host buffers that sketch_nt4_device reuses (they
    grow to the longest strand sketched and its entries)."""
    _pinned.clear()


def _host_buffer(name: str, n: int, dtype) -> torch.Tensor:
    """A pinned host buffer of at least n elements, reused from call to
    call (grown by half again when too small)."""
    buf = _pinned.get(name)
    if buf is None or buf.numel() < n:
        size = max(n, 0 if buf is None else buf.numel() * 3 // 2, 1 << 16)
        buf = _pinned[name] = torch.empty(size, dtype=dtype, pin_memory=True)
    return buf


def sketch_nt4_device(seq_codes: np.ndarray, min_aa_len: int, kmer: int,
                      mod_bit: int, bbit: int, boff: int,
                      trans_code: int = 1, device=None) -> np.ndarray:
    """sketch.sketch_nt4 with the frames sketched on ``device`` (the card
    unless the caller asks for the CPU): the same multiset of u64
    entries, in the JAX sketch_nt4_device's order.  On the card the
    strand goes up and the entries come back through pinned buffers
    reused from call to call (freed by release_buffers): the result is
    a view of that buffer, valid until the next call, so a caller that
    keeps it copies it (Index.build hands it to native.bb_add, which
    copies it at once)."""
    dev = resolve_device(device)
    n = len(seq_codes)
    if n < 3:
        return np.empty(0, np.uint64)
    if dev.type == "cpu":
        seq = torch.from_numpy(np.array(seq_codes, dtype=np.uint8))
        return sketch_entries_plain(seq, min_aa_len, kmer, mod_bit, bbit,
                                    boff, trans_code).numpy().view(np.uint64)
    up = _host_buffer("seq", n, torch.uint8)[:n]
    np.copyto(up.numpy(), seq_codes, casting="unsafe")
    seq = torch.empty(n, dtype=torch.uint8, device=dev)
    seq.copy_(up, non_blocking=True)
    run = sketch_launch(seq, min_aa_len, kmer, mod_bit, bbit, boff,
                        trans_code)
    regions = run.regions()
    total = sum(r.numel() for r in regions)
    host = _host_buffer("entries", total, torch.int64)
    o = 0
    for r in regions:
        host[o:o + r.numel()].copy_(r, non_blocking=True)
        o += r.numel()
    torch.cuda.current_stream(dev).synchronize()
    return host[:total].numpy().view(np.uint64)
