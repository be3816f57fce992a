"""Six-frame ORF modimer sketch of a genome strand on the card (K6, the
device sketch of the index build) and its plain PyTorch version.
Counterpart of miniprot_tpu/kernels/sketch_jax.py.

Same function as sketch.sketch_nt4 (reference sketch.c:40-100):
translate each frame, keep the windows of kmer codons that lie inside
an ORF run of at least min_aa_len sense codons, hash their reduced
k-mer and keep the hashes whose low mod_bit bits are zero.  The strand
is sketched whole: ORF state spans any distance.  The plain version
follows the JAX sketch_frames op for op (run lengths by cummax); the
hash runs in int64 with an explicit 24-bit mask (torch has little
uint32 arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..options import BITS_PER_AA
from . import LAUNCHES, call, require, resolve_device, stream_ptr


def _frames(n: int, kmer: int):
    """Per frame: (slots, windows, offset of its windows in the output)."""
    out, off = [], 0
    for p in (0, 1, 2):
        ns = max(0, -(-(n - 2 - p) // 3))
        nw = ns - kmer + 1 if ns >= kmer else 0
        out.append((ns, nw, off))
        off += nw
    return out, off


def sketch_frames(seq, min_aa_len: int, kmer: int, mod_bit: int,
                  trans_code: int = 1):
    """Modimer candidates of one strand.

    seq: (N,) uint8 nt4 codes.  Returns (hs, ps, keep): hash >> mod_bit
    and end position (int32), and the keep flag (bool), one entry per
    window, frames 0, 1, 2 concatenated (a frame with fewer than kmer
    codons has none).  Entries with keep False are undefined on the card
    and computed in the plain version.  CUDA tensors launch K6; CPU
    tensors run sketch_frames_plain."""
    if not seq.is_cuda:
        return sketch_frames_plain(seq, min_aa_len, kmer, mod_bit, trans_code)
    require(seq, torch.uint8, 1, "seq")
    n = seq.shape[0]
    fr, total = _frames(n, kmer)
    dev = seq.device
    hs = torch.empty(total, dtype=torch.int32, device=dev)
    ps = torch.empty(total, dtype=torch.int32, device=dev)
    keep = torch.zeros(total, dtype=torch.int8, device=dev)
    if total == 0:
        return hs, ps, keep.bool()
    T = tables.get_tables(trans_code)
    codon = torch.from_numpy(T.codon.astype(np.uint8)).to(dev)
    codon13 = torch.from_numpy(T.codon13.astype(np.uint8)).to(dev)
    call("mp_sketch_orf", seq.data_ptr(), codon.data_ptr(),
         codon13.data_ptr(), hs.data_ptr(), ps.data_ptr(), keep.data_ptr(),
         fr[0][0], fr[1][0], fr[2][0], fr[1][2], fr[2][2], min_aa_len, kmer,
         mod_bit, stream_ptr(seq))
    LAUNCHES["sketch_orf"] += 1
    return hs, ps, keep.bool()


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


def sketch_frames_plain(seq, min_aa_len: int, kmer: int, mod_bit: int,
                        trans_code: int = 1):
    """Plain PyTorch version of K6 (the JAX sketch_frames in torch ops)."""
    dev = seq.device
    T = tables.get_tables(trans_code)
    codon_t = torch.from_numpy(T.codon.astype(np.int64)).to(dev)
    codon13_t = torch.from_numpy(T.codon13.astype(np.int64)).to(dev)
    mask_k = (1 << (kmer * BITS_PER_AA)) - 1
    s = seq.to(torch.int64)
    valid = (s[:-2] < 4) & (s[1:-1] < 4) & (s[2:] < 4)
    cod = torch.where(valid, (s[:-2] << 4) | (s[1:-1] << 2) | s[2:], 0)
    sense = valid & (torch.where(valid, codon_t[cod], 255) < 20)
    rc = codon13_t[cod]
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


def sketch_nt4_device(seq_codes: np.ndarray, min_aa_len: int, kmer: int,
                      mod_bit: int, bbit: int, boff: int,
                      trans_code: int = 1, device=None) -> np.ndarray:
    """sketch.sketch_nt4 with the frames sketched on ``device`` (the card
    unless the caller asks for the CPU): the same multiset of u64
    entries (hash >> mod_bit) << 32 | block id."""
    dev = resolve_device(device)
    if len(seq_codes) < 3:
        return np.empty(0, np.uint64)
    seq = torch.from_numpy(np.ascontiguousarray(seq_codes, dtype=np.uint8))
    hs, ps, keep = sketch_frames(seq.to(dev), min_aa_len, kmer, mod_bit,
                                 trans_code)
    hs = hs[keep].cpu().numpy().astype(np.uint64)
    blk = (ps[keep].cpu().numpy().astype(np.uint64) >> np.uint64(bbit)) \
        + np.uint64(boff)
    return (hs << np.uint64(32)) | blk
