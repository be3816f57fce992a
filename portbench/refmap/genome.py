"""Genome database: 4-bit packed sequence store with random access.

Mirrors the reference genome model (ntseq.c): all contigs concatenated
into one 4-bit-packed buffer (2 bases/byte, low nibble first; 0..3 =
ACGT, >=4 ambiguous), per-contig (name, offset, length) records,
forward/reverse-complement slicing, binary dump/restore embedded in the
.mpi index format, and the optional splice-score (--spsc) store.

Coordinates: ``vid = cid << 1 | strand`` and v-coordinates are on the
chosen strand (miniprot.h:137, ntseq.c:108-114).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import tables
from .bseq import read_fasta_all


@dataclass
class Contig:
    name: str
    off: int
    len: int


@dataclass
class SpliceScores:
    """Per-(contig,strand) sorted u64 = pos<<8 | (score+64)<<1 | isAcceptor."""
    a: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))


class NtDB:
    """Packed nucleotide database (mp_ntdb_t)."""

    def __init__(self) -> None:
        self.ctg: list[Contig] = []
        self.l_seq: int = 0
        self.seq = np.empty(0, np.uint8)  # packed, (l_seq+1)//2 bytes
        self.spsc: list[SpliceScores] | None = None  # 2*n_ctg entries

    # ---------- construction ----------

    @classmethod
    def from_fasta(cls, fn: str) -> "NtDB":
        """Read a (gzipped) FASTA into a packed DB (mp_ntseq_read, ntseq.c:29-77).

        Fast path: one whole-file read + a single C pass per record that
        strips newlines, maps nt4 and packs nibbles in place (mx_fa_pack).
        FASTQ and unusual layouts fall back to the streaming parser."""
        db = cls()
        nt4 = tables.get_tables(1).nt4  # nt4 mapping is code-independent
        from . import native
        from .bseq import _open_maybe_gzip, _split_hdr, iter_fasta_spans
        data = None
        with _open_maybe_gzip(fn) as f:
            head = f.peek(1)[:1] if hasattr(f, "peek") else b""
            if head == b">":
                data = f.read()
        if data is None:
            # FASTQ / non-FASTA genome: streaming parser, per-record pack
            packed_parts: list[np.ndarray] = []
            off = 0
            for rec in read_fasta_all(fn):
                c = nt4[np.frombuffer(rec.seq, dtype=np.uint8)]
                db.ctg.append(Contig(rec.name, off, len(c)))
                off += len(c)
                packed_parts.append(c)
            flat = (np.concatenate(packed_parts) if packed_parts
                    else np.empty(0, np.uint8))
            del packed_parts
            if len(flat) & 1:
                flat = np.concatenate([flat, np.zeros(1, np.uint8)])
            db.l_seq = off
            db.seq = (flat[0::2] | (flat[1::2] << 4)).astype(np.uint8)
        else:
            # record boundaries come from the shared bseq scanner;
            # newline strip + nt4 map + nibble pack run in one C pass
            packed = np.zeros(len(data) // 2 + 1, np.uint8)
            off = 0
            for hdr, body_s, body_e in iter_fasta_spans(data):
                name, _ = _split_hdr(hdr)
                new_off = native.fa_pack(data, body_s, body_e, nt4,
                                         packed, off)
                db.ctg.append(Contig(name, off, new_off - off))
                off = new_off
            db.l_seq = off
            # NB: the slice view pins the full len(data)//2+1 buffer
            # (~1% newline overhead); a .copy() would transiently need
            # +l_seq/2 bytes while `data` is still live, a worse peak
            db.seq = packed[: (off + 1) // 2]
        return db

    @property
    def n_ctg(self) -> int:
        return len(self.ctg)

    # ---------- random access ----------

    def get(self, cid: int, st: int, en: int, rev: bool) -> np.ndarray:
        """Fetch contig bases [st, en) as nt4 codes; revcomp if rev
        (mp_ntseq_get, ntseq.c:89-106).  Runs in C."""
        from . import native
        c = self.ctg[cid]
        if en < 0 or en > c.len:
            en = c.len
        return native.unpack(self.seq, c.off + st, c.off + en, rev)

    def get_by_v(self, vid: int, st: int, en: int) -> np.ndarray:
        """v-coordinate fetch (mp_ntseq_get_by_v, ntseq.c:108-114)."""
        clen = self.ctg[vid >> 1].len
        assert st >= 0 and en >= 0 and st < clen
        en = min(en, clen)
        if vid & 1:
            return self.get(vid >> 1, clen - en, clen - st, True)
        return self.get(vid >> 1, st, en, False)

    # ---------- splice-score (--spsc) store ----------


    def spsc_get(self, cid: int, st0: int, en0: int, rev: bool) -> np.ndarray | None:
        """Dense uint8 splice-score track for [st0,en0) on a strand; 0xff =
        unset (mp_ntseq_spsc_get, ntseq.c:130-153)."""
        if self.spsc is None:
            return None
        clen = self.ctg[cid].len
        if en0 < 0 or en0 > clen:
            en0 = clen
        if not rev:
            st, en = st0, en0
        else:
            st, en = clen - en0, clen - st0
        sc = np.full(en - st, 0xFF, np.uint8)
        s = self.spsc[cid << 1 | (1 if rev else 0)]
        if len(s.a) > 0:
            pos = (s.a >> np.uint64(8)).astype(np.int64)
            lo = np.searchsorted(pos, st, "right")
            hi = np.searchsorted(pos, en, "right")
            for j in range(lo, hi):
                x = int(pos[j]) - st
                score = int(s.a[j] & np.uint64(0xFF))
                if x == en - st:
                    continue
                if sc[x] == 0xFF or sc[x] < score:
                    sc[x] = score
        return sc

    def spsc_get_by_v(self, vid: int, st: int, en: int) -> np.ndarray | None:
        clen = self.ctg[vid >> 1].len
        assert st >= 0 and en >= 0 and st < clen
        en = min(en, clen)
        if vid & 1:
            return self.spsc_get(vid >> 1, clen - en, clen - st, True)
        return self.spsc_get(vid >> 1, st, en, False)
