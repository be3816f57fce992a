"""Genome k-mer index: dense bucket array over modimer hashes.

Mirrors the reference index (index.c): per-(contig,strand) six-frame
modimer sketching, then a counting sort into a bucket array
``ki[2^(4k - mod_bit)]`` of int64 start offsets plus ``kb[]`` of uint32
block ids.  Block ids are global across contig-strands through the
``bo[]`` offset table; ``block2pos`` recovers (contig,strand) by binary
search.  The on-disk format is byte-compatible with reference ``.mpi``
files (magic "MPI\\3"; index.c:189-229) so indexes can be exchanged and
cross-validated with the reference tool.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import native, tables
from .genome import NtDB
from .options import IdxOpt
from .sketch import sketch_nt4

# build-worker state inherited via fork (set only inside Index.build)
_BUILD_CTX = None


def _build_worker(job):
    cid, strand = job
    nt, opt, bo = _BUILD_CTX
    seq = nt.get(cid, 0, -1, bool(strand))
    # RAW (hash, block) entries, unsorted: the parent streams every part
    # through the fused bucket build, which sorts + dedups per bucket
    # (the reference's per-strand radix sort + dedup, sketch.c:94-99,
    # becomes unnecessary work).  The view pickles by value.
    return sketch_nt4(seq, opt.min_aa_len, opt.kmer, opt.mod_bit, opt.bbit,
                      int(bo[cid << 1 | strand]), opt.trans_code, copy=False)


@dataclass
class Index:
    opt: IdxOpt
    nt: NtDB
    bo: np.ndarray        # uint32, 2*n_ctg+1 block offsets (index.c:11-26)
    ki: np.ndarray        # int64, n_bucket start offsets
    kb: np.ndarray        # uint32, block ids per bucket


    @property
    def n_kb(self) -> int:
        return len(self.kb)

    # ---------- build ----------

    @staticmethod
    def _block_offsets(nt: NtDB, bbit: int) -> np.ndarray:
        bo = np.zeros(nt.n_ctg * 2 + 1, np.uint32)
        off = 0
        for i, c in enumerate(nt.ctg):
            nblk = (c.len + (1 << bbit) - 1) >> bbit
            bo[i << 1 | 0] = off
            off += nblk
            bo[i << 1 | 1] = off
            off += nblk
        assert off < 0xFFFFFFFF
        bo[nt.n_ctg * 2] = off
        return bo

    @classmethod
    def build(cls, fn_or_db, opt: IdxOpt, n_threads: int = 1) -> "Index":
        """Build from a FASTA path or an NtDB (mp_idx_build, index.c:97-136).

        n_threads > 1 sketches contig-strands on a fork-based process
        pool (the reference's kt_for over 2*n_ctg, index.c:123); output
        is independent of n_threads (per-strand multisets are simply
        concatenated before the global sort+dedup)."""
        tables.set_default_code(opt.trans_code)
        nt = fn_or_db if isinstance(fn_or_db, NtDB) else NtDB.from_fasta(fn_or_db)
        bo = cls._block_offsets(nt, opt.bbit)
        jobs = [(cid, strand) for cid in range(nt.n_ctg) for strand in (0, 1)]
        global _BUILD_CTX

        # every sketch source yields RAW (hash, block) parts in job
        # order; they stream straight into the fused bucket build, which
        # sorts + dedups per (tiny, cache-local) bucket slice in place.
        # Byte-identical to the reference pipeline (per-strand radix
        # sort + dedup, sketch.c:94-99, then counting scatter,
        # index.c:71-95) because block ranges are disjoint + ascending
        # across strand parts (see mx_bb_finish); replaces 5-6
        # full-array radix passes per strand and the full-size cursor
        # table walks of the counting merge.
        if n_threads > 1 and len(jobs) > 1:
            def raw_parts():
                import multiprocessing as mp
                import warnings
                global _BUILD_CTX
                _BUILD_CTX = (nt, opt, bo)
                try:
                    with warnings.catch_warnings():
                        # fork after BLAS threads exist: safe here
                        # because the workers touch only numpy +
                        # libmpnative (no locks shared with those threads)
                        warnings.filterwarnings("ignore", message=".*fork.*")
                        with mp.get_context("fork").Pool(
                                min(n_threads, len(jobs))) as pool:
                            # ordered imap, chunksize=1 REQUIRED: workers
                            # return copy=False views into their module
                            # sketch buffer, which stay valid only until
                            # the worker's next job; chunked dispatch
                            # would overwrite earlier views in the chunk
                            # before they are pickled
                            yield from pool.imap(_build_worker, jobs,
                                                 chunksize=1)
                finally:
                    _BUILD_CTX = None
        else:
            def raw_parts():
                for cid, strand in jobs:
                    seq = nt.get(cid, 0, -1, bool(strand))
                    yield sketch_nt4(seq, opt.min_aa_len, opt.kmer,
                                     opt.mod_bit, opt.bbit,
                                     int(bo[cid << 1 | strand]),
                                     opt.trans_code, copy=False)

        n_bucket = opt.n_bucket
        # raw modimer density is ~1/bp per strand-pair before the
        # 2^-mod_bit sampling (one 6-mer per codon position across
        # 3 frames x 2 strands, thinned by ORF/min_aa_len masking);
        # reserve ~10% above that so growth copies are rare
        density = 1.10 / (1 << opt.mod_bit)
        native.bb_reset(n_bucket, int(nt.l_seq * density) + (1 << 16))
        total = 0
        for part in raw_parts():
            total += len(part)
            native.bb_add(part)
        ki = np.empty(n_bucket, np.int64)
        kb = np.empty(total, np.uint32)
        n_final = native.bb_finish(ki, kb)
        kb = kb[:n_final]
        native.release_sketch_buf()
        return cls(opt, nt, bo, ki, kb)

    # ---------- queries ----------

    def bucket(self, h: int) -> np.ndarray:
        """Block ids for hash h."""
        st = int(self.ki[h])
        en = int(self.ki[h + 1]) if h + 1 < len(self.ki) else len(self.kb)
        return self.kb[st:en]

    def bucket_counts(self, hashes: np.ndarray) -> np.ndarray:
        """Occurrence count per hash (vectorized)."""
        h = hashes.astype(np.int64)
        st = self.ki[h]
        en = np.where(h + 1 < len(self.ki), self.ki[np.minimum(h + 1, len(self.ki) - 1)],
                      len(self.kb))
        return en - st

    def block2pos(self, b: int) -> int:
        """Block id -> contig-strand vid (mp_idx_block2pos, index.c:28-44)."""
        i = int(np.searchsorted(self.bo, b, side="right")) - 1
        if i >= self.nt.n_ctg * 2:
            return -1
        return i

