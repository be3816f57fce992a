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

import struct
import time
from dataclasses import dataclass

import numpy as np

from . import native, tables
from .genome import NtDB
from .options import IdxOpt
from .sketch import sketch_nt4

IDX_MAGIC = b"MPI\3"

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
    def n_block(self) -> int:
        return int(self.bo[-1])

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
    def build(cls, fn_or_db, opt: IdxOpt, n_threads: int = 1,
              sketch_device=None, stats: dict | None = None) -> "Index":
        """Build from a FASTA path or an NtDB (mp_idx_build, index.c:97-136).

        n_threads > 1 sketches contig-strands on a fork-based process
        pool (the reference's kt_for over 2*n_ctg, index.c:123); output
        is independent of n_threads (per-strand multisets are simply
        concatenated before the global sort+dedup).

        sketch_device ("cuda" or "cpu") sketches the six frames of each
        strand with kernels/sketch_gpu.py on that device instead (equal
        to the host sketch) — --gpu-sketch on the CLI; None keeps the
        host C sketch.  With sketch_device, ``stats`` (a dict) receives
        the host seconds of its stages: fetch_s (nt.get, the reverse
        complement included), sketch_s (upload, K6, pull-back),
        bb_add_s and bb_finish_s."""
        tables.set_default_code(opt.trans_code)
        from . import native, sysutil
        from .sysutil import profiler
        profiler.start("index_build")
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
        stage = dict.fromkeys(("fetch_s", "sketch_s", "bb_add_s",
                               "bb_finish_s"), 0.0)
        if sketch_device is not None:
            from .kernels import sketch_gpu

            def raw_parts():
                for cid, strand in jobs:
                    t0 = time.perf_counter()
                    seq = nt.get(cid, 0, -1, bool(strand))
                    t1 = time.perf_counter()
                    part = sketch_gpu.sketch_nt4_device(
                        seq, opt.min_aa_len, opt.kmer, opt.mod_bit, opt.bbit,
                        int(bo[cid << 1 | strand]), opt.trans_code,
                        device=sketch_device)
                    stage["fetch_s"] += t1 - t0
                    stage["sketch_s"] += time.perf_counter() - t1
                    yield part
        elif n_threads > 1 and len(jobs) > 1:
            def raw_parts():
                import multiprocessing as mp
                import warnings
                global _BUILD_CTX
                _BUILD_CTX = (nt, opt, bo)
                try:
                    with warnings.catch_warnings():
                        # fork after jax/BLAS threads exist: safe here
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
            t0 = time.perf_counter()
            native.bb_add(part)
            stage["bb_add_s"] += time.perf_counter() - t0
        sysutil.log("Index.build", "collected syncmers")
        ki = np.empty(n_bucket, np.int64)
        kb = np.empty(total, np.uint32)
        t0 = time.perf_counter()
        n_final = native.bb_finish(ki, kb)
        stage["bb_finish_s"] = time.perf_counter() - t0
        if stats is not None and sketch_device is not None:
            stats.update(stage)
        kb = kb[:n_final]
        sysutil.log("Index.build", "%d kmer-block pairs", len(kb))
        native.release_sketch_buf()
        if sketch_device is not None:
            sketch_gpu.release_buffers()
        profiler.stop("index_build")
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

    def print_stat(self, max_occ: int) -> str:
        occupied, n_large, tot, sum_large = native.idx_stat(self.ki, max_occ)
        mean = tot / (occupied - n_large) if occupied > n_large else 0.0
        return (f"{occupied} distinct k-mers; mean occ of infrequent k-mers: "
                f"{mean:.2f}; {n_large} frequent k-mers accounting for "
                f"{sum_large} occurrences")

    # ---------- I/O (.mpi compatible; index.c:189-229) ----------

    def dump(self, fn: str) -> None:
        with open(fn, "wb") as fp:
            fp.write(IDX_MAGIC)
            o = self.opt
            fp.write(struct.pack("<4iI", o.bbit, o.min_aa_len, o.kmer,
                                 o.mod_bit, o.trans_code))
            fp.write(struct.pack("<q", self.n_kb))
            self.nt.dump(fp)
            fp.write(self.ki.astype("<i8").tobytes())
            fp.write(self.kb.astype("<u4").tobytes())

    @classmethod
    def restore(cls, fn: str, mmap: bool | None = None) -> "Index":
        """Load a .mpi index.

        mmap=True (the default; MINIPROT_TPU_MMAP_INDEX=0 disables)
        maps the two big tables — ki (67MB at default k) and kb (4B per
        kmer-block pair, ~400MB per 200Mb of genome) — read-only from
        the file instead of reading them up front: the load returns in
        milliseconds and pages fault in lazily as buckets are touched,
        which is what a serving process restarting against a warm page
        cache wants.  Both tables are read-only for the whole mapping
        path (lookups + dump's astype copies), so a shared mapping is
        safe."""
        import os as _os
        if mmap is None:
            mmap = _os.environ.get("MINIPROT_TPU_MMAP_INDEX", "1") != "0"
        with open(fn, "rb") as fp:
            magic = fp.read(4)
            if magic != IDX_MAGIC:
                raise ValueError(f"{fn}: not an index file")
            bbit, min_aa_len, kmer, mod_bit, trans_code = struct.unpack("<4iI", fp.read(20))
            opt = IdxOpt(bbit=bbit, min_aa_len=min_aa_len, kmer=kmer,
                         mod_bit=mod_bit, trans_code=trans_code)
            tables.set_default_code(trans_code)
            (n_kb,) = struct.unpack("<q", fp.read(8))
            nt = NtDB.restore(fp, mmap=mmap)
            if mmap:
                off = fp.tell()
                ki = np.memmap(fn, dtype="<i8", mode="r", offset=off,
                               shape=(opt.n_bucket,))
                kb = np.memmap(fn, dtype="<u4", mode="r",
                               offset=off + opt.n_bucket * 8,
                               shape=(n_kb,))
            else:
                # np.fromfile reads straight into one fresh array (the
                # fp.read + frombuffer + copy chain costs two extra
                # full-size passes on 500MB-class tables)
                ki = np.fromfile(fp, dtype="<i8", count=opt.n_bucket)
                kb = np.fromfile(fp, dtype="<u4", count=n_kb)
        bo = cls._block_offsets(nt, opt.bbit)
        from . import sysutil
        sysutil.log("Index.restore", "loaded the index")
        return cls(opt, nt, bo, ki, kb)

    @classmethod
    def load(cls, fn: str, opt: IdxOpt, n_threads: int = 1,
             sketch_device=None) -> "Index":
        """Load a prebuilt .mpi or build from FASTA (mp_idx_load)."""
        try:
            with open(fn, "rb") as fp:
                magic = fp.read(4)
        except OSError:
            magic = b""
        if magic == IDX_MAGIC:
            return cls.restore(fn)
        return cls.build(fn, opt, n_threads=n_threads,
                         sketch_device=sketch_device)
