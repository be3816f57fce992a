"""Multi-process data-parallel mapping runner (port of
miniprot_tpu.parallel.runner).

The reference parallelizes mapping with kt_for threads inside one
process (map.c:291, kthread.c) and keeps output in input order through
the kt_pipeline handoff (map.c:293-325).  Across processes the
equivalent is: shard queries round-robin across processes (data
parallel: queries are independent), map each shard against its own
copy of the index, and restore the global input order at emission on
process 0.

Every output mode emits in parallel: each shard FORMATS its own
queries' text and spools it, so the process-0 emit never re-formats.
For id-free modes (PAF, --aln, --trans: the default) a spooled record
is (query_index, text) and the merge is pure ordered concatenation.
GFF/GTF record ids (``MP%06d``, format.c:372) are assigned in *output*
order, which is only known after the merge, so they use a TWO-PHASE id
assignment: shards format with a NUL sentinel standing in for the id
digits (_DeferredId) and spool (query_index, text, n_records); the
merge keeps a running global id base and rewrites each sentinel to
``base + local``, a string splice, not a re-format.

Spools are STREAMS: each shard appends one pickled record per query as
it maps (a shard never holds its results in RAM), and the process-0
emit is a k-way heap merge over lazy per-shard readers (one record per
shard in memory).

Coordination uses a shared spool directory plus the torch.distributed
barrier when a process group is initialized; the spool files double as
per-shard checkpoints: a preempted run is resumed by re-running only
the processes whose spool file is missing.

With a device, each shard maps through its own GpuExtEngine on that
device (each process drives the card it is given); an engine error
raises and the shard exits non-zero (no host fallback).
"""

from __future__ import annotations

import heapq
import os
import pickle
import time

import numpy as np

from ..align import DpEnv
from ..bseq import BatchReader
from ..index import Index
from ..mapper import map_query
from ..options import F_GFF, F_GTF, MapOpt
from ..pipeline import _emit_query


def emit_is_parallel(opt: MapOpt) -> bool:
    """True when per-query output text is independent of global state
    (no output-order record ids), so a spooled record is final text.
    GFF/GTF also format shard-side, but through the deferred-id
    two-phase scheme (see module docstring / _DeferredId)."""
    return not (opt.flag & (F_GFF | F_GTF))


class _DeferredId:
    """Stands in for the global GFF/GTF record id during shard-side
    formatting.  Supports the id-counter arithmetic the emit path does
    (``id_counter[0] += 1`` per emitted record) and formats, via the
    writers' existing ``{gid:06d}`` f-strings, unchanged, as a
    NUL-delimited sentinel carrying the shard-local ordinal.  The
    process-0 merge rewrites each sentinel to the true global id once
    output order is known (``_rewrite_ids``)."""

    __slots__ = ("local",)

    def __init__(self, local: int) -> None:
        self.local = local

    def __add__(self, k: int) -> "_DeferredId":
        return _DeferredId(self.local + k)

    def __format__(self, spec: str) -> str:
        return f"\x00{self.local}\x00"


def _rewrite_ids(text: str, base: int) -> str:
    """Splice global ids into shard-formatted GFF/GTF text: sentinel
    segments (odd positions after a NUL split) hold the local ordinal;
    the true id is ``base + local`` zero-padded exactly as the writers'
    ``{gid:06d}`` would have printed it."""
    if "\x00" not in text:
        return text
    parts = text.split("\x00")
    for i in range(1, len(parts), 2):
        parts[i] = format(base + int(parts[i]), "06d")
    return "".join(parts)


# the filesystem barrier's limit and its polling period, in seconds
SPOOL_TIMEOUT_S = 86400.0
SPOOL_POLL_S = 0.5


def spool_path(spool_dir: str, process_id: int) -> str:
    return os.path.join(spool_dir, f"shard{process_id:05d}.pkl")


def wait_for_spools(spool_dir: str, num_processes: int) -> None:
    """Filesystem barrier: block until every shard spool exists.

    Used when no process group coordinates the processes (independent
    CLI launches over a shared filesystem).  Spool files are written to
    a .tmp name and os.replace()d, so existence implies the shard is
    complete."""
    deadline = time.monotonic() + SPOOL_TIMEOUT_S
    missing = set(range(num_processes))
    while missing:
        missing = {pid for pid in missing
                   if not os.path.exists(spool_path(spool_dir, pid))}
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"shards never finished: {sorted(missing)} "
                f"(no spool file after {SPOOL_TIMEOUT_S:.0f}s)")
        time.sleep(SPOOL_POLL_S)


def map_shard(mi: Index, fn: str, opt: MapOpt, process_id: int,
              num_processes: int, spool_dir: str,
              resume: bool = False, device="cuda",
              n_threads: int = 1) -> int:
    """Map queries with global index % num_processes == process_id,
    streaming one record per query to the shard spool in ascending query
    order.

    resume: when the final spool file already exists, skip mapping (the
    atomic .tmp -> final rename makes an existing spool a complete,
    trustworthy checkpoint; docstring at module top).

    device: "cuda" (the default) batches this shard's alignment-round
    DPs onto the card through a GpuExtEngine (pipeline.map_batch_gpu;
    through the device daemon when one answers, daemon.attach) and
    raises without a card, "cpu" runs the same engine on the kernels'
    plain versions, None maps on the host C engine; the spooled records
    are identical either way.  An engine error raises (no host
    fallback).  n_threads: this shard's thread count (-t), the engine's
    n_workers."""
    if resume and os.path.exists(spool_path(spool_dir, process_id)):
        return -1
    engine = None
    if device is not None:
        from ..device import GpuExtEngine
        engine = GpuExtEngine(opt, device=device,
                              n_workers=max(1, min(n_threads,
                                                   os.cpu_count() or 1)))
    env = DpEnv(opt)
    reader = BatchReader(fn)
    par_emit = emit_is_parallel(opt)
    n = 0
    qi = 0
    tmp = spool_path(spool_dir, process_id) + ".tmp"

    def spool_rec(fp, qi0, rec, regs):
        import io as _io
        buf = _io.StringIO()
        if par_emit:
            # format here: the proc-0 merge then only concatenates
            _emit_query(mi, opt, rec.name,
                        np.frombuffer(rec.seq, dtype=np.uint8), regs,
                        [0], buf)
            pickle.dump((qi0, buf.getvalue()), fp,
                        protocol=pickle.HIGHEST_PROTOCOL)
        else:
            # GFF/GTF: format here too, with deferred ids; the merge
            # splices in the global id base (two-phase id assignment)
            idc = [_DeferredId(0)]
            _emit_query(mi, opt, rec.name,
                        np.frombuffer(rec.seq, dtype=np.uint8), regs,
                        idc, buf)
            pickle.dump((qi0, buf.getvalue(), idc[0].local), fp,
                        protocol=pickle.HIGHEST_PROTOCOL)

    with open(tmp, "wb") as fp:
        while True:
            batch = reader.read_batch(opt.mini_batch_size)
            if not batch:
                break
            mine = [(qi0, rec) for qi0, rec in
                    enumerate(batch, start=qi)
                    if qi0 % num_processes == process_id]
            qi += len(batch)
            if engine is not None:
                from ..pipeline import map_batch_gpu
                mapped = map_batch_gpu(mi, opt, env, engine,
                                       [rec for _, rec in mine])
                for (qi0, _), (rec, _, regs) in zip(mine, mapped):
                    spool_rec(fp, qi0, rec, regs)
                    n += 1
            else:
                for qi0, rec in mine:
                    seq = np.frombuffer(rec.seq, dtype=np.uint8)
                    regs = map_query(mi, seq, opt, env=env)
                    spool_rec(fp, qi0, rec, regs)
                    n += 1
    os.replace(tmp, spool_path(spool_dir, process_id))  # atomic: resumable
    if engine is not None:
        from ..pipeline import _engine_stats
        try:
            _engine_stats(engine, None)
        finally:
            engine.close()
    return n


def _iter_spool(path: str):
    with open(path, "rb") as fp:
        while True:
            try:
                yield pickle.load(fp)
            except EOFError:
                return


def emit_merged(opt: MapOpt, num_processes: int, spool_dir: str,
                out) -> int:
    """Process-0 ordered emit: streaming k-way merge of the shard spools
    in global query order, through the standard per-query output
    filters.  Memory: one in-flight record per shard."""
    streams = [_iter_spool(spool_path(spool_dir, pid))
               for pid in range(num_processes)]
    if opt.flag & F_GFF:
        out.write("##gff-version 3\n")
    id_counter = [0]
    n = 0
    # each stream is ascending in qi, so heapq.merge restores the global
    # input order without materializing anything
    for rec in heapq.merge(*streams, key=lambda r: r[0]):
        if len(rec) == 2:          # parallel emit: pre-formatted text
            out.write(rec[1])
        elif len(rec) == 3:        # GFF/GTF: splice in the global ids
            out.write(_rewrite_ids(rec[1], id_counter[0]))
            id_counter[0] += rec[2]
        else:
            raise ValueError(f"spool record of {len(rec)} fields: not a "
                             "map_shard spool")
        n += 1
    return n


def map_file_multihost(mi: Index, fn: str, opt: MapOpt, process_id: int,
                       num_processes: int, spool_dir: str, out,
                       resume: bool = False, device="cuda",
                       n_threads: int = 1) -> int:
    """Full multi-process run for one process: map my shard (on
    ``device``, as map_shard), barrier, and (on process 0) emit the
    merged ordered output.

    The barrier is torch.distributed.barrier when a process group is
    initialized, else the filesystem barrier (process 0 waits for every
    shard's spool file, the others return): the mode the CLI's --shards
    flag uses, where each shard is an independent process over a shared
    spool directory."""
    n = map_shard(mi, fn, opt, process_id, num_processes, spool_dir,
                  resume=resume, device=device, n_threads=n_threads)
    if num_processes > 1:
        import torch.distributed as tdist
        if tdist.is_available() and tdist.is_initialized():
            tdist.barrier()
        elif process_id == 0:
            wait_for_spools(spool_dir, num_processes)
        # fs mode: a non-zero shard is done once its own spool is
        # renamed; only the emitter waits for everyone
    if process_id == 0:
        return emit_merged(opt, num_processes, spool_dir, out)
    return n
