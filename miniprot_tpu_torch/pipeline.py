"""Batched mapping pipeline with ordered output.

The reference's 3-step read/map/write pipeline (map.c:242-343, kthread.c)
maps to a batch loop here:

  read  -> up to mini_batch_size residues of queries per mini-batch
  map   -> data-parallel across a fork-based process pool (the kt_for
           analog); with a device engine, the alignment DPs of the whole
           mini-batch are batched onto the CUDA kernels (or, with
           device="cpu", their plain PyTorch versions)
  write -> input-order emit with the per-query best-score/coverage
           output filters

Output is byte-identical across (n_threads, device) settings.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from .align import DpEnv
from .bseq import BatchReader
from .format import write_output
from .index import Index
from .mapper import map_query
from .options import F_GFF, MapOpt

# worker-process state, inherited via fork
_W: dict = {}


def _emit_query(mi: Index, opt: MapOpt, name: str, seq: np.ndarray, regs,
                id_counter: list[int], out) -> None:
    """Per-query ordered emit with output filters (map.c:297-313)."""
    best_sc = -1
    if regs:
        r0 = regs[0]
        best_sc = r0.p.dp_max if r0.p is not None else r0.chn_sc
    n_out = 0
    for j, r in enumerate(regs):
        if j >= opt.out_n:
            break
        sc = r.p.dp_max if r.p is not None else r.chn_sc
        if sc <= 0 or sc < float(best_sc) * opt.out_sim:
            continue
        if r.qe - r.qs < float(len(seq)) * opt.out_cov:
            continue
        id_counter[0] += 1
        out.write(write_output(mi, opt, name, seq, r, id_counter[0], j + 1))
        n_out += 1
    if n_out == 0:
        out.write(write_output(mi, opt, name, seq, None, 0, 0))


def _worker_map(seq_bytes: bytes):
    seq = np.frombuffer(seq_bytes, dtype=np.uint8)
    return map_query(_W["mi"], seq, _W["opt"], env=_W["env"])


def _worker_pre_align(seq_bytes: bytes):
    from .mapper import pre_align
    seq = np.frombuffer(seq_bytes, dtype=np.uint8)
    return pre_align(_W["mi"], seq, _W["opt"])


def _make_pool(mi: Index, opt: MapOpt, n_workers: int):
    import multiprocessing as mp
    import warnings
    _W["mi"] = mi
    _W["opt"] = opt
    _W["env"] = DpEnv(opt)
    ctx = mp.get_context("fork")
    with warnings.catch_warnings():
        # fork after torch/BLAS threads exist: safe here because the map
        # workers touch only numpy + libmpnative (no locks shared with
        # those threads)
        warnings.filterwarnings("ignore", message=".*fork.*")
        return ctx.Pool(n_workers)


def _put(q, item, stop) -> None:
    """q.put(item), giving up once ``stop`` is set: a producer thread
    whose consumer has gone never blocks for ever on a full queue."""
    import queue as _q
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return
        except _q.Full:
            pass


class _Prefetcher:
    """Read batch N+1 while batch N maps (the kt_pipeline analog,
    kthread.c:97-159).  A read error (a malformed or truncated input) is
    raised by get(); close() ends the reader thread."""

    def __init__(self, reader: BatchReader, chunk_size: int):
        import queue as _q
        import threading
        self._q: "_q.Queue" = _q.Queue(maxsize=1)
        self._stop = threading.Event()

        def run():
            try:
                while not self._stop.is_set():
                    b = reader.read_batch(chunk_size)
                    _put(self._q, b, self._stop)
                    if not b:
                        return
            except Exception as e:
                _put(self._q, e, self._stop)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def get(self):
        b = self._q.get()
        if isinstance(b, Exception):
            raise b
        return b

    def close(self) -> None:
        self._stop.set()
        self._t.join()


# the measured engine choice (port of miniprot_tpu.pipeline's route
# probe), engaged only when the caller asks for it (route_probe=True):
# 0 turns it off even then.  The first mini-batch is probed when it holds
# at least ROUTE_MIN_BATCH queries, on blocks of min(ROUTE_BLOCK_MAX,
# max(ROUTE_BLOCK_MIN, len(batch) // 3)) queries per engine.
ROUTE_PROBE_N = 1
ROUTE_MIN_BATCH = 512
ROUTE_BLOCK_MIN = 64
ROUTE_BLOCK_MAX = 512
# a DECISIVE probe outcome (>= this rate ratio) is cached on disk and
# reused for this long, so repeat runs on the same machine skip the
# probe; near ties are probed again every run.
ROUTE_CACHE_MARGIN = 1.3
ROUTE_CACHE_TTL_S = 6 * 3600.0
# the probe's clock
_clock = time.monotonic


def _route_cache_path() -> str:
    return os.path.join(os.path.expanduser("~/.cache/miniprot_tpu_torch"),
                        "route.json")


def _route_cache_load():
    """The cached engine choice, or None (absent, unreadable or
    stale)."""
    import json
    try:
        with open(_route_cache_path()) as f:
            c = json.load(f)
        if time.time() - c["ts"] > ROUTE_CACHE_TTL_S:
            return None
        return c["choice"] if c["choice"] in ("device", "host") else None
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _route_cache_store(t_dev: float, t_host: float, choice: str) -> None:
    """Cache a decisive outcome (atomic replace); a near tie is not
    cached.  A cache that cannot be written only means the next run
    probes again."""
    import json
    if max(t_dev, t_host) < min(t_dev, t_host) * ROUTE_CACHE_MARGIN:
        return
    path = _route_cache_path()
    tmp = path + f".tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"ts": time.time(), "t_dev": t_dev, "t_host": t_host,
                       "choice": choice}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _route_probe(mi, opt, env, engine, part, block, pool, id_counter,
                 out):
    """Measured engine choice by a split A/B (port of
    miniprot_tpu.pipeline._route_probe): the first ``block`` queries of
    ``part`` are mapped on the device engine, the rest on the host
    engine (the pool, or map_query), each query once and emitted in
    input order (the two engines' outputs are byte-identical), and the
    faster engine keeps the rest of the run.  A device error raises.
    Returns (keep the device engine, device s, host s)."""
    dev_part, host_part = part[:block], part[block:]
    t0 = _clock()
    dev_results = map_batch_gpu(mi, opt, env, engine, dev_part, pool)
    t_dev = _clock() - t0
    for rec, seq, regs in dev_results:
        _emit_query(mi, opt, rec.name, seq, regs, id_counter, out)
    t0 = _clock()
    if pool is not None:
        host_results = pool.map(_worker_map, [r.seq for r in host_part],
                                chunksize=max(1, len(host_part) // 32))
    else:
        host_results = [map_query(mi, np.frombuffer(rec.seq, np.uint8),
                                  opt, env=env) for rec in host_part]
    t_host = _clock() - t0
    for rec, regs in zip(host_part, host_results):
        seq = np.frombuffer(rec.seq, dtype=np.uint8)
        _emit_query(mi, opt, rec.name, seq, regs, id_counter, out)
    keep = t_dev <= t_host
    sys.stderr.write(
        f"[route] A/B over {block}+{len(host_part)} queries: device "
        f"{t_dev:.2f}s vs host {t_host:.2f}s -> "
        f"{'device' if keep else 'host'} engine for this run\n")
    return keep, t_dev, t_host


def map_file(mi: Index, fn: str, opt: MapOpt, n_threads: int = 1,
             out=None, device="cuda", dbg: dict | None = None,
             ckpt: str | None = None, stats: dict | None = None,
             route_probe: bool = False) -> int:
    """Map all queries in a FASTA/FASTQ file (mp_map_file, map.c:330-343).

    device: "cuda" (the default) runs the alignment DPs on the CUDA
    kernels and raises when no sm_90 card is there; "cpu" runs the same
    engine on the kernels' plain PyTorch versions; None maps on the host
    C engine only.

    route_probe: measure the engine on ``device`` against the host
    engine on the first mini-batch (when it holds ROUTE_MIN_BATCH
    queries or more) and keep the faster for the rest of the run
    (_route_probe); a decisive outcome is cached for ROUTE_CACHE_TTL_S
    and later runs read it instead of probing.  Off by default: the
    engine on ``device`` then maps everything.

    ckpt: path of a mini-batch checkpoint journal (requires a seekable
    `out`).  Mini-batches are idempotent work units (the reference's
    kt_pipeline structure, kthread.c:97-159, has the same property);
    after each batch the journal records (batch, n_mapped, id_counter,
    byte offset).  On restart the output is truncated to the last
    complete batch and mapping resumes at the next one, producing
    byte-identical output to an uninterrupted run."""
    if route_probe and device is None:
        raise ValueError("route_probe compares a device engine with the "
                         "host engine: it needs a device")
    out = out or sys.stdout
    dbg = dbg or {}
    reader = BatchReader(fn)
    env = DpEnv(opt)
    id_counter = [0]
    done_batches = -1
    ckpt_f = None
    if ckpt is not None:
        if os.path.exists(ckpt):
            with open(ckpt) as f:
                lines = [ln for ln in f.read().splitlines()
                         if ln.count("\t") == 3]
            if lines:
                b, nm, idc, off = lines[-1].split("\t")
                done_batches, id_counter[0] = int(b), int(idc)
                out.seek(int(off))
            else:
                out.seek(0)  # crashed before the first journal entry
            out.truncate()
        ckpt_f = open(ckpt, "a")
    if opt.flag & F_GFF and done_batches < 0:
        out.write("##gff-version 3\n")
    from .sysutil import profiler
    n_mapped = 0
    engine = pool = pre = None
    # the map's span ends where the teardown's begins (the finally below)
    map_span = profiler.span("map").__enter__()
    try:
        n_workers = max(1, min(n_threads, os.cpu_count() or 1))
        if device is not None:
            from .device import GpuExtEngine
            engine = GpuExtEngine(opt, device, n_workers=n_workers)
        with profiler.span("pool_start"):
            pool = _make_pool(mi, opt, n_workers) if n_workers > 1 else None
        pre = _Prefetcher(reader, opt.mini_batch_size)
        batch_idx = -1
        while True:
            with profiler.span("map.read_wait"):
                batch = pre.get()
            if not batch:
                break
            batch_idx += 1
            if batch_idx <= done_batches:
                n_mapped += len(batch)  # already emitted by a prior run
                continue
            if (engine is not None and route_probe and ROUTE_PROBE_N > 0
                    and batch_idx == done_batches + 1
                    and len(batch) >= ROUTE_MIN_BATCH):
                choice = _route_cache_load()
                if choice is not None:
                    sys.stderr.write(f"[route] cached decision: {choice} "
                                     "engine (probed again when older than "
                                     f"{ROUTE_CACHE_TTL_S / 3600:.0f}h)\n")
                    if stats is not None:
                        stats.update(route_choice=choice, route_cached=True)
                else:
                    block = min(ROUTE_BLOCK_MAX,
                                max(ROUTE_BLOCK_MIN, len(batch) // 3))
                    part, batch = batch[:2 * block], batch[2 * block:]
                    keep, t_dev, t_host = _route_probe(
                        mi, opt, env, engine, part, block, pool,
                        id_counter, out)
                    choice = "device" if keep else "host"
                    _route_cache_store(t_dev, t_host, choice)
                    if stats is not None:
                        stats.update(route_choice=choice, route_cached=False,
                                     route_probe_device_s=t_dev,
                                     route_probe_host_s=t_host)
                    n_mapped += len(part)
                if choice == "host":
                    _engine_stats(engine, stats)
                    engine.close()
                    engine = None
            if engine is not None:
                _map_batch_gpu(mi, opt, env, engine, batch, id_counter, out, pool)
            elif pool is not None:
                results = pool.map(_worker_map, [r.seq for r in batch],
                                   chunksize=max(1, len(batch) // (n_workers * 8)))
                for rec, regs in zip(batch, results):
                    seq = np.frombuffer(rec.seq, dtype=np.uint8)
                    _emit_query(mi, opt, rec.name, seq, regs, id_counter, out)
            else:
                for rec in batch:
                    if dbg.get("qname"):
                        sys.stderr.write(f"QR\t{rec.name}\t{len(rec.seq)}\t0\n")
                    seq = np.frombuffer(rec.seq, dtype=np.uint8)
                    regs = map_query(mi, seq, opt, env=env, dbg=dbg)
                    _emit_query(mi, opt, rec.name, seq, regs, id_counter, out)
            n_mapped += len(batch)
            if ckpt_f is not None:
                out.flush()
                ckpt_f.write(f"{batch_idx}\t{n_mapped}\t{id_counter[0]}\t"
                             f"{out.tell()}\n")
                ckpt_f.flush()
            from . import sysutil
            sysutil.log("map_file", "mapped %d sequences", len(batch))
    finally:
        if pre is not None:
            pre.close()
        map_span.__exit__(None, None, None)
        with profiler.span("map.teardown"):
            if engine is not None:
                try:
                    _engine_stats(engine, stats)
                finally:
                    engine.close()
            if ckpt_f is not None:
                ckpt_f.close()
            if pool is not None:
                pool.terminate()
                pool.join()
    return n_mapped


def _engine_stats(engine, stats) -> None:
    """Log the device engine's DP split and put its counters in
    ``stats``: ``daemon`` says whether the engine shipped its batches to
    a device daemon, and then the daemon's side (engine.daemon_stats:
    batches and kernel launches for this engine, peak planes and cap).
    ``launched``: the problems the engine launched per DP recurrence
    (sysutil.LAUNCHED_FIELDS); ``host_dp_s_by_reason``: the host
    seconds of each ``host_reasons`` reason's DPs (summed over the
    threads that ran them); ``host_cells_by_reason``: their cells, sum
    of nl * al, per reason; ``host_offthread``: the host-routed DPs that
    ran on the engine's worker threads; ``host_join_s``: the seconds
    flush_end waited for them; ``dp_regions``: the regions whose DP
    steps map_batch_gpu ran through the engine."""
    from . import sysutil
    from .sysutil import profiler
    sysutil.log(
        "map_file",
        "DP split: %d device / %d host calls; %.1f%% of cells on "
        "device (%s)", engine.n_device, engine.n_host,
        100.0 * profiler.device_fraction(), engine.device)
    if stats is not None:
        stats.update(n_device=engine.n_device, n_host=engine.n_host,
                     device_fraction=profiler.device_fraction(),
                     batches=dict(engine.batches),
                     bucket_batches=dict(engine.bucket_batches),
                     bucket_problems={
                         k: tuple(v) for k, v
                         in engine.bucket_problems.items()},
                     host_reasons=dict(engine.host_reasons),
                     host_dp_s=engine.host_dp_s,
                     host_dp_s_by_reason=dict(engine.host_dp_s_by_reason),
                     host_cells_by_reason=dict(engine.host_cells),
                     dp_regions=engine.dp_regions,
                     host_offthread=engine.host_offthread,
                     host_join_s=engine.host_join_s,
                     launched={k: dict(zip(sysutil.LAUNCHED_FIELDS, v))
                               for k, v in engine.launched.items()},
                     launch_s=engine.launch_s,
                     decode_s=engine.decode_s,
                     peak_pending_tb=engine.peak_pending_tb,
                     daemon=engine.client is not None,
                     **engine.daemon_stats())


# pre_align streaming (port of miniprot_tpu.pipeline's constants of the
# same names): queries per chunk that the producer hands the align pump
# (0 = the whole mini-batch in one chunk), and the number of active
# generators the pump bundles before a flush round while chunks are
# still coming (smaller early rounds would fragment the batches).
# PRE_CHUNK is chosen from paired runs on the card (PERF.md section 5):
# 256 read faster than 0 on every map.
PRE_CHUNK = 256
MIN_ACTIVE_GENS = 512
# queued chunks the producer may run ahead of the pump
_READY_CHUNKS = 4


def map_batch_gpu(mi: Index, opt: MapOpt, env: DpEnv, engine, batch,
                  pool=None) -> list:
    """Map one mini-batch with device-batched alignment DPs; returns
    [(rec, seq, final_regs), ...] in batch order (port of
    miniprot_tpu.pipeline.map_batch_tpu).

    Seed/chain/refine (pre_align) run on a producer thread, in chunks of
    PRE_CHUNK queries (on the pool when there is one), while the align
    pump runs flush rounds for the chunks already produced: each
    region's align_region_steps generator starts as its chunk arrives,
    and every round advances all active generators through the engine.
    A generator's results do not depend on which round it joins (the
    per-problem DP is exact whatever the batch), and chunks arrive in
    input order from the one producer, so the output is byte-identical
    to the host engine's at every chunking.  A producer error is raised
    here."""
    import copy
    import queue as _q
    import threading

    from .align import align_region_steps
    from .mapper import finish_align, pre_align, trim_scratch
    from .sysutil import profiler

    ready: _q.Queue = _q.Queue(maxsize=_READY_CHUNKS)
    chunk = PRE_CHUNK if PRE_CHUNK > 0 else max(1, len(batch))
    # pre_align sets and restores a flag of the options it is given: the
    # in-process producer works on its own copy of them
    pre_opt = copy.copy(opt)

    # set when the pump stops early (an error): the producer ends after
    # its current chunk, never blocked on a full queue
    stop = threading.Event()

    def producer() -> None:
        try:
            for c0 in range(0, len(batch), chunk):
                if stop.is_set():
                    return
                ch = batch[c0:c0 + chunk]
                with profiler.span("pre_align"):
                    if pool is not None:
                        pre = pool.map(_worker_pre_align,
                                       [r.seq for r in ch],
                                       chunksize=max(1, len(ch) // 32))
                    else:
                        pre = [pre_align(mi, np.frombuffer(r.seq, np.uint8),
                                         pre_opt) for r in ch]
                _put(ready, (ch, pre), stop)
            _put(ready, None, stop)
        except BaseException as e:   # raised in the pump, never hangs it
            _put(ready, ("error", e), stop)

    per_query: list = []
    gens: list = []
    active: dict[int, list] = {}
    # seconds the pump sat blocked on the queue (while the profiler is
    # on: align_rounds is the pump's wall less them)
    waited = [0.0]

    def prime(ch, pre, into: dict) -> None:
        for rec, (regs, ext) in zip(ch, pre):
            seq = np.frombuffer(rec.seq, dtype=np.uint8)
            per_query.append((rec, seq, regs))
            for r, (el, er) in zip(regs, ext):
                g = align_region_steps(env, opt, mi, len(seq), seq, r,
                                       el, er)
                gens.append(g)
                try:
                    into[len(gens) - 1] = next(g)
                except StopIteration:
                    pass

    def absorb(into: dict, floor: int) -> bool:
        """Start the generators of every chunk produced so far, waiting
        for more while ``into`` holds fewer than ``floor``; False once
        the producer is done."""
        while True:
            if len(into) >= floor and ready.empty():
                return True
            # the pump is the queue's one reader: a get after a non-empty
            # look returns at once
            wait = profiler.span("pre_align_wait")
            with wait:
                item = ready.get()
            waited[0] += wait.dt
            if item is None:
                return False
            if item[0] == "error":
                raise item[1]
            with profiler.span("pump.prime"):
                prime(*item, into)

    thread = threading.Thread(target=producer, daemon=True,
                              name="pre-align-producer")
    t_pump = time.monotonic()
    thread.start()
    producing = True
    try:
        while True:
            # absorb chunks: wait while under the bundling floor, take
            # what is there otherwise
            if producing:
                producing = absorb(active, max(1, MIN_ACTIVE_GENS))
            if not active:
                if producing:
                    continue
                break
            with profiler.span("pump.submit"):
                handles = {gi: [engine.submit(req) for req in reqs]
                           for gi, reqs in active.items()}
            fl = engine.flush_begin()
            # chunks that arrived meanwhile start while the card works;
            # their generators join the next round
            fresh: dict[int, list] = {}
            if producing:
                producing = absorb(fresh, 0)
            results = engine.flush_end(fl)
            nxt: dict[int, list] = {}
            with profiler.span("pump.advance"):
                for gi, hs in handles.items():
                    try:
                        nxt[gi] = gens[gi].send([results[h] for h in hs])
                    except StopIteration:
                        pass
            nxt.update(fresh)
            active = nxt
    finally:
        # no producer outlives its batch
        stop.set()
        thread.join()
    profiler.add_stage("align_rounds",
                       time.monotonic() - t_pump - waited[0])
    engine.dp_regions += len(gens)
    # release the large scratch slots of the pump's host DPs, as
    # map_query does after each of its queries, and the engine's workers'
    trim_scratch()
    engine.trim_scratch()
    with profiler.span("finish_align"):
        done = [(rec, seq, finish_align(mi, opt, regs))
                for rec, seq, regs in per_query]
    return done


def _map_batch_gpu(mi: Index, opt: MapOpt, env: DpEnv, engine, batch,
                   id_counter, out, pool=None) -> None:
    from .sysutil import profiler
    done = map_batch_gpu(mi, opt, env, engine, batch, pool)
    with profiler.span("emit"):
        for rec, seq, regs in done:
            _emit_query(mi, opt, rec.name, seq, regs, id_counter, out)
