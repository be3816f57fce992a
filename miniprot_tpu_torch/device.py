"""GPU execution engine for batched alignment DPs.

Collects DP requests from align_region_steps generators across many
regions and queries and dispatches them in shape-bucketed batches:

  "ext"    score-only extension DPs  -> kernels/nasw_ext (K1)
  "cigars" anchored gap-filling DPs  -> kernels/nasw_cigar_scan (K2 + K3)
           at go >= 1, else (or with cig_impl="striped", the
           MINIPROT_TPU_CIG_IMPL switch) kernels/nasw_cigar_striped
           (K4 + K5)

Launches are asynchronous on the card's current stream.  flush_begin
launches every batch of a round, queues the copies of all their results
to pinned host memory behind the kernels (the collect wave, one event
per batch), and then starts the host engine's share of the round (jobs
routed to the host by design) while the card works and the results
travel; flush_end waits once, on the wave's last event, and decodes.
With one thread (n_workers 1) the host share runs in flush_begin on the
calling thread.  With more, it runs on the engine's n_workers - 1
worker threads, one native call each that holds no interpreter lock
(native.DpJobs, Dp16Ctx.dp_many), longest jobs first, and flush_end
joins it after the card's wave.

Host routing (part of the algorithm, identical results, counted in
n_host and, per reason, in host_reasons): ext jobs outside
ext_fits_int16, longer than the largest bucket or shorter than
MIN_DEVICE_NL; CIGAR jobs shorter than CIG_MIN_NL or wider than the
largest class, --spsc CIGAR jobs whose folded donor goes negative, and
scan walks that hit the round cap.

Daemon clients: when a device daemon (daemon.py) answers, the engine
builds its batches as always and ships them there (daemon.attach says
when): each flush's batches go in one launch_many RPC, each collect wave
(and each planes-cap drain) is one collect RPC, the daemon decodes, and
the engine takes the card's identity and plane budget from the daemon's
ping, so the process never creates a CUDA context.

There is no hidden fallback: a build failure, a launch error, a device
fault or a daemon error raises out of the engine.

CIGAR memory policy: a batch allocates its traceback planes at launch
(tb_bytes(): tb + hint for the scan kernel, tb alone for the striped
one, int16 each); the per-batch cap and the cap on
launched-but-uncollected planes are fractions of the card's own memory
(on a daemon client, the daemon's figures for the card it owns), and a
batch is launched only after older batches are collected down to that
cap.
"""

from __future__ import annotations

import heapq
import os as _os
import queue as _queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .align import DpEnv
from .kernels import resolve_device, to_host
from .kernels import nasw_cigar_scan as csk
from .kernels import nasw_cigar_striped as cst
from .kernels import nasw_ext as nk
from . import native
from .native import DPF_CIGAR, DPF_EXT_LEFT, DPF_EXT_RIGHT
from .options import MapOpt
from .sysutil import profiler

AL_BUCKETS = (128, 512, 1024)
# the top bucket covers the default max_intron/2 = 100kb extension
# window (map.c:226) entirely on the device
NL_BUCKETS = (2112, 4224, 8448, 16896, 33792, 67584, 101376)
MIN_DEVICE_NL = 1024     # smaller windows are cheaper on the host
CIG_SLEN_CLASSES = (4, 16, 64)          # al <= 32 / 128 / 512
CIG_NL_BUCKETS = (2048, 4096, 8192, 16384, 32768, 65536)
CIG_MIN_NL = 512
# fractions of the card's memory: one CIGAR batch's planes, and all
# launched-but-uncollected planes together
CIG_TB_FRACTION = 0.25
PENDING_TB_FRACTION = 0.30
# ext batches hold about this many (problem x row) track cells, so
# windows up to the 33.8 kb bucket go in 1024-problem launches and the
# 67.6 and 101.4 kb buckets in 512-problem ones (K1 at al=128 and nl
# 67584 takes ~7x less device time per problem in a launch of 1024 than
# in one of 128: PERF.md)
EXT_BATCH_CELLS = 1 << 26
# CIGAR batches hold about this many (problem x row x position) DP cells
# (1 GiB of tb + hint planes on the scan kernel, 512 MiB of tb on the
# striped one), so short windows of the narrow classes go in launches of
# up to 1024 (4096 at W = 32) problems
CIG_BATCH_CELLS = 1 << 28


def ext_fits_int16(al: int, mat_max: int, end_bonus: int) -> bool:
    """True when the int32 ext kernel is provably bit-equivalent to the
    reference's saturating-int16 arithmetic (nasw-sse.c:342-402) for an
    extension problem with query length ``al``: every true prefix score
    is <= al*max(mat), the tracked candidate adds end_bonus once, and
    the floor clip never binds the outputs (proof in
    miniprot_tpu/device.py:ext_fits_int16)."""
    return al * max(mat_max, 0) + max(end_bonus, 0) <= 32767


def ext_capacity(nl_b: int) -> int:
    """Problems per ext batch for an nl bucket (a power of two in
    [128, 1024])."""
    cap = 1024
    while cap > nk.B_LANES and cap * nl_b > EXT_BATCH_CELLS:
        cap >>= 1
    return cap


def cig_capacity(cls, nl_b: int, W: int, tb_cap: int) -> int:
    """Problems per CIGAR batch of class ``cls`` (scan or striped) at
    class width W and nl bucket nl_b: the largest power of two from the
    class's own CAPACITY (128, or 512 for the al <= 32 class) up whose
    cells stay within CIG_BATCH_CELLS and whose planes (the class's own
    planes_bytes) fit ``tb_cap``."""
    cap = cls.CAPACITY
    rows = csk._pad_rows(nl_b)
    while (2 * cap * rows * W <= CIG_BATCH_CELLS
           and cls.planes_bytes(nl_b, W, 2 * cap) <= tb_cap):
        cap *= 2
    return cap


def _memory_bytes(dev: torch.device) -> int:
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(_os.sysconf("SC_PAGE_SIZE") * _os.sysconf("SC_PHYS_PAGES"))


@dataclass
class _ExtJob:
    nsq: np.ndarray
    asq: np.ndarray
    ss: np.ndarray | None
    io: int
    ext_left: bool
    result: tuple | None = None


@dataclass
class _CigJob:
    nsq: np.ndarray
    asq: np.ndarray
    ss: np.ndarray | None
    result: tuple | None = None


class _Remote:
    """The handles of a batch launched through the daemon: its id once a
    launch_many has carried it, its decoded results once collected."""

    __slots__ = ("bid", "results")

    def __init__(self):
        self.bid = self.results = None


class GpuExtEngine:
    """Batches alignment DPs onto the CUDA kernels (or, for
    device="cpu", onto their plain PyTorch versions), in this process or
    through the device daemon at ``daemon`` (a socket path; see
    daemon.attach for when the engine attaches without one)."""

    def __init__(self, opt: MapOpt, device="cuda", cig_impl=None,
                 daemon: str | None = None, n_workers: int = 1):
        from . import daemon as _daemon
        self.opt = opt
        # the map's thread count: n_workers - 1 threads run the host
        # share (started on first use, joined in close)
        self.n_workers = max(1, int(n_workers))
        self._workers: _HostWorkers | None = None
        self.client = _daemon.attach(device, daemon)
        self._unsent: list = []      # (batch, _Remote) not yet shipped
        # the CIGAR kernel: "scan" (go >= 1 only) or "striped"; the
        # same output either way, so the switch is for coverage and
        # parity, not tuning (the JAX engine reads the same variable)
        self.cig_impl = cig_impl or _os.environ.get("MINIPROT_TPU_CIG_IMPL",
                                                    "scan")
        if self.cig_impl not in ("scan", "striped"):
            raise ValueError(f"cig_impl {self.cig_impl!r}: 'scan' or "
                             "'striped'")
        self.env = DpEnv(opt)  # host engine + sp/io defaults
        self.sp = self.env.sp
        self.scalars = (opt.go, opt.ge, opt.fs, opt.io, opt.xdrop,
                        opt.end_bonus, opt.ie_coef)
        self.mat = opt.mat
        self.mat_max = int(np.max(opt.mat))
        if self.client is not None:
            info = self.client.info
            self.device = torch.device(info["device_type"])
            self.cig_tb_cap = info["batch_cap"]
            self.pending_tb_cap = info["pending_cap"]
            self._daemon_start = info
        else:
            self.device = resolve_device(device)
            mem = _memory_bytes(self.device)
            self.cig_tb_cap = int(mem * CIG_TB_FRACTION)
            self.pending_tb_cap = int(mem * PENDING_TB_FRACTION)
        self.peak_pending_tb = 0     # most tb+hint bytes ever in flight
        self.ext_jobs: list[_ExtJob] = []
        self.cig_jobs: list[_CigJob] = []
        self.requests: list[tuple] = []   # ("ext", idx) | ("cigars", [idx...])
        self.n_device = 0
        self.n_host = 0
        self.batches = {"ext": 0, "cig": 0, "cig_small": 0,
                        "cig_striped": 0, "cig_small_striped": 0}
        # launches per (kind, width, nl bucket), and the problems those
        # launches held: [sum, max]
        self.bucket_batches: dict[tuple, int] = {}
        self.bucket_problems: dict[tuple, list] = {}
        # host-routed DPs per reason; the host seconds of each reason's
        # DPs, and those of flush_begin's share (every reason but the
        # round-cap redos, which run in collects), summed over the
        # threads that ran them
        self.host_reasons: dict[str, int] = {}
        self.host_dp_s_by_reason: dict[str, float] = {}
        # the host-routed DPs' cells, sum(nl * al), per reason (as
        # profiler.host_cells counts them)
        self.host_cells: dict[str, int] = {}
        self.host_dp_s = 0.0
        # host-routed DPs that ran on a worker thread, and the seconds
        # flush_end waited for the workers
        self.host_offthread = 0
        self.host_join_s = 0.0
        # the launched problems per DP recurrence, as
        # profiler.launched counts them: [problems, sum(nl * al),
        # sum(nl + al), padded cells]
        self.launched: dict[str, list] = {}
        # the regions whose DP-step generators map_batch_gpu drove
        # through this engine
        self.dp_regions = 0
        # host seconds spent inside the batches' launch() calls (upload,
        # prep and kernel launches, and any wait for the card there), and
        # decoding collected results (the CIGARs' run expansion)
        self.launch_s = 0.0
        self.decode_s = 0.0
        # on a daemon client: the seconds the daemon waited on this
        # engine's batches inside its collects (the rest of a collect
        # RPC's wall is decode and transfer)
        self.daemon_wait_s = 0.0

    # ---- request intake ----

    def submit(self, req) -> int:
        if req[0] == "ext":
            _, nsq, asq, ss, io, ext_left = req
            self.ext_jobs.append(_ExtJob(nsq, asq, ss, io, ext_left))
            self.requests.append(("ext", len(self.ext_jobs) - 1))
        else:
            idxs = []
            for nsq, asq, ss in req[1]:
                self.cig_jobs.append(_CigJob(nsq, asq, ss))
                idxs.append(len(self.cig_jobs) - 1)
            self.requests.append(("cigars", idxs))
        return len(self.requests) - 1

    # ---- batching ----

    def _route_host(self, reason: str) -> None:
        self.host_reasons[reason] = self.host_reasons.get(reason, 0) + 1

    def _run_host(self, reason: str, fn, jobs, idxs) -> float:
        """fn(jobs, idxs), the host DPs of jobs ``idxs``, routed for
        ``reason``: their cells are counted, their seconds go to
        host_dp_s_by_reason and are returned."""
        nl = np.array([len(jobs[i].nsq) for i in idxs], np.int64)
        al = np.array([len(jobs[i].asq) for i in idxs], np.int64)
        profiler.add_host_cells(reason, int(np.dot(nl, al)), len(idxs),
                                into=self.host_cells)
        t0 = time.monotonic()
        with profiler.span("engine.host_dp." + reason):
            fn(jobs, idxs)
        dt = time.monotonic() - t0
        self.host_dp_s_by_reason[reason] = (
            self.host_dp_s_by_reason.get(reason, 0.0) + dt)
        return dt

    def _count_launch(self, key: tuple, n: int) -> None:
        self.bucket_batches[key] = self.bucket_batches.get(key, 0) + 1
        tot = self.bucket_problems.setdefault(key, [0, 0])
        tot[0] += n
        tot[1] = max(tot[1], n)

    def _launch(self, batch):
        """batch.launch(), its host seconds added to launch_s; on a
        daemon client the batch waits for the next _send and a _Remote
        stands for its handles."""
        if self.client is not None:
            r = _Remote()
            self._unsent.append((batch, r))
            return r
        t0 = time.monotonic()
        try:
            with profiler.span("engine.launch"):
                return batch.launch()
        finally:
            self.launch_s += time.monotonic() - t0

    def _send(self) -> None:
        """One launch_many RPC for the batches _launch queued since the
        last; its seconds are added to launch_s."""
        unsent, self._unsent = self._unsent, []
        if not unsent:
            return
        t0 = time.monotonic()
        try:
            with profiler.span("engine.launch"):
                bids = self.client.launch_many([b for b, _ in unsent])
        finally:
            self.launch_s += time.monotonic() - t0
        for (_, r), bid in zip(unsent, bids):
            r.bid = bid

    def _fetch(self, remotes: list) -> None:
        """One collect RPC for launched batches' _Remotes (sending any
        still queued first): their results, decoded by the daemon, land
        in each."""
        self._send()
        results, _, wait_s = self.client.collect([r.bid for r in remotes])
        self.daemon_wait_s += wait_s
        for r, res in zip(remotes, results):
            r.results = res

    def _wait_one(self, handles):
        """A blocking collect of one launched batch outside the wave:
        what _collect decodes."""
        if isinstance(handles, _Remote):
            self._fetch([handles])
            return handles
        host = to_host(handles)
        host.wait()
        return host

    def daemon_stats(self) -> dict:
        """The daemon's side of this engine's work, from a ping: batches
        it launched and kernel launches since the engine attached, the
        seconds it waited on them in collects, its peak planes in flight
        (over its life) and its cap; {} for an engine that launches its
        own batches."""
        if self.client is None:
            return {}
        now, then = self.client.ping(), self._daemon_start
        return {"daemon_batches": now["launched"] - then["launched"],
                "daemon_launches": {k: v - then["launches"].get(k, 0)
                                    for k, v in now["launches"].items()},
                "daemon_wait_s": self.daemon_wait_s,
                "daemon_peak_pending_tb": now["peak_tb"],
                "daemon_pending_cap": now["pending_cap"]}

    def close(self) -> None:
        """Join the worker threads and close the daemon connection."""
        try:
            if self._workers is not None:
                self._workers, workers = None, self._workers
                workers.close()
        finally:
            if self.client is not None:
                self.client.close()

    def trim_scratch(self) -> None:
        """Have each worker thread release its native scratch slots above
        mapper.SCRATCH_TRIM_BYTES, as the pump's thread does after each
        mini-batch (queued behind any share it is running)."""
        if self._workers is not None:
            from .mapper import trim_scratch
            self._workers.each(trim_scratch)

    def _prep(self, job, ext_left, io):
        return nk.prep_problem(job.nsq, job.asq, sp=self.sp,
                               sp_null_bonus=self.opt.sp_null_bonus, io=io,
                               ext_left=ext_left, ss=job.ss)

    def _launch_ext(self, ext_jobs) -> tuple:
        """Bucket + launch the ext batches; returns (pending, host_jobs),
        host_jobs {reason: [job index, ...]}.  Jobs without an external
        splice track ship raw nt4 windows (device prep); --spsc jobs
        keep host prep."""
        buckets: dict[tuple, list[int]] = {}
        host_jobs: dict[str, list[int]] = {}
        for i, job in enumerate(ext_jobs):
            nl, al = len(job.nsq), len(job.asq)
            reason = ("ext_short" if nl < MIN_DEVICE_NL
                      else "ext_outside_buckets" if (al > AL_BUCKETS[-1]
                                                     or nl > NL_BUCKETS[-1])
                      else "ext_not_int16" if not ext_fits_int16(
                          al, self.mat_max, self.opt.end_bonus)
                      # threshold-table growth
                      else "ext_logpen" if self.opt.ie_coef > 8.0 else None)
            if reason is None:
                al_b = next(b for b in AL_BUCKETS if al <= b)
                nl_b = next(b for b in NL_BUCKETS if nl <= b)
                if job.ss is not None and int(
                        self.opt.ie_coef * np.log2(nl_b) + 0.5) > 126:
                    # host-prepped (--spsc) batches stream the log-length
                    # penalty as int8 (126: one count of margin for
                    # mp_log2_f32-vs-log2 drift)
                    reason = "ext_logpen"
            if reason is not None:
                self._route_host(reason)
                host_jobs.setdefault(reason, []).append(i)
                continue
            buckets.setdefault((al_b, nl_b), []).append(i)
        from . import tables
        T = tables.get_tables()
        pending: list = []
        for (al_b, nl_b), idxs in buckets.items():
            cap = ext_capacity(nl_b)
            raw_all = [i for i in idxs if ext_jobs[i].ss is None]
            old_all = [i for i in idxs if ext_jobs[i].ss is not None]
            for c0 in range(0, len(raw_all), cap):
                chunk = raw_all[c0:c0 + cap]
                batch = nk.RawExtBatch(
                    al_b, nl_b, self.mat, self.scalars, sp=self.sp,
                    trans_code=tables._default_code, device=self.device,
                    capacity=len(chunk))
                for i in chunk:
                    job = ext_jobs[i]
                    nt4 = T.nt4[job.nsq]
                    aas = T.aa20[job.asq]
                    if job.ext_left:
                        nt4 = nt4[::-1]
                        aas = aas[::-1]
                    batch.add_raw(nt4, aas, io=job.io, ext_left=job.ext_left)
                pending.append((chunk, batch, self._launch(batch)))
            for c0 in range(0, len(old_all), nk.B_LANES):
                chunk = old_all[c0:c0 + nk.B_LANES]
                batch = nk.ExtBatch(al_b, nl_b, self.mat, self.scalars,
                                    device=self.device, capacity=len(chunk))
                for i in chunk:
                    job = ext_jobs[i]
                    nas, aas, d, a = self._prep(job, job.ext_left, job.io)
                    batch.add(nas, aas, d, a, io=job.io)
                pending.append((chunk, batch, self._launch(batch)))
        for chunk, batch, _ in pending:
            self.n_device += len(chunk)
            self.batches["ext"] += 1
            self._count_launch(("ext", batch.al, batch.nl), batch.n)
            profiler.add_device_dp("ext", batch.nlv[:batch.n],
                                   batch.als[:batch.n],
                                   batch.nl * batch.al * batch.n,
                                   into=self.launched)
        return pending, host_jobs

    def _ext_host(self, ext_jobs, i) -> None:
        job = ext_jobs[i]
        sc, ntl, aal, _ = self.env.dp(
            job.nsq, job.asq,
            DPF_EXT_LEFT if job.ext_left else DPF_EXT_RIGHT,
            ss=job.ss, io=job.io)
        job.result = (sc, ntl, aal)
        self.n_host += 1

    def _collect(self, batch, host, span="engine.decode"):
        """batch.collect of a prefetched copy, its seconds in decode_s
        (a daemon's results come decoded) and in the profiler's ``span``
        (a drain's decodes have one of their own, inside the drain)."""
        if isinstance(host, _Remote):
            return host.results
        t0 = time.monotonic()
        try:
            with profiler.span(span):
                return batch.collect(host)
        finally:
            self.decode_s += time.monotonic() - t0

    def _cig_classes(self, W: int):
        """(raw class, host-prepped class) for CIGAR jobs of class width
        W: the scan kernel when go >= 1 and cig_impl is "scan", else the
        striped kernel.  go == 0 must take the striped kernel: the
        scan/striped equivalence proof needs go >= 1 (the reference's
        lazy-F break truncates at exact ties)."""
        if self.cig_impl == "scan" and self.scalars[0] >= 1:
            return (csk.SmallScanCigarBatch if W <= csk.SMALL_W
                    else csk.RawScanCigarBatch), csk.ScanCigarBatch
        return (cst.SmallCigarBatch if W <= csk.SMALL_W
                else cst.RawCigarBatch), cst.CigarBatch

    def cig_shape(self, nl: int, al: int):
        """(slen_class, nl_bucket) for a CIGAR job, or None when the job
        runs on the host.  A bucket is usable when a full batch's
        traceback planes (the batch class's own tb_bytes) fit the
        per-batch cap."""
        if nl < CIG_MIN_NL or al < 1:
            return None
        slen_p = (al + 7) // 8
        sc = next((s for s in CIG_SLEN_CLASSES if slen_p <= s), None)
        if sc is None:
            return None
        W = sc * 8
        cls = self._cig_classes(W)[0]
        for b in CIG_NL_BUCKETS:
            if nl <= b and cls.planes_bytes(b, W) <= self.cig_tb_cap:
                return sc, b
        return None

    def _cig_hosts(self, cig_jobs, idxs) -> None:
        """The CIGAR jobs ``idxs`` on the host engine: one batched native
        call instead of one per tiny rectangle."""
        res = self.env.dp_cigars([(cig_jobs[i].nsq, cig_jobs[i].asq,
                                   cig_jobs[i].ss) for i in idxs])
        for i, r in zip(idxs, res):
            cig_jobs[i].result = r
            self.n_host += 1

    def _ext_hosts(self, ext_jobs, idxs) -> None:
        for i in idxs:
            self._ext_host(ext_jobs, i)

    def _decode_cig_one(self, cig_jobs, idxs, batch, host,
                        span="engine.decode") -> None:
        results = self._collect(batch, host, span)
        for j, (k, r) in enumerate(zip(idxs, results)):
            if r is None:
                # the run-walk hit its round cap for this problem (an
                # adversarially fragmented path): redo it on the host
                profiler.add_device_dp("cigar", batch.nlv[j:j + 1],
                                       batch.alv[j:j + 1],
                                       batch.nl * batch.al,
                                       into=self.launched, sign=-1)
                self.n_device -= 1
                self._route_host("walk_round_cap")
                self._run_host("walk_round_cap", self._cig_hosts, cig_jobs,
                               [k])
            else:
                cig_jobs[k].result = r

    def _launch_cig(self, cig_jobs) -> tuple:
        """Bucket + launch the CIGAR batches; returns (pending,
        host_jobs), host_jobs {reason: [job index, ...]}.  Before each
        launch, the oldest launched batches are collected until the new
        batch's planes fit under pending_tb_cap."""
        host_jobs: dict[str, list[int]] = {}
        buckets: dict[tuple, list[int]] = {}
        for i, job in enumerate(cig_jobs):
            shape = self.cig_shape(len(job.nsq), len(job.asq))
            if shape is None:
                reason = ("cig_short" if len(job.nsq) < CIG_MIN_NL
                          else "cig_outside_classes")
                self._route_host(reason)
                host_jobs.setdefault(reason, []).append(i)
                continue
            buckets.setdefault(shape, []).append(i)
        from . import tables
        T = tables.get_tables()
        pending: list = []
        outstanding = [0]

        def launch(idxs, batch):
            need = batch.tb_bytes()
            while pending and outstanding[0] + need > self.pending_tb_cap:
                # a blocking collect outside the wave
                with profiler.span("engine.drain"):
                    o_idxs, o_batch, o_handles = pending.pop(0)
                    t0 = time.monotonic()
                    host = self._wait_one(o_handles)
                    profiler.add_device_block(time.monotonic() - t0)
                    self._decode_cig_one(cig_jobs, o_idxs, o_batch, host,
                                         "engine.drain.decode")
                outstanding[0] -= o_batch.tb_bytes()
            pending.append((idxs, batch, self._launch(batch)))
            outstanding[0] += need
            self.peak_pending_tb = max(self.peak_pending_tb, outstanding[0])
            kind = _cig_kind(batch)
            self.batches[kind] += 1
            self._count_launch((kind, batch.al, batch.nl), batch.n)
            self.n_device += len(idxs)
            profiler.add_device_dp("cigar", batch.nlv[:batch.n],
                                   batch.alv[:batch.n],
                                   batch.nl * batch.al * batch.n,
                                   into=self.launched)

        for (slen, nl_b), idxs in buckets.items():
            W = slen * 8
            raw_cls, prep_cls = self._cig_classes(W)
            # batches grow as the window shrinks, so short windows fill
            # the card with problems (K2's and K4's warp per problem)
            cap = cig_capacity(raw_cls, nl_b, W, self.cig_tb_cap)
            prep_cap = cig_capacity(prep_cls, nl_b, W, self.cig_tb_cap)
            raw_all = [i for i in idxs if cig_jobs[i].ss is None]
            old_all = [i for i in idxs if cig_jobs[i].ss is not None]
            for c0 in range(0, len(raw_all), cap):
                raw_idx = raw_all[c0:c0 + cap]
                # no --spsc track: donor >= 0 by construction, so the
                # folded donor stream cannot go negative
                batch = raw_cls(W, nl_b, self.mat, self.scalars,
                                sp=self.sp, trans_code=tables._default_code,
                                device=self.device, capacity=cap)
                for i in raw_idx:
                    job = cig_jobs[i]
                    batch.add_raw(T.nt4[job.nsq], T.aa20[job.asq],
                                  io=self.opt.io)
                launch(raw_idx, batch)
            for c0 in range(0, len(old_all), prep_cap):
                old_idx = old_all[c0:c0 + prep_cap]
                usable = []
                batch = prep_cls(W, nl_b, self.mat, self.scalars,
                                 device=self.device, capacity=prep_cap)
                for i in old_idx:
                    job = cig_jobs[i]
                    nas, aas, d, a = self._prep(job, False, self.opt.io)
                    if int(d.min()) + self.opt.io < 0:
                        # folded donor stream would go negative: the
                        # single-saturation fold no longer matches the
                        # reference's double-saturating subs; host it
                        self._route_host("cig_spsc_donor")
                        self.host_dp_s += self._run_host(
                            "cig_spsc_donor", self._cig_hosts, cig_jobs, [i])
                        continue
                    batch.add(nas, aas, d, a, io=self.opt.io)
                    usable.append(i)
                if usable:
                    launch(usable, batch)
        return pending, host_jobs

    def flush_begin(self) -> "_Flight":
        """Launch every batch of the current request set, start the
        collect wave (every batch's results queued for host memory), then
        run the host engine's share while the card works, one reason at
        a time.  Returns the in-flight state; call flush_end(flight)
        exactly once for the results."""
        fl = _Flight(self.device,
                     self._fetch if self.client is not None else None)
        profiler.flush_rounds += 1
        fl.requests, self.requests = self.requests, []
        fl.ext_jobs, self.ext_jobs = self.ext_jobs, []
        fl.cig_jobs, self.cig_jobs = self.cig_jobs, []
        with profiler.span("engine.pack"):
            ext_pending, ext_host = self._launch_ext(fl.ext_jobs)
            cig_pending, cig_host = self._launch_cig(fl.cig_jobs)
        if self.client is not None:
            self._send()
        fl.begin_wave(ext_pending, cig_pending)
        if self.n_workers > 1:
            if ext_host or cig_host:
                with profiler.span("engine.host_pack"):
                    fl.host = self._start_host_share(fl, ext_host, cig_host)
            return fl
        for reason, idxs in ext_host.items():
            self.host_dp_s += self._run_host(reason, self._ext_hosts,
                                             fl.ext_jobs, idxs)
        for reason, idxs in cig_host.items():
            self.host_dp_s += self._run_host(reason, self._cig_hosts,
                                             fl.cig_jobs, idxs)
        return fl

    def _start_host_share(self, fl, ext_host, cig_host) -> "_HostShare":
        """Pack the round's host-routed jobs once and hand them to the
        worker threads, a slice and one native call each."""
        if self._workers is None:
            self._workers = _HostWorkers(self.n_workers - 1)
        share = _HostShare(fl, ext_host, cig_host, self.opt.io)
        jobs = share.jobs
        cells = jobs.nl.astype(np.int64) * jobs.al
        # each reason's jobs are contiguous in the share
        firsts = np.searchsorted(share.reason_of,
                                 np.arange(len(share.reasons)))
        for reason, c, n in zip(share.reasons,
                                np.add.reduceat(cells, firsts).tolist(),
                                np.diff(firsts, append=jobs.n).tolist()):
            profiler.add_host_cells(reason, c, n, into=self.host_cells)
        self.n_host += jobs.n
        self.host_offthread += jobs.n
        use_x4 = native._x4_pays(self.env.ctx)
        share.tasks = [
            self._workers.put(w, _HostTask(self.env.ctx.dp_many, jobs,
                                           use_x4, sel))
            for w, sel in enumerate(_longest_first(cells,
                                                   self.n_workers - 1))]
        return share

    def _join_host_share(self, fl) -> None:
        """Wait for the flight's host share (a worker's error raises),
        count its seconds and put its results in the jobs."""
        share, fl.host = fl.host, None
        t0 = time.monotonic()
        with profiler.span("engine.host_join"):
            share.join()
        self.host_join_s += time.monotonic() - t0
        secs = np.bincount(share.reason_of, weights=share.jobs.job_s,
                           minlength=len(share.reasons))
        for reason, dt in zip(share.reasons, secs.tolist()):
            self.host_dp_s_by_reason[reason] = (
                self.host_dp_s_by_reason.get(reason, 0.0) + dt)
            # stage seconds only: they ran on other threads
            profiler.add_stage("engine.host_dp." + reason, dt)
        self.host_dp_s += float(secs.sum())
        share.scatter(fl)

    def flush_end(self, fl: "_Flight") -> list:
        """Join the flight's collect wave, decode, join its host share,
        and return results aligned with its submit order.  A copy,
        decode or worker error raises."""
        fl.join()
        for chunk, batch, host in fl.ext_wave:
            for i, r in zip(chunk, self._collect(batch, host)):
                fl.ext_jobs[i].result = r
        for idxs, batch, host in fl.cig_wave:
            self._decode_cig_one(fl.cig_jobs, idxs, batch, host)
        fl.ext_wave = fl.cig_wave = None
        if fl.host is not None:
            self._join_host_share(fl)
        with profiler.span("engine.scatter"):
            out = []
            for kind, ref in fl.requests:
                if kind == "ext":
                    out.append(fl.ext_jobs[ref].result)
                else:
                    out.append([fl.cig_jobs[i].result for i in ref])
        return out

    def flush(self) -> list:
        return self.flush_end(self.flush_begin())


def _cig_kind(batch) -> str:
    """The batches/bucket_batches key of a CIGAR batch: its class width
    and kernel."""
    kind = "cig_small" if batch.al <= csk.SMALL_W else "cig"
    if isinstance(batch, (cst.CigarBatch, cst.RawCigarBatch)):
        kind += "_striped"
    return kind


class _Flight:
    """One in-flight flush: its requests/jobs snapshot and its collect
    wave, the launched batches with their results on the way to host
    memory (or, through a daemon, the batches it launched: ``fetch`` is
    the engine's _fetch, and the wave's join is one collect RPC)."""

    __slots__ = ("requests", "ext_jobs", "cig_jobs", "ext_wave",
                 "cig_wave", "host", "_device", "_done", "_joined",
                 "_fetch")

    def __init__(self, device, fetch=None):
        self.host = None      # the host share on the workers (_HostShare)
        self._device = device
        self._done = None     # the wave's closing event, on the card
        self._joined = False
        self._fetch = fetch

    def begin_wave(self, ext_pending, cig_pending) -> None:
        """Queue the copies of every launched batch's results to host
        memory (kernels.to_host), then the wave's closing event; a
        daemon's batches keep their _Remotes (it copies them itself)."""
        with profiler.span("engine.wave"):
            if self._fetch is not None:
                self.ext_wave, self.cig_wave = ext_pending, cig_pending
                return
            self.ext_wave = [(i, b, to_host(h)) for i, b, h in ext_pending]
            self.cig_wave = [(i, b, to_host(h)) for i, b, h in cig_pending]
            if self._device.type == "cuda":
                self._done = torch.cuda.Event()
                self._done.record()

    def join(self) -> None:
        """Wait once for the wave's closing event (stream order: every
        copy of the round has then landed), or make the daemon's one
        collect RPC; adds the driving thread's wait to the profiler."""
        if self._joined:
            raise RuntimeError("flight joined twice")
        self._joined = True
        t0 = time.monotonic()
        with profiler.span("engine.join"):
            if self._fetch is not None:
                remotes = [h for _, _, h in self.ext_wave + self.cig_wave]
                if remotes:
                    self._fetch(remotes)
            elif self._done is not None:
                self._done.synchronize()
        profiler.add_device_block(time.monotonic() - t0)


def _longest_first(cost: np.ndarray, k: int) -> list:
    """Job indices split into at most k slices (int32 arrays): jobs by
    cost, largest first, each to the slice with the least cost so far,
    so that no large job is left to start last."""
    order = np.argsort(-cost, kind="stable")
    parts: list = [[] for _ in range(k)]
    load = [(0, w) for w in range(k)]
    for i, c in zip(order.tolist(), cost[order].tolist()):
        tot, w = heapq.heappop(load)
        parts[w].append(i)
        heapq.heappush(load, (tot + c, w))
    return [np.asarray(p, np.int32) for p in parts if p]


class _HostShare:
    """One round's host-routed DPs on the worker threads: the jobs
    packed once (native.DpJobs: ext jobs, then CIGAR jobs), each job's
    reason, and the tasks running its slices."""

    __slots__ = ("jobs", "reasons", "reason_of", "ext_idx", "cig_idx",
                 "tasks")

    def __init__(self, fl, ext_host: dict, cig_host: dict, io: int):
        self.reasons = list(ext_host) + list(cig_host)
        self.ext_idx = [i for idxs in ext_host.values() for i in idxs]
        self.cig_idx = [i for idxs in cig_host.values() for i in idxs]
        self.reason_of = np.repeat(
            np.arange(len(self.reasons)),
            [len(v) for v in ext_host.values()]
            + [len(v) for v in cig_host.values()])
        jobs = ([fl.ext_jobs[i] for i in self.ext_idx]
                + [fl.cig_jobs[i] for i in self.cig_idx])
        n_ext = len(self.ext_idx)
        self.jobs = native.DpJobs(
            [j.nsq for j in jobs], [j.asq for j in jobs],
            [j.ss for j in jobs],
            [DPF_EXT_LEFT if j.ext_left else DPF_EXT_RIGHT
             for j in jobs[:n_ext]] + [DPF_CIGAR] * len(self.cig_idx),
            [j.io for j in jobs[:n_ext]] + [io] * len(self.cig_idx))
        self.tasks: list = []

    def join(self) -> None:
        """Wait for every slice; then raise the first worker error."""
        for t in self.tasks:
            t.done.wait()
        for t in self.tasks:
            if t.error is not None:
                raise t.error

    def scatter(self, fl) -> None:
        """The results into the jobs, as the inline host share sets
        them: ext (score, nt_len, aa_len), CIGAR (score, CIGAR view)."""
        p = self.jobs
        sc, ntl, aal = p.score.tolist(), p.nt_len.tolist(), p.aa_len.tolist()
        for k, i in enumerate(self.ext_idx):
            fl.ext_jobs[i].result = (sc[k], ntl[k], aal[k])
        n_ext = len(self.ext_idx)
        for (i, r) in zip(self.cig_idx, p.cigar_results(
                range(n_ext, p.n))):
            fl.cig_jobs[i].result = r


class _HostTask:
    """fn(*args) for a worker thread; ``done`` is set when it has ended,
    ``error`` holds what it raised."""

    __slots__ = ("fn", "args", "done", "error")

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args
        self.done = threading.Event()
        self.error = None

    def run(self) -> None:
        try:
            self.fn(*self.args)
        except BaseException as e:   # raised in flush_end
            self.error = e
        finally:
            self.done.set()


class _HostWorkers:
    """The engine's worker threads, each with its own queue of tasks;
    close() ends and joins them."""

    def __init__(self, n: int):
        self._queues = [_queue.SimpleQueue() for _ in range(n)]
        self._threads = [threading.Thread(target=self._work, args=(q,),
                                          daemon=True,
                                          name=f"engine-host-{w}")
                         for w, q in enumerate(self._queues)]
        for t in self._threads:
            t.start()

    @staticmethod
    def _work(q) -> None:
        while True:
            task = q.get()
            if task is None:
                return
            task.run()

    def put(self, w: int, task: _HostTask) -> _HostTask:
        self._queues[w].put(task)
        return task

    def each(self, fn) -> None:
        """fn() on every worker, behind its queued tasks."""
        for q in self._queues:
            q.put(_HostTask(fn))

    def close(self) -> None:
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()


def pump_align_generators(gens: list, engine: GpuExtEngine) -> None:
    """Advance align_region_steps generators in lockstep, batching their
    DP requests through the engine (port of
    miniprot_tpu.device.pump_align_generators).  Each generator yields a
    LIST of requests per round and receives the matching list of
    results; each round's batches launch together and are collected in
    one wave (engine.flush)."""
    waiting = {}
    for gi, g in enumerate(gens):
        try:
            waiting[gi] = next(g)
        except StopIteration:
            pass
    while waiting:
        handles = {gi: [engine.submit(req) for req in reqs]
                   for gi, reqs in waiting.items()}
        results = engine.flush()
        nxt = {}
        for gi, hs in handles.items():
            try:
                nxt[gi] = gens[gi].send([results[h] for h in hs])
            except StopIteration:
                pass
        waiting = nxt
