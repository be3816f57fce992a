"""Timers, peak-RSS and stderr logging (sys.c:93-127 parity).

Messages follow the reference's ``[M::func@wall*cpu] ...`` stderr format
at verbosity >= 3; mp_verbose semantics: >=1 errors, >=2 warnings,
>=3 info.
"""

from __future__ import annotations

import resource
import sys
import threading
import time

import numpy as np

verbose = 3

_t0 = time.monotonic()
_c0 = time.process_time()


def realtime() -> float:
    return time.monotonic() - _t0


def cputime() -> float:
    return time.process_time() - _c0


def peakrss_gb() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    children = resource.getrusage(resource.RUSAGE_CHILDREN)
    return max(ru.ru_maxrss, children.ru_maxrss) / 1024.0 / 1024.0


def percent_cpu() -> float:
    rt = realtime()
    return cputime() / rt if rt > 0 else 0.0


def log(func: str, fmt: str, *args, level: int = 3) -> None:
    if verbose >= level:
        msg = fmt % args if args else fmt
        sys.stderr.write(f"[M::{func}@{realtime():.3f}*{percent_cpu():.2f}] {msg}\n")


def warn(fmt: str, *args) -> None:
    if verbose >= 2:
        msg = fmt % args if args else fmt
        sys.stderr.write(f"[WARNING]\033[1;31m {msg}\033[0m\n")


def error(fmt: str, *args) -> None:
    if verbose >= 1:
        msg = fmt % args if args else fmt
        sys.stderr.write(f"[ERROR]\033[1;31m {msg}\033[0m\n")


class _NoSpan:
    """What ``Profiler.span`` returns while the profiler is off."""

    __slots__ = ()
    dt = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """One timed interval of a stage: its seconds go to the profiler's
    ``stages[name]`` (and to ``dt``); on the main thread it is also a
    ``torch.profiler.record_function`` range of the same name, so a
    Chrome trace of the main thread shows it on the trace's own clock
    (a range opened on another thread does not reach the trace)."""

    __slots__ = ("_prof", "_name", "_rf", "_t0", "dt")

    def __init__(self, prof: "Profiler", name: str):
        self._prof, self._name, self._rf = prof, name, None

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            import torch
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self.dt = time.monotonic() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._prof.add_stage(self._name, self.dt)
        return False


# the host_cells key of the DPs of a map on the host C engine alone
HOST_ENGINE = "host_engine"

# the counts per DP recurrence in Profiler.launched, in order
LAUNCHED_FIELDS = ("problems", "cells", "seq_bytes", "padded_cells")


class Profiler:
    """Per-stage wall-time + DP-cell observability (the reference only
    has the [M::...] stage lines; this build adds structured stage
    timers and counts of the DP work launched on the device).  Stages
    are timed by ``span`` while ``enabled`` (--profile, --profile-trace,
    a traced benchmark run); off, a span costs one attribute check."""

    def __init__(self) -> None:
        self.enabled = False
        self.stages: dict[str, float] = {}
        # DP cells (sum of nl * al) evaluated by the host C kernel, per
        # route: a host_reasons key of the device engine, or HOST_ENGINE
        self.host_cells: dict[str, int] = {}
        self.cells_device = 0     # padded cells of the launched batches
        self.n_dp_host = 0
        self.n_dp_device = 0
        # per DP recurrence ("ext", "cigar", "cigar32"), the launched
        # problems (LAUNCHED_FIELDS): [problems, unpadded cells
        # sum(nl * al), sequence bytes sum(nl + al), padded cells]
        self.launched: dict[str, list] = {}
        # the seconds the driving thread waited on the card: the collect
        # waves' joins and the planes-cap drains
        self.device_exposed_s = 0.0
        self.flush_rounds = 0
        # the pre_align producer thread adds its stage seconds beside the
        # pump's stages: stage updates take this lock
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Zero every counter and stage timer; ``enabled`` is kept."""
        enabled = self.enabled
        self.__init__()
        self.enabled = enabled

    def span(self, name: str):
        """``with profiler.span(name):`` adds the block's seconds to
        ``stages[name]`` while the profiler is on (see _Span); off, it
        is a shared no-op, with no clock read and no torch call."""
        if not self.enabled:
            return _NO_SPAN
        return _Span(self, name)

    def add_stage(self, stage: str, dt: float) -> None:
        """Add ``dt`` seconds to ``stage`` (any thread)."""
        if self.enabled:
            with self._lock:
                self.stages[stage] = self.stages.get(stage, 0.0) + dt

    # the DP counters are always on (one numpy pass per launched batch
    # and per round's host share of a reason): the host/device split and
    # the launched work are reported by map_file on device runs

    def add_host_cells(self, reason: str, cells: int, n: int,
                       into: dict | None = None) -> None:
        """Count ``n`` host DPs of ``cells`` cells in all, routed to the
        host for ``reason``; also into ``into`` (an engine's own counts,
        the same layout as ``host_cells``)."""
        for counts in (self.host_cells, into):
            if counts is not None:
                counts[reason] = counts.get(reason, 0) + cells
        self.n_dp_host += n

    def add_device_dp(self, kind: str, nl, al, padded: int,
                      into: dict | None = None, sign: int = 1) -> None:
        """Count launched problems of DP recurrence ``kind``: ``nl``,
        ``al`` their genome and query lengths, ``padded`` the cells
        their batch computes; also into ``into`` (an engine's own
        counts, the same layout as ``launched``).  ``sign`` -1 takes
        them back out (a problem redone on the host)."""
        nl = np.asarray(nl, np.int64)
        al = np.asarray(al, np.int64)
        add = (sign * len(nl), sign * int(np.dot(nl, al)),
               sign * int(nl.sum() + al.sum()), sign * int(padded))
        for counts in (self.launched, into):
            if counts is not None:
                c = counts.setdefault(kind, [0, 0, 0, 0])
                for j, v in enumerate(add):
                    c[j] += v
        self.cells_device += add[3]
        self.n_dp_device += add[0]

    def add_device_block(self, exposed: float) -> None:
        """Seconds the driving thread waited on the card (a wave's join
        or a blocking collect)."""
        self.device_exposed_s += exposed

    def device_fraction(self) -> float:
        """Fraction of DP cells evaluated on the device (padded batch
        cells counted as device work; 0.0 when no DP ran)."""
        tot = sum(self.host_cells.values()) + self.cells_device
        return self.cells_device / tot if tot else 0.0

    def report(self) -> None:
        if not self.enabled:
            return
        for stage, dt in sorted(self.stages.items()):
            sys.stderr.write(f"[P::{stage}] {dt:.3f} s\n")
        wall = self.stages.get("map") or realtime()
        cells_host = sum(self.host_cells.values())
        if cells_host:
            sys.stderr.write(
                f"[P::dp_host] {self.n_dp_host} DPs, "
                f"{cells_host / 1e9:.3f} Gcells, "
                f"{cells_host / 1e9 / wall:.3f} GCUPS over the map stage\n")
        if self.cells_device:
            sys.stderr.write(
                f"[P::dp_device] {self.n_dp_device} DPs, "
                f"{self.cells_device / 1e9:.3f} Gcells (padded batches), "
                f"{self.flush_rounds} flush rounds; the driving thread "
                f"waited {self.device_exposed_s:.3f} s on the card\n")
            for kind, (n, cells, nbytes, padded) in sorted(
                    self.launched.items()):
                sys.stderr.write(
                    f"[P::launched] {kind}: {n} problems, "
                    f"{cells / 1e9:.3f} Gcells unpadded of "
                    f"{padded / 1e9:.3f} padded, {nbytes / 1e6:.3f} MB of "
                    "sequence\n")
        self._report_kernel_launches()

    @staticmethod
    def _report_kernel_launches() -> None:
        """One line per device kernel that launched in this process."""
        import sys as _s
        kmod = _s.modules.get("miniprot_tpu_torch.kernels")
        if kmod is None:
            return
        for name, n in kmod.launch_counts().items():
            if n:
                sys.stderr.write(f"[P::kernels] {name}: {n} launches\n")


profiler = Profiler()


def disable_numpy_thp() -> None:
    """Stop numpy from madvising MADV_HUGEPAGE on >=4MB allocations.

    On hosts where THP defrag is synchronous (virtualized/fragmented
    machines) those faults run 100x+ slower (measured 2us ->
    230-335us/page here), dominating index build and batch I/O, and
    genome-scale arrays gain nothing from THP in this access profile.
    Called from the tool entry points (CLI, chip_smoke.py) — NOT at
    package import, so embedding applications keep their own policy.
    Respects an explicit NUMPY_MADVISE_HUGEPAGE from the user."""
    import os
    if "NUMPY_MADVISE_HUGEPAGE" in os.environ:
        return
    os.environ["NUMPY_MADVISE_HUGEPAGE"] = "0"   # forks / subprocesses
    try:  # runtime setter: numpy may already be imported (e.g. by torch)
        import numpy as np
        np._core.multiarray._set_madvise_hugepage(False)
    except (ImportError, AttributeError):
        try:
            np.core.multiarray._set_madvise_hugepage(False)  # numpy 1.x
        except Exception:
            pass
