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


class Profiler:
    """Per-stage wall-time + DP-cell observability (the reference only
    has the [M::...] stage lines; this build adds structured stage
    timers and a GCUPS counter derived from DP cell counts).  Enabled by
    --profile; near-zero cost when disabled."""

    def __init__(self) -> None:
        self.enabled = False
        self.stages: dict[str, float] = {}
        self.cells_host = 0       # DP cells evaluated by the host C kernel
        self.cells_device = 0     # DP cells evaluated by the device kernels
        self.cells_device_ext = 0    # split: extension kernel cells
        self.cells_device_cig = 0    # split: CIGAR kernel cells
        self.cells_device_cig_small = 0  # of those: small class (al<=32)
        self.n_dp_host = 0
        self.n_dp_device = 0
        # collect-wave span: each flush round's seconds on the card's
        # clock from before its first launch to after its last result
        # copy (the host's packing between launches included, so not all
        # of it is work on the card), plus the waits of collects made
        # outside a wave (the planes-cap drain)
        self.wave_span_s = 0.0
        # the part of those seconds the driving thread actually waited
        # (the wave's join and the drain); the rest ran behind host work
        self.device_exposed_s = 0.0
        self.flush_rounds = 0
        self._open: dict[str, float] = {}
        # the pre_align producer thread adds its stage seconds beside the
        # pump's stages: stage updates take this lock
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Zero every counter and stage timer; ``enabled`` is kept."""
        enabled = self.enabled
        self.__init__()
        self.enabled = enabled

    def start(self, stage: str) -> None:
        if self.enabled:
            self._open[stage] = time.monotonic()

    def stop(self, stage: str) -> None:
        if self.enabled and stage in self._open:
            self.add_stage(stage, time.monotonic() - self._open.pop(stage))

    def add_stage(self, stage: str, dt: float) -> None:
        """Add ``dt`` seconds to ``stage`` (any thread)."""
        if self.enabled:
            with self._lock:
                self.stages[stage] = self.stages.get(stage, 0.0) + dt

    # cell counting is always on (two integer adds per DP call): the
    # host/device cell split is a first-class product metric (what
    # fraction of DP work lands on the card), reported by map_file on
    # device runs

    def add_host_dp(self, nl: int, al: int) -> None:
        self.cells_host += nl * al
        self.n_dp_host += 1

    def add_device_dp(self, cells: int, n: int, kind: str = "ext") -> None:
        self.cells_device += cells
        self.n_dp_device += n
        if kind.startswith("cig"):
            self.cells_device_cig += cells
            if kind.startswith("cig_small"):
                self.cells_device_cig_small += cells
        else:
            self.cells_device_ext += cells

    def add_device_block(self, dt: float,
                         exposed: float | None = None) -> None:
        """dt: a collect wave's span (or a blocking collect's wait);
        exposed: the seconds of it the driving thread waited, ``dt``
        when left out (a blocking collect)."""
        self.wave_span_s += dt
        self.device_exposed_s += dt if exposed is None else exposed

    def device_fraction(self) -> float:
        """Fraction of DP cells evaluated on the device (padded batch
        cells counted as device work; 0.0 when no DP ran)."""
        tot = self.cells_host + self.cells_device
        return self.cells_device / tot if tot else 0.0

    def report(self) -> None:
        if not self.enabled:
            return
        for stage, dt in sorted(self.stages.items()):
            sys.stderr.write(f"[P::{stage}] {dt:.3f} s\n")
        wall = self.stages.get("map") or realtime()
        if self.cells_host:
            sys.stderr.write(
                f"[P::dp_host] {self.n_dp_host} DPs, "
                f"{self.cells_host / 1e9:.3f} Gcells, "
                f"{self.cells_host / 1e9 / wall:.3f} GCUPS over the map stage\n")
        if self.cells_device:
            sys.stderr.write(
                f"[P::dp_device] {self.n_dp_device} DPs, "
                f"{self.cells_device / 1e9:.3f} Gcells (padded batches), "
                f"{self.flush_rounds} flush rounds; collect waves span "
                f"{self.wave_span_s:.3f} s (first launch to last result "
                "copy, host packing between launches included), the "
                f"driving thread waited {self.device_exposed_s:.3f} s\n")
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
