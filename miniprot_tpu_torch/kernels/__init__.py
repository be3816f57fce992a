"""Hand-written CUDA kernels for Hopper, their loader and launch counts.

Route: every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into ONE shared
library with a plain C interface in the package's build directory,
which is loaded with ctypes.  The library is rebuilt when any source is
newer than it.  Each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``; :func:`call` raises on a non-zero
code, so a refused launch never passes silently.

Nothing here imports a GPU toolchain at module import: the build runs
on the first launch (or on an explicit :func:`build`).
"""

from __future__ import annotations

import contextlib
import ctypes as ct
import fcntl
import os
import re
import shutil
import subprocess
import threading

import torch

from ..native.build import BUILD_DIR

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SO = os.path.join(BUILD_DIR, "libmpkernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel wrapper; a wrapper adds one exactly where it
# launches its CUDA kernel (plain-version calls on CPU tensors never count)
LAUNCHES = {"ext_dp": 0, "scan_cigar_dp": 0, "scan_cigar_dp_small": 0,
            "run_walk": 0, "striped_cigar_dp": 0, "striped_cigar_dp32": 0,
            "cell_walk": 0, "sketch_orf": 0, "track_prep": 0}

# the __global__ function each counter's wrapper launches: the name a
# profiler trace gives the kernel
KERNEL_FUNCTIONS = {
    "ext_dp": "ext_dp_kernel", "scan_cigar_dp": "scan_cigar_kernel",
    "scan_cigar_dp_small": "scan_cigar_kernel",
    "run_walk": "run_walk_kernel", "striped_cigar_dp": "striped_cigar_kernel",
    "striped_cigar_dp32": "striped32_kernel", "cell_walk": "cell_walk_kernel",
    "sketch_orf": "sketch_orf_kernel", "track_prep": "track_prep_kernel"}

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""     # nvcc's -Xptxas -v output of the last build here
_timed: list | None = None   # (entry, start, end) events under timed_launches

_vp, _i, _ll = ct.c_void_p, ct.c_int, ct.c_longlong
_SIGNATURES = {
    # nas D A logpen nl al prof out | n R RD AL go ge fs xdrop endb nwp
    # | stream
    "mp_ext_dp": [_vp] * 8 + [_i] * 10 + [_vp],
    # nas D A nl al prof tb hint score | n R RD W TR go ge fs nwp | stream
    "mp_scan_cigar": [_vp] * 9 + [_i] * 9 + [_vp],
    # tb hint nl al states counts fi fj | n TR W rounds | stream
    "mp_run_walk": [_vp] * 8 + [_i] * 4 + [_vp],
    # nas D A nl al aas mat tb score | n R RD W TR go ge fs | stream
    "mp_striped_cigar": [_vp] * 9 + [_i] * 8 + [_vp],
    "mp_striped_cigar32": [_vp] * 9 + [_i] * 8 + [_vp],
    # tb nl al states fi fj | n TR W steps | stream
    "mp_cell_walk": [_vp] * 6 + [_i] * 4 + [_vp],
    # seq out status | n off1 off2 boff | min_aa_len kmer mod_bit bbit |
    # params (host) | stream
    "mp_sketch_orf": [_vp] * 3 + [_ll] * 4 + [_i] * 4 + [_vp] * 2,
    # nt8 left io nl al nas D A logpen | n R | params (host) | stream
    "mp_track_prep": [_vp] * 9 + [_i] * 2 + [_vp] * 2,
}


def trace_kernel_times(path: str) -> dict:
    """{__global__ function: (device events, device ms)} of the kernel
    events (category "kernel", one per launch) that name one of
    KERNEL_FUNCTIONS in a Chrome trace torch.profiler wrote."""
    import json
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = set(KERNEL_FUNCTIONS.values())
    out: dict = {}
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        # a template instance's name carries its arguments:
        # "void ext_dp_kernel<4, 1, false>(signed char const*, ...)"
        base = re.match(r"(?:void\s+)?(\w+)", ev.get("name", ""))
        if base is None or base.group(1) not in names:
            continue
        n, us = out.get(base.group(1), (0, 0.0))
        out[base.group(1)] = (n + 1, us + float(ev.get("dur", 0.0)))
    return {k: (n, us / 1e3) for k, (n, us) in out.items()}


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_gpu_backend() -> bool:
    """True when a CUDA card of compute capability >= (9, 0) is visible."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) >= (9, 0))


def default_device() -> torch.device:
    """The device entry points use unless the caller names one."""
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device`` argument; asking for
    the card without an sm_90 card raises (never a silent CPU run)."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not on_gpu_backend():
        raise RuntimeError(
            "device='cuda' needs a CUDA card of compute capability >= 9.0 "
            "(Hopper); pass device='cpu' for the plain PyTorch kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _sources() -> list[str]:
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def build(force: bool = False) -> str:
    """Compile the kernel library if it is missing or stale; returns its
    path.  Concurrent builds serialize on a lock file."""
    global BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = _sources()
    with open(os.path.join(BUILD_DIR, "kernels.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        newest = max(os.path.getmtime(s) for s in srcs)
        if (not force and os.path.exists(SO)
                and os.path.getmtime(SO) >= newest):
            return SO
        nvcc = _nvcc()
        tag = f"{os.getpid()}"
        cus = [s for s in srcs if s.endswith(".cu")]
        objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3]
                             + f".{tag}.o") for s in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", s, "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(cus, objs)]
        logs, failed = [], []
        for s, p in zip(cus, procs):
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(s)}\n{out}")
            if p.returncode != 0:
                failed.append(os.path.basename(s))
        BUILD_LOG = "".join(logs)
        tmp = f"{SO}.{tag}.tmp"
        try:
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
            r = subprocess.run([nvcc, "-gencode",
                                "arch=compute_90a,code=sm_90a", "-shared",
                                *objs, "-o", tmp],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
            os.replace(tmp, SO)
        finally:
            for f in objs + [tmp]:
                if os.path.exists(f):
                    os.unlink(f)
    return SO


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            so = ct.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = args
                fn.restype = ct.c_int
            _lib = so
    return _lib


def call(entry: str, *args) -> None:
    """Launch C entry point ``entry`` of the kernel library; raise when
    it reports a CUDA error."""
    fn = getattr(lib(), entry)
    if len(args) != len(fn.argtypes):
        # ctypes would pass surplus arguments unconverted
        raise TypeError(f"{entry}: {len(args)} arguments, the C entry "
                        f"takes {len(fn.argtypes)}")
    if _timed is None:
        code = fn(*args)
    else:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        code = fn(*args)
        t1.record()
        _timed.append((entry, t0, t1))
    if code != 0:
        raise RuntimeError(f"{entry}: CUDA error {code} "
                           f"({torch.cuda.get_device_name()})")


@contextlib.contextmanager
def timed_launches():
    """Bracket every kernel launch inside the block with CUDA events on
    the current stream.  Yields a dict that, on leaving the block, holds
    the summed device ms per C entry point."""
    global _timed
    events: list = []
    totals: dict = {}
    _timed = events
    try:
        yield totals
    finally:
        _timed = None
        if events:
            torch.cuda.synchronize()
        for entry, t0, t1 in events:
            totals[entry] = totals.get(entry, 0.0) + t0.elapsed_time(t1)


# K2 runs a launch of fewer problems than this (2 per SM) in its spread
# geometry, more warps per problem: one warp per problem would
# leave most of the card's 528 schedulers idle
SPREAD_BELOW = 264


def warps_for(geometries: tuple, n: int) -> int:
    """Warps per problem for a launch of n problems: the last (spread)
    entry of a width's geometries below SPREAD_BELOW, else the first."""
    return geometries[-1] if n < SPREAD_BELOW else geometries[0]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, dtype, ndim: int, name: str,
            align: int = 1) -> None:
    """Wrapper-side argument check for a kernel input on the card;
    ``align``: the byte alignment the kernel's vector loads need."""
    if not t.is_cuda or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: expected a contiguous CUDA {dtype} "
                         f"tensor of rank {ndim}, {align}-byte aligned, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


class HostCopy:
    """A batch's result tensors in host memory: pinned copies queued on
    the launch stream behind its kernels, readable once ``event`` (the
    copies' completion) has passed.  CPU results carry no event."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors: tuple, event=None):
        self.tensors = tensors
        self.event = event

    def wait(self) -> None:
        """Block until the copies have landed."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None

    def arrays(self) -> list:
        """The results as numpy arrays, after waiting for the copies."""
        self.wait()
        return [t.numpy() for t in self.tensors]


def to_host(handles) -> HostCopy:
    """Start copying a launch's result tensor(s) to host memory without
    waiting: on the card, non-blocking copies into pinned tensors from
    torch's caching host allocator (a block is reused only after the
    copies recorded on it have completed) and one event behind them.
    A HostCopy passes through unchanged."""
    if isinstance(handles, HostCopy):
        return handles
    if isinstance(handles, torch.Tensor):
        handles = (handles,)
    if not handles[0].is_cuda:
        return HostCopy(tuple(handles))
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in handles)
    for h, t in zip(host, handles):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return HostCopy(host, event)
