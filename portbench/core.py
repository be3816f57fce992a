"""One run of one benchmark cell: set-up, the measured window, the
traced reading and the check against the reference.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration file it names, its traffic mix
``portbench/traffic/<traffic>.json`` (data: the parameters of one
loop), the loop that mix names, ``portbench/loops/<loop>.py``, and, for
each metric, ``portbench/metrics/<metric>.py`` (a module with
``read(ctx)`` returning a number, or None where the run has nothing to
read).  A later cell, mix, loop or metric is a new file, never an edit
here.

A loop module has four functions of a ``Run``: ``setup`` (after the
inputs are generated: what the window needs, warmed up), ``window(run,
seconds)`` (the measured work; it sets ``ctx["attempted"]``),
``release`` (drops the program's state before the reference runs) and
``check`` (the verdict: ``correct``, ``failed``, ``checked`` and
``compared``, each compared number beside its limit).

What every reader finds in ``ctx``: ``setup_s``, ``generate_s``,
``attempted``, and whatever the loop sets (``loops/closed_maps.py``
lists its own); in traced runs also ``stages`` (the port's profiler
stage seconds), ``device_exposed_s``, ``trace`` (``read_trace``) and
``launched`` (the problem lengths of every DP launch, ``Spans``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

from . import workgen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "miniprot_tpu")


class NoDevice(RuntimeError):
    """The run found fewer cards than its cell asks for."""


# ---------------------------------------------------------------------------
# the cell, found by name
# ---------------------------------------------------------------------------

def load_cell(root: str, workload: str) -> dict:
    """The workload entry of ``root``/BENCHMARK.json with its
    configuration, traffic mix and metric entries resolved."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return workload in m.get("workloads", [workload])

    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def _load(root: str, folder: str, name: str):
    path = os.path.join(root, "portbench", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: str, name: str):
    """The ``read`` function of portbench/metrics/<name>.py."""
    return _load(root, "metrics", name).read


def load_loop(root: str, name: str):
    """The loop module portbench/loops/<name>.py."""
    return _load(root, "loops", name)


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def require_cards(n: int) -> None:
    """Raise NoDevice unless ``n`` CUDA cards are there."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this "
                       "benchmark measures the port on an NVIDIA card")
    have = torch.cuda.device_count()
    if have < n:
        raise NoDevice(f"the cell asks for {n} cards, "
                       f"torch.cuda.device_count() is {have}")


def device_info(device: str, n: int) -> dict:
    import torch
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": n,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    return {"platform": "cpu", "kind": "cpu", "count": n,
            "memory_peak_bytes": 0}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, for the log."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


# ---------------------------------------------------------------------------
# the program's environment
# ---------------------------------------------------------------------------

def program_env() -> None:
    """Run the port as configured: its own engine in this process (no
    device daemon), its default CIGAR kernel, its build directory inside
    the checkout, and no JAX pulled in by any library."""
    os.environ["MINIPROT_TPU_DAEMON"] = "0"
    for k in ("MINIPROT_TPU_CIG_IMPL", "MINIPROT_TORCH_BUILD",
              "MINIPROT_TPU_DAEMON_SOCK"):
        os.environ.pop(k, None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def program_opts(mapcfg: dict):
    """The port's (IdxOpt, MapOpt) for a configuration's ``map`` group,
    as the CLI would set them for ``--gff`` and ``-I`` at the
    deployment's genome size."""
    from miniprot_tpu_torch.options import F_GFF, IdxOpt, MapOpt
    mo = MapOpt()
    if mapcfg.get("gff"):
        mo.flag |= F_GFF
    mo.set_max_intron(int(mapcfg["intron_cap_genome_bp"]))
    return IdxOpt(), mo


# ---------------------------------------------------------------------------
# tracing (--trace 1 only)
# ---------------------------------------------------------------------------

class Spans:
    """Host spans around the program's layer calls, as
    ``torch.profiler.record_function`` ranges in the traced window, and
    the problem lengths of every DP batch launched: installed by
    wrapping the program's functions in this process, removed by
    ``close``."""

    # (module, attribute path, span name)
    WRAPS = (("miniprot_tpu_torch.pipeline", "map_file", "map_file"),
             ("miniprot_tpu_torch.pipeline", "_make_pool", "pool_start"),
             ("miniprot_tpu_torch.pipeline", "map_batch_gpu", "pump"),
             ("miniprot_tpu_torch.device", "GpuExtEngine.flush_begin",
              "flush_begin"),
             ("miniprot_tpu_torch.device", "GpuExtEngine.flush_end",
              "flush_end"))
    # the DP batch classes that define ``launch`` themselves (the
    # others inherit one of these, and wrapping them too would count
    # their launches twice): (module, class, recurrence, lengths)
    BATCHES = (
        ("miniprot_tpu_torch.kernels.nasw_ext", "ExtBatch", "ext",
         ("nlv", "als")),
        ("miniprot_tpu_torch.kernels.nasw_ext", "RawExtBatch", "ext",
         ("nlv", "als")),
        ("miniprot_tpu_torch.kernels.nasw_cigar_scan", "_ScanBatch",
         "cigar", ("nlv", "alv")),
        ("miniprot_tpu_torch.kernels.nasw_cigar_striped", "_StripedBatch",
         "cigar", ("nlv", "alv")),
        ("miniprot_tpu_torch.kernels.nasw_cigar_striped", "Dp32Batch",
         "cigar32", ("nlv", "alv")))

    def __init__(self):
        import importlib

        import torch
        self.launched: dict[str, list] = {}
        self._undo: list = []
        for mod_name, path, span in self.WRAPS:
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for o in outer:
                owner = getattr(owner, o)
            self._patch(owner, attr, self._spanned(getattr(owner, attr),
                                                   span, torch))
        resolved = [(getattr(importlib.import_module(m), c), kind, lens)
                    for m, c, kind, lens in self.BATCHES]
        for cls, kind, lens in resolved:
            if "launch" not in vars(cls):
                raise TypeError(f"{cls.__name__} inherits its launch: "
                                "wrap the class that defines it")
            self._patch(cls, "launch", self._counted(cls.launch, kind, lens))

    def _patch(self, owner, attr, new):
        had = attr in vars(owner)
        self._undo.append((owner, attr, vars(owner).get(attr), had))
        setattr(owner, attr, new)

    @staticmethod
    def _spanned(fn, span, torch):
        def wrapper(*a, **kw):
            with torch.profiler.record_function(span):
                return fn(*a, **kw)
        return wrapper

    def _counted(self, fn, kind, lens):
        log = self.launched

        def launch(batch, *a, **kw):
            n = batch.n
            nl, al = (np.asarray(getattr(batch, k)[:n], np.int64).copy()
                      for k in lens)
            log.setdefault(kind, []).append((nl, al))
            return fn(batch, *a, **kw)
        return launch

    def close(self) -> None:
        for owner, attr, old, had in reversed(self._undo):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo.clear()


def read_trace(path: str, window_span: str) -> dict:
    """Device busy time, kernel times and idle gaps of the traced
    window from a Chrome trace that torch.profiler wrote.

    Busy: the union of every kernel, copy and memset on the card inside
    the ``window_span`` range.  Idle gaps are labelled with the
    innermost host span (record_function) open at the gap's middle."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == window_span
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {window_span!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, spans = [], []
    ops: dict[str, float] = {}
    kernels: dict[str, list] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            s, t = max(ts, w0), min(ts + dur, w1)
            if t <= s:
                continue
            dev.append((s, t))
            m = re.match(r"(?:void\s+)?([\w:]+)", e.get("name", ""))
            name = m.group(1) if m else e.get("name", "?")
            ops[name] = ops.get(name, 0.0) + (t - s) / 1e6
            if cat == "kernel":
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += (t - s) / 1e6
        elif (cat == "user_annotation" and e.get("name") != window_span
              and ts < w1 and ts + dur > w0):
            spans.append((ts, ts + dur, e["name"]))
    dev.sort()
    busy, gaps, cur_s, cur_t = 0.0, [], None, w0
    for s, t in dev:
        if cur_s is None or s > cur_t:
            if cur_s is not None:
                busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_s is not None:
        busy += cur_t - cur_s
    gaps.append((cur_t, w1))
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = (min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner
                 else "outside the program's spans")
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in top_idle]}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

class Run:
    """What a loop works with: the cell's configuration and mix, the
    seed, the device, the generated inputs (``fa``, ``faa``, ``n_prot``),
    a scratch directory, ``state`` for the loop's own objects, ``ctx``
    for the metric readers and ``notes`` for the run's log line."""

    def __init__(self, spec: dict, seed: int, device: str, workdir: str):
        self.cell, self.config = spec["cell"], spec["config"]
        self.traffic = spec["traffic"]
        self.seed, self.device, self.workdir = seed, device, workdir
        self.n_threads = int(self.config["threads"])
        self.fa = os.path.join(workdir, "genome.fa")
        self.faa = os.path.join(workdir, "proteome.faa")
        self.n_prot = 0
        self.state: dict = {}
        self.ctx: dict = {}
        self.notes: list[str] = []

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: str = ROOT,
             t_start: float | None = None, log=sys.stderr) -> dict:
    """Run one cell once; returns the result line's object (without the
    sys.modules check, which ``main`` makes last).  ``device`` "cpu"
    drives the port's plain kernel versions: the harness's own tests
    only, never a measurement."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, config = spec["cell"], spec["config"]
    loop = load_loop(root, spec["traffic"]["loop"])
    chips = int(cell["chips"])
    if device == "cuda":
        require_cards(chips)
    program_env()
    import torch

    from miniprot_tpu_torch import sysutil
    sysutil.disable_numpy_thp()
    run = Run(spec, seed, device, tempfile.mkdtemp(prefix="portbench-"))
    ctx = run.ctx
    spans = None
    try:
        t0 = time.perf_counter()
        gen = getattr(workgen, config["generator"])
        run.n_prot = int(gen(run.fa, run.faa, seed=seed % (1 << 63),
                             **config["generator_args"]))
        ctx["generate_s"] = time.perf_counter() - t0
        loop.setup(run)
        prof = None
        if trace:
            # the profiler's first start is slow: pay it in set-up
            with torch.profiler.profile(activities=_activities(device)):
                torch.zeros(1, device=device).add_(1)
            spans = Spans()
            sysutil.profiler.enabled = True
            sysutil.profiler.reset()
            prof = torch.profiler.profile(activities=_activities(device))
        run.sync()
        ctx.update(setup_s=time.perf_counter() - t_start, trace=None,
                   stages={}, device_exposed_s=None, launched={})

        # ---- the measured window ----
        if prof is not None:
            prof.start()
        with (torch.profiler.record_function("portbench.window") if trace
              else contextlib.nullcontext()):
            loop.window(run, seconds)
        if prof is not None:
            prof.stop()
        if trace:
            tpath = os.path.join(run.workdir, "trace.json")
            prof.export_chrome_trace(tpath)
            ctx["trace"] = read_trace(tpath, "portbench.window")
            os.unlink(tpath)
            ctx["stages"] = dict(sysutil.profiler.stages)
            ctx["device_exposed_s"] = sysutil.profiler.device_exposed_s
            ctx["launched"] = spans.launched
        dev = device_info(device, chips)
        if trace:
            dev["busy_s"] = ctx["trace"]["busy_s"]
            dev["window_s"] = ctx["trace"]["window_s"]

        # ---- the program's state is freed; the reference checks ----
        loop.release(run)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        verdict = loop.check(run)
        ref_s = time.perf_counter() - t_ref

        names = [m["name"] for m in (spec["per_layer"] if trace
                                     else spec["end_to_end"])]
        metrics = {}
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]
                 + spec["per_layer"]}
        for name in names:
            v = load_reader(root, name)(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
        result = {"correct": verdict["correct"],
                  "attempted": ctx["attempted"],
                  "failed": verdict["failed"], "metrics": metrics,
                  "device": dev}
        if trace:
            result["breakdown"] = {
                "device_ops": ctx["trace"]["device_ops"],
                "idle_gaps": ctx["trace"]["idle_gaps"]}
        result["compared"] = verdict["compared"]
        card = power_limit() if device == "cuda" else "cpu"
        log.write(f"[portbench] {cell['name']} seed {seed} on {card}: "
                  f"generate {ctx['generate_s']:.3f} s, set-up "
                  f"{ctx['setup_s']:.3f} s, reference {ref_s:.3f} s, "
                  f"checked {verdict['checked']}; "
                  + "; ".join(run.notes) + "\n")
        return result
    finally:
        if spans is not None:
            spans.close()
            sysutil.profiler.enabled = False
        shutil.rmtree(run.workdir, ignore_errors=True)


def _activities(device: str):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, or
    the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="portbench/run.py",
        description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(ROOT, args.workload)
    try:
        result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except NoDevice as e:
        sys.stderr.write(f"[portbench] {e}\n")
        return 2
    return finish(result)


def finish(result: dict, out=None, err=None) -> int:
    """Print the result: its compared numbers beside their limits as the
    last lines of standard error, then the result line, last on
    standard output.  Nothing is printed, and 3 returned, when JAX or
    the JAX package has been loaded in this process."""
    out = out or sys.stdout
    err = err or sys.stderr
    bad = forbidden_modules()
    if bad:
        err.write("[portbench] loaded in this process, and not allowed: "
                  f"{', '.join(bad)}\n")
        return 3
    for name, c in result["compared"].items():
        err.write(f"[portbench] compared {name}: {c['value']} "
                  f"(limit {c['limit']})\n")
    err.flush()
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0
