"""Loop ``closed_maps``: whole-proteome maps, one at a time, back to back.

Set-up builds the index from the generated genome
(``Index.build(..., sketch_device=<the card>)``) and maps the proteome's
first ``warmup_proteins`` once, so the kernel library loads and the
cell's buckets launch before the window.  The window runs
``pipeline.map_file`` over the whole proteome, GFF to a file, until
``seconds`` have passed; the map in flight finishes.  The check maps a
sample of the proteins on the reference and compares every map of the
window with it (``portbench/check.py``).

The mix's parameters: ``warmup_proteins``, ``check_sample``,
``check_longest``.  What it sets in ``ctx``: ``attempted`` and
``proteins`` (every protein of every map in the window), ``maps``,
``window_s`` (the window's start to the last map's end),
``proteins_per_map``, ``index_build_s`` and ``stats`` (each map's
``map_file(stats=)``).
"""

from __future__ import annotations

import os
import time

from portbench import core
from portbench.check import check_maps


def _write_subset(src: str, dst: str, n: int) -> None:
    """The first ``n`` records of a FASTA file (one line a sequence)."""
    k = 0
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            if line.startswith(">"):
                k += 1
                if k > n:
                    break
            g.write(line)


def _map(run, faa: str, out_path: str, stats: dict | None = None) -> None:
    from miniprot_tpu_torch import pipeline
    with open(out_path, "w") as out:
        pipeline.map_file(run.state["mi"], faa, run.state["mo"],
                          n_threads=run.n_threads, out=out,
                          device=run.device, stats=stats)


def setup(run) -> None:
    from miniprot_tpu_torch.index import Index
    t0 = time.perf_counter()
    io, run.state["mo"] = core.program_opts(run.config["map"])
    run.state["mi"] = Index.build(run.fa, io, n_threads=run.n_threads,
                                  sketch_device=run.device)
    run.sync()
    run.ctx["index_build_s"] = time.perf_counter() - t0
    warm = os.path.join(run.workdir, "warm.faa")
    _write_subset(run.faa, warm, int(run.traffic["warmup_proteins"]))
    _map(run, warm, os.path.join(run.workdir, "warm.gff"))


def window(run, seconds: float) -> None:
    outputs, stats_all, ends = [], [], []
    t0 = time.perf_counter()
    while True:
        path = os.path.join(run.workdir, f"map{len(outputs)}.gff")
        st: dict = {}
        _map(run, run.faa, path, st)
        outputs.append(path)
        stats_all.append(st)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    window_s = ends[-1] - t0
    done = run.n_prot * len(outputs)
    run.state["outputs"] = outputs
    run.ctx.update(attempted=done, proteins=done, maps=len(outputs),
                   window_s=window_s, proteins_per_map=run.n_prot,
                   stats=stats_all)
    per_map = [round(b - a, 3) for a, b in zip([t0] + ends, ends)]
    split = [(st.get("n_device"), st.get("n_host")) for st in stats_all]
    run.notes.append(
        f"{run.n_prot} proteins, {len(outputs)} maps in {window_s:.3f} s "
        f"(each {per_map} s); index {run.ctx['index_build_s']:.3f} s; "
        f"DP split (device, host) {split}")


def release(run) -> None:
    run.state.pop("mi", None)


def check(run) -> dict:
    return check_maps(run.fa, run.faa, run.state["outputs"], run.config,
                      run.traffic, run.seed, n_threads=run.n_threads)
