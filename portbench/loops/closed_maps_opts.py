"""Loop ``closed_maps_opts``: the ``closed_maps`` loop for a
configuration whose ``map`` group sets CLI options beyond ``gff`` and
``intron_cap_genome_bp`` (the two that ``core.program_opts`` and
``refmap.run.make_opts`` read).

Each such key is set on the port's ``MapOpt`` in set-up and on the
reference's in the check, as the port's CLI sets the option it stands
for (``CLI_OPTS``), and both are checked as the CLI checks them.  The
window (with one more note in the run's log), the release, what goes
into ``ctx`` and the comparison are those of ``closed_maps`` and
``portbench.check``.
"""

from __future__ import annotations

import os
import sys
import time

from portbench import check as cmp
from portbench import core
from portbench.loops import closed_maps
from portbench.loops.closed_maps import _map, _write_subset
from portbench.loops.closed_maps import release  # noqa: F401

# the map group's keys that stand for a CLI option, and the option:
# each is set as an int on MapOpt's field of the same name
CLI_OPTS = {"sp_model": "-j"}


def map_opts(mo, mapcfg: dict):
    """``mo`` (the port's or the reference's MapOpt) with the map
    group's CLI options set, then checked."""
    for key in CLI_OPTS:
        if key in mapcfg:
            setattr(mo, key, int(mapcfg[key]))
    mo.check()
    return mo


def setup(run) -> None:
    from miniprot_tpu_torch.index import Index
    t0 = time.perf_counter()
    io, mo = core.program_opts(run.config["map"])
    run.state["mo"] = map_opts(mo, run.config["map"])
    run.state["mi"] = Index.build(run.fa, io, n_threads=run.n_threads,
                                  sketch_device=run.device)
    run.sync()
    run.ctx["index_build_s"] = time.perf_counter() - t0
    warm = os.path.join(run.workdir, "warm.faa")
    _write_subset(run.faa, warm, int(run.traffic["warmup_proteins"]))
    _map(run, warm, os.path.join(run.workdir, "warm.gff"))


def window(run, seconds: float) -> None:
    """closed_maps's window, and a note of the window's host-routed DP
    cells per reason and regions aligned, where the port counts them."""
    closed_maps.window(run, seconds)
    cells: dict = {}
    for st in run.ctx["stats"]:
        for k, v in st.get("host_cells_by_reason", {}).items():
            cells[k] = cells.get(k, 0) + v
    run.notes.append(
        f"host cells by reason {dict(sorted(cells.items()))}; regions "
        f"{[st.get('dp_regions') for st in run.ctx['stats']]}")


def reference_opts(mapcfg: dict):
    """The reference's (IdxOpt, MapOpt) for the map group."""
    from portbench.refmap.run import make_opts
    io, mo = make_opts(mapcfg)
    return io, map_opts(mo, mapcfg)


def check(run) -> dict:
    """The window's maps against the reference's, mapped with the same
    options, protein by protein (``portbench.check``: a sample drawn
    from the seed and the longest; ``differing``, limit 0)."""
    from portbench.refmap.index import Index
    from portbench.refmap.run import map_gff
    prots = cmp.sample(cmp.read_fasta(run.faa), run.traffic, run.seed)
    io, mo = reference_opts(run.config["map"])
    mi = Index.build(run.fa, io, n_threads=run.n_threads)
    ref = {k: cmp.normalise(v) for k, v in
           map_gff(mi, mo, prots, n_threads=run.n_threads).items()}
    maps = []
    for path in run.state["outputs"]:
        with open(path) as f:
            maps.append(cmp.split_blocks(f.read()))
    n_bad, first = cmp.count_differing(ref, maps)
    for i, name in first:
        sys.stderr.write(f"[portbench] map {i}, protein {name}: the "
                         "port's output differs from the reference's\n")
    return {"correct": n_bad == 0, "failed": n_bad, "checked": len(ref),
            "compared": {"differing": {"value": n_bad, "limit": 0}}}
