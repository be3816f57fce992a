"""The readers of the program's own spans and counters: a traced run of
a cell added as data only reads them on the CPU, and each per-kernel
roofline's least time is ``work.least_seconds`` of the launched
problems."""

import numpy as np
import pytest

from portbench import core, counts, work
from test_portbench_run import _run, root  # noqa: F401  (module fixture)


def test_added_cell_traced_reads_the_program_spans(root):  # noqa: F811
    r = _run(root, trace=True, seed=17)
    assert r["correct"] is True
    m = r["metrics"]
    # the program's spans and counters are read; the per-kernel
    # rooflines find no kernel on the CPU and are left out
    for name in ("pump.generators_ms_per_protein",
                 "engine.pack_ms_per_protein", "engine.launch_ms_per_protein",
                 "engine.decode_ms_per_protein",
                 "map.finish_emit_ms_per_protein"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms/protein"
    assert 0 < m["engine.unpadded_cell_share"]["value"] <= 100
    assert "kernels.ext_roofline" not in m
    assert "kernels.cigar_roofline" not in m


@pytest.mark.parametrize("name", ["kernels.ext_roofline",
                                  "kernels.cigar_roofline"])
def test_roofline_readers_least_time_is_work_least_seconds(name):
    """A per-kernel roofline reads the program's summed counts: its least
    time equals work.least_seconds on the launched problems themselves,
    and the share is that over its kernels' device time alone."""
    mod = core._load(core.ROOT, "metrics", name)
    rng = np.random.default_rng(5)
    launches = {k: [(rng.integers(1, 20000, n), rng.integers(1, 1000, n))
                    for n in (3, 128, 1)]
                for k in ("ext", "cigar", "cigar32")}
    # two maps, each with its own share of the launches
    stats = [{"launched": {}}, {"launched": {}}]
    for k, ls in launches.items():
        for j, (nl, al) in enumerate(ls):
            c = stats[j % 2]["launched"].setdefault(
                k, {"problems": 0, "cells": 0, "seq_bytes": 0,
                    "padded_cells": 0})
            c["problems"] += len(nl)
            c["cells"] += int(np.sum(nl * al))
            c["seq_bytes"] += int(np.sum(nl + al))
            c["padded_cells"] += int(nl.max() * al.max() * len(nl))
    ctx = {"stats": stats, "trace": {"kernels": {
        kern: (1, 0.5) for kern in mod.KERNELS} | {"track_prep_kernel":
                                                      (1, 9.0)}}}
    least = work.least_seconds({k: launches[k] for k in mod.KINDS})
    assert counts.least_seconds(counts.launched(ctx), mod.KINDS) \
        == pytest.approx(least, rel=1e-12)
    assert mod.read(ctx) == pytest.approx(
        100 * least / (0.5 * len(mod.KERNELS)), rel=1e-12)
    # no kernel of its own in the trace, or no counts: nothing to read
    assert mod.read({**ctx, "trace": {"kernels": {"track_prep_kernel":
                                                  (1, 9.0)}}}) is None
    assert mod.read({**ctx, "stats": [{}]}) is None
