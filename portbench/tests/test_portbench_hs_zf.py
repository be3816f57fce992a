"""The hs_zf deployment's pieces on the CPU: the loop that sets the
configuration's CLI options (``loops/closed_maps_opts.py``) on the
port's and the reference's options alike, a check whose reference
runs at another splice model than the port (it has to fail), and the
two readers of the port's DP-cell counters on hand-made contexts.
Nothing here is a measurement."""

import json
import os

import pytest

from portbench import core, workgen

TINY = {"contigs": [["a", 120_000], ["b", 120_000]], "total_genes": 8,
        "protein_len": {"median": 250, "sigma": 0.5, "min_aa": 50},
        "max_exons": 6, "max_intron": 1500, "mut_rate": 0.3,
        "rev_frac": 0.4, "fs_frac": 0.1, "tandem_frac": 0.0,
        "satellites_per_ctg": 0, "splice_classes": 0.3}


@pytest.fixture(scope="module")
def loop():
    return core.load_loop(core.ROOT, "closed_maps_opts")


@pytest.fixture(scope="module")
def hs_zf():
    with open(os.path.join(core.ROOT, "portbench/configs/hs_zf.json")) as f:
        return json.load(f)


def test_the_loops_options_are_the_clis(loop, hs_zf, tmp_path):
    """The port's and the reference's MapOpt carry -j 2 as the port's
    CLI parses it from ``--gff -j 2``."""
    from miniprot_tpu_torch import cli
    from miniprot_tpu_torch.options import F_GFF
    fa = tmp_path / "g.fa"
    fa.write_text(">c\n" + "ACGTTGCA" * 2000 + "\n")
    _, want, _, _ = cli.load_for_server(["--gff", "-j", "2", str(fa)])
    mapcfg = hs_zf["map"]
    _, port = core.program_opts(mapcfg)
    port = loop.map_opts(port, mapcfg)
    _, ref = loop.reference_opts(mapcfg)
    assert want.sp_model == port.sp_model == ref.sp_model == 2
    assert want.flag & F_GFF and port.flag == want.flag == ref.flag
    # -I at the source's genome size: 3.6 * sqrt(3.086e9) + 1
    assert port.max_intron == ref.max_intron == 199_987
    bad = dict(mapcfg, sp_model=3)
    with pytest.raises(ValueError):
        loop.map_opts(core.program_opts(bad)[1], bad)


def test_a_reference_at_another_splice_model_fails_the_check(loop,
                                                            tmp_path):
    cfg = {"generator": "make_workload", "generator_args": TINY,
           "map": {"gff": True, "intron_cap_genome_bp": 240_000,
                   "sp_model": 2},
           "threads": 1}
    mix = {"loop": "closed_maps_opts", "warmup_proteins": 1,
           "check_sample": 8, "check_longest": 1}
    spec = {"cell": {"name": "tiny.j2", "chips": 1}, "config": cfg,
            "traffic": mix}
    core.program_env()
    run = core.Run(spec, 2**33 + 7, "cpu", str(tmp_path))
    run.n_prot = workgen.make_workload(run.fa, run.faa, seed=run.seed,
                                       **TINY)
    loop.setup(run)
    assert run.state["mo"].sp_model == 2
    loop.window(run, 0.0)
    assert run.ctx["maps"] == 1 and run.ctx["proteins"] == run.n_prot
    loop.release(run)
    same = loop.check(run)
    assert same["correct"] is True and same["checked"] == run.n_prot
    assert same["compared"] == {"differing": {"value": 0, "limit": 0}}
    cfg["map"]["sp_model"] = 1
    other = loop.check(run)
    assert other["correct"] is False and other["failed"] > 0


def _ctx(host=None, proteins=4):
    st = {"launched": {"ext": {"problems": 3, "cells": 600},
                       "cigar": {"problems": 5, "cells": 200}}}
    if host is not None:
        st["host_cells_by_reason"] = host
    return {"stats": [st, dict(st)], "proteins": proteins}


def test_card_cell_share():
    read = core.load_reader(core.ROOT, "engine.card_cell_share")
    assert read(_ctx({"cig_short": 100, "ext_short": 100})) == \
        pytest.approx(80.0)
    assert read(_ctx({})) == pytest.approx(100.0)
    # a program that does not count its host cells, or no DP at all
    assert read(_ctx()) is None
    assert read({"stats": [{"host_cells_by_reason": {}}],
                 "proteins": 1}) is None


def test_dp_cells_per_protein():
    read = core.load_reader(core.ROOT, "map.dp_cells_per_protein")
    # (2 maps x (800 on the card + 200 on the host)) / 4 proteins
    assert read(_ctx({"cig_short": 200})) == pytest.approx(500 / 1e6)
    assert read(_ctx()) is None
    assert read({"stats": [], "proteins": 0}) is None
