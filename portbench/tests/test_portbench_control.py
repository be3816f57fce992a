"""The control (the reference computed at int8 where the port computes
at int16) fails the check, and the reference passes against itself:
on three seeds, at a size a test run can hold."""

import json
import os
import shutil

import pytest

from portbench import check, control, core


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(os.path.join(core.ROOT, "portbench"),
                    os.path.join(r, "portbench"))
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = {"source": "tiny", "generator": "make_workload",
           "generator_args": {
               "contigs": [["a", 200_000], ["b", 200_000]],
               "total_genes": 12,
               "protein_len": {"median": 415, "sigma": 0.76, "min_aa": 50},
               "max_exons": 8, "max_intron": 1500, "mut_rate": 0.35,
               "rev_frac": 0.5, "fs_frac": 0.05, "tandem_frac": 0.0,
               "satellites_per_ctg": 0, "splice_classes": 0.0},
           "map": {"gff": True, "intron_cap_genome_bp": 400_000},
           "threads": 2}
    with open(os.path.join(r, "portbench/configs/tiny.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny", "source": "tiny",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny.batch", "config": "tiny",
                               "traffic": "batch", "chips": 1,
                               "why": "tiny"})
    with open(os.path.join(r, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return r


@pytest.mark.parametrize("seed", [3, 2**31 + 1, 77])
def test_control_fails_the_check(root, seed):
    r = control.reading(root, "tiny.batch", seed)
    assert r["checked"] >= 10
    # the limit is 0: the control has to read above it
    assert r["differing"] > 0


def test_reference_passes_against_itself(root, tmp_path):
    spec = core.load_cell(root, "tiny.batch")
    fa, faa = control.generate(spec["config"], 5, str(tmp_path))
    a = control.side_blocks("int16", root, "tiny.batch", 5, fa, faa)
    b = control.side_blocks("int16", root, "tiny.batch", 5, fa, faa)
    assert check.count_differing(a, [b])[0] == 0
    assert any(v for v in a.values())   # some proteins map
