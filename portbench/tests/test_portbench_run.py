"""Whole runs of the harness on the CPU at a tiny size, with the port's
plain kernel versions: a cell added as data only, the result line, and
runs whose timed path is broken underneath, which the check has to
catch.  The look for a card is skipped (``device="cpu"``), and nothing
here is a measurement."""

import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import core

TINY = {"contigs": [["a", 150_000], ["b", 150_000]], "total_genes": 6,
        "protein_len": {"median": 300, "sigma": 0.5, "min_aa": 50},
        "max_exons": 6, "max_intron": 1500, "mut_rate": 0.1,
        "rev_frac": 0.5, "fs_frac": 0.2, "tandem_frac": 0.0,
        "satellites_per_ctg": 0, "splice_classes": 0.0}

# a loop added as a file of its own: the index built back to back,
# each build held against the reference's index
BUILDS_LOOP = """
import time

from portbench import core


def setup(run):
    run.state["io"], _ = core.program_opts(run.config["map"])


def window(run, seconds):
    from miniprot_tpu_torch.index import Index
    run.state["builds"] = []
    t0 = time.perf_counter()
    while not run.state["builds"] or time.perf_counter() - t0 < seconds:
        mi = Index.build(run.fa, run.state["io"], n_threads=run.n_threads,
                         sketch_device=run.device)
        run.state["builds"].append((mi.ki.copy(), mi.kb.copy()))
    run.ctx.update(attempted=len(run.state["builds"]),
                   window_s=time.perf_counter() - t0)


def release(run):
    pass


def check(run):
    import numpy as np

    from portbench.refmap.index import Index
    from portbench.refmap.run import make_opts
    ref = Index.build(run.fa, make_opts(run.config["map"])[0])
    bad = sum(not (np.array_equal(ki, ref.ki) and np.array_equal(kb, ref.kb))
              for ki, kb in run.state["builds"])
    return {"correct": bad == 0, "failed": bad, "checked": 1,
            "compared": {"differing_builds": {"value": bad, "limit": 0}}}
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with one more cell, mix and metric, all data files:
    nothing of the harness's code is edited to add them."""
    r = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(os.path.join(core.ROOT, "portbench"),
                    os.path.join(r, "portbench"))
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = {"source": "tiny", "genome_bp": 300_000, "proteins": 6,
           "generator": "make_workload", "generator_args": TINY,
           "map": {"gff": True, "intron_cap_genome_bp": 300_000},
           "threads": 2}
    with open(os.path.join(r, "portbench/configs/tiny.json"), "w") as f:
        json.dump(cfg, f)
    mix = {"loop": "closed_maps", "warmup_proteins": 1,
           "check_sample": 4, "check_longest": 1}
    with open(os.path.join(r, "portbench/traffic/tiny_mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(r, "portbench/metrics/tiny.maps.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['maps']\n")
    with open(os.path.join(r, "portbench/loops/tiny_builds.py"), "w") as f:
        f.write(BUILDS_LOOP)
    with open(os.path.join(r, "portbench/traffic/tiny_builds.json"),
              "w") as f:
        json.dump({"loop": "tiny_builds"}, f)
    with open(os.path.join(r, "portbench/metrics/tiny.builds_per_s.py"),
              "w") as f:
        f.write("def read(ctx):\n"
                "    return ctx['attempted'] / ctx['window_s']\n")
    bench["configs"].append({"name": "tiny", "source": "tiny",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "tiny"})
    bench["workloads"].append({"name": "tiny.index", "config": "tiny",
                               "traffic": "tiny_builds", "chips": 1,
                               "why": "tiny"})
    for m in bench["end_to_end"]:
        if m["name"] == "proteins_per_s":
            m["workloads"].append("tiny.cell")
    bench["end_to_end"].append({"name": "tiny.builds_per_s",
                                "unit": "builds/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.index"]})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append("tiny.cell")
    bench["per_layer"].append({"name": "tiny.maps", "unit": "maps",
                               "better": "higher",
                               "source": "host_clock", "layer": "tiny",
                               "moves": "proteins_per_s",
                               "workloads": ["tiny.cell"]})
    with open(os.path.join(r, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return r


def _run(root, trace=False, seed=2**31 + 5, cell="tiny.cell"):
    spec = core.load_cell(root, cell)
    return core.run_cell(spec, seed, 0.1, trace, device="cpu", root=root,
                         log=io.StringIO())


def test_added_cell_runs_and_prints_the_result_line(root):
    r = _run(root)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"proteins_per_s", "setup_s"}
    assert r["metrics"]["proteins_per_s"]["unit"] == "proteins/s"
    out, err = io.StringIO(), io.StringIO()
    assert core.finish(r, out=out, err=err) == 0
    line = json.loads(out.getvalue().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    # the compared numbers come last, in the line and on stderr
    assert list(line)[-1] == "compared"
    assert line["compared"]["differing"] == {"value": 0, "limit": 0}
    assert err.getvalue().splitlines()[-1].startswith(
        "[portbench] compared differing: 0 (limit 0)")


def test_added_cell_traced(root):
    r = _run(root, trace=True, seed=17)
    assert r["correct"] is True
    m = r["metrics"]
    # the data-only metric is read; the kernels' roofline finds no
    # kernel on the CPU and is left out, never reported as 0
    assert m["tiny.maps"]["value"] >= 1
    assert "kernels.dp_roofline" not in m and "mfu.map" not in m
    for name in ("host_front.pre_align_ms_per_protein",
                 "pipeline.align_rounds_ms_per_protein",
                 "setup.index_build_s"):
        assert m[name]["value"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0


def test_a_loop_added_as_a_file_of_its_own_runs(root):
    r = _run(root, cell="tiny.index", seed=2**40 + 3)
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["metrics"]) == {"tiny.builds_per_s", "setup_s"}
    assert r["compared"] == {"differing_builds": {"value": 0, "limit": 0}}


def test_each_dp_launch_is_counted_once():
    """Spans logs one entry a launch, also for the classes that inherit
    their launch (the al <= 32 classes), and puts every class back."""
    from miniprot_tpu_torch import tables
    from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
    from miniprot_tpu_torch.kernels import nasw_cigar_striped as st
    before = {c: vars(c).get("launch") for c in (
        sk._ScanBatch, sk.SmallScanCigarBatch, st._StripedBatch,
        st.SmallCigarBatch)}
    rng = np.random.default_rng(3)
    opt = (11, 1, 23, 29, 100, 5, 0.5)
    spans = core.Spans()
    try:
        for cls, w in ((sk.SmallScanCigarBatch, 32), (st.SmallCigarBatch, 32),
                       (sk.RawScanCigarBatch, 128), (st.RawCigarBatch, 128)):
            b = cls(w, 2048, tables.BLOSUM62, opt,
                    sp=tables.splice_model_scores(1), device="cpu")
            for _ in range(3):
                b.add_raw(rng.integers(0, 4, 200).astype(np.uint8),
                          rng.integers(0, 20, 30).astype(np.uint8), io=29)
            assert len(b.collect(b.launch())) == 3
    finally:
        spans.close()
    assert list(spans.launched) == ["cigar"]
    assert len(spans.launched["cigar"]) == 4
    for nl, al in spans.launched["cigar"]:
        assert nl.tolist() == [200] * 3 and al.tolist() == [30] * 3
    assert {c: vars(c).get("launch") for c in before} == before


def test_half_the_batch_left_out_is_caught(root, monkeypatch):
    from miniprot_tpu_torch import pipeline
    real = pipeline.map_batch_gpu

    def half(mi, opt, env, engine, batch, pool=None):
        return real(mi, opt, env, engine, batch[:len(batch) // 2], pool)
    monkeypatch.setattr(pipeline, "map_batch_gpu", half)
    r = _run(root)
    assert r["correct"] is False and r["failed"] > 0


def test_an_answer_altered_where_it_is_produced_is_caught(root,
                                                          monkeypatch):
    from miniprot_tpu_torch import pipeline
    real = pipeline.write_output

    def altered(mi, opt, name, seq, r, gid, hit_idx):
        s = real(mi, opt, name, seq, r, gid, hit_idx)
        return s.replace("\tmRNA\t", "\tmRNA\t1", 1)
    monkeypatch.setattr(pipeline, "write_output", altered)
    r = _run(root)
    assert r["correct"] is False and r["failed"] > 0


def test_a_dp_step_that_leaves_its_state_unchanged_is_caught(
        root, monkeypatch):
    import torch

    from miniprot_tpu_torch.kernels import nasw_ext

    def unchanged(nas, D, A, logpen, nlv, alv, prof, opts):
        # the result buffer as allocated, the DP never run
        return torch.zeros((nas.shape[0], 3), dtype=torch.int32)
    monkeypatch.setattr(nasw_ext, "ext_dp", unchanged)
    r = _run(root)
    assert r["correct"] is False and r["failed"] > 0


def test_no_card_no_result(tmp_path):
    """The measurement path without a card exits non-zero and prints no
    result line: it never falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "dm_ag.batch", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=core.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "cuda" in r.stderr.lower()


def test_without_the_port_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's own
    files cannot run: the port is not there (the look for a card is
    skipped, so the run gets as far as importing the port)."""
    shutil.copytree(os.path.join(core.ROOT, "portbench"),
                    tmp_path / "portbench")
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    code = ("from portbench import core; "
            f"spec = core.load_cell({str(tmp_path)!r}, 'dm_ag.batch'); "
            "core.run_cell(spec, 1, 1, False, device='cpu', "
            f"root={str(tmp_path)!r})")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "miniprot_tpu_torch" in r.stderr
