"""The profiler's spans and the engine's launched-work counters on CPU
maps (device="cpu": the kernels' plain PyTorch versions): which spans a
map records, how the pump's children cover its rounds, that a span
costs nothing while the profiler is off, that the main thread's spans
reach a torch.profiler trace, and that the engine's counts equal the
lengths of every launched batch.  The genome is the size
test_torch_e2e.py maps, with four genes: the plain kernels take about
a second a batch here."""

import io
import json

import numpy as np
import pytest
import torch

from miniprot_tpu_torch import pipeline, sysutil
from miniprot_tpu_torch import index as tidx
from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
from miniprot_tpu_torch.kernels import nasw_cigar_striped as st
from miniprot_tpu_torch.kernels import nasw_ext as nk
from miniprot_tpu_torch.options import F_GFF, IdxOpt, MapOpt
from miniprot_tpu_torch.sysutil import LAUNCHED_FIELDS, profiler

# the batch classes that define ``launch``: (class, recurrence, the
# attribute holding the query lengths)
LAUNCHERS = ((nk.ExtBatch, "ext", "als"), (nk.RawExtBatch, "ext", "als"),
             (sk._ScanBatch, "cigar", "alv"),
             (st._StripedBatch, "cigar", "alv"),
             (st.Dp32Batch, "cigar32", "alv"))

# the pump's spans that no other pump span holds (engine.drain and
# engine.host_dp.cig_spsc_donor run inside engine.pack)
PUMP_CHILDREN = ("pump.prime", "pump.submit", "pump.advance", "engine.pack",
                 "engine.wave", "engine.join", "engine.decode",
                 "engine.scatter")
NESTED_HOST_DP = ("engine.host_dp.cig_spsc_donor",)


def _opt():
    o = MapOpt()
    o.flag |= F_GFF
    o.bw = o.max_intron = 4000
    return o


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    from miniprot_tpu_torch.testgen import make_workload
    d = tmp_path_factory.mktemp("spans")
    fa, faa = str(d / "g.fa"), str(d / "q.faa")
    make_workload(fa, faa, genome_len=300_000, n_genes=4, seed=7, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    return tidx.Index.build(fa, IdxOpt()), faa, d


@pytest.fixture(scope="module")
def traced(genome):
    """One map with the profiler on and a probe on every batch class's
    launch: the stages, the map's stats, the probe's log, and the
    profiler's device counts."""
    mi, faa, _ = genome
    was = profiler.enabled
    profiler.enabled = True
    profiler.reset()
    probe: list = []
    real = {cls: vars(cls)["launch"] for cls, _, _ in LAUNCHERS}

    def probed(cls, kind, al_attr):
        def launch(batch, *a, **kw):
            n = batch.n
            probe.append((kind, np.array(batch.nlv[:n], np.int64),
                          np.array(getattr(batch, al_attr)[:n], np.int64),
                          batch.nl * batch.al * n))
            return real[cls](batch, *a, **kw)
        return launch

    stats: dict = {}
    try:
        for cls, kind, al_attr in LAUNCHERS:
            cls.launch = probed(cls, kind, al_attr)
        pipeline.map_file(mi, faa, _opt(), n_threads=1, out=io.StringIO(),
                          device="cpu", stats=stats)
    finally:
        for cls, _, _ in LAUNCHERS:
            cls.launch = real[cls]
    try:
        yield dict(stages=dict(profiler.stages), stats=stats, probe=probe,
                   cells_device=profiler.cells_device,
                   launched=dict(profiler.launched))
    finally:
        profiler.enabled = was
        profiler.reset()


def test_every_span_on_the_path_has_seconds(traced):
    st_, stats = traced["stages"], traced["stats"]
    names = ["map", "pool_start", "map.read_wait", "map.teardown",
             "pre_align", "pre_align_wait", "align_rounds", "finish_align",
             "emit", "pump.prime", "pump.submit", "pump.advance",
             "engine.pack", "engine.launch", "engine.wave", "engine.join",
             "engine.decode", "engine.scatter"]
    names += ["engine.host_dp." + r for r in stats["host_reasons"]]
    assert stats["host_reasons"] and stats["n_device"] > 0
    for name in names:
        assert st_.get(name, 0.0) > 0, name


def test_pump_children_cover_align_rounds(traced):
    st_ = traced["stages"]
    children = sum(st_.get(k, 0.0) for k in PUMP_CHILDREN)
    children += sum(v for k, v in st_.items()
                    if k.startswith("engine.host_dp.")
                    and k not in NESTED_HOST_DP)
    rounds, wait = st_["align_rounds"], st_["pre_align_wait"]
    assert children + wait <= rounds + wait + 1e-9
    assert children >= 0.8 * rounds


def test_profiler_off_records_nothing(genome, monkeypatch):
    mi, faa, _ = genome

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the "
                             "profiler off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    was = profiler.enabled
    profiler.enabled = False
    try:
        profiler.reset()
        stats: dict = {}
        pipeline.map_file(mi, faa, _opt(), n_threads=1, out=io.StringIO(),
                          device="cpu", stats=stats)
        assert profiler.stages == {}
        # the counters stay on
        assert stats["launched"]["ext"]["problems"] > 0
        assert profiler.span("x") is profiler.span("y")
    finally:
        profiler.enabled = was
        profiler.reset()


def test_main_thread_spans_reach_the_trace_inside_map(genome, monkeypatch,
                                                      tmp_path):
    """Under torch.profiler (CPU).  Every DP is routed to the host here:
    the plain kernels' own operations would fill the trace (hundreds of
    MB a batch)."""
    from miniprot_tpu_torch import device
    monkeypatch.setattr(device, "MIN_DEVICE_NL", 1 << 30)
    monkeypatch.setattr(device, "CIG_MIN_NL", 1 << 30)
    mi, faa, _ = genome
    was = profiler.enabled
    profiler.enabled = True
    try:
        profiler.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pipeline.map_file(mi, faa, _opt(), n_threads=1,
                              out=io.StringIO(), device="cpu")
        stages = dict(profiler.stages)
    finally:
        profiler.enabled = was
        profiler.reset()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = [e for e in events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    maps = [e for e in ann if e["name"] == "map"]
    assert len(maps) == 1
    m0 = float(maps[0]["ts"])
    m1 = m0 + float(maps[0]["dur"])
    names = {e["name"] for e in ann}
    for name in ("pump.prime", "pump.submit", "pump.advance", "engine.pack",
                 "engine.host_dp.ext_short", "engine.host_dp.cig_short",
                 "engine.wave", "engine.join", "engine.scatter",
                 "finish_align", "emit", "map.read_wait", "pool_start",
                 "pre_align_wait", "map.teardown"):
        assert name in names, name
    # every span but the teardown, which follows it, lies inside map
    for e in ann:
        if e["name"] not in ("map", "map.teardown"):
            assert m0 <= float(e["ts"]) and (
                float(e["ts"]) + float(e["dur"]) <= m1), e["name"]
    # the producer thread's span is stage seconds only
    assert "pre_align" not in names and stages["pre_align"] > 0


def test_launched_counts_equal_every_launch(traced):
    want: dict = {}
    for kind, nl, al, padded in traced["probe"]:
        c = want.setdefault(kind, [0, 0, 0, 0])
        c[0] += len(nl)
        c[1] += int(np.sum(nl * al))
        c[2] += int(np.sum(nl + al))
        c[3] += padded
    got = traced["stats"]["launched"]
    assert set(got) == set(want) >= {"ext", "cigar"}
    for kind, c in want.items():
        assert got[kind] == dict(zip(LAUNCHED_FIELDS, c)), kind
    assert traced["launched"] == want


def test_unpadded_at_most_padded(traced):
    for kind, c in traced["stats"]["launched"].items():
        assert 0 < c["cells"] <= c["padded_cells"], kind


def test_padded_sum_is_the_device_cell_count(traced):
    padded = sum(c["padded_cells"]
                 for c in traced["stats"]["launched"].values())
    assert padded == traced["cells_device"]
    assert padded == sum(p for *_, p in traced["probe"])


def test_host_dp_seconds_by_reason(traced):
    stats = traced["stats"]
    assert set(stats["host_dp_s_by_reason"]) == set(stats["host_reasons"])
    assert all(v > 0 for v in stats["host_dp_s_by_reason"].values())
    assert sum(stats["host_dp_s_by_reason"].values()) == pytest.approx(
        stats["host_dp_s"])


def test_span_seconds_land_in_their_stage():
    p = sysutil.Profiler()
    with p.span("a"):
        pass
    assert p.stages == {}
    p.enabled = True
    with p.span("a") as s:
        pass
    with p.span("a"):
        pass
    assert p.stages["a"] >= s.dt >= 0
    with pytest.raises(ValueError):
        with p.span("b"):
            raise ValueError("raised inside")
    assert "b" in p.stages
