"""The opt-in route probe of the port's map_file (route_probe=True) and
the CLI's --route-probe and --profile-trace, on the CPU: the engine on
device="cpu" (the kernels' plain versions) against the host engine on a
small testgen workload, with the probe's gates shrunk, its clock faked
to pick the winner and its cache moved to a temporary directory.
Whichever engine wins, the output is byte-identical to
miniprot_tpu.pipeline.map_file(use_tpu=False)."""
import io
import json
import os
import time

import pytest

from miniprot_tpu import index as jidx
from miniprot_tpu import options as jopt
from miniprot_tpu import pipeline as jpipe
from miniprot_tpu_torch import cli, device
from miniprot_tpu_torch import pipeline as tpipe
from miniprot_tpu_torch.bseq import read_fastx
from miniprot_tpu_torch.index import Index
from miniprot_tpu_torch.options import F_SHOW_UNMAP, IdxOpt, MapOpt


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """An 8-protein testgen workload, its port index and miniprot_tpu's
    host-engine output at -G 4k -u."""
    from miniprot_tpu_torch.testgen import make_workload
    d = tmp_path_factory.mktemp("route")
    fa, faa = str(d / "g.fa"), str(d / "q.faa")
    make_workload(fa, faa, genome_len=160_000, n_genes=9, seed=7, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    o = jopt.MapOpt()
    o.flag |= F_SHOW_UNMAP
    o.bw = o.max_intron = 4000
    buf = io.StringIO()
    jpipe.map_file(jidx.Index.build(fa, jopt.IdxOpt()), faa, o, n_threads=1,
                   out=buf, use_tpu=False)
    names = [r.name for r in read_fastx(faa)]
    return fa, faa, Index.build(fa, IdxOpt()), buf.getvalue(), names


def _opt():
    o = MapOpt()
    o.flag |= F_SHOW_UNMAP
    o.bw = o.max_intron = 4000
    return o


@pytest.fixture
def probe(monkeypatch, tmp_path):
    """Probe gates shrunk to this workload (blocks of 2 queries per
    engine), the cache in tmp_path; returns (cache path, set_clock):
    set_clock(t_dev, t_host) makes the probe read those seconds."""
    monkeypatch.setattr(tpipe, "ROUTE_MIN_BATCH", 6)
    monkeypatch.setattr(tpipe, "ROUTE_BLOCK_MIN", 2)
    cache = str(tmp_path / "cache" / "route.json")
    monkeypatch.setattr(tpipe, "_route_cache_path", lambda: cache)

    def set_clock(t_dev, t_host):
        ticks = iter([0.0, t_dev, 100.0, 100.0 + t_host])
        monkeypatch.setattr(tpipe, "_clock", lambda: next(ticks))

    return cache, set_clock


def _map(workload, **kw):
    _, faa, mi, _, _ = workload
    buf, stats = io.StringIO(), {}
    tpipe.map_file(mi, faa, _opt(), n_threads=1, out=buf, device="cpu",
                   stats=stats, route_probe=True, **kw)
    return buf.getvalue(), stats


def _names_in_order(out):
    """Query names in the order the output first shows them."""
    seen: list = []
    for ln in out.splitlines():
        if ln.startswith("##"):
            continue
        if not seen or seen[-1] != ln.split("\t")[0]:
            seen.append(ln.split("\t")[0])
    return seen


@pytest.mark.parametrize("winner", ["device", "host"])
def test_probe_output_byte_identical_whichever_engine_wins(
        workload, probe, winner):
    cache, set_clock = probe
    set_clock(1.0, 2.0) if winner == "device" else set_clock(2.0, 1.0)
    out, stats = _map(workload)
    assert out == workload[3]
    # every query once, in input order (-u prints the unmapped ones)
    assert _names_in_order(out) == workload[4]
    assert stats["route_choice"] == winner and not stats["route_cached"]
    assert (stats["route_probe_device_s"], stats["route_probe_host_s"]) \
        == ((1.0, 2.0) if winner == "device" else (2.0, 1.0))
    with open(cache) as f:
        assert json.load(f)["choice"] == winner


def test_decisive_outcome_is_cached_and_read_without_probing(
        workload, probe, monkeypatch):
    cache, set_clock = probe
    set_clock(3.0, 1.0)                  # host 3x faster: decisive
    _map(workload)
    assert os.path.exists(cache)

    def no_probe(*a, **k):
        raise AssertionError("probed despite a cached decision")

    monkeypatch.setattr(tpipe, "_route_probe", no_probe)
    out, stats = _map(workload)
    assert out == workload[3]
    assert stats["route_cached"] and stats["route_choice"] == "host"
    assert "route_probe_device_s" not in stats


def test_near_tie_is_not_cached(workload, probe):
    cache, set_clock = probe
    set_clock(1.1, 1.0)                  # within ROUTE_CACHE_MARGIN
    out, stats = _map(workload)
    assert out == workload[3] and stats["route_choice"] == "host"
    assert not os.path.exists(cache)


def test_stale_cache_entry_is_ignored(workload, probe):
    cache, set_clock = probe
    os.makedirs(os.path.dirname(cache))
    with open(cache, "w") as f:
        json.dump({"ts": time.time() - tpipe.ROUTE_CACHE_TTL_S - 60,
                   "t_dev": 1.0, "t_host": 9.0, "choice": "device"}, f)
    set_clock(4.0, 1.0)
    out, stats = _map(workload)
    assert out == workload[3]
    assert stats["route_choice"] == "host" and not stats["route_cached"]
    with open(cache) as f:
        assert json.load(f)["choice"] == "host"


def test_probe_runs_only_on_the_first_new_batch_under_ckpt(
        workload, probe, monkeypatch, tmp_path):
    """Two mini-batches of 3 queries or more (-K); the probe takes the first
    batch of a fresh run, and of a run resumed after batch 0 the first
    batch it maps (batch 1); the output is byte-identical either way."""
    cache, set_clock = probe
    calls: list = []
    real = tpipe._route_probe

    def counted(mi, opt, env, engine, part, *a):
        calls.append(len(part))
        set_clock(2.0, 1.0)
        return real(mi, opt, env, engine, part, *a)

    monkeypatch.setattr(tpipe, "_route_probe", counted)
    monkeypatch.setattr(tpipe, "_route_cache_store", lambda *a: None)
    monkeypatch.setattr(tpipe, "ROUTE_MIN_BATCH", 3)
    _, faa, mi, want, _ = workload
    o = _opt()
    o.mini_batch_size = sum(len(r.seq) for r in read_fastx(faa)) // 2
    path, ckpt = str(tmp_path / "out.paf"), str(tmp_path / "out.ckpt")
    with open(path, "w+") as f:
        tpipe.map_file(mi, faa, o, out=f, device="cpu", ckpt=ckpt,
                       route_probe=True)
    with open(ckpt) as f:
        journal = f.read().splitlines()
    n0 = int(journal[0].split("\t")[1])
    n1 = int(journal[1].split("\t")[1]) - n0
    assert n1 >= 3
    assert calls == [min(2 * max(2, n0 // 3), n0)]
    assert open(path).read() == want
    # resume after batch 0: the probe takes batch 1
    with open(ckpt, "w") as f:
        f.write(journal[0] + "\n")
    calls.clear()
    with open(path, "r+") as f:
        tpipe.map_file(mi, faa, o, out=f, device="cpu", ckpt=ckpt,
                       route_probe=True)
    assert calls == [min(2 * max(2, n1 // 3), n1)]
    assert open(path).read() == want


def test_device_error_raises_and_is_not_cached(workload, probe, monkeypatch):
    cache, set_clock = probe
    set_clock(1.0, 5.0)

    def broken(self, batch):
        raise RuntimeError("mp_ext_dp: CUDA error 700")

    monkeypatch.setattr(device.GpuExtEngine, "_launch", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _map(workload)
    assert not os.path.exists(cache)


def test_route_probe_needs_a_device_engine(workload):
    _, faa, mi, _, _ = workload
    with pytest.raises(ValueError, match="needs a device"):
        tpipe.map_file(mi, faa, _opt(), out=io.StringIO(), device=None,
                       route_probe=True)


def test_cli_route_probe_reaches_map_file_on_the_card(workload, monkeypatch):
    fa, faa = workload[:2]
    seen: list = []
    monkeypatch.setattr(cli, "map_file",
                        lambda *a, **k: seen.append(k) or 0)
    assert cli.main([fa, faa, "--route-probe"]) == 0
    assert seen[0]["route_probe"] is True and seen[0]["device"] == "cuda"
    seen.clear()
    assert cli.main([fa, faa]) == 0
    assert seen[0]["route_probe"] is False


def test_cli_route_probe_with_no_gpu_is_a_usage_error(workload, capsys):
    fa, faa = workload[:2]
    assert cli.main(["--no-gpu", "--route-probe", fa, faa]) == 1
    assert "--no-gpu" in capsys.readouterr().err


def test_cli_profile_trace_on_host_engine(workload, tmp_path):
    """--profile-trace DIR with --no-gpu writes DIR/trace.json (a Chrome
    trace of the host side) and leaves the output as it is."""
    fa, faa = workload[:2]
    plain, traced = str(tmp_path / "a.paf"), str(tmp_path / "b.paf")
    tdir = tmp_path / "trace"
    assert cli.main(["--no-gpu", "-t1", "-o", plain, fa, faa]) == 0
    assert cli.main(["--no-gpu", "-t1", "-o", traced,
                     f"--profile-trace={tdir}", fa, faa]) == 0
    assert open(plain).read() == open(traced).read()
    with open(tdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    # the profiler's spans are on for the traced map, and off after it
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"map", "map.read_wait", "map.teardown"} <= spans
    from miniprot_tpu_torch.sysutil import profiler
    assert not profiler.enabled
