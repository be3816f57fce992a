"""The port's shard runner (miniprot_tpu_torch.parallel.runner) and the
CLI's --shards flags on the CPU, mirroring tests/test_multiprocess.py:
shard processes on a gloo process group (the torch.distributed barrier)
or independent CLI processes over a spool directory (the filesystem
barrier) emit bytes identical to the single-process map_file, the
merged output equals the JAX package's runner on the same files, a
shard's spool is the same from the engine's plain kernels and from the
host engine, and an engine error raises out of the shard."""
import io
import os
import pathlib
import pickle
import subprocess
import sys

import pytest

from miniprot_tpu_torch import cli
from miniprot_tpu_torch import device as tdev
from miniprot_tpu_torch import options as topt
from miniprot_tpu_torch.index import Index
from miniprot_tpu_torch.options import F_GFF, F_GTF, IdxOpt, MapOpt
from miniprot_tpu_torch.parallel import runner
from miniprot_tpu_torch.pipeline import map_file
from miniprot_tpu_torch.testgen import make_workload

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
FLAGS = {"paf": 0, "gff": F_GFF, "gtf": F_GTF}


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_all(cmds, timeout=TIMEOUT_S):
    """Start every command at once; wait for each with a time limit (a
    hung process fails the test) and return [(rc, stdout, stderr)]."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _golden(mpi, faa, flag):
    mi = Index.load(mpi, IdxOpt())
    opt = MapOpt()
    opt.flag |= flag
    buf = io.StringIO()
    map_file(mi, faa, opt, 1, out=buf, device=None)
    return buf.getvalue()


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """test_multiprocess.py's 600 kb workload, its index dumped once."""
    d = tmp_path_factory.mktemp("shards")
    fa, faa = str(d / "g.fa"), str(d / "q.faa")
    make_workload(fa, faa, genome_len=600_000, n_genes=12, seed=3, n_ctg=2,
                  max_intron=5000, rev_frac=0.3)
    mpi = str(d / "g.mpi")
    Index.build(fa, IdxOpt()).dump(mpi)
    return fa, faa, mpi


MAP_WORKER = r"""
import datetime, os, sys
import torch.distributed as tdist
from miniprot_tpu_torch.index import Index
from miniprot_tpu_torch.options import IdxOpt, MapOpt
from miniprot_tpu_torch.parallel.runner import map_file_multihost

pid, NP = int(sys.argv[1]), int(sys.argv[2])
mpi, faa, out_path, spool, init = sys.argv[3:8]
flag = int(sys.argv[8])
tdist.init_process_group("gloo", init_method=init, world_size=NP, rank=pid,
                         timeout=datetime.timedelta(seconds=60))
try:
    mi = Index.load(mpi, IdxOpt())
    opt = MapOpt()
    opt.flag |= flag
    with open(out_path if pid == 0 else os.devnull, "w") as out:
        map_file_multihost(mi, faa, opt, pid, NP, spool, out, device=None)
finally:
    tdist.destroy_process_group()
print("MAP-OK-" + str(pid), flush=True)
"""


def _gloo_shards(tmp_path, mpi, faa, n_proc, flag):
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    out_path = str(tmp_path / "mp.out")
    init = "file://" + str(tmp_path / "store")
    outs = _run_all([[sys.executable, "-c", MAP_WORKER, str(i), str(n_proc),
                      mpi, faa, out_path, spool, init, str(flag)]
                     for i in range(n_proc)])
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"MAP-OK-{i}" in out, (out, err[-2000:])
    with open(out_path) as f:
        return f.read()


@pytest.mark.parametrize("n_proc,mode", [(2, "paf"), (4, "paf"),
                                         (2, "gff"), (4, "gff"),
                                         (4, "gtf")])
def test_multi_process_mapping_matches_single(tmp_path, workload, n_proc,
                                              mode):
    """Shard processes on a gloo process group (the torch.distributed
    barrier) with the streaming k-way spool merge on process 0 are
    byte-identical to the single-process map_file: PAF through the
    parallel emit, GFF/GTF through the two-phase deferred ids."""
    _, faa, mpi = workload
    got = _gloo_shards(tmp_path, mpi, faa, n_proc, FLAGS[mode])
    assert got == _golden(mpi, faa, FLAGS[mode])


def test_eight_process_gff_two_phase_emit(tmp_path):
    """8 shard processes, GFF, on a tandem-heavy workload of thousands
    of records: any id-splice off-by-one in the two-phase emit would
    surface."""
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=4_000_000, n_genes=210, seed=11,
                  n_ctg=3, max_intron=4000, rev_frac=0.3, tandem_frac=0.7)
    mpi = str(tmp_path / "g.mpi")
    Index.build(fa, IdxOpt()).dump(mpi)
    golden = _golden(mpi, faa, F_GFF)
    n_records = sum(1 for ln in golden.splitlines()
                    if ln and not ln.startswith("##"))
    assert n_records >= 2000, n_records   # the stream must be heavy
    assert _gloo_shards(tmp_path, mpi, faa, 8, F_GFF) == golden


def test_cli_shards_match_single(tmp_path):
    """--shards/--shard-id/--spool-dir (independent processes over a
    shared spool directory, the filesystem barrier) give the plain CLI's
    bytes, and an existing spool is a checkpoint: a rerun of shard 0
    alone emits the same output."""
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=400_000, n_genes=8, seed=11, n_ctg=2,
                  max_intron=4000, rev_frac=0.4)
    cmd = [sys.executable, "-m", "miniprot_tpu_torch.cli", "--no-gpu", "-t1"]
    spool = str(tmp_path / "spool")
    out_path = str(tmp_path / "sharded.paf")
    n = 3
    outs = _run_all([cmd + [fa, faa]] + [
        cmd + ["--shards", str(n), "--shard-id", str(i), "--spool-dir",
               spool, *(["-o", out_path] if i == 0 else []), fa, faa]
        for i in range(n)])
    for rc, _, err in outs:
        assert rc == 0, err[-2000:]
    single = outs[0][1]
    assert all(not out for _, out, _ in outs[1:])  # shards write to -o only
    got = open(out_path).read()
    assert got == single
    assert got.count("\n") >= 8

    os.remove(out_path)
    assert cli.main(["--no-gpu", "-t1", "--shards", str(n), "--shard-id",
                     "0", "--spool-dir", spool, "-o", out_path, fa, faa]) == 0
    assert open(out_path).read() == single


@pytest.mark.parametrize("args", [
    ["--shards", "2"],
    ["--shards", "2", "--shard-id", "2", "--spool-dir", "SPOOL"],
    ["--shards", "2", "--shard-id", "-1", "--spool-dir", "SPOOL"],
    ["--shards", "2", "--spool-dir", "SPOOL", "EXTRA"],
    ["--shards", "2", "--spool-dir", "SPOOL", "--resume", "-o", "OUT"],
    ["--shards", "2", "--spool-dir", "SPOOL", "--route-probe"],
    ["--shards", "2", "--spool-dir", "SPOOL", "--profile-trace=TRACE"],
])
def test_cli_shard_usage_errors(tmp_path, workload, args):
    """A shard run without --spool-dir, with a shard id out of range,
    with two query files, with --resume, --route-probe or
    --profile-trace is a usage error (exit code 1), as in the JAX CLI
    (the last two: map_shard has neither a probe nor a trace)."""
    fa, faa, _ = workload
    sub = {"SPOOL": str(tmp_path / "spool"), "OUT": str(tmp_path / "o.paf")}
    argv = [sub.get(a, a).replace("TRACE", str(tmp_path / "tr"))
            for a in args if a != "EXTRA"]
    pos = [fa, faa] + ([faa] if "EXTRA" in args else [])
    assert cli.main([*argv, *pos]) == 1
    assert not os.path.exists(tmp_path / "o.paf")


def _load_spool(d):
    recs = []
    with open(runner.spool_path(d, 0), "rb") as f:
        while True:
            try:
                recs.append(pickle.load(f))
            except EOFError:
                return recs


@pytest.fixture
def small(tmp_path):
    """test_multiprocess.py:284's one-gene 24 kb workload; max_ext 1100
    keeps the plain kernels' rectangles small."""
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=24_000, n_genes=1, seed=9, n_ctg=1,
                  max_intron=900, max_exons=3, rev_frac=0.0)
    opt = MapOpt()
    opt.max_ext = 1100
    return Index.build(fa, IdxOpt()), faa, opt


def test_shard_engine_spool_matches_host(tmp_path, small):
    """map_shard(device="cpu") runs the shard's alignment DPs through the
    GpuExtEngine on the kernels' plain versions and spools the same
    records as the host-engine shard (device=None)."""
    mi, faa, opt = small
    d1, d2 = str(tmp_path / "s1"), str(tmp_path / "s2")
    os.makedirs(d1), os.makedirs(d2)
    n1 = runner.map_shard(mi, faa, opt, 0, 1, d1, device=None)
    n2 = runner.map_shard(mi, faa, opt, 0, 1, d2, device="cpu")
    assert n1 == n2 == 1
    assert _load_spool(d1) == _load_spool(d2)


def test_shard_engine_error_raises(tmp_path, small, monkeypatch):
    """An engine whose launch raises makes map_shard raise (no host
    fallback) and leaves no complete spool behind; a shard left to its
    default device, or a CLI shard without --no-gpu, asks for the card
    and fails where there is none instead of mapping on the host; a
    shard whose spool is already complete is skipped before it builds an
    engine."""
    mi, faa, opt = small

    def launch(self, batch):
        raise RuntimeError("mp_ext_dp: CUDA error 700")

    monkeypatch.setattr(tdev.GpuExtEngine, "_launch", launch)
    d = str(tmp_path / "s")
    os.makedirs(d)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        runner.map_shard(mi, faa, opt, 0, 1, d, device="cpu")
    assert not os.path.exists(runner.spool_path(d, 0))

    from miniprot_tpu_torch import kernels
    if kernels.on_gpu_backend():
        return
    fa = str(tmp_path / "g.fa")
    with pytest.raises(RuntimeError, match="compute capability"):
        cli.main(["--shards", "2", "--shard-id", "1", "--spool-dir", d, fa,
                  faa])
    with pytest.raises(RuntimeError, match="compute capability"):
        runner.map_file_multihost(mi, faa, opt, 1, 2, d, io.StringIO())
    assert not os.path.exists(runner.spool_path(d, 1))
    runner.map_shard(mi, faa, opt, 1, 2, d, device=None)
    assert runner.map_shard(mi, faa, opt, 1, 2, d, resume=True) == -1


@pytest.mark.parametrize("mode", ["paf", "gff"])
def test_merged_output_matches_jax_runner(tmp_path, workload, mode):
    """The port's map_file_multihost and the JAX package's, both in
    filesystem mode over 3 shards run in turn (shards 1 and 2 spool and
    return, shard 0 waits for the spools and emits), on the same files:
    the same bytes."""
    from miniprot_tpu import index as jidx
    from miniprot_tpu import options as jopt
    from miniprot_tpu.parallel import runner as jrunner
    fa, faa, mpi = workload
    flag = FLAGS[mode]

    def run(mod, mi, opt_mod, spool, **host):
        opt = opt_mod.MapOpt()
        opt.flag |= flag
        os.makedirs(spool)
        for pid in (1, 2, 0):
            buf = io.StringIO()
            mod.map_file_multihost(mi, faa, opt, pid, 3, spool, buf, **host)
        return buf.getvalue()

    want = run(jrunner, jidx.Index.build(fa, jopt.IdxOpt()), jopt,
               str(tmp_path / "jax"))
    got = run(runner, Index.load(mpi, IdxOpt()), topt, str(tmp_path / "port"),
              device=None)
    assert got == want and got.count("\n") >= 12


def test_emit_merged_refuses_a_foreign_spool(tmp_path):
    """emit_merged reads the 2- and 3-field records map_shard writes and
    raises on any other record instead of guessing its layout."""
    d = str(tmp_path)
    with open(runner.spool_path(d, 0), "wb") as f:
        pickle.dump((0, "q0\n"), f)
        pickle.dump((1, "q1", b"SEQ", []), f)
    with pytest.raises(ValueError, match="4 fields"):
        runner.emit_merged(MapOpt(), 1, d, io.StringIO())
