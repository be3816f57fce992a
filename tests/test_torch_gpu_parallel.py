"""The multi-process layer and the entry points on the card, at a small
size: entry() against its plain version and the host C engine,
dryrun_multichip(1) on NCCL, mesh_map_queries on a one-rank NCCL grid
with a GpuExtEngine on the card, and two CLI --shards processes sharing
the card, each output byte-identical to the host engine's.

Marked ``gpu``: they need an NVIDIA card of compute capability >= 9.0
and skip elsewhere.  Run on the card with

    python -m pytest -m gpu tests/test_torch_gpu_parallel.py
"""
import datetime
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_card():
    from miniprot_tpu_torch.kernels import on_gpu_backend
    if not on_gpu_backend():
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    return torch.device("cuda")


@pytest.fixture
def workload(tmp_path):
    from miniprot_tpu_torch.testgen import make_workload
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=400_000, n_genes=10, seed=17, n_ctg=2,
                  max_intron=4000, rev_frac=0.5)
    return fa, faa


def test_entry_on_card_matches_plain_and_host(cuda_card):
    from miniprot_tpu_torch import entry, kernels
    fn, args = entry.entry()
    kernels.reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ext_dp"] == 1
    assert kernels.launch_counts()["track_prep"] == 1
    pfn, pargs = entry.entry("cpu")
    assert torch.equal(got.cpu(), pfn(*pargs))
    rows = [(int(s), int(i) + 1, int(j) + 1) for s, i, j in got.tolist()]
    assert rows == entry.entry_reference()


def test_dryrun_multichip_one_card(cuda_card):
    from miniprot_tpu_torch import entry
    entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="one per rank"):
        entry.dryrun_multichip(torch.cuda.device_count() + 1)


def test_mesh_map_on_card_engine(cuda_card, workload, tmp_path):
    """A 1 x 1 NCCL grid: the two lookup passes on the card, the
    alignment rounds on the GpuExtEngine mesh_map_queries builds on the
    card by default; bytes equal to map_file on the host engine; the
    steps' device ms from CUDA events."""
    import torch.distributed as tdist

    from miniprot_tpu_torch import kernels
    from miniprot_tpu_torch.bseq import read_fastx
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.parallel import dist
    from miniprot_tpu_torch.pipeline import _emit_query, map_file
    fa, faa = workload
    mi = Index.build(fa, IdxOpt())
    opt = MapOpt()
    recs = list(read_fastx(faa))
    seqs = [np.frombuffer(r.seq, np.uint8) for r in recs]
    want = io.StringIO()
    map_file(mi, faa, opt, 1, out=want, device=None)
    tdist.init_process_group(
        "nccl", init_method="file://" + str(tmp_path / "store"),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = dist.make_mesh(1, 1)
        assert mesh.device.type == "cuda"
        kernels.reset_launch_counts()
        stats = {}
        regs = dist.mesh_map_queries(mesh, mi, seqs, opt, stats=stats)
        launches = kernels.launch_counts()
    finally:
        tdist.destroy_process_group()
    buf = io.StringIO()
    idc = [0]
    for rec, seq, r in zip(recs, seqs, regs):
        _emit_query(mi, opt, rec.name, seq, r, idc, buf)
    assert buf.getvalue() == want.getvalue()
    assert launches["ext_dp"] > 0 and launches["track_prep"] > 0
    assert stats["count_step_ms"] > 0 and stats["gather_step_ms"] > 0


def test_cli_shards_share_the_card(cuda_card, workload, tmp_path):
    """Two CLI shard processes on the one card (no --no-gpu): shard 0's
    merged output equals the single-process host-engine CLI's."""
    fa, faa = workload
    cmd = [sys.executable, "-m", "miniprot_tpu_torch.cli", "-t1"]
    single = subprocess.run(cmd + ["--no-gpu", fa, faa], cwd=ROOT,
                            capture_output=True, text=True, timeout=600)
    assert single.returncode == 0, single.stderr[-2000:]
    spool = str(tmp_path / "spool")
    out = str(tmp_path / "sharded.paf")
    procs = [subprocess.Popen(
        cmd + ["--shards", "2", "--shard-id", str(i), "--spool-dir", spool,
               *(["-o", out] if i == 0 else []), fa, faa],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
        assert "device /" in err   # the shard's DP split line
    with open(out) as f:
        assert f.read() == single.stdout
    assert os.path.getsize(out) > 0
