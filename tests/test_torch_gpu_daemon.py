"""The device daemon on the card, at a small size: a daemon process that
owns the card serves an ext batch and a scan batch with the results of
a direct launch, and a CLI process that maps through it gives the host
engine's bytes without ever initializing CUDA.

Marked ``gpu``: they need an NVIDIA card of compute capability >= 9.0
and skip elsewhere.  Run on the card with

    python -m pytest -m gpu tests/test_torch_gpu_daemon.py
"""
import io
import os
import pathlib
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


@pytest.fixture
def cuda_card():
    from miniprot_tpu_torch.kernels import on_gpu_backend
    if not on_gpu_backend():
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    return torch.device("cuda")


@pytest.fixture
def card_daemon(cuda_card, tmp_path):
    """A daemon process on the card, on a socket under tmp_path."""
    from miniprot_tpu_torch.daemon import DaemonClient
    sock = str(tmp_path / "d.sock")
    err = open(sock + ".err", "w")
    proc = subprocess.Popen([sys.executable, "-m", "miniprot_tpu_torch.daemon",
                             "--socket", sock], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while True:
            assert proc.poll() is None, open(sock + ".err").read()
            try:
                DaemonClient.connect(sock, probe_only=True).close()
                break
            except ConnectionError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        yield sock
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def _batches(dev):
    from miniprot_tpu_torch import tables
    from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
    from miniprot_tpu_torch.kernels import nasw_ext as ne
    rng = np.random.default_rng(3)
    mat = tables.BLOSUM62.copy()
    tables.set_stop_sc(mat, 23)
    sp = tables.splice_model_scores(1)
    scal = (11, 1, 23, 29, 100, 5, 0.5)
    ext = ne.RawExtBatch(128, 2112, mat, scal, sp=sp, device=dev,
                         capacity=64)
    scan = sk.RawScanCigarBatch(128, 4096, mat, scal, sp=sp, device=dev)
    for k in range(64):
        ext.add_raw(rng.integers(0, 4, int(rng.integers(1100, 2100))
                                 ).astype(np.int8),
                    rng.integers(0, 20, int(rng.integers(30, 128))
                                 ).astype(np.int8), io=29,
                    ext_left=bool(k % 2))
    for _ in range(40):
        scan.add_raw(rng.integers(0, 4, int(rng.integers(600, 4000))
                                  ).astype(np.int8),
                     rng.integers(0, 20, int(rng.integers(33, 128))
                                  ).astype(np.int8), io=29)
    return ext, scan


def test_daemon_on_card_serves_ext_and_scan_like_a_direct_launch(
        card_daemon, cuda_card):
    from miniprot_tpu_torch.daemon import DaemonClient
    ext, scan = _batches(cuda_card)
    want = [pickle.loads(pickle.dumps(b)).run() for b in (ext, scan)]
    c = DaemonClient.connect(card_daemon)
    try:
        assert c.info["device_type"] == "cuda"
        assert tuple(c.info["capability"]) >= (9, 0)
        before = c.info["launches"]
        got, card_s, _ = c.collect(c.launch_many([ext, scan]))
        after = c.ping()["launches"]
    finally:
        c.close()
    assert got[0] == want[0]
    assert all(g[0] == w[0] and np.array_equal(g[1], w[1])
               for g, w in zip(got[1], want[1]))
    assert card_s > 0
    for k in ("track_prep", "ext_dp", "scan_cigar_dp", "run_walk"):
        assert after[k] > before[k], k


CLIENT = r"""
import sys
import torch
from miniprot_tpu_torch import cli
rc = cli.main(sys.argv[1:])
print("CUDA", torch.cuda.is_initialized())
sys.exit(rc)
"""


def test_client_maps_through_the_daemon_without_cuda(card_daemon, tmp_path):
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.pipeline import map_file
    from miniprot_tpu_torch.testgen import make_workload
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=400_000, n_genes=10, seed=17,
                  n_ctg=2, max_intron=4000, rev_frac=0.5)
    mi = Index.build(fa, IdxOpt())
    mpi = str(tmp_path / "g.mpi")
    mi.dump(mpi)
    buf = io.StringIO()
    map_file(mi, faa, MapOpt(), 1, out=buf, device=None)
    out = str(tmp_path / "out.paf")
    env = dict(os.environ, MINIPROT_TPU_DAEMON_SOCK=card_daemon)
    env.pop("MINIPROT_TPU_DAEMON", None)
    r = subprocess.run([sys.executable, "-c", CLIENT, mpi, faa, "-o", out],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr
    assert "CUDA False" in r.stdout
    with open(out) as f:
        assert f.read() == buf.getvalue()
