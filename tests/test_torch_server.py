"""The port's map server on the CPU (MapServer(device="cpu"): the GPU
engine on the kernels' plain versions) over test_torch_e2e.py's testgen
workload: its replies are the CLI's bytes, repeat requests give the same
bytes, an empty request an empty reply, and oversize or malformed
requests an #mpserve-error: line (the server keeps serving)."""
import threading

import pytest

from miniprot_tpu_torch import cli, server

FLAGS = ["--no-gpu", "-G4k", "-t1"]


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    from miniprot_tpu_torch.testgen import make_workload
    d = tmp_path_factory.mktemp("serve")
    fa, faa = str(d / "g.fa"), str(d / "q.faa")
    make_workload(fa, faa, genome_len=300_000, n_genes=10, seed=7, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    return fa, faa, d


@pytest.fixture(scope="module")
def srv(workload):
    fa, _, _ = workload
    parsed = cli.load_for_server([*FLAGS, fa])
    assert isinstance(parsed, tuple)
    mi, opt, n_threads, device = parsed
    assert device is None and n_threads == 1 and opt.max_intron == 4000
    s = server.MapServer(("127.0.0.1", 0), mi, opt, n_threads, device="cpu")
    t = threading.Thread(target=s.serve_forever, daemon=True)
    t.start()
    yield s
    s.shutdown()
    s.server_close()
    t.join(30)
    assert not t.is_alive()


def test_load_for_server_follows_gpu_flags(workload):
    fa, _, _ = workload
    assert cli.load_for_server(["-G4k", fa])[3] == "cuda"
    assert cli.load_for_server(["--no-gpu", fa])[3] is None
    assert cli.load_for_server([]) == 1


def test_server_matches_cli(srv, workload):
    fa, faa, d = workload
    out = str(d / "cli.paf")
    assert cli.main([*FLAGS, "-o", out, fa, faa]) == 0
    host, port = srv.server_address
    got = server.query(host, port, open(faa, "rb").read())
    want = open(out, "rb").read()
    assert got == want and want.count(b"\n") >= 10


def test_server_repeat_requests_give_same_bytes(srv, workload):
    _, faa, _ = workload
    host, port = srv.server_address
    payload = open(faa, "rb").read()
    assert server.query(host, port, payload) == server.query(host, port,
                                                             payload)


def test_server_empty_request(srv):
    host, port = srv.server_address
    assert server.query(host, port, b"") == b""


@pytest.mark.parametrize("case", ["oversize", "bad_gzip", "bad_header"])
def test_server_reports_bad_requests_and_keeps_serving(srv, workload,
                                                       monkeypatch, case):
    _, faa, _ = workload
    host, port = srv.server_address
    payload = open(faa, "rb").read()
    bad = {"oversize": payload, "bad_gzip": b"\x1f\x8b\x08garbage",
           "bad_header": b">\xff\xfe\nMKVL\n"}[case]
    if case == "oversize":
        monkeypatch.setattr(srv, "max_request", len(payload) // 3)
    with pytest.raises(RuntimeError, match="exceeds|Error"):
        server.query(host, port, bad)
    monkeypatch.undo()
    first = b"".join(open(faa, "rb").readlines()[:2])
    assert server.query(host, port, first).startswith(b"prot_c0_0\t")
