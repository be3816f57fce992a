"""The port's device daemon (miniprot_tpu_torch.daemon) on the CPU, held
against the JAX package's (miniprot_tpu.daemon) and its host engine.

A daemon started with ``--device cpu`` serves the kernels' plain PyTorch
versions on a private socket under tmp_path (never the default path:
other test processes' engines must not find it).  Its framing reads the
JAX daemon's messages and the other way round; real batches of every
family come back equal to a run in this process and to the host C
engine; a whole map through it is byte-identical to the JAX host map;
two clients share one plane budget; and every failure (a launch that
raises, a daemon killed mid-map, a named socket that does not answer, a
daemon that is not the port's) raises out of the map.  Every socket
wait and process wait has a time limit."""
import contextlib
import io
import os
import pathlib
import pickle
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from miniprot_tpu import daemon as jdaemon
from miniprot_tpu import index as jidx
from miniprot_tpu import native as jnative
from miniprot_tpu import options as jopt
from miniprot_tpu import pipeline as jpipe
from miniprot_tpu import tables as jtables
from miniprot_tpu.native import DPF_CIGAR, DPF_EXT_LEFT, DPF_EXT_RIGHT
from miniprot_tpu_torch import daemon as tdaemon
from miniprot_tpu_torch import device as tdev
from miniprot_tpu_torch import index as tidx
from miniprot_tpu_torch import kernels
from miniprot_tpu_torch import options as topt
from miniprot_tpu_torch import pipeline as tpipe
from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
from miniprot_tpu_torch.kernels import nasw_cigar_striped as st
from miniprot_tpu_torch.kernels import nasw_ext as ne
from test_torch_daemon_fixtures import BoomBatch, FakeBatch

ROOT = pathlib.Path(__file__).resolve().parents[1]
START_TIMEOUT_S = 60.0
WAIT_S = 30.0
OPT = (11, 1, 23, 29, 100, 5, 0.5)      # go ge fs io xdrop endb ie_coef


@pytest.fixture(autouse=True)
def _daemons_allowed(monkeypatch):
    """tests/conftest.py switches daemons off for every other test."""
    monkeypatch.setenv("MINIPROT_TPU_DAEMON", "1")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env.pop("MINIPROT_TPU_DAEMON_SOCK", None)
    return env


def _spawn(sock):
    """A daemon process on ``sock`` (stderr to a file beside it)."""
    err = open(str(sock) + ".err", "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "miniprot_tpu_torch.daemon", "--socket",
             str(sock), "--device", "cpu"],
            cwd=ROOT, env=_env(), stdout=subprocess.DEVNULL, stderr=err)
    finally:
        err.close()


def _wait_ready(proc, sock):
    deadline = time.monotonic() + START_TIMEOUT_S
    while True:
        assert proc.poll() is None, open(str(sock) + ".err").read()
        try:
            tdaemon.DaemonClient.connect(str(sock), timeout=5,
                                         probe_only=True).close()
            return
        except ConnectionError:
            pass
        assert time.monotonic() < deadline, "the daemon never answered"
        time.sleep(0.1)


def _reap(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=WAIT_S)


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """A daemon process serving the plain kernels on a private socket."""
    sock = tmp_path_factory.mktemp("dsock") / "d.sock"
    proc = _spawn(sock)
    try:
        _wait_ready(proc, sock)
        yield str(sock), proc
    finally:
        _reap(proc)


@contextlib.contextmanager
def _served(sock, **kw):
    """An in-process _Server on the CPU, serving on a thread."""
    srv = tdaemon._Server(str(sock), device="cpu", **kw)
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(str(sock)):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    try:
        yield srv
    finally:
        srv.stop.set()
        t.join(timeout=WAIT_S)
        assert not t.is_alive()


def _client(sock):
    return tdaemon.DaemonClient.connect(sock, timeout=10)


# ---- framing ----


def _roundtrip(send, recv, msg):
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    # the receiver reads while the sender writes: 3 MB overflows the
    # socket buffer and crosses _recv_exact's 1 MiB chunks
    t = threading.Thread(target=send, args=(a, msg))
    t.start()
    try:
        return recv(b)
    finally:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
        a.close()
        b.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_framing_interoperates_with_the_jax_daemon(direction):
    send, recv = ((tdaemon._send, jdaemon._recv) if direction == "port_to_jax"
                  else (jdaemon._send, tdaemon._recv))
    msg = ("launch_many", [np.arange(7, dtype=np.int16), (1, "two", None)],
           b"\x01" * 3_000_000)
    got = _roundtrip(send, recv, msg)
    assert got[0] == "launch_many" and got[2] == msg[2]
    np.testing.assert_array_equal(got[1][0], msg[1][0])
    assert got[1][1] == msg[1][1]


@pytest.mark.parametrize("impl", ["port", "jax"])
@pytest.mark.parametrize("fault", ["oversized", "mid_message"])
def test_framing_errors(impl, fault):
    """An oversized header and a peer that closes mid-message raise in
    both packages; a peer that closes between messages is a clean
    end (None)."""
    recv = tdaemon._recv if impl == "port" else jdaemon._recv
    a, b = socket.socketpair()
    b.settimeout(WAIT_S)
    try:
        if fault == "oversized":
            a.sendall(struct.pack(">Q", (1 << 31) + 1))
            with pytest.raises(ValueError, match="oversized"):
                recv(b)
        else:
            a.sendall(struct.pack(">Q", 100) + b"x" * 10)
            a.close()
            with pytest.raises(ConnectionError):
                recv(b)
            c, d = socket.socketpair()
            d.settimeout(WAIT_S)
            c.close()
            assert recv(d) is None
            d.close()
    finally:
        a.close()
        b.close()


# ---- ping, launch, collect ----


def test_ping_reports_the_port_device_and_budget(daemon):
    sock, proc = daemon
    c = _client(sock)
    try:
        info = c.ping()
    finally:
        c.close()
    assert info["package"] == "miniprot_tpu_torch"
    assert info["pid"] == proc.pid
    assert (info["device_type"], info["name"], info["capability"]) == (
        "cpu", "cpu", None)
    assert set(info["launches"]) == set(kernels.LAUNCHES)
    mem = info["memory"]
    assert mem > 0
    assert info["pending_cap"] == int(mem * tdev.PENDING_TB_FRACTION)
    assert info["batch_cap"] == int(mem * tdev.CIG_TB_FRACTION)
    assert info["inflight_tb"] == 0 and info["peak_tb"] >= 0
    assert info["warm"] is None


def _ext_case(rng, T, nl_pad):
    nl = int(rng.integers(10, nl_pad - 6))
    ns = rng.choice(list(b"ACGTN"), nl,
                    p=[.24, .24, .24, .24, .04]).astype(np.uint8)
    aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"),
                    int(rng.integers(1, 120))).astype(np.uint8)
    return ns, aa, bool(rng.integers(0, 2))


def _cig_case(rng, nl_hi, al_hi):
    ns = rng.choice(list(b"ACGTN"), int(rng.integers(3, nl_hi)),
                    p=[.24, .24, .24, .24, .04]).astype(np.uint8)
    aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"),
                    int(rng.integers(1, al_hi + 1))).astype(np.uint8)
    return ns, aa


def _batch(kind, rng):
    """(batch on the CPU, its problems, dp16 keywords) for one family."""
    T = jtables.get_tables(1)
    go = 0 if kind == "striped_go0" else OPT[0]
    mat = jtables.BLOSUM62.copy()
    jtables.set_stop_sc(mat, 23)
    sp = jtables.splice_model_scores(1)
    scal = (go, *OPT[1:])
    kw = dict(mat=mat, nt4=T.nt4, aa20=T.aa20, codon=T.codon, sp=sp,
              sp_null_bonus=-7, go=go, ge=1, io=29, fs=23, xdrop=100,
              end_bonus=5, ie_coef=0.5)
    if kind == "ext":
        b = ne.RawExtBatch(128, 264, mat, scal, sp=sp, trans_code=1,
                           device="cpu")
        cases = [_ext_case(rng, T, 264) for _ in range(8)]
        for ns, aa, left in cases:
            nt4, aas = T.nt4[ns], T.aa20[aa]
            if left:
                nt4, aas = nt4[::-1], aas[::-1]
            b.add_raw(nt4, aas, io=29, ext_left=left)
        return b, cases, kw
    cls, W, nl_pad, n = {"scan128": (sk.RawScanCigarBatch, 128, 256, 6),
                         "scan32": (sk.SmallScanCigarBatch, 32, 512, 40),
                         "striped_go0": (st.RawCigarBatch, 128, 256, 6)}[kind]
    b = cls(W, nl_pad, mat, scal, sp=sp, trans_code=1, device="cpu")
    cases = [_cig_case(rng, nl_pad - 24, W) for _ in range(n)]
    for ns, aa in cases:
        b.add_raw(T.nt4[ns], T.aa20[aa], io=29)
    return b, cases, kw


def _same(a, b):
    if isinstance(a, tuple) and len(a) == 2 and isinstance(a[1], np.ndarray):
        return a[0] == b[0] and np.array_equal(a[1], b[1])
    return a == b


@pytest.mark.parametrize("kind", ["ext", "scan128", "scan32",
                                  "striped_go0"])
def test_real_batches_through_the_daemon(daemon, kind):
    """launch_many + collect of a port batch: equal to batch.run() here
    and to the JAX package's host DP (miniprot_tpu.native.dp16)."""
    sock, _ = daemon
    b, cases, kw = _batch(kind, np.random.default_rng(
        {"ext": 1, "scan128": 2, "scan32": 3, "striped_go0": 4}[kind]))
    here = pickle.loads(pickle.dumps(b)).run()
    c = _client(sock)
    try:
        bids = c.launch_many([b])
        (remote,), card_s, wait_s = c.collect(bids)
    finally:
        c.close()
    assert card_s == 0.0 and wait_s >= 0.0      # no card events on the CPU
    assert len(remote) == len(cases) == len(here)
    assert all(_same(r, h) for r, h in zip(remote, here))
    for case, r in zip(cases, remote):
        if kind == "ext":
            ns, aa, left = case
            sc, ntl, aal, _ = jnative.dp16(
                ns, aa, flag=DPF_EXT_LEFT if left else DPF_EXT_RIGHT, **kw)
            assert r == (sc, ntl, aal)
        else:
            sc, _, _, cig = jnative.dp16(*case, flag=DPF_CIGAR, **kw)
            assert r[0] == sc and np.array_equal(r[1], cig)


def _flat(staged):
    if isinstance(staged, torch.Tensor):
        return [staged]
    return [t for x in staged for t in _flat(x)]


@pytest.mark.parametrize("kind", ["ext", "scan32"])
def test_wire_carries_only_the_rows_in_use(kind):
    """slim_for_wire trims a batch at capacity to its n rows: a fraction
    of the pickle, the same staged inputs (what launch() runs on), the
    same tb_bytes()."""
    rng = np.random.default_rng(9)
    T = jtables.get_tables(1)
    mat, sp = jtables.BLOSUM62, jtables.splice_model_scores(1)
    if kind == "ext":
        b = ne.RawExtBatch(128, 16896, mat, OPT, sp=sp, device="cpu",
                           capacity=512)
        for ns, aa, left in [_ext_case(rng, T, 264) for _ in range(2)]:
            b.add_raw(T.nt4[ns], T.aa20[aa], io=29, ext_left=left)
    else:
        b = sk.SmallScanCigarBatch(32, 2048, mat, OPT, sp=sp, device="cpu")
        for ns, aa in [_cig_case(rng, 200, 32) for _ in range(3)]:
            b.add_raw(T.nt4[ns], T.aa20[aa], io=29)
    full = pickle.dumps(b)
    tb = getattr(b, "tb_bytes", lambda: 0)()
    tdaemon.slim_for_wire(b)
    slim = pickle.dumps(b)
    assert len(slim) * 50 < len(full), (len(slim), len(full))
    assert getattr(b, "tb_bytes", lambda: 0)() == tb
    got = _flat(pickle.loads(slim).stage())
    want = _flat(pickle.loads(full).stage())
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---- a whole map ----


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """test_torch_e2e.py's workload at about half its size (one ext, one
    W=128 and one W=32 batch a map), both packages' indexes built
    once."""
    from miniprot_tpu_torch.testgen import make_workload
    d = tmp_path_factory.mktemp("dmap")
    fa, faa = str(d / "g.fa"), str(d / "q.faa")
    make_workload(fa, faa, genome_len=160_000, n_genes=5, seed=11, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    return (faa, jidx.Index.build(fa, jopt.IdxOpt()),
            tidx.Index.build(fa, topt.IdxOpt()))


def _opts(mod, flag):
    o = mod.MapOpt()
    o.flag |= flag
    o.bw = o.max_intron = 4000
    return o


def _jax_map(jmi, faa, flag):
    buf = io.StringIO()
    jpipe.map_file(jmi, faa, _opts(jopt, flag), n_threads=1, out=buf,
                   use_tpu=False)
    return buf.getvalue()


def _port_map(tmi, faa, flag):
    buf, stats = io.StringIO(), {}
    tpipe.map_file(tmi, faa, _opts(topt, flag), n_threads=1, out=buf,
                   device="cpu", stats=stats)
    return buf.getvalue(), stats


@pytest.mark.parametrize("fmt", ["paf", "gff"])
def test_map_through_the_daemon_is_byte_identical(daemon, workload, fmt,
                                                  monkeypatch):
    sock, _ = daemon
    faa, jmi, tmi = workload
    flag = topt.F_GFF if fmt == "gff" else 0
    monkeypatch.setenv("MINIPROT_TPU_DAEMON_SOCK", sock)
    got, stats = _port_map(tmi, faa, flag)
    assert got == _jax_map(jmi, faa, flag)
    assert got.count("\n") >= 4
    assert all(stats["batches"][k] > 0 for k in ("ext", "cig", "cig_small"))
    assert stats["daemon"] is True and stats["daemon_batches"] > 0
    assert stats["n_device"] > 0 and stats["device_fraction"] >= 0.90
    assert stats["daemon_peak_pending_tb"] <= stats["daemon_pending_cap"]
    assert stats["daemon_wait_s"] >= 0.0


# ---- the shared plane budget ----


def _cig_jobs(rng, n, nl, al):
    nt = np.frombuffer(b"ACGT", np.uint8)
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    return [(rng.choice(nt, int(rng.integers(*nl))),
             rng.choice(aa, int(rng.integers(*al)))) for _ in range(n)]


def test_two_clients_share_one_plane_budget(tmp_path, monkeypatch):
    """Two engines' rounds (two CIGAR batches each: W=128 and W=32) fit
    the daemon's cap one at a time, not together: the second client's
    last batch waits for room until the collects run, both collects
    (concurrent) finish, both results equal the host engine's, and the
    daemon's peak stays under its cap."""
    opt = topt.MapOpt()
    probe = tdev.GpuExtEngine(opt, "cpu")
    mem = tdev._memory_bytes(torch.device("cpu"))
    per = [probe.cig_shape(600, al) for al in (100, 20)]
    tb = sum(cls.planes_bytes(nl_b, sc * 8, tdev.cig_capacity(
        cls, nl_b, sc * 8, probe.cig_tb_cap))
        for cls, (sc, nl_b) in zip((sk.RawScanCigarBatch,
                                    sk.SmallScanCigarBatch), per))
    cap = tb * 3 // 2            # one round fits, two do not
    monkeypatch.setattr(tdaemon, "PENDING_TB_FRACTION", cap / mem)
    rng = np.random.default_rng(31)
    jobs = [_cig_jobs(rng, 3, (520, 700), (40, 120))
            + _cig_jobs(rng, 3, (520, 700), (5, 32)) for _ in range(2)]
    with _served(tmp_path / "d.sock") as srv:
        assert srv.pending_cap <= cap
        engines = [tdev.GpuExtEngine(opt, "cpu", daemon=srv.sock_path)
                   for _ in range(2)]
        assert all(e.pending_tb_cap == srv.pending_cap for e in engines)
        flights = []
        for e, js in zip(engines, jobs):
            e.submit(("cigars", [(ns, aa, None) for ns, aa in js]))
            flights.append(e.flush_begin())
        # the second client's last batch waits for room that only the
        # first client's collect gives back
        deadline = time.monotonic() + 120
        while srv.budget_waits < 1:
            assert time.monotonic() < deadline, "no batch waited for room"
            time.sleep(0.02)
        results = [None, None]

        def finish(k):
            results[k] = engines[k].flush_end(flights[k])

        threads = [threading.Thread(target=finish, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "a collect never finished"
        info = engines[0].client.ping()
        for e in engines:
            e.close()
    assert info["budget_waits"] >= 1
    assert 0 < info["peak_tb"] <= info["pending_cap"]
    assert info["inflight_tb"] == 0 and info["pending"] == 0
    env = probe.env
    for js, (res,) in zip(jobs, results):
        for (ns, aa), (sc, cig) in zip(js, res):
            hsc, _, _, hcig = env.dp(ns, aa, DPF_CIGAR)
            assert sc == hsc and np.array_equal(cig, hcig)


# ---- no fallback ----


def test_launch_error_raises_out_of_the_map(tmp_path, workload,
                                            monkeypatch):
    faa, _, tmi = workload

    def boom(self, staged=None):
        raise RuntimeError("boom-launch")

    monkeypatch.setattr(ne.RawExtBatch, "launch", boom)
    with _served(tmp_path / "d.sock") as srv:
        monkeypatch.setenv("MINIPROT_TPU_DAEMON_SOCK", srv.sock_path)
        with pytest.raises(RuntimeError, match="boom-launch"):
            _port_map(tmi, faa, 0)
        c = _client(srv.sock_path)
        try:
            info = c.ping()           # the daemon keeps serving
        finally:
            c.close()
    assert info["inflight_tb"] == 0


def test_daemon_killed_mid_map_raises(tmp_path, workload, monkeypatch):
    """The daemon dies with a round's batches launched: the wave's
    collect raises out of the map."""
    faa, _, tmi = workload
    sock = tmp_path / "d.sock"
    proc = _spawn(sock)
    try:
        _wait_ready(proc, sock)
        monkeypatch.setenv("MINIPROT_TPU_DAEMON_SOCK", str(sock))
        real_end = tdev.GpuExtEngine.flush_end

        def flush_end(self, fl):
            proc.kill()
            proc.wait(timeout=WAIT_S)
            return real_end(self, fl)

        monkeypatch.setattr(tdev.GpuExtEngine, "flush_end", flush_end)
        with pytest.raises(OSError):
            _port_map(tmi, faa, 0)
    finally:
        _reap(proc)


def test_named_socket_that_does_not_answer_raises(tmp_path, workload,
                                                  monkeypatch):
    faa, _, tmi = workload
    missing = str(tmp_path / "none.sock")
    monkeypatch.setenv("MINIPROT_TPU_DAEMON_SOCK", missing)
    with pytest.raises(ConnectionError, match="no daemon answers"):
        _port_map(tmi, faa, 0)
    stale = tmp_path / "stale.sock"
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(str(stale))
    s.close()                          # the file stays, nobody listens
    with pytest.raises(ConnectionError):
        tdev.GpuExtEngine(topt.MapOpt(), "cpu", daemon=str(stale))
    # unnamed, or switched off, a CPU engine never attaches
    monkeypatch.delenv("MINIPROT_TPU_DAEMON_SOCK")
    assert tdev.GpuExtEngine(topt.MapOpt(), "cpu").client is None
    monkeypatch.setenv("MINIPROT_TPU_DAEMON_SOCK", missing)
    monkeypatch.setenv("MINIPROT_TPU_DAEMON", "0")
    assert tdev.GpuExtEngine(topt.MapOpt(), "cpu").client is None


def test_port_client_refuses_a_jax_daemon(tmp_path):
    sock = str(tmp_path / "jax.sock")
    srv = jdaemon._Server(sock)
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + WAIT_S
        while not os.path.exists(sock):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        with pytest.raises(RuntimeError, match="not a miniprot_tpu_torch"):
            tdaemon.DaemonClient.connect(sock)
        with pytest.raises(RuntimeError, match="not a miniprot_tpu_torch"):
            tdev.GpuExtEngine(topt.MapOpt(), "cpu", daemon=sock)
    finally:
        srv.stop.set()
        t.join(timeout=WAIT_S)
    assert not t.is_alive()


def test_daemon_of_another_device_type_is_refused(daemon):
    sock, _ = daemon
    with pytest.raises(RuntimeError, match="serves cpu"):
        tdaemon.attach("cuda", sock)


def test_attached_engine_names_the_card_without_probing_it(tmp_path,
                                                           monkeypatch):
    """An engine on "cuda" attached to a daemon that owns the card takes
    the device and the plane budget from the daemon's ping and never
    asks torch.cuda anything (here the daemon is a CPU one that reports
    a card, and every torch.cuda query raises)."""
    with _served(tmp_path / "d.sock") as srv:
        real_ping = srv.op_ping
        monkeypatch.setattr(srv, "op_ping",
                            lambda: dict(real_ping(), device_type="cuda"))

        def no_probe(*a, **k):
            raise AssertionError("a daemon client probed the card")

        for name in ("is_available", "get_device_capability",
                     "get_device_properties", "init", "synchronize"):
            monkeypatch.setattr(torch.cuda, name, no_probe)
        eng = tdev.GpuExtEngine(topt.MapOpt(), "cuda",
                                daemon=srv.sock_path)
        assert eng.device == torch.device("cuda")
        assert eng.pending_tb_cap == srv.pending_cap
        rng = np.random.default_rng(12)
        jobs = _cig_jobs(rng, 3, (520, 700), (5, 120))
        ext = _cig_jobs(rng, 1, (1100, 1400), (30, 100))
        for ns, aa in ext:
            eng.submit(("ext", ns, aa, None, 29, False))
        eng.submit(("cigars", [(ns, aa, None) for ns, aa in jobs]))
        res = eng.flush()
        eng.close()
    for (ns, aa), r in zip(ext, res):
        sc, ntl, aal, _ = eng.env.dp(ns, aa, DPF_EXT_RIGHT, io=29)
        assert r == (sc, ntl, aal)
    for (ns, aa), (sc, cig) in zip(jobs, res[-1]):
        hsc, _, _, hcig = eng.env.dp(ns, aa, DPF_CIGAR)
        assert sc == hsc and np.array_equal(cig, hcig)
    assert eng.n_device == 4 and eng.n_host == 0


def test_daemon_without_a_card_exits_nonzero(tmp_path, capsys):
    """Without --device cpu the daemon needs an sm_90 card: here main()
    (what ``python -m miniprot_tpu_torch.daemon`` exits with) refuses to
    start and never serves the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    sock = tmp_path / "card.sock"
    assert tdaemon.main(["--socket", str(sock)]) != 0
    assert "compute capability" in capsys.readouterr().err
    assert not sock.exists()


# ---- housekeeping ----


def test_protocol_roundtrip_order_and_launch_errors(daemon):
    """Results come back in the order asked for; a launch error surfaces
    at collect, releases its room, and the daemon keeps serving."""
    sock, proc = daemon
    c = _client(sock)
    try:
        b1 = c.launch(FakeBatch([1, 2, 3]))
        b2, b3 = c.launch_many([FakeBatch([10, 20]), FakeBatch([5])])
        res, _, _ = c.collect([b3, b1, b2])
        assert res == [[11], [3, 5, 7], [21, 41]]
        bid = c.launch(BoomBatch([1], need=1 << 20))
        with pytest.raises(RuntimeError, match="boom-batch"):
            c.collect([bid])
        with pytest.raises(RuntimeError, match="unknown batch ids"):
            c.collect([bid])
        info = c.ping()
        assert info["pid"] == proc.pid and info["inflight_tb"] == 0
    finally:
        c.close()


def test_a_closed_client_drops_its_batches(daemon):
    """Batches a client launched and never collected are dropped when
    its connection closes, their room given back at once."""
    sock, _ = daemon
    c = _client(sock)
    c.launch_many([FakeBatch([1], need=1 << 20), FakeBatch([2], need=1)])
    c.close()
    c = _client(sock)
    try:
        deadline = time.monotonic() + WAIT_S
        while True:
            info = c.ping()
            if info["pending"] == 0 and info["inflight_tb"] == 0:
                break
            assert time.monotonic() < deadline, info
            time.sleep(0.05)
    finally:
        c.close()


def test_bench_with_a_bad_kind_is_an_error(daemon):
    sock, _ = daemon
    c = _client(sock)
    try:
        with pytest.raises(RuntimeError, match="unknown bench kind"):
            c.bench("nonsense")
        assert c.ping()["package"] == "miniprot_tpu_torch"
    finally:
        c.close()


def test_launchers_rpc_grows_the_pool(daemon):
    """Grows to the size asked for, never shrinks, and several launchers
    still admit and return batches in order."""
    sock, _ = daemon
    c = _client(sock)
    try:
        assert c.set_launchers(3) == 3
        assert c.set_launchers(2) == 3
        assert c.set_launchers(4) == 4
        bids = c.launch_many([FakeBatch([k], need=k) for k in range(8)])
        res, _, _ = c.collect(bids)
        assert res == [[2 * k + 1] for k in range(8)]
        assert c.ping()["launchers"] == 4
    finally:
        c.close()


def test_idle_exit(tmp_path, capsys):
    sock = tmp_path / "idle.sock"
    rc = []
    t = threading.Thread(target=lambda: rc.append(tdaemon.main(
        ["--socket", str(sock), "--device", "cpu", "--idle-exit", "0.5"])))
    t.start()
    t.join(timeout=WAIT_S)
    assert not t.is_alive() and rc == [0]
    assert "idle-exit" in capsys.readouterr().err
    assert not sock.exists()


def test_stop_shuts_the_daemon_down(tmp_path):
    sock = str(tmp_path / "stop.sock")
    with _served(sock) as srv:
        assert tdaemon.main(["--socket", sock, "--stop"]) == 0
        assert srv.stop.wait(timeout=WAIT_S)
    assert tdaemon.main(["--socket", sock, "--stop"]) == 1


def test_warm_builds_every_form(monkeypatch):
    """warm_kernels builds a batch of every form of warm_shapes("hot")
    and ("all") at its shape and launches it (launches stubbed here: the
    plain versions at these widths take minutes on the CPU); the hot
    shapes are the engine's buckets."""
    hot = tdaemon.warm_shapes("hot")
    for name, W, nl, n, go0 in hot:
        if name == "RawExtBatch":
            assert W in tdev.AL_BUCKETS and nl in tdev.NL_BUCKETS
        else:
            assert W // 8 in tdev.CIG_SLEN_CLASSES
            assert nl in tdev.CIG_NL_BUCKETS
    assert {n for *_, n, _ in hot} == {1, kernels.SPREAD_BELOW}
    with pytest.raises(ValueError):
        tdaemon.warm_shapes("some")
    seen = []
    for cls in (ne.RawExtBatch, ne.ExtBatch, sk.RawScanCigarBatch,
                sk.SmallScanCigarBatch, sk.ScanCigarBatch, st.RawCigarBatch,
                st.SmallCigarBatch, st.CigarBatch, st.Dp32Batch):
        monkeypatch.setattr(cls, "launch",
                            lambda self, staged=None: self)
        monkeypatch.setattr(cls, "collect", lambda self, h: seen.append(
            (type(h).__name__, h.al, h.n, h.go)))
    for shapes in ("hot", "all"):
        seen.clear()
        labels = tdaemon.warm_kernels(shapes=shapes, device="cpu")
        want = tdaemon.warm_shapes(shapes)
        assert len(labels) == len(want) == len(seen)
        assert [(s[0], s[2], s[3] == 0) for s in seen] == [
            (name, n, go0) for name, _, _, n, go0 in want]
    assert len(want) > 3 * len(hot)
