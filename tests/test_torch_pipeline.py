"""The port's streaming map and collect wave on the CPU: map_batch_gpu's
pre_align producer (PRE_CHUNK, MIN_ACTIVE_GENS, the pool) keeps the
output byte-identical to the JAX host engine and in input order; an
error on either thread raises and never hangs; flush_begin starts the
collect wave before the host DPs and flush_end joins it once; the
wave's results equal per-batch collects and the host C engine; an error
in a collect raises out of flush_end (no fallback)."""
import io
import threading

import numpy as np
import pytest

from miniprot_tpu import index as jidx
from miniprot_tpu import options as jopt
from miniprot_tpu import pipeline as jpipe
from miniprot_tpu_torch import device as tdev
from miniprot_tpu_torch import index as tidx
from miniprot_tpu_torch import kernels
from miniprot_tpu_torch import options as topt
from miniprot_tpu_torch import pipeline as tpipe
from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
from miniprot_tpu_torch.kernels import nasw_cigar_striped as st
from miniprot_tpu_torch.kernels import nasw_ext as ne
from miniprot_tpu_torch.native import DPF_CIGAR, DPF_EXT_LEFT, DPF_EXT_RIGHT
from miniprot_tpu_torch.options import F_GFF, F_SHOW_UNMAP

# seconds a map of the small workload may take before a test calls it
# hung (one takes a few seconds here)
HANG_S = 120


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """test_torch_e2e.py's testgen workload, both packages' indexes."""
    from miniprot_tpu_torch.testgen import make_workload
    d = tmp_path_factory.mktemp("stream")
    fa, faa = str(d / "g.fa"), str(d / "q.faa")
    make_workload(fa, faa, genome_len=300_000, n_genes=10, seed=7, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    return (fa, faa, jidx.Index.build(fa, jopt.IdxOpt()),
            tidx.Index.build(fa, topt.IdxOpt()))


def _opt(mod, flag):
    o = mod.MapOpt()
    o.flag |= flag
    o.bw = o.max_intron = 4000
    return o


def _names(faa):
    return [ln[1:].split()[0] for ln in open(faa) if ln.startswith(">")]


@pytest.fixture(scope="module")
def jax_out(workload):
    """The JAX host engine's bytes, per output flag."""
    _, faa, jmi, _ = workload
    outs = {}
    for flag in (F_SHOW_UNMAP, F_GFF):
        buf = io.StringIO()
        jpipe.map_file(jmi, faa, _opt(jopt, flag), n_threads=1, out=buf,
                       use_tpu=False)
        outs[flag] = buf.getvalue()
    return outs


@pytest.mark.parametrize("pre_chunk,min_active,n_threads,flag", [
    (0, 512, 1, F_SHOW_UNMAP), (1, 1, 1, F_SHOW_UNMAP),
    (3, 512, 1, F_SHOW_UNMAP), (3, 1, 2, F_SHOW_UNMAP), (2, 4, 1, F_GFF)])
def test_streamed_map_byte_identical_in_input_order(
        workload, jax_out, monkeypatch, pre_chunk, min_active, n_threads,
        flag):
    """map_file(device="cpu") at each chunking gives the JAX host
    engine's bytes; with -u every query is emitted exactly once, in one
    run of lines, in input order."""
    _, faa, _, tmi = workload
    monkeypatch.setattr(tpipe, "PRE_CHUNK", pre_chunk)
    monkeypatch.setattr(tpipe, "MIN_ACTIVE_GENS", min_active)
    buf, stats = io.StringIO(), {}
    tpipe.map_file(tmi, faa, _opt(topt, flag), n_threads=n_threads, out=buf,
                   device="cpu", stats=stats)
    got = buf.getvalue()
    assert got == jax_out[flag]
    assert stats["n_device"] > 0 and stats["batches"]["ext"] > 0
    if flag == F_SHOW_UNMAP:
        runs = [ln.split("\t")[0] for ln in got.splitlines()]
        runs = [q for i, q in enumerate(runs) if i == 0 or runs[i - 1] != q]
        assert runs == _names(faa)


def _run_bounded(fn):
    """fn() on a thread; returns its exception, or fails if it has not
    ended within HANG_S."""
    box = []

    def run():
        try:
            fn()
        except BaseException as e:
            box.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(HANG_S)
    assert not t.is_alive(), "map_file hung"
    return box[0] if box else None


@pytest.mark.parametrize("where,n_threads", [("producer", 1),
                                             ("producer", 2),
                                             ("pump", 1)])
def test_error_on_either_thread_raises(workload, monkeypatch, where,
                                       n_threads):
    """A pre_align that raises on the second chunk (in-process or in a
    pool worker), or a flush_end that raises while chunks are still
    coming, makes map_file raise that error within a time limit; the
    producer thread has ended by then."""
    from miniprot_tpu_torch import mapper
    _, faa, _, tmi = workload
    monkeypatch.setattr(tpipe, "PRE_CHUNK", 1)
    monkeypatch.setattr(tpipe, "MIN_ACTIVE_GENS", 1)
    second = [ln.strip() for ln in open(faa)
              if not ln.startswith(">")][1].encode()
    if where == "producer":
        real = mapper.pre_align

        def pre_align(mi, seq, opt, **kw):
            if seq.tobytes() == second:
                raise ValueError("pre_align failed on chunk 2")
            return real(mi, seq, opt, **kw)

        monkeypatch.setattr(mapper, "pre_align", pre_align)
    else:
        def flush_end(self, fl):
            raise ValueError("collect failed")

        monkeypatch.setattr(tdev.GpuExtEngine, "flush_end", flush_end)
    err = _run_bounded(lambda: tpipe.map_file(
        tmi, faa, _opt(topt, 0), n_threads=n_threads, out=io.StringIO(),
        device="cpu"))
    assert isinstance(err, ValueError), err
    assert ("chunk 2" if where == "producer" else "collect") in str(err)
    assert not any(t.name == "pre-align-producer" and t.is_alive()
                   for t in threading.enumerate())


# ---- the engine's collect wave, with recording fake batches ----


class _FakeBatch:
    """Records collect; returns fixed results.  Its launch handle is
    (name, fail), which the recording to_host of _fake_engine reads."""

    def __init__(self, name, log, results, fail=None):
        self.name, self.log, self.results, self.fail = (name, log, results,
                                                        fail)

    def collect(self, host):
        self.log.append(("collect", self.name))
        host.arrays()
        if self.fail == "collect":
            raise ValueError("decode failed")
        return self.results


def _fake_engine(monkeypatch, fail=None):
    """A CPU engine whose round is two ext jobs (one in a fake batch,
    one on the host) and two CIGAR jobs (the same split)."""
    eng = tdev.GpuExtEngine(topt.MapOpt(), "cpu")
    log: list = []
    ext_b = _FakeBatch("ext", log, [(7, 8, 9)], fail)
    cig_b = _FakeBatch("cig", log, [(5, np.array([3], np.uint32))])
    monkeypatch.setattr(eng, "_launch_ext",
                        lambda jobs: ([([0], ext_b, ("ext", fail))],
                                      {"ext_short": [1]}))
    monkeypatch.setattr(eng, "_launch_cig",
                        lambda jobs: ([([0], cig_b, ("cig", None))],
                                      {"cig_short": [1]}))

    def to_host(handle):
        name, how = handle
        log.append(("copy", name))
        if how == "copy":
            class _Bad:
                def synchronize(self):
                    raise RuntimeError("CUDA error: result copy failed")
            return kernels.HostCopy((), _Bad())
        return kernels.HostCopy(())

    monkeypatch.setattr(tdev, "to_host", to_host)

    def ext_host(jobs, i):
        log.append(("host", "ext"))
        jobs[i].result = (1, 2, 3)

    def dp_cigars(jobs):
        log.append(("host", "cig"))
        return [(4, np.array([6], np.uint32))] * len(jobs)

    monkeypatch.setattr(eng, "_ext_host", ext_host)
    monkeypatch.setattr(eng.env, "dp_cigars", dp_cigars)
    real_join = tdev._Flight.join

    def join(fl):
        log.append(("join", None))
        real_join(fl)

    monkeypatch.setattr(tdev._Flight, "join", join)
    z = np.zeros(4, np.uint8)
    eng.submit(("ext", z, z, None, 29, False))
    eng.submit(("ext", z, z, None, 29, True))
    eng.submit(("cigars", [(z, z, None), (z, z, None)]))
    return eng, log


def test_flush_begin_starts_wave_before_host_dps_and_end_joins_once(
        monkeypatch):
    eng, log = _fake_engine(monkeypatch)
    fl = eng.flush_begin()
    assert log == [("copy", "ext"), ("copy", "cig"),
                   ("host", "ext"), ("host", "cig")]
    del log[:]
    res = eng.flush_end(fl)
    assert log == [("join", None), ("collect", "ext"), ("collect", "cig")]
    assert res[0] == (7, 8, 9) and res[1] == (1, 2, 3)
    assert [sc for sc, _ in res[2]] == [5, 4]
    with pytest.raises(RuntimeError, match="joined twice"):
        fl.join()


@pytest.mark.parametrize("fail", ["collect", "copy"])
def test_collect_error_raises_out_of_flush_end(monkeypatch, fail):
    """The port does not fall back: a decode error or a failed result
    copy (its event raising at the wait) raises out of flush_end, and
    the engine has no broken state to fall back to."""
    eng, _ = _fake_engine(monkeypatch, fail)
    fl = eng.flush_begin()
    with pytest.raises((ValueError, RuntimeError),
                       match="decode failed|copy failed"):
        eng.flush_end(fl)
    assert not hasattr(eng, "broken")


# ---- the wave on real batches ----


def _jobs(rng, n, nl, al):
    return [(rng.choice(np.frombuffer(b"ACGT", np.uint8), int(
        rng.integers(*nl))),
        rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8), int(
            rng.integers(*al)))) for _ in range(n)]


@pytest.mark.parametrize("cig_impl", ["scan", "striped"])
def test_wave_results_equal_per_batch_collects_and_host(monkeypatch,
                                                        cig_impl):
    """A round of ext jobs (left and right) and CIGAR jobs of both
    classes through flush_begin/flush_end on the CPU: the results equal
    each launched batch's own collect of its launch handle, and the host
    C engine's DPs."""
    opt = topt.MapOpt()
    eng = tdev.GpuExtEngine(opt, "cpu", cig_impl=cig_impl)
    launched = []
    real_launch = eng._launch

    def launch(batch):
        h = real_launch(batch)
        launched.append((batch, h))
        return h

    monkeypatch.setattr(eng, "_launch", launch)
    rng = np.random.default_rng(5)
    ext = _jobs(rng, 6, (1100, 1500), (30, 120))
    cig = _jobs(rng, 4, (520, 700), (40, 120)) + _jobs(rng, 4, (520, 700),
                                                       (5, 32))
    for k, (ns, aa) in enumerate(ext):
        eng.submit(("ext", ns, aa, None, opt.io, k % 2 == 1))
    eng.submit(("cigars", [(ns, aa, None) for ns, aa in cig]))
    res = eng.flush_end(eng.flush_begin())
    kinds = {type(b) for b, _ in launched}
    cls = ((sk.RawScanCigarBatch, sk.SmallScanCigarBatch)
           if cig_impl == "scan" else (st.RawCigarBatch, st.SmallCigarBatch))
    assert kinds == {ne.RawExtBatch, *cls}
    assert eng.n_host == 0
    per_batch = [r for b, h in launched for r in b.collect(h)]
    got = [res[k] for k in range(len(ext))] + res[-1]
    assert len(per_batch) == len(got)
    # the same problems in the engine's order: ext batches, then CIGAR
    # batches; match them by content
    for r in got:
        assert any(r[0] == p[0] and all(np.array_equal(a, b)
                                        for a, b in zip(r[1:], p[1:]))
                   for p in per_batch)
    env = eng.env
    for k, (ns, aa) in enumerate(ext):
        sc, ntl, aal, _ = env.dp(ns, aa, DPF_EXT_LEFT if k % 2
                                 else DPF_EXT_RIGHT, io=opt.io)
        assert res[k] == (sc, ntl, aal)
    for (ns, aa), (gsc, gcig) in zip(cig, res[-1]):
        sc, _, _, c = env.dp(ns, aa, DPF_CIGAR)
        assert gsc == sc and np.array_equal(gcig, c)


# ---- the native engine beside the producer thread ----


def test_native_scratch_is_per_thread():
    """CIGAR DPs on one thread give their serial results while another
    thread runs DPs of its own and frees its scratch after each round:
    the native engine's scratch slots belong to the thread that uses
    them (the in-process producer runs pre_align beside the pump's host
    DPs, and each trims after its own work)."""
    from miniprot_tpu_torch import native
    from miniprot_tpu_torch.align import DpEnv
    rng = np.random.default_rng(9)
    mine, theirs = (_jobs(rng, 6, (520, 1500), (40, 200)) for _ in range(2))
    env = DpEnv(topt.MapOpt())
    want = [env.dp(ns, aa, DPF_CIGAR) for ns, aa in mine]
    stop = threading.Event()
    errors: list = []

    def other():
        env2 = DpEnv(topt.MapOpt())
        try:
            while not stop.is_set():
                for ns, aa in theirs:
                    env2.dp(ns, aa, DPF_CIGAR)
                native._lib.mx_scratch_trim(0)
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=other, daemon=True)
    t.start()
    try:
        for _ in range(40):
            for (ns, aa), w in zip(mine, want):
                got = env.dp(ns, aa, DPF_CIGAR)
                assert got[0] == w[0] and np.array_equal(got[3], w[3])
    finally:
        stop.set()
        t.join(HANG_S)
    assert not errors and not t.is_alive()
