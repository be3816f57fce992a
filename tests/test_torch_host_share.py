"""The engine's host share off the pump's thread: the batched native
entry (native.DpJobs + Dp16Ctx.dp_many, one mx_dp16_many call) against
one Dp16Ctx.dp per job, GpuExtEngine's worker threads (the same results
at 1 and 4 host threads, a worker's error raised out of flush_end, close
joining them), and map_file's bytes at n_threads 1 and 4."""

import io
import threading

import numpy as np
import pytest

from miniprot_tpu_torch import device as tdev
from miniprot_tpu_torch import native, pipeline
from miniprot_tpu_torch import index as tidx
from miniprot_tpu_torch.align import DpEnv
from miniprot_tpu_torch.native import DPF_CIGAR, DPF_EXT_LEFT, DPF_EXT_RIGHT
from miniprot_tpu_torch.options import F_GFF, IdxOpt, MapOpt

HANG_S = 120
NT = np.frombuffer(b"ACGT", np.uint8)
AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)


def _seq(rng, alphabet, lo, hi):
    return rng.choice(alphabet, int(rng.integers(lo, hi)))


def _track(rng, nl):
    """An --spsc splice-score track: mostly unset (0xff)."""
    ss = np.full(nl, 0xFF, np.uint8)
    k = int(rng.integers(1, max(nl // 4, 2)))
    ss[rng.integers(0, nl, k)] = rng.integers(0, 256, k).astype(np.uint8)
    return ss


def _jobs(seed, n, nl, al, flags=(DPF_CIGAR,), spsc=0.0, al0=0.0):
    """n random (nsq, asq, ss, flag) jobs: nl and al ranges; a share
    ``spsc`` with a splice track and ``al0`` with an empty query."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ns = _seq(rng, NT, *nl)
        aa = (AA[:0] if rng.random() < al0 else _seq(rng, AA, *al))
        ss = _track(rng, len(ns)) if rng.random() < spsc else None
        out.append((ns, aa, ss, flags[k % len(flags)]))
    return out


def _one_by_one(ctx, jobs, io):
    return [ctx.dp(ns, aa, f, io, ss) for ns, aa, ss, f in jobs]


def _many(ctx, jobs, io, use_x4, sel=None):
    p = native.DpJobs([j[0] for j in jobs], [j[1] for j in jobs],
                      [j[2] for j in jobs], [j[3] for j in jobs], io)
    ctx.dp_many(p, use_x4, sel)
    return p


@pytest.mark.parametrize("use_x4", [True, False])
@pytest.mark.parametrize("case", [
    "cigar_30_120", "cigar_120_511", "cigar_512_2000", "cigar_al0",
    "cigar_spsc", "ext_left_right", "ext_spsc"])
def test_batched_entry_equals_one_dp_per_job(case, use_x4):
    """mx_dp16_many, in x4 groups or one mx_dp16 a job, gives each job's
    score, ends and CIGAR exactly as one Dp16Ctx.dp call does."""
    opt = MapOpt()
    ctx = DpEnv(opt).ctx
    ext = (DPF_EXT_LEFT, DPF_EXT_RIGHT)
    jobs = {
        "cigar_30_120": lambda: _jobs(1, 23, (30, 121), (8, 45)),
        "cigar_120_511": lambda: _jobs(2, 13, (120, 512), (30, 180)),
        "cigar_512_2000": lambda: _jobs(3, 5, (512, 2001), (150, 700)),
        "cigar_al0": lambda: _jobs(4, 12, (3, 90), (1, 30), al0=0.5),
        "cigar_spsc": lambda: _jobs(5, 11, (30, 400), (10, 130), spsc=0.6),
        "ext_left_right": lambda: _jobs(6, 10, (60, 1500), (20, 300), ext),
        "ext_spsc": lambda: _jobs(7, 8, (60, 900), (20, 300), ext,
                                  spsc=0.6),
    }[case]()
    want = _one_by_one(ctx, jobs, opt.io)
    p = _many(ctx, jobs, opt.io, use_x4)
    for k, (ns, aa, ss, f) in enumerate(jobs):
        sc, ntl, aal, cig = want[k]
        assert p.score[k] == sc, (case, k)
        if f == DPF_CIGAR:
            o, n = p.cig_off[k], p.n_cig[k]
            np.testing.assert_array_equal(p.cig[o:o + n], cig)
        else:
            assert (p.nt_len[k], p.aa_len[k]) == (ntl, aal), (case, k)
    assert (p.job_s >= 0).all() and p.job_s.sum() > 0


def test_batched_entry_runs_only_the_selection_and_mixed_jobs():
    """A selection runs those jobs alone (the others' slots untouched);
    CIGAR and ext jobs of two io values mix in one call; dp_cigars is
    the same entry's results."""
    opt = MapOpt()
    ctx = DpEnv(opt).ctx
    jobs = (_jobs(8, 9, (40, 600), (10, 200))
            + _jobs(9, 6, (60, 900), (20, 300), (DPF_EXT_LEFT,
                                                  DPF_EXT_RIGHT)))
    ios = [opt.io if k % 3 else opt.io_end for k in range(len(jobs))]
    p = native.DpJobs([j[0] for j in jobs], [j[1] for j in jobs],
                      [j[2] for j in jobs], [j[3] for j in jobs], ios)
    p.score[:] = -12345
    sel = np.arange(1, len(jobs), 2, dtype=np.int32)
    ctx.dp_many(p, True, sel)
    for k, (ns, aa, ss, f) in enumerate(jobs):
        if k % 2 == 0:
            assert p.score[k] == -12345
            continue
        sc, ntl, aal, cig = ctx.dp(ns, aa, f, ios[k], ss)
        assert p.score[k] == sc
        if f == DPF_CIGAR:
            o, n = p.cig_off[k], p.n_cig[k]
            np.testing.assert_array_equal(p.cig[o:o + n], cig)
        else:
            assert (p.nt_len[k], p.aa_len[k]) == (ntl, aal)
    cj = [(ns, aa, ss) for ns, aa, ss, f in jobs if f == DPF_CIGAR]
    for (sc, cig), (ns, aa, ss) in zip(ctx.dp_cigars(cj, opt.io), cj):
        want = ctx.dp(ns, aa, DPF_CIGAR, opt.io, ss)
        assert sc == want[0]
        np.testing.assert_array_equal(cig, want[3])
    # a track must cover its window: the entry reads nl bytes of it
    ns, aa = jobs[0][:2]
    with pytest.raises(ValueError, match="shorter"):
        native.DpJobs([ns], [aa], [np.full(len(ns) - 1, 0xFF, np.uint8)],
                      DPF_CIGAR, opt.io)


# ---- the engine's worker threads ----


def _round(eng, opt, seed):
    """Submit one round whose DPs all route to the host on the CPU
    engine: short ext jobs (left and right, one with a track), short
    CIGAR jobs and CIGAR jobs wider than the largest class."""
    rng = np.random.default_rng(seed)
    for k in range(6):
        ns, aa = _seq(rng, NT, 100, 900), _seq(rng, AA, 20, 200)
        ss = _track(rng, len(ns)) if k == 2 else None
        eng.submit(("ext", ns, aa, ss, opt.io if k % 3 else opt.io_end,
                    k % 2 == 0))
    short = [(_seq(rng, NT, 30, 511), _seq(rng, AA, 5, 150), None)
             for _ in range(9)]
    wide = [(_seq(rng, NT, 1600, 1900), _seq(rng, AA, 513, 600), None)
            for _ in range(2)]
    eng.submit(("cigars", short[:5] + wide[:1]))
    eng.submit(("cigars", short[5:] + wide[1:]))


def _same(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return (a[0] == b[0] and len(a) == len(b)
            and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:])))


def test_flush_results_equal_at_1_and_4_host_threads():
    """The same rounds through flush_begin/flush_end with the host share
    inline (n_workers 1) and on three worker threads (n_workers 4): the
    same results, counts and reasons; with 1 no thread is started."""
    opt = MapOpt()
    got, engs = {}, {}
    for n in (1, 4):
        before = threading.active_count()
        eng = engs[n] = tdev.GpuExtEngine(opt, "cpu", n_workers=n)
        got[n] = []
        for seed in (11, 12):
            _round(eng, opt, seed)
            got[n].append(eng.flush_end(eng.flush_begin()))
        started = threading.active_count() - before
        assert started == (0 if n == 1 else 3)
    for r1, r4 in zip(got[1], got[4]):
        assert _same(r1, r4)
    e1, e4 = engs[1], engs[4]
    assert e1.n_host == e4.n_host == 2 * (6 + 11) and e1.n_device == 0
    assert e1.host_reasons == e4.host_reasons
    assert set(e4.host_reasons) == {"ext_short", "cig_short",
                                    "cig_outside_classes"}
    assert (e1.host_offthread, e4.host_offthread) == (0, e4.n_host)
    assert set(e4.host_dp_s_by_reason) == set(e4.host_reasons)
    assert sum(e4.host_dp_s_by_reason.values()) == pytest.approx(
        e4.host_dp_s)
    assert e4.host_join_s >= 0 and e1.host_join_s == 0
    for e in engs.values():
        e.close()


def test_close_joins_the_worker_threads():
    """close() ends and joins every worker thread; an engine that never
    ran a host share has none to join."""
    opt = MapOpt()
    tdev.GpuExtEngine(opt, "cpu", n_workers=4).close()
    eng = tdev.GpuExtEngine(opt, "cpu", n_workers=4)
    _round(eng, opt, 13)
    eng.flush_end(eng.flush_begin())
    eng.trim_scratch()
    threads = list(eng._workers._threads)
    assert len(threads) == 3 and all(t.is_alive() for t in threads)
    eng.close()
    assert not any(t.is_alive() for t in threads)
    assert eng._workers is None


def _bounded(fn):
    """fn() on a thread; its exception, or a failure after HANG_S."""
    box = []

    def run():
        try:
            fn()
        except BaseException as e:
            box.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(HANG_S)
    assert not t.is_alive(), "hung"
    return box[0] if box else None


def test_worker_error_raises_out_of_flush_end(monkeypatch):
    """A native call that raises on a worker is raised out of flush_end,
    within a time limit and with no fallback; the engine then maps the
    next round and close() joins its threads."""
    opt = MapOpt()
    eng = tdev.GpuExtEngine(opt, "cpu", n_workers=4)
    real = type(eng.env.ctx).dp_many
    calls = []

    def dp_many(self, jobs, use_x4, sel=None):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            raise MemoryError("mx_dp16_many")
        return real(self, jobs, use_x4, sel)

    monkeypatch.setattr(type(eng.env.ctx), "dp_many", dp_many)
    _round(eng, opt, 14)
    fl = eng.flush_begin()
    err = _bounded(lambda: eng.flush_end(fl))
    assert isinstance(err, MemoryError), err
    assert all(n.startswith("engine-host-") for n in calls)
    _round(eng, opt, 15)
    assert _bounded(lambda: eng.flush_end(eng.flush_begin())) is None
    threads = list(eng._workers._threads)
    assert _bounded(eng.close) is None
    assert not any(t.is_alive() for t in threads)


def test_map_file_byte_identical_at_1_and_4_threads(tmp_path):
    """map_file(device="cpu") of a testgen genome gives the same bytes at
    n_threads 1 and 4 (every host share on the workers at 4)."""
    from miniprot_tpu_torch.testgen import make_workload
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=200_000, n_genes=3, seed=3, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    mi = tidx.Index.build(fa, IdxOpt())
    opt = MapOpt()
    opt.flag |= F_GFF
    opt.bw = opt.max_intron = 4000
    outs, stats = {}, {}
    for n in (1, 4):
        buf, stats[n] = io.StringIO(), {}
        pipeline.map_file(mi, faa, opt, n_threads=n, out=buf, device="cpu",
                          stats=stats[n])
        outs[n] = buf.getvalue()
    assert outs[1] == outs[4] and outs[1].count("\tmRNA\t") >= 2
    assert stats[1]["host_offthread"] == 0
    assert stats[4]["n_host"] == stats[1]["n_host"] > 0
    assert stats[4]["host_offthread"] == stats[4]["n_host"] - sum(
        v for k, v in stats[4]["host_reasons"].items()
        if k in ("walk_round_cap", "cig_spsc_donor"))
