"""The port's scan CIGAR DP and run-walk (kernels/nasw_cigar_scan.py) on
the CPU, through their plain PyTorch versions, against the host C engine
miniprot_tpu.native (dp16 with DPF_CIGAR), the JAX ScanCigarBatch in
interpret mode and the JAX _run_backtrack.  Exact: integer DP, bytes
out."""
import numpy as np
import pytest

from miniprot_tpu import native, tables
from miniprot_tpu.native import DPF_CIGAR
from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
from miniprot_tpu_torch.kernels.nasw_ext import prep_problem

OPT = (11, 1, 23, 29, 100, 5, 0.5)      # go ge fs io xdrop endb ie_coef


def _setup(go=11, ge=1, fs=23):
    T = tables.get_tables(1)
    mat = tables.BLOSUM62.copy()
    tables.set_stop_sc(mat, fs)
    sp = tables.splice_model_scores(1)
    kw = dict(mat=mat, nt4=T.nt4, aa20=T.aa20, codon=T.codon, sp=sp,
              sp_null_bonus=-7, go=go, ge=ge, io=29, fs=fs, xdrop=100,
              end_bonus=5, ie_coef=0.5)
    return T, mat, sp, kw


def _assert_matches(cases, results, kw):
    assert len(results) == len(cases)
    for (ns, aa, *ss), r in zip(cases, results):
        assert r is not None
        rsc, _, _, rcig = native.dp16(ns, aa, flag=DPF_CIGAR,
                                      ss=ss[0] if ss else None, **kw)
        sc, cig = r
        assert sc == rsc, (len(ns), len(aa))
        assert np.array_equal(cig, rcig), (len(ns), len(aa))


def _rand_case(rng, nl_lo, nl_hi, al_lo, al_hi, alphabet=b"ARNDCQEGHILKMFPSTWYVX*"):
    nl = int(rng.integers(nl_lo, nl_hi))
    al = int(rng.integers(al_lo, al_hi))
    ns = rng.choice(list(b"ACGTN"), nl,
                    p=[.24, .24, .24, .24, .04]).astype(np.uint8)
    aa = rng.choice(list(alphabet), al).astype(np.uint8)
    return ns, aa


@pytest.mark.parametrize("al_pad,nl_pad,n,seed", [
    (8, 64, 16, 3),       # slen 1: fully wrap-driven I chains
    (32, 256, 24, 4),     # the mapper's small class
    (128, 256, 12, 5),    # the mapper's big class
])
def test_scan_cigar_matches_reference(al_pad, nl_pad, n, seed):
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(seed)
    batch = sk.ScanCigarBatch(al_pad, nl_pad, mat, OPT, device="cpu")
    cases = []
    for _ in range(n):
        ns, aa = _rand_case(rng, 3, nl_pad, 1, al_pad + 1)
        cases.append((ns, aa))
        nas, aas, d, a = prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                      io=29, ext_left=False)
        batch.add(nas, aas, d, a)
    _assert_matches(cases, batch.run(), kw)


def test_scan_cigar_wide_class_matches_reference():
    """The al <= 512 class (two positions per thread on the card)."""
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(77)
    batch = sk.RawScanCigarBatch(512, 1024, mat, OPT, sp=sp, trans_code=1,
                                  device="cpu")
    cases = []
    for _ in range(6):
        ns, aa = _rand_case(rng, 300, 1024, 120, 513)
        cases.append((ns, aa))
        batch.add_raw(T.nt4[ns], T.aa20[aa], io=29)
    _assert_matches(cases, batch.run(), kw)


def test_small_class_matches_reference():
    """SmallScanCigarBatch: al <= 32, up to 512 problems per launch."""
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(56)
    batch = sk.SmallScanCigarBatch(32, 512, mat, OPT, sp=sp, trans_code=1,
                                    device="cpu")
    cases = []
    for _ in range(400):
        ns, aa = _rand_case(rng, 3, 512 - 24, 1, 33)
        cases.append((ns, aa))
        batch.add_raw(T.nt4[ns], T.aa20[aa], io=29)
    _assert_matches(cases, batch.run(), kw)


def test_scan_cigar_raw_matches_reference():
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(17)
    batch = sk.RawScanCigarBatch(32, 256, mat, OPT, sp=sp, trans_code=1,
                                  device="cpu")
    cases = []
    for _ in range(20):
        ns, aa = _rand_case(rng, 3, 250, 1, 33)
        cases.append((ns, aa))
        batch.add_raw(T.nt4[ns], T.aa20[aa], io=29)
    _assert_matches(cases, batch.run(), kw)


def test_scan_cigar_spsc_track_matches_reference():
    """External --spsc tracks ride the host-prep ScanCigarBatch path."""
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(23)
    batch = sk.ScanCigarBatch(32, 256, mat, OPT, device="cpu")
    cases = []
    for _ in range(12):
        ns, aa = _rand_case(rng, 9, 250, 1, 33, b"ARNDCQEGHILKMFPSTWYV")
        nl = len(ns)
        ss = np.full(nl, 0xFF, np.uint8)
        k = int(rng.integers(1, max(nl // 4, 2)))
        ss[rng.integers(0, nl, k)] = rng.integers(0, 256, k).astype(np.uint8)
        nas, aas, d, a = prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                      io=29, ext_left=False, ss=ss)
        if int(d.min()) + 29 < 0:
            continue    # folded donor would go negative: host-only job
        cases.append((ns, aa, ss))
        batch.add(nas, aas, d, a)
    assert batch.n >= 6
    _assert_matches(cases, batch.run(), kw)


def test_scan_cigar_saturating_regime_matches_reference():
    """Inflated scores drive H to the int16 ceiling and deep floor; the
    clipped arithmetic must track the saturating reference exactly."""
    T, mat, sp, kw = _setup()
    mat_hot = mat.reshape(22, 22).copy()
    mat_hot[mat_hot > 0] = 125                 # int8 storage bound
    kw = dict(kw, mat=mat_hot)
    rng = np.random.default_rng(29)
    batch = sk.ScanCigarBatch(32, 512, mat_hot, OPT, device="cpu")
    cases = []
    for _ in range(10):
        nl = int(rng.integers(100, 500))
        al = int(rng.integers(8, 33))
        ns = rng.choice(list(b"ACGT"), nl).astype(np.uint8)
        aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al).astype(np.uint8)
        cases.append((ns, aa))
        nas, aas, d, a = prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                      io=29, ext_left=False)
        batch.add(nas, aas, d, a)
    _assert_matches(cases, batch.run(), kw)


def test_scan_walk_round_cap_flags_unfinished(monkeypatch):
    """A tiny round budget leaves long paths unfinished; collect returns
    None for them (the engine redoes them on the host) and still
    decodes the problems that fit."""
    monkeypatch.setattr(sk, "_rounds_cap", lambda: 3)
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(41)
    batch = sk.ScanCigarBatch(32, 256, mat, OPT, device="cpu")
    cases = []
    for _ in range(8):
        nl = int(rng.integers(150, 250))
        al = int(rng.integers(20, 33))
        ns = rng.choice(list(b"ACGT"), nl).astype(np.uint8)
        aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al).astype(np.uint8)
        cases.append((ns, aa))
        nas, aas, d, a = prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                      io=29, ext_left=False)
        batch.add(nas, aas, d, a)
    assert batch.rounds() == 3
    res = batch.run()
    assert any(r is None for r in res), \
        "3 rounds cannot finish 150+-row noisy paths"
    fit = [(c, r) for c, r in zip(cases, res) if r is not None]
    _assert_matches([c for c, _ in fit], [r for _, r in fit], kw)


def test_scan_cigar_rejects_go0():
    """go == 0 breaks the scan/striped equivalence; the batch refuses
    the job (the engine sends go == 0 CIGAR jobs to the striped
    batches)."""
    T, mat, sp, _ = _setup()
    batch = sk.ScanCigarBatch(32, 256, mat, (0, 1, 23, 29, 100, 5, 0.5),
                               device="cpu")
    nas, aas, d, a = prep_problem(
        np.frombuffer(b"ACGTACGTACGT", np.uint8),
        np.frombuffer(b"MKT", np.uint8), sp=sp, sp_null_bonus=-7, io=29,
        ext_left=False)
    with pytest.raises(AssertionError):
        batch.add(nas, aas, d, a)


def test_engine_routes_go0_cigars_to_host():
    """go == 0 CIGAR jobs leave the scan kernel (its proof needs go >= 1)
    and now run on the striped batches on the device, not on the host
    engine."""
    from miniprot_tpu_torch.device import GpuExtEngine
    from miniprot_tpu_torch.options import MapOpt
    T, mat, sp, kw = _setup(go=0)
    opt = MapOpt()
    opt.go = 0
    rng = np.random.default_rng(8)
    jobs = [_rand_case(rng, 600, 900, 20, 100) for _ in range(3)]
    engine = GpuExtEngine(opt, "cpu")
    engine.submit(("cigars", [(ns, aa, None) for ns, aa in jobs]))
    (res,) = engine.flush()
    assert engine.n_device == 3 and engine.n_host == 0
    assert engine.batches["cig_striped"] == 1 and engine.batches["cig"] == 0
    kw = dict(kw, mat=opt.mat)
    _assert_matches(jobs, res, kw)


def test_scan_batch_matches_jax_interpret():
    """The same problems through the JAX ScanCigarBatch (Pallas interpret
    mode) give the same scores and CIGARs."""
    from miniprot_tpu.kernels.nasw_cigar_scan import ScanCigarBatch as JaxScan
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(64)
    port = sk.ScanCigarBatch(32, 256, mat, OPT, device="cpu")
    jb = JaxScan(al_pad=32, nl_pad=256, mat=mat, opt_scalars=OPT)
    for _ in range(8):
        ns, aa = _rand_case(rng, 3, 250, 1, 33)
        nas, aas, d, a = prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                      io=29, ext_left=False)
        port.add(nas, aas, d, a)
        jb.add(nas, aas, d, a)
    got, want = port.run(), jb.run(interpret=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and np.array_equal(g[1], w[1])


def test_run_walk_plain_matches_jax_run_backtrack():
    """run_walk_plain on the port's tb/hint planes equals the JAX
    _run_backtrack (a jax while_loop) on the same planes."""
    import torch

    from miniprot_tpu.kernels import nasw_cigar_scan as jsk
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(90)
    batch = sk.RawScanCigarBatch(128, 512, mat, OPT, sp=sp, trans_code=1,
                                  device="cpu")
    for _ in range(20):
        ns, aa = _rand_case(rng, 40, 500, 5, 129)
        batch.add_raw(T.nt4[ns], T.aa20[aa], io=29)
    n, R = batch.n, batch._rows()
    from miniprot_tpu_torch.kernels.nasw_ext import _prep_seq_device
    nlv = torch.from_numpy(batch.nlv[:n])
    alv = torch.from_numpy(batch.alv[:n])
    nas, D, A = _prep_seq_device(
        torch.from_numpy(batch.nt[:n, :R + 8]), torch.zeros(n),
        torch.from_numpy(batch.iov[:n]), nlv, sp=sp, codon=T.codon,
        n_rows=R)
    tb, hint, _ = sk.scan_cigar_dp_plain(
        nas, D, A, nlv, alv, torch.from_numpy(batch.prof[:n]),
        OPT[:3], R)
    rounds = 300
    states, counts, fi, fj = sk.run_walk_plain(tb, hint, nlv, alv, rounds)
    # the JAX walk reads (rows, W, 128) position-ordered planes
    tbj = np.zeros((R, 128, 128), np.int16)
    hij = np.zeros((R, 128, 128), np.int16)
    tbj[:, :, :n] = tb.numpy().transpose(1, 2, 0)
    hij[:, :, :n] = hint.numpy().transpose(1, 2, 0)
    nl_v = np.full(128, 0, np.int32)
    al_v = np.full(128, 1, np.int32)
    nl_v[:n], al_v[:n] = batch.nlv[:n], batch.alv[:n]
    import jax.numpy as jnp
    js, jc, jfi, jfj = (np.asarray(x) for x in jsk._run_backtrack(
        jnp.asarray(tbj), jnp.asarray(hij), jnp.asarray(nl_v),
        jnp.asarray(al_v), R, 128, rounds))
    assert np.array_equal(states.numpy(), js.T[:n])
    assert np.array_equal(counts.numpy(), jc.T[:n])
    assert np.array_equal(fi.numpy(), jfi[:n])
    assert np.array_equal(fj.numpy(), jfj[:n])


def test_tb_bytes_count_hint_plane_and_engine_respects_cap(monkeypatch):
    """A scan batch's tb_bytes() is twice the striped kernel's tb-only
    formula (the tb plane plus the hint plane), and the engine never has
    more planes in flight than its pending cap."""
    from miniprot_tpu.kernels.nasw_cigar_pallas import CigarBatch
    from miniprot_tpu.kernels.nasw_cigar_scan import Raw4ScanCigarBatch
    from miniprot_tpu_torch import device
    from miniprot_tpu_torch.options import MapOpt
    T, mat, sp, kw = _setup()
    for W, nl in ((128, 4096), (512, 2048)):
        port = sk.RawScanCigarBatch(W, nl, mat, OPT, sp=sp, device="cpu")
        assert port.tb_bytes() == 2 * CigarBatch(W, nl, mat, OPT).tb_bytes()
    small = sk.SmallScanCigarBatch(32, 2048, mat, OPT, sp=sp,
                                   device="cpu")
    assert small.tb_bytes() == Raw4ScanCigarBatch(32, 2048, mat, OPT,
                                                  sp=sp).tb_bytes()
    assert small.tb_bytes() == 2 * (2048 * 32 * 512 * 2)

    # 16-problem batches keep the plain DP short: 40 jobs, 3 batches (a
    # cells cap of one 16-problem batch keeps cig_capacity from growing)
    monkeypatch.setattr(sk, "B", 16)
    monkeypatch.setattr(sk.RawScanCigarBatch, "CAPACITY", 16)
    monkeypatch.setattr(device, "CIG_BATCH_CELLS", 16 * 2048 * 128)
    rng = np.random.default_rng(12)
    jobs = [_rand_case(rng, 520, 640, 40, 120, b"ARNDCQEGHILKMFPSTWYV")
            for _ in range(40)]
    one_batch = sk.RawScanCigarBatch(128, 2048, mat, OPT, sp=sp,
                                     device="cpu").tb_bytes()
    assert one_batch == 2 * 2 * 2048 * 128 * 16
    peaks = []
    for mem in (int(one_batch / 0.25), 1 << 40):
        monkeypatch.setattr(device, "_memory_bytes", lambda dev, m=mem: m)
        engine = device.GpuExtEngine(MapOpt(), "cpu")
        engine.submit(("cigars", [(ns, aa, None) for ns, aa in jobs]))
        (res,) = engine.flush()
        assert engine.n_device == 40 and engine.batches["cig"] == 3
        assert engine.peak_pending_tb <= engine.pending_tb_cap
        peaks.append(engine.peak_pending_tb)
        _assert_matches(jobs[::5], res[::5], kw)
    assert peaks == [one_batch, 3 * one_batch]


@pytest.mark.parametrize("cls_name,W", [("SmallScanCigarBatch", 32),
                                        ("RawScanCigarBatch", 128),
                                        ("RawScanCigarBatch", 512),
                                        ("ScanCigarBatch", 128)])
def test_cig_capacity_is_a_power_of_two_within_the_caps(cls_name, W):
    """At every nl bucket the scan batch capacity is a power of two, never
    below the class's own (128, 512 for the al <= 32 class), within the
    cells cap unless at that floor, within the per-batch planes cap, and
    the largest such: doubling it breaks one of the caps."""
    from miniprot_tpu_torch import device
    cls = getattr(sk, cls_name)
    floor = 512 if W == 32 else 128
    assert cls.CAPACITY == floor
    tb_cap = int(80e9 * device.CIG_TB_FRACTION)     # an 80 GB card
    for nl_b in device.CIG_NL_BUCKETS:
        if cls.planes_bytes(nl_b, W) > tb_cap:
            continue                # the engine hosts this bucket
        cap = device.cig_capacity(cls, nl_b, W, tb_cap)
        assert cap >= floor and cap & (cap - 1) == 0, (nl_b, cap)
        assert cls.planes_bytes(nl_b, W, cap) <= tb_cap
        cells = cap * sk._pad_rows(nl_b) * W
        assert cap == floor or cells <= device.CIG_BATCH_CELLS
        assert (2 * cells > device.CIG_BATCH_CELLS
                or cls.planes_bytes(nl_b, W, 2 * cap) > tb_cap)
    # the short windows of the narrow classes fill wide launches
    assert device.cig_capacity(cls, 2048, W, tb_cap) >= (4 * floor if W < 512
                                                         else 2 * floor)


def test_engine_larger_scan_batches_match_host_and_count_routing():
    """200 CIGAR jobs of one bucket go in one launch (they took two at
    the old 128-problem capacity), decode to the host engine's CIGARs,
    and the engine's stats count problems per launch and the jobs it
    routed to the host by reason."""
    from miniprot_tpu_torch.device import CIG_MIN_NL, GpuExtEngine
    from miniprot_tpu_torch.options import MapOpt
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(23)
    jobs = [_rand_case(rng, 520, 700, 33, 121, b"ARNDCQEGHILKMFPSTWYV")
            for _ in range(200)]
    short = [_rand_case(rng, 40, CIG_MIN_NL, 5, 30) for _ in range(5)]
    opt = MapOpt()
    engine = GpuExtEngine(opt, "cpu")
    engine.submit(("cigars", [(ns, aa, None) for ns, aa in jobs + short]))
    (res,) = engine.flush()
    assert engine.batches["cig"] == 1 and engine.n_device == 200
    assert engine.bucket_problems == {("cig", 128, 2048): [200, 200]}
    assert engine.host_reasons == {"cig_short": 5} and engine.n_host == 5
    assert engine.host_dp_s > 0
    kw = dict(kw, mat=opt.mat)
    _assert_matches((jobs + short)[::7], res[::7], kw)
