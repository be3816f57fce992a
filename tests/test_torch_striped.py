"""The port's striped CIGAR DP and cell walk (kernels/nasw_cigar_striped.py)
on the CPU, through their plain PyTorch versions, against the host C
engine miniprot_tpu.native (dp16 with DPF_CIGAR, dp32), the JAX
RawCigarBatch / Dp32Batch in Pallas interpret mode and the JAX
_device_backtrack.  Exact: integer DP, bytes out."""
import numpy as np
import pytest
import torch

from miniprot_tpu import native, tables
from miniprot_tpu.native import DPF_CIGAR
from miniprot_tpu_torch.kernels import nasw_cigar_striped as st
from miniprot_tpu_torch.kernels.nasw_ext import prep_problem

OPT = (11, 1, 23, 29, 100, 5, 0.5)      # go ge fs io xdrop endb ie_coef
NT = b"ACGTN"
AA = b"ARNDCQEGHILKMFPSTWYVX*"


def _setup(go=11):
    T = tables.get_tables(1)
    mat = tables.BLOSUM62.copy()
    tables.set_stop_sc(mat, 23)
    sp = tables.splice_model_scores(1)
    kw = dict(mat=mat, nt4=T.nt4, aa20=T.aa20, codon=T.codon, sp=sp,
              sp_null_bonus=-7, go=go, ge=1, io=29, fs=23, xdrop=100,
              end_bonus=5, ie_coef=0.5)
    return T, mat, sp, kw


def _case(rng, nl_lo, nl_hi, al_lo, al_hi, alphabet=AA):
    nl = int(rng.integers(nl_lo, nl_hi))
    al = int(rng.integers(al_lo, al_hi))
    ns = rng.choice(list(NT), nl, p=[.24, .24, .24, .24, .04]).astype(np.uint8)
    return ns, rng.choice(list(alphabet), al).astype(np.uint8)


def _assert_host(cases, results, kw):
    assert len(results) == len(cases)
    for (ns, aa), (sc, cig) in zip(cases, results):
        rsc, _, _, rcig = native.dp16(ns, aa, flag=DPF_CIGAR, **kw)
        assert sc == rsc, (len(ns), len(aa))
        assert np.array_equal(cig, rcig), (len(ns), len(aa))


def _fill(batch, cases, sp, raw, T):
    for ns, aa in cases:
        if raw:
            batch.add_raw(T.nt4[ns], T.aa20[aa], io=29)
        else:
            nas, aas, d, a = prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                          io=29, ext_left=False)
            batch.add(nas, aas, d, a)


@pytest.mark.parametrize("al_pad,nl_hi,al_lo,n,raw,seed", [
    (16, 250, 9, 12, False, 12),     # every problem two stripes
    (128, 512, 2, 24, False, 77),    # mixed stripe counts in one batch
    (512, 512, 130, 6, True, 99),    # wide stripes (slen up to 64)
])
def test_cigar_batch_matches_host_engine(al_pad, nl_hi, al_lo, n, raw, seed):
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(seed)
    cases = [_case(rng, 9, nl_hi, al_lo, al_pad + 1) for _ in range(n)]
    cls = st.RawCigarBatch if raw else st.CigarBatch
    extra = dict(sp=sp, trans_code=1) if raw else {}
    batch = cls(al_pad, nl_hi, mat, OPT, device="cpu", **extra)
    _fill(batch, cases, sp, raw, T)
    _assert_host(cases, batch.run(), kw)


@pytest.mark.parametrize("raw", [False, True])
def test_go0_batches_match_host_engine(raw):
    """go == 0: the case the scan kernel cannot take (its proof needs
    go >= 1); the striped DP matches the host engine at go == 0."""
    T, mat, sp, kw = _setup(go=0)
    rng = np.random.default_rng(5 + raw)
    cases = [_case(rng, 9, 400, 2, 129) for _ in range(16)]
    opt = (0,) + OPT[1:]
    cls = st.RawCigarBatch if raw else st.CigarBatch
    extra = dict(sp=sp, trans_code=1) if raw else {}
    batch = cls(128, 400, mat, opt, device="cpu", **extra)
    _fill(batch, cases, sp, raw, T)
    _assert_host(cases, batch.run(), kw)


def test_saturating_regime_matches_host_engine():
    """Inflated scores drive H to the int16 ceiling; the clipped
    arithmetic tracks the saturating host engine."""
    T, mat, sp, kw = _setup()
    hot = mat.reshape(22, 22).copy()
    hot[hot > 0] = 125
    kw = dict(kw, mat=hot)
    rng = np.random.default_rng(29)
    cases = []
    for _ in range(8):
        nl = int(rng.integers(100, 500))
        ns = rng.choice(list(b"ACGT"), nl).astype(np.uint8)
        aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"),
                        int(rng.integers(8, 33))).astype(np.uint8)
        cases.append((ns, aa))
    batch = st.CigarBatch(32, 512, hot, OPT, device="cpu")
    _fill(batch, cases, sp, False, T)
    _assert_host(cases, batch.run(), kw)


def test_raw_batch_and_walk_match_jax_interpret():
    """The same problems through the JAX RawCigarBatch (Pallas interpret
    mode, device walk) give the same scores and CIGARs, and the plain
    walk's state stream equals the JAX _device_backtrack's."""
    import jax.numpy as jnp

    from miniprot_tpu.kernels import nasw_cigar_pallas as jck
    T, mat, sp, kw = _setup()
    rng = np.random.default_rng(1005)
    cases = [_case(rng, 40, 250, 2, 32, AA[:-1]) for _ in range(4)]
    port = st.RawCigarBatch(32, 256, mat, OPT, sp=sp, device="cpu")
    jb = jck.RawCigarBatch(al_pad=32, nl_pad=256, mat=mat, opt_scalars=OPT,
                           sp=sp, trans_code=1)
    _fill(port, cases, sp, True, T)
    _fill(jb, cases, sp, True, T)
    got = port.run()
    want = jb.collect(jb.launch(interpret=True))
    for g, w in zip(got, want):
        assert g[0] == w[0] and np.array_equal(g[1], w[1])
    _assert_host(cases, got, kw)
    # the walk alone, on the port's words
    tb, score, nlv, alv = port._launch_dp()
    steps = port.steps()
    states, fi, fj = st.cell_walk_plain(tb, nlv, alv, steps)
    n, R, W = tb.shape
    tbj = np.zeros((R, W, 128), np.int16)
    tbj[:, :, :n] = tb.numpy().transpose(1, 2, 0)
    nl_v = np.zeros(128, np.int32)
    al_v = np.ones(128, np.int32)
    nl_v[:n], al_v[:n] = port.nlv[:n], port.alv[:n]
    js, jfi, jfj = (np.asarray(x) for x in jck._device_backtrack(
        jnp.asarray(tbj), jnp.asarray(nl_v), jnp.asarray(al_v),
        jnp.asarray((al_v + 7) // 8), R, W, steps))
    assert np.array_equal(states.numpy(), js.T[:n, :steps])
    assert np.array_equal(fi.numpy(), jfi[:n])
    assert np.array_equal(fj.numpy(), jfj[:n])


def test_walk_finishes_within_its_steps():
    """steps() = max nl + max al + 2 leaves every walk done (i < 2 or
    j < 0), so collect never needs a host redo."""
    T, mat, sp, _ = _setup()
    rng = np.random.default_rng(3)
    cases = [_case(rng, 20, 300, 1, 129) for _ in range(10)]
    batch = st.CigarBatch(128, 300, mat, OPT, device="cpu")
    _fill(batch, cases, sp, False, T)
    states, fi, fj, _ = batch.launch()
    assert bool(((fi < 2) | (fj < 0)).all())
    assert bool((states[:, -1] == 15).all())


def _dp32_cases(rng, T, n_exact, n_rand, al_lo, al_hi, nl_hi):
    from miniprot_tpu.testgen import _aa2codons
    codons = _aa2codons()
    cases = []
    for k in range(n_exact + n_rand):
        al = int(rng.integers(al_lo, al_hi + 1))
        if k < n_exact:
            # an exact translated match: the highest-scoring diagonal
            aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al).astype(np.uint8)
            ns = np.frombuffer("".join(codons[chr(c)][0] for c in aa).encode(),
                               np.uint8)
        else:
            ns, aa = _case(rng, 9, nl_hi, al, al + 1)
        cases.append((ns, aa))
    return cases


def _assert_dp32(cases, results, mat, sp, T):
    for (ns, aa), (sc, cig) in zip(cases, results):
        rsc, rcig = native.dp32(ns, aa, flag=DPF_CIGAR, mat=mat, nt4=T.nt4,
                                aa20=T.aa20, codon=T.codon, sp=sp,
                                sp_null_bonus=-7, go=11, ge=1, io=29, fs=23)
        assert sc == rsc, (len(ns), len(aa), sc, rsc)
        assert np.array_equal(cig, rcig), (len(ns), len(aa))


def test_dp32_batch_matches_host_engine():
    """gs32b (4 int32 lanes, no saturation) against the host mx_dp32,
    with exact-codon homologs whose scores pass the int16 range."""
    T, mat, sp, _ = _setup()
    hot = mat.reshape(22, 22).copy()
    hot[np.arange(20), np.arange(20)] = 127
    rng = np.random.default_rng(314)
    cases = _dp32_cases(rng, T, 3, 5, 260, 300, 900)
    batch = st.Dp32Batch(300, 900, hot, OPT, device="cpu")
    _fill(batch, cases, sp, False, T)
    res = batch.run()
    assert max(sc for sc, _ in res[:3]) > 32767
    _assert_dp32(cases, res, hot, sp, T)


def test_dp32_batch_matches_jax_interpret():
    from miniprot_tpu.kernels.nasw_cigar_pallas import Dp32Batch as JaxDp32
    T, mat, sp, _ = _setup()
    rng = np.random.default_rng(315)
    cases = _dp32_cases(rng, T, 2, 4, 2, 16, 250)
    port = st.Dp32Batch(16, 256, mat, OPT, device="cpu")
    jb = JaxDp32(al_pad=16, nl_pad=256, mat=mat, opt_scalars=OPT)
    _fill(port, cases, sp, False, T)
    _fill(jb, cases, sp, False, T)
    got, want = port.run(), jb.run(interpret=True)
    for g, w in zip(got, want):
        assert g[0] == w[0] and np.array_equal(g[1], w[1])
    _assert_dp32(cases, got, mat, sp, T)


def test_plain_words_define_only_valid_cells():
    """The plain DP's words are 0 outside rows [2, nl) and the stripes
    of each problem's own slen (what the card leaves undefined)."""
    T, mat, sp, _ = _setup()
    rng = np.random.default_rng(8)
    cases = [_case(rng, 9, 120, 1, 40) for _ in range(5)]
    batch = st.RawCigarBatch(128, 120, mat, OPT, sp=sp, device="cpu")
    _fill(batch, cases, sp, True, T)
    tb, _, nlv, alv = batch._launch_dp()
    valid = st.valid_cells(nlv, alv, tb.shape[1], tb.shape[2])
    assert bool((tb[~valid] == 0).all()) and bool((tb[valid] != 0).any())


def test_engine_striped_route_and_tb_bytes(monkeypatch):
    """cig_impl="striped" (the MINIPROT_TPU_CIG_IMPL switch) sends every
    CIGAR job to the striped batches, whose tb_bytes() counts the tb
    plane alone (the JAX CigarBatch formula)."""
    from miniprot_tpu.kernels.nasw_cigar_pallas import CigarBatch as JaxCig
    from miniprot_tpu_torch.device import GpuExtEngine
    from miniprot_tpu_torch.options import MapOpt
    T, mat, sp, kw = _setup()
    for W, nl in ((128, 4096), (512, 2048)):
        port = st.RawCigarBatch(W, nl, mat, OPT, sp=sp, device="cpu")
        assert port.tb_bytes() == JaxCig(W, nl, mat, OPT).tb_bytes()
    monkeypatch.setenv("MINIPROT_TPU_CIG_IMPL", "striped")
    engine = GpuExtEngine(MapOpt(), "cpu")
    assert engine.cig_impl == "striped"
    rng = np.random.default_rng(21)
    jobs = [_case(rng, 520, 700, 40, 120, AA[:-2]) for _ in range(3)]
    jobs += [_case(rng, 520, 700, 5, 30, AA[:-2]) for _ in range(2)]
    engine.submit(("cigars", [(ns, aa, None) for ns, aa in jobs]))
    (res,) = engine.flush()
    assert engine.n_device == 5 and engine.n_host == 0
    assert engine.batches["cig_striped"] == 1
    assert engine.batches["cig_small_striped"] == 1
    kw = dict(kw, mat=MapOpt().mat)
    _assert_host(jobs, res, kw)
    with pytest.raises(ValueError):
        GpuExtEngine(MapOpt(), "cpu", cig_impl="fast")


def test_prep_tracks_feed_the_same_words():
    """RawCigarBatch (device prep of raw nt4) and CigarBatch (host prep)
    give the same words for the same problems."""
    T, mat, sp, _ = _setup()
    rng = np.random.default_rng(44)
    cases = [_case(rng, 30, 200, 3, 60) for _ in range(6)]
    raw = st.RawCigarBatch(64, 200, mat, OPT, sp=sp, device="cpu")
    host = st.CigarBatch(64, 200, mat, OPT, device="cpu")
    _fill(raw, cases, sp, True, T)
    _fill(host, cases, sp, False, T)
    a, b = raw._launch_dp(), host._launch_dp()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
