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


# ---------------------------------------------------------------------------
# The identities K4 rests on: the striped words of a genome row are the
# position-order words of the scan DP (two prefix scans per row), and at
# go == 0 the lazy-F fixup is one step at each stripe-segment start.  Its
# B4' form (4 wrapping int32 lanes) rests on the same identities, with
# the floors of points below.
# ---------------------------------------------------------------------------

# B4' scan values carry their position as (q - QOFF) * ge with QOFF the
# widest class (1024), so they never pass INT_MAX (striped_cigar.cu)
QOFF = 1024
SENT32 = -(3 << 29)          # B4' scan "no value": below every scan value


def _k4_rows(nas, D, A, nlv, alv, aas, mat, opts, rows, vl=st.VL):
    """Plain position-order model of K4's rows (not on the card path):
    the order-free terms of each genome row, the segmented I scan
    (segments of slen = ceil(al / vl) positions) for the state nibble and
    bit 4; then at go >= 1 the full-row scan for bit 9 and the final H,
    at go == 0 one lazy-F step at each segment start q = k * slen: H(q) =
    max(hp1(q), hp1(q - 1) - ge), bit 9 where the second term is larger.
    The words are stored in striped column order, (q % slen) * vl + q //
    slen.  Same arguments and results as striped_cigar_dp_plain (vl = 8,
    saturating int16: B4) or striped_cigar_dp32_plain (vl = 4, wrapping
    int32: B4').  B4' differs in its floors: I starts each stripe segment
    at NEG32 - ge (folded into the segment's first scan value); the lazy-F
    fixup shifts NEG32 into lane 0, which reaches position q as NEG32 -
    q * ge (the full scan's seed, and at go == 0 position 0's one step);
    bit 4 is set at a segment start where go > 0 (NEG32 > NEG32 - go)."""
    from miniprot_tpu_torch.kernels.nasw_cigar_scan import (
        _left, _row_terms, _sadd, _ssub, _state_nibble)
    sat = vl == st.VL
    n, R = nas.shape
    W = aas.shape[1]
    go, ge, fs = (int(v) for v in opts)
    i32, i64 = torch.int32, torch.int64
    if sat:
        NEG, NEGI, add, sub = st.NEG16, -(1 << 29), _sadd, _ssub
    else:
        NEG, NEGI, add, sub = st.NEG32, SENT32, torch.add, torch.sub
    q = torch.arange(W, dtype=i32).view(1, W)
    qg = q.to(i64) * ge if sat else (q.to(i64) - QOFF) * ge
    sl = torch.clamp((alv + vl - 1) // vl, min=1).view(n, 1)
    seg0 = q % sl == 0
    # segment starts of lanes 1..vl-1, and in B4' position 0 (NEG32 in)
    fix = seg0 & ((q > 0) if sat else True) & (q < vl * sl)
    segkey = (q // sl).to(i64) << 34
    prof = mat.to(i32)[:, aas.long().clamp(min=0)].permute(1, 0, 2)
    prof = torch.where(q.view(1, 1, W) >= alv.view(n, 1, 1), NEG, prof)
    D, A = D.to(i32), A.to(i32)

    def full(v):
        return torch.full((n, W), v, dtype=i32)

    def to32(x):
        # what the card computes in int32 must not have wrapped
        assert int(x.min()) >= -(1 << 31) and int(x.max()) < (1 << 31)
        return x.to(i32)

    H1, H2, H3, D1, D2, D3 = (full(NEG) for _ in range(6))
    Ac, Bc, Cc = full(NEG), full(NEG), full(NEG)
    ar = torch.arange(n)
    words = torch.zeros((n, rows, W), dtype=i32)
    score = torch.full((n,), NEG, dtype=i32)
    for i in range(2, min(int(nlv.max()), rows)):
        match, cands, bits, (Ac, Bc, Cc) = _row_terms(
            i, nas, D, A, prof[ar, nas[:, i].long()], (H1, H2, H3), D3,
            (Ac, Bc, Cc), (go, ge, fs), NEG, add, sub)
        base = match
        for x in cands:
            base = torch.maximum(base, x)
        v = sub(base, go)
        if not sat:
            v = torch.where(seg0, v.clamp(min=NEG - ge), v)
        u = to32(v.to(i64) + qg)
        assert int(u.min()) > NEGI
        SM = torch.cummax(segkey + (u.to(i64) + (1 << 32)), dim=1).values
        SM = SM - segkey - (1 << 32)
        if sat:
            Iused = torch.clamp(torch.where(seg0, NEGI, _left(SM, NEGI))
                                - qg, min=NEG).to(i32)
        else:
            Iused = to32(torch.where(seg0, NEG - ge, _left(SM, NEGI) - qg))
        hp1 = torch.maximum(base, Iused)
        b4 = torch.where(seg0, (not sat) and go > 0,
                         _left(Iused, NEGI) > _left(sub(hp1, go), 0))
        if go >= 1:
            pre = _left(torch.cummax(u, dim=1).values, NEGI).to(i64)
            if sat:
                Istar = torch.clamp(pre - qg, min=NEG).to(i32)
                H = torch.maximum(base, Istar)
            else:
                Istar = to32(torch.clamp(pre, min=NEG - QOFF * ge) - qg)
                H = torch.maximum(hp1, Istar)
            b9 = Istar > hp1
        else:
            Iin = sub(_left(hp1, NEG), ge)
            if not sat:
                Iin = torch.where(q == 0, NEG, Iin)
            Iin = torch.where(fix, Iin, NEG if sat else NEGI)
            b9 = Iin > hp1
            H = torch.maximum(hp1, Iin)
        word = _state_nibble(match, Iused, cands) | (b4.to(i32) << 4)
        for k, b in enumerate(bits + (b9,), 5):
            word = word | (b.to(i32) << k)
        words[:, i] = word
        score = torch.where(nlv - 1 == i, H[ar, (alv - 1).long()], score)
        H3, H2, H1 = H2, H1, H
        D3, D2, D1 = D2, D1, cands[0]
    valid = st.valid_cells(nlv, alv, rows, W, vl)
    return torch.where(valid, _to_striped(words, alv, vl), 0), score


def _to_striped(words, alv, vl=st.VL):
    """(n, rows, W) position-order words -> striped column order,
    (q % slen) * vl + q // slen; columns past vl * slen are 0."""
    n, rows, W = words.shape
    sl = torch.clamp((alv.long() + vl - 1) // vl, min=1).view(n, 1)
    q = torch.arange(W).view(1, W)
    col = torch.where(q < vl * sl, (q % sl) * vl + q // sl, W)
    out = torch.zeros((n, rows, W + 1), dtype=words.dtype)
    out.scatter_(2, col.view(n, 1, W).expand(n, rows, W), words)
    return out[:, :, :W].to(torch.int16)


def _batch_args(batch):
    n = batch.n
    nlv, alv = batch._lens()
    return (*batch._tracks(), nlv, alv, torch.from_numpy(batch.aas[:n]),
            torch.from_numpy(batch.mat), (batch.go, batch.ge, batch.fs),
            batch._rows())


def _identity_batch(W, go, seed):
    """A CigarBatch of class width W with al = 1, al = W, al that leaves
    the last stripe segment short, and nl from 2 rows up (mixed in one
    batch); its K4 arguments on the CPU."""
    T, mat, sp, _ = _setup(go)
    rng = np.random.default_rng(seed)
    n, nl_hi = (10, 120) if W == 512 else (16, 200)
    als = [1, W, W - 3, 8 * (W // 16) + 5, 9, 2]
    batch = st.CigarBatch(W, nl_hi, mat, (go,) + OPT[1:], device="cpu",
                          capacity=n)
    cases = []
    for k in range(n):
        al = als[k] if k < len(als) else int(rng.integers(1, W + 1))
        nl = (2, 3, 5)[k] if k < 3 else int(rng.integers(20, nl_hi))
        ns, aa = _case(rng, nl, nl + 1, al, al + 1)
        cases.append((ns, aa))
    _fill(batch, cases, sp, False, T)
    return _batch_args(batch)


def _identity_batch32(W, go, seed):
    """A Dp32Batch of width W (any multiple of 4) on BLOSUM62 with 127 on
    the diagonal: al = 1, W, W - 3 and 4 * (W // 8) + 5 (al not a
    multiple of 4: pad positions in lane 3), nl from 2 rows up, and
    exact-codon homologs (al up to 300) whose scores pass 32767 where W
    allows; its B4' arguments on the CPU."""
    T, mat, sp, _ = _setup(go)
    hot = mat.reshape(22, 22).copy()
    hot[np.arange(20), np.arange(20)] = 127
    rng = np.random.default_rng(seed)
    als = [1, W, W - 3, 4 * (W // 8) + 5, 9, 2]
    hom = [min(W, 300), min(W, 290), min(W, 277)]
    batch = st.Dp32Batch(W, 920, hot, (go,) + OPT[1:], device="cpu",
                         capacity=len(als) + len(hom) + 3)
    cases = []
    for k, al in enumerate(als):
        nl = (2, 3, 5)[k] if k < 3 else int(rng.integers(20, 160))
        cases.append(_case(rng, nl, nl + 1, al, al + 1))
    cases += [_dp32_cases(rng, T, 1, 0, al, al, 0)[0] for al in hom]
    cases += [_case(rng, 40, 400, al, al + 1)
              for al in rng.integers(1, W + 1, 3)]
    _fill(batch, cases, sp, False, T)
    return _batch_args(batch)


@pytest.mark.parametrize("W,go", [(W, go) for W in (32, 128, 512)
                                  for go in (0, 1, 11)])
def test_k4_row_model_matches_striped_plain(W, go):
    """The position-order rows (two scans at go >= 1; pass 1 plus one
    fixup step at the segment starts at go == 0) give _striped_plain's
    words, every bit, and its scores."""
    args = _identity_batch(W, go, 400 + W + go)
    tb, score = st.striped_cigar_dp_plain(*args)
    tb_m, score_m = _k4_rows(*args)
    assert torch.equal(score_m, score)
    assert torch.equal(tb_m, tb)
    b9 = (tb.to(torch.int32) >> 9) & 1
    if go == 0:
        # the lazy-F break holds after its first step: bit 9 only in
        # stripe 0 of lanes 1-7 (columns 1..7)
        assert int(b9[:, :, 8:].sum()) == 0 and int(b9.sum()) > 0
    else:
        assert int(b9[:, :, 8:].sum()) > 0


@pytest.mark.parametrize("W,go", [(W, go) for W in (32, 128, 300, 512, 1024)
                                  for go in (0, 1, 11)])
def test_b4p_row_model_matches_striped_plain(W, go):
    """B4' (4 wrapping int32 lanes, what K4's striped32_kernel computes):
    the position-order rows give striped_cigar_dp32_plain's words on
    every valid cell, every bit, and its scores.  The batches hold pad
    positions (al not a multiple of 4; at go == 0 their match term
    wraps past INT_MIN, as paddd does), scores past 32767
    where W >= 300, and bit 9 beyond stripe 0 at go >= 1."""
    args = _identity_batch32(W, go, 600 + W + go)
    tb, score = st.striped_cigar_dp32_plain(*args)
    tb_m, score_m = _k4_rows(*args, vl=st.VL32)
    assert torch.equal(score_m, score)
    assert torch.equal(tb_m, tb)
    alv = args[4]
    assert bool((alv % st.VL32 != 0).any())
    if W >= 300:
        assert int(score.max()) > 32767
    b9 = (tb.to(torch.int32) >> 9) & 1
    if go == 0:
        # one lazy-F step: bit 9 only in stripe 0 (columns 0..3)
        assert int(b9[:, :, 4:].sum()) == 0 and int(b9.sum()) > 0
    else:
        assert int(b9[:, :, 4:].sum()) > 0


@pytest.mark.parametrize("W,go", [(32, 0), (128, 1), (300, 11)])
def test_b4p_lazy_f_pass_cap_changes_no_word(W, go):
    """gs32b (and the host mx_dp32) stop the lazy-F fixup after 4 passes,
    the JAX Dp32Batch after 8.  With 4 lanes every lane's start I has
    reached every later lane by pass 3, so later passes carry only the
    NEG32 shifted into lane 0, which lies below every H it meets: 8
    passes give the same words and scores as 4."""
    args = _identity_batch32(W, go, 700 + W + go)
    tb4, sc4 = st._striped_plain(st.VL32, *args)
    tb8, sc8 = st._striped_plain(st.VL32, *args, passes=8)
    assert torch.equal(sc4, sc8) and torch.equal(tb4, tb8)


@pytest.mark.parametrize("W", [1028, 1026, 0])
def test_dp32_width_outside_its_classes_raises(W):
    """B4' runs W a multiple of 4 up to 1024 (the widest class); any
    other W raises on either device, the CPU's plain version included."""
    n, R = 1, 8
    args = (torch.zeros((n, R), dtype=torch.int8),
            torch.zeros((n, R + 8), dtype=torch.int32),
            torch.zeros((n, R + 8), dtype=torch.int32),
            torch.full((n,), 5, dtype=torch.int32),
            torch.ones(n, dtype=torch.int32),
            torch.zeros((n, W), dtype=torch.int8),
            torch.zeros((22, 22), dtype=torch.int8), (11, 1, 23), R)
    with pytest.raises(ValueError):
        st.striped_cigar_dp32(*args)


@pytest.mark.parametrize("W,go", [(W, go) for W in (32, 128, 512)
                                  for go in (1, 11)])
def test_striped_words_are_scan_words_permuted(W, go):
    """At go >= 1 the striped words equal the scan DP's words (hint
    plane ignored) moved into striped columns, with one difference the
    walk erases: where bit 9 is set, the scan word's nibble is 1 (the
    state the walk reads there) and the striped word keeps its pass-1
    nibble.  The scores agree."""
    from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
    nas, D, A, nlv, alv, aas, mat, opts, rows = _identity_batch(
        W, go, 500 + W + go)
    prof = mat[:, aas.long()].permute(1, 0, 2).contiguous()
    tb_s, _, score_s = sk.scan_cigar_dp_plain(nas, D, A, nlv, alv, prof,
                                              opts, rows)
    tb, score = st.striped_cigar_dp_plain(nas, D, A, nlv, alv, aas, mat,
                                          opts, rows)
    assert torch.equal(score_s, score)
    valid = st.valid_cells(nlv, alv, rows, W)
    scan = torch.where(valid, _to_striped(tb_s.to(torch.int32), alv),
                       0).to(torch.int32)
    strp = tb.to(torch.int32)
    b9 = (strp >> 9) & 1 == 1
    assert torch.equal(scan >> 4, strp >> 4)
    assert torch.equal(torch.where(b9, 0, scan), torch.where(b9, 0, strp))
    assert bool(((scan & 15)[b9] == 1).all()) and bool(b9.any())


@pytest.mark.parametrize("cls_name,W", [("SmallCigarBatch", 32),
                                        ("RawCigarBatch", 128),
                                        ("RawCigarBatch", 512),
                                        ("CigarBatch", 128)])
def test_striped_capacity_grows_like_the_scan_batches(cls_name, W):
    """The engine sizes striped batches with device.cig_capacity on
    their own tb-only planes: at every nl bucket a power of two, never
    below the class's own (128, 512 for the al <= 32 class), within the
    cells and planes caps, the largest such, and never below the scan
    class's capacity at the same bucket (half the planes)."""
    from miniprot_tpu_torch import device
    from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
    cls = getattr(st, cls_name)
    scan = {32: sk.SmallScanCigarBatch, 128: sk.RawScanCigarBatch,
            512: sk.RawScanCigarBatch}[W]
    floor = 512 if W == 32 else 128
    assert cls.CAPACITY == floor and cls.PLANES == 1
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
        if scan.planes_bytes(nl_b, W) <= tb_cap:
            assert cap >= device.cig_capacity(scan, nl_b, W, tb_cap)
    assert device.cig_capacity(cls, 2048, W, tb_cap) >= (4 * floor if W < 512
                                                         else 2 * floor)


def test_engine_striped_batches_past_the_class_capacity():
    """At go == 0 (-O 0), 150 CIGAR jobs of one bucket go in one striped
    launch (two at the class capacity of 128), decode to the host
    engine's CIGARs, and the engine counts the launch's problems."""
    from miniprot_tpu_torch.device import GpuExtEngine
    from miniprot_tpu_torch.options import MapOpt
    T, mat, sp, kw = _setup(go=0)
    rng = np.random.default_rng(31)
    jobs = [_case(rng, 514, 560, 33, 121, AA[:-2]) for _ in range(150)]
    opt = MapOpt()
    opt.go = 0
    engine = GpuExtEngine(opt, "cpu")
    engine.submit(("cigars", [(ns, aa, None) for ns, aa in jobs]))
    (res,) = engine.flush()
    assert engine.batches["cig_striped"] == 1 and engine.n_device == 150
    assert engine.bucket_problems == {("cig_striped", 128, 2048): [150, 150]}
    _assert_host(jobs[::6], res[::6], dict(kw, mat=opt.mat))
