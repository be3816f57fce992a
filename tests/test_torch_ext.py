"""The port's extension DP (kernels/nasw_ext.py) on the CPU, through its
plain PyTorch version, against the host C engine miniprot_tpu.native
(dp16 with DPF_EXT_LEFT/RIGHT) and the JAX RawExtBatch in interpret
mode.  Exact: the DP is integer arithmetic."""
import numpy as np
import pytest
import torch

from miniprot_tpu import native, tables
from miniprot_tpu.native import DPF_EXT_LEFT, DPF_EXT_RIGHT
from miniprot_tpu_torch.kernels import nasw_ext as ne

OPT = (11, 1, 23, 29, 100, 5, 0.5)      # go ge fs io xdrop endb ie_coef


def _setup(mat=None):
    T = tables.get_tables(1)
    if mat is None:
        mat = tables.BLOSUM62.copy()
        tables.set_stop_sc(mat, 23)
    return T, mat, tables.splice_model_scores(1)


def _kw(T, mat, sp, **over):
    kw = dict(mat=mat, nt4=T.nt4, aa20=T.aa20, codon=T.codon, sp=sp,
              sp_null_bonus=-7, go=11, ge=1, io=29, fs=23, xdrop=100,
              end_bonus=5, ie_coef=0.5)
    kw.update(over)
    return kw


def _check(cases, results, kw_for):
    assert len(results) == len(cases)
    for (ns, aa, ext_left, *rest), got in zip(cases, results):
        rsc, rntl, raal, _ = native.dp16(
            ns, aa, flag=DPF_EXT_LEFT if ext_left else DPF_EXT_RIGHT,
            **kw_for(*rest))
        assert got == (rsc, rntl, raal), (len(ns), len(aa), ext_left)


def test_ext_kernel_matches_host_dp():
    T, mat, sp = _setup()
    rng = np.random.default_rng(9)
    batch = ne.ExtBatch(al_pad=128, nl_pad=256, mat=mat, opt_scalars=OPT,
                        device="cpu")
    cases = []
    for _ in range(12):
        nl = int(rng.integers(10, 250))
        al = int(rng.integers(1, 120))
        ext_left = bool(rng.integers(0, 2))
        ns = rng.choice(list(b"ACGT"), nl).astype(np.uint8)
        aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al).astype(np.uint8)
        cases.append((ns, aa, ext_left))
        nas, aas, d, a = ne.prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                         io=29, ext_left=ext_left)
        batch.add(nas, aas, d, a)
    _check(cases, batch.run(), lambda: _kw(T, mat, sp))


def _raw_batch(rng, mat, sp, al_pad, nl_pad, n, T, *, nl_lo=10, al_hi=120,
               ios=(19, 29)):
    batch = ne.RawExtBatch(al_pad=al_pad, nl_pad=nl_pad, mat=mat,
                           opt_scalars=OPT, sp=sp, trans_code=1,
                           device="cpu")
    cases = []
    for _ in range(n):
        nl = int(rng.integers(nl_lo, nl_pad - 6))
        al = int(rng.integers(1, al_hi))
        ext_left = bool(rng.integers(0, 2))
        io = int(rng.choice(ios))
        ns = rng.choice(list(b"ACGTN"), nl,
                        p=[.24, .24, .24, .24, .04]).astype(np.uint8)
        aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al).astype(np.uint8)
        cases.append((ns, aa, ext_left, io))
        nt4, aas = T.nt4[ns], T.aa20[aa]
        if ext_left:
            nt4, aas = nt4[::-1], aas[::-1]
        batch.add_raw(nt4, aas, io=io, ext_left=ext_left)
    return batch, cases


def test_raw_ext_batch_matches_host_dp():
    """Raw nt upload + device prep, mixed left/right with per-problem io."""
    T, mat, sp = _setup()
    batch, cases = _raw_batch(np.random.default_rng(11), mat, sp, 128, 256,
                              16, T)
    _check(cases, batch.run(), lambda io: _kw(T, mat, sp, io=io))


def test_raw_ext_batch_matches_jax_interpret():
    """The same inputs through the JAX RawExtBatch (Pallas interpret
    mode, one 264-row chunk, al <= 32) give the same triples."""
    from miniprot_tpu.kernels.nasw_pallas import RawExtBatch as JaxRawExt
    T, mat, sp = _setup()
    rng = np.random.default_rng(21)
    batch, cases = _raw_batch(rng, mat, sp, 32, 264, 6, T, al_hi=33)
    jb = JaxRawExt(al_pad=32, nl_pad=264, mat=mat, opt_scalars=OPT, sp=sp,
                   trans_code=1)
    for ns, aa, ext_left, io in cases:
        nt4, aas = T.nt4[ns], T.aa20[aa]
        if ext_left:
            nt4, aas = nt4[::-1], aas[::-1]
        jb.add_raw(nt4, aas, io=io, ext_left=ext_left)
    assert batch.run() == jb.run(interpret=True)


def test_device_prep_matches_host_prep():
    """_prep_seq_device + _logpen_device (torch ops) equal the host
    prep_problem + ExtBatch.add tracks, mixed left/right problems with
    per-problem io/al/nl."""
    rng = np.random.default_rng(33)
    T = tables.get_tables(1)
    R, AL, n = 264, 64, 128
    for sp_model in (1, 2):
        sp = tables.splice_model_scores(sp_model)
        nt8 = np.zeros((n, R + 8), np.int8)
        leftb = np.zeros(n, np.int8)
        iov = np.zeros(n, np.int32)
        als = np.ones(n, np.int32)
        nlv = np.zeros(n, np.int32)
        jobs = []
        for b in range(n):
            nl = int(rng.integers(5, R))
            al = int(rng.integers(2, AL))
            nsq = rng.choice(list(b"ACGTNacgtn"), nl).astype(np.uint8)
            asq = rng.choice(list(b"ARNDCQEGHILKMFPSTWYVX*"), al).astype(
                np.uint8)
            left = bool(rng.integers(0, 2))
            io = int(rng.integers(5, 60))
            jobs.append((nsq, asq, left, io, nl, al))
            nt = T.nt4[nsq]
            nt8[b, :nl] = nt[::-1] if left else nt
            leftb[b], iov[b], als[b], nlv[b] = left, io, al, nl
        nas_d, D_d, A_d = ne._prep_seq_device(
            torch.from_numpy(nt8), torch.from_numpy(leftb),
            torch.from_numpy(iov), torch.from_numpy(nlv), sp=sp,
            codon=T.codon, n_rows=R)
        thr = ne._logpen_thresholds(0.5, R)
        pen_d = ne._logpen_device(torch.from_numpy(als), thr, R,
                                  torch.device("cpu")).numpy()
        nas_d, D_d, A_d = nas_d.numpy(), D_d.numpy(), A_d.numpy()
        for b, (nsq, asq, left, io, nl, al) in enumerate(jobs):
            nas, _, donor, acceptor = ne.prep_problem(
                nsq, asq, sp=sp, sp_null_bonus=-7, io=io, ext_left=left)
            D_h = np.zeros(R + 8, np.int32)
            D_h[:nl + 1] = donor.astype(np.int32)[:nl + 1] + io
            A_h = np.zeros(R + 8, np.int32)
            A_h[:nl + 1] = acceptor.astype(np.int32)[:nl + 1]
            assert np.array_equal(nas_d[b, :nl], nas), (sp_model, b)
            assert np.array_equal(D_d[b], D_h), (sp_model, b)
            assert np.array_equal(A_d[b], A_h), (sp_model, b)
            assert np.array_equal(pen_d[b], ne._host_logpen(0.5, R, al)), b


# ---------------------------------------------------------------------------
# Saturation equivalence: the ext DP is int32 and non-saturating; the
# reference saturates at int16.  device.ext_fits_int16 enforces the
# equivalence bound al*max(mat)+end_bonus <= 32767.
# ---------------------------------------------------------------------------


def _perfect_codons(aa_codes, T):
    """nt4 genome spelling each aa code as one codon (perfect match)."""
    rev = np.full(22, -1, np.int64)
    for c in range(63, -1, -1):
        rev[T.codon[c]] = c
    cod = rev[aa_codes]
    assert (cod >= 0).all()
    return np.stack([(cod >> 4) & 3, (cod >> 2) & 3, cod & 3],
                    axis=1).reshape(-1).astype(np.uint8)


def _hot_matrix(diag, off):
    mat = np.full((22, 22), off, np.int32)
    np.fill_diagonal(mat, diag)
    mat[21, :] = mat[:, 21] = off          # X row stays punitive
    return mat


def test_ext_saturation_edge_bit_exact():
    """Scores driven to the int16 edge (true max 32261 with a 512-aa
    perfect match at diag=63) still equal the saturating host engine."""
    T = tables.get_tables(1)
    mat = _hot_matrix(63, -3)
    sp = tables.splice_model_scores(1)
    rng = np.random.default_rng(77)
    batch = ne.RawExtBatch(al_pad=512, nl_pad=2640, mat=mat, opt_scalars=OPT,
                           sp=sp, trans_code=1, device="cpu")
    aa_pool = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    cases = []
    for k in range(12):
        al = 512 if k < 4 else int(rng.integers(64, 512))
        aa = rng.choice(aa_pool, al).astype(np.uint8)
        nt4 = _perfect_codons(T.aa20[aa], T)
        if k % 2:  # mutate a few codons so mismatch penalties engage
            pos = rng.integers(0, len(nt4), max(2, len(nt4) // 50))
            nt4 = nt4.copy()
            nt4[pos] = (nt4[pos] + 1) % 4
        tail = rng.integers(0, 4, int(rng.integers(0, 800))).astype(np.uint8)
        nt4 = np.concatenate([nt4, tail])
        ext_left = bool(rng.integers(0, 2))
        ns = np.frombuffer(b"ACGT", np.uint8)[nt4]
        cases.append((ns, aa, ext_left))
        if ext_left:
            batch.add_raw(nt4[::-1], T.aa20[aa][::-1], io=29, ext_left=True)
        else:
            batch.add_raw(nt4, T.aa20[aa], io=29)
    results = batch.run()
    _check(cases, results, lambda: _kw(T, mat, sp))
    assert sum(r[0] > 30000 for r in results) >= 2, \
        "the test must reach the int16 edge"


def test_ext_saturation_deep_negative_bit_exact():
    """Adversarial penalties (go=120, ge=60, fs=125) push intermediate
    values far below -32768 in int32 terms; the outputs still agree."""
    T = tables.get_tables(1)
    mat = _hot_matrix(63, -120)
    sp = tables.splice_model_scores(1)
    rng = np.random.default_rng(78)
    batch = ne.RawExtBatch(al_pad=512, nl_pad=2112, mat=mat,
                           opt_scalars=(120, 60, 125, 29, 1 << 28, 5, 0.5),
                           sp=sp, trans_code=1, device="cpu")
    aa_pool = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    cases = []
    for _ in range(12):
        al = int(rng.integers(200, 512))
        nl = int(rng.integers(1100, 2100))
        aa = rng.choice(aa_pool, al).astype(np.uint8)
        nt4 = rng.integers(0, 4, nl).astype(np.uint8)
        ext_left = bool(rng.integers(0, 2))
        ns = np.frombuffer(b"ACGT", np.uint8)[nt4]
        cases.append((ns, aa, ext_left))
        if ext_left:
            batch.add_raw(nt4[::-1], T.aa20[aa][::-1], io=29, ext_left=True)
        else:
            batch.add_raw(nt4, T.aa20[aa], io=29)
    _check(cases, batch.run(),
           lambda: _kw(T, mat, sp, go=120, ge=60, fs=125, xdrop=1 << 28))


def test_ext_saturation_beyond_bound_routes_to_host():
    """A matrix whose attainable score exceeds int16 (diag=127, al=300)
    saturates the reference path and is routed to the host engine by
    ext_fits_int16, so the engine's result keeps saturating semantics."""
    from miniprot_tpu_torch.device import GpuExtEngine, ext_fits_int16
    from miniprot_tpu_torch.options import MapOpt
    assert ext_fits_int16(512, 63, 5) and not ext_fits_int16(512, 64, 5)
    T = tables.get_tables(1)
    opt = MapOpt()
    opt.mat = _hot_matrix(127, -3)
    rng = np.random.default_rng(79)
    aa_pool = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    aa = rng.choice(aa_pool, 300).astype(np.uint8)
    nt4 = _perfect_codons(T.aa20[aa], T)
    nt4 = np.concatenate([nt4, rng.integers(0, 4, 1200).astype(np.uint8)])
    ns = np.frombuffer(b"ACGT", np.uint8)[nt4]
    sp = tables.splice_model_scores(1)
    kw = dict(mat=opt.mat, nt4=T.nt4, aa20=T.aa20, codon=T.codon, sp=sp,
              sp_null_bonus=-7, go=opt.go, ge=opt.ge, io=opt.io, fs=opt.fs,
              xdrop=opt.xdrop, end_bonus=opt.end_bonus, ie_coef=opt.ie_coef)
    rsc, rntl, raal, _ = native.dp16(ns, aa, flag=DPF_EXT_RIGHT, **kw)
    assert rsc == 32767 + opt.end_bonus, \
        "reference semantics must saturate here"
    engine = GpuExtEngine(opt, "cpu")
    engine.submit(("ext", ns, aa, None, opt.io, False))
    (res,) = engine.flush()
    assert engine.n_host == 1 and engine.n_device == 0
    assert res == (rsc, rntl, raal)


@pytest.mark.parametrize("nsq,asq,left", [
    (b"CCATTAAACTGGAGAGTAT", b"NWRV", True),
    (b"GAGCGGAGAATGGACCTGCCCAATGGCAAT", b"SGEWQCPMA", True),
    (b"GCGTAGACTACAGAATGAAATGGCAATACTTCGTACTTCCCGATACCGGGTTAAAGTTGTT",
     b"VDYRMKWQYF", False),
])
def test_ext_boundary_column_only_at_row2(nsq, asq, left):
    """The [-1] column's 0/-fs/-fs values exist at row 2 only; from row 3
    on the reference rebuilds the column from the previous rows' last
    stripe, NEG at lane 0 (the host engine's dp16_ext_w).  These windows
    start one or two bases before a homologous stretch, where a start
    through H(0,-1) = -fs at row 3 would score higher; the JAX ext kernel
    (nasw_pallas.py:125-128) keeps those values through row 4 and
    reports (8, 13, 4) for the first case, the host engine (3, 13, 4)."""
    from miniprot_tpu_torch.align import DpEnv
    from miniprot_tpu_torch.options import MapOpt
    T = tables.get_tables(1)
    opt = MapOpt()
    sp = DpEnv(opt).sp
    ns = np.frombuffer(nsq, np.uint8)
    aa = np.frombuffer(asq, np.uint8)
    batch = ne.RawExtBatch(32, 264, opt.mat, (opt.go, opt.ge, opt.fs, opt.io,
                                               opt.xdrop, opt.end_bonus,
                                               opt.ie_coef), sp=sp,
                           device="cpu")
    nt4, aas = T.nt4[ns], T.aa20[aa]
    if left:
        nt4, aas = nt4[::-1], aas[::-1]
    batch.add_raw(nt4, aas, io=opt.io, ext_left=left)
    kw = _kw(T, opt.mat, sp, go=opt.go, ge=opt.ge, io=opt.io, fs=opt.fs,
             xdrop=opt.xdrop, end_bonus=opt.end_bonus, ie_coef=opt.ie_coef,
             sp_null_bonus=opt.sp_null_bonus)
    _check([(ns, aa, left)], batch.run(), lambda: kw)


def _indel_homolog(rng, al, nl):
    """A window spelling a random protein in codons, with three random
    insertions or deletions, padded with random bases to nl."""
    from miniprot_tpu_torch.testgen import _aa2codons
    codons = _aa2codons()
    aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al).astype(np.uint8)
    ns = np.frombuffer("".join(codons[chr(c)][0] for c in aa).encode(),
                       np.uint8)
    for _ in range(3):
        p, k = int(rng.integers(0, len(ns))), int(rng.integers(1, 12))
        ins = rng.choice(list(b"ACGT"), k).astype(np.uint8)
        ns = (np.concatenate([ns[:p], ins, ns[p:]]) if rng.random() < .5
              else np.concatenate([ns[:p], ns[p + k:]]))
    tail = rng.choice(list(b"ACGT"), max(0, nl - len(ns))).astype(np.uint8)
    return np.concatenate([ns, tail])[:nl], aa


@pytest.mark.parametrize("go", [0, 1])
def test_ext_gap_open_0_follows_8lane_lazy_f(go, monkeypatch):
    """At go == 0 the reference's lazy-F breaks at its first step, so the
    exact prefix-max I (right for go >= 1) overshoots: the plain DP runs
    I inside each SSE lane plus one step into the next lane.  Held
    against the port's host engine and the JAX package's 8-lane
    extension path (its AVX-512 wide path is taken only for go > 0 in
    the port).  Reproducer (ROADMAP Queue C): a left extension scored 87
    by the 8-lane path, 83 by the JAX engine's wide path, 88 by the JAX
    ext kernel."""
    import ctypes as ct

    from miniprot_tpu_torch import native as tnative
    try:
        monkeypatch.setattr(ct.c_int32.in_dll(native._lib, "mx_no_wide_ext"),
                            "value", 1)
    except ValueError:
        pass                       # a build without the wide path
    T, mat, sp = _setup()
    rng = np.random.default_rng(9 + go)
    opt = (go,) + OPT[1:]
    batch = ne.ExtBatch(128, 600, mat, opt, device="cpu")
    cases = [(np.frombuffer(b"GACTTCAACCTAGCAAACTGCGAACGCACAACAAAAGCATAGAC"
                            b"GTAGTAATAGAAGACCTAAAAATGCTA", np.uint8),
              np.frombuffer(b"DFNLANCEHMYNAQHSTNYFTSIDVVIEDLKML", np.uint8),
              True)]
    for _ in range(47):
        al = int(rng.integers(20, 128))
        ns, aa = _indel_homolog(rng, al, int(rng.integers(3 * al, 600)))
        cases.append((ns, aa, bool(rng.integers(0, 2))))
    for ns, aa, left in cases:
        nas, aas, d, a = ne.prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                         io=29, ext_left=left)
        batch.add(nas, aas, d, a)
    got = batch.run()
    kw = _kw(T, mat, sp, go=go)
    _check(cases, got, lambda: kw)
    for (ns, aa, left), g in zip(cases, got):
        assert g == tnative.dp16(ns, aa, flag=DPF_EXT_LEFT if left
                                 else DPF_EXT_RIGHT, **kw)[:3]
    if go == 0:
        assert got[0] == (87, 71, 33)
