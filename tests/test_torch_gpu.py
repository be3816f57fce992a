"""The port's CUDA kernels K1-K6 against their plain PyTorch versions on
the card (exact: the DPs and the sketch are integer arithmetic).

Marked ``gpu``: they need an NVIDIA card of compute capability >= 9.0
and skip elsewhere.  Run on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from miniprot_tpu_torch import tables
from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
from miniprot_tpu_torch.kernels import nasw_cigar_striped as st
from miniprot_tpu_torch.kernels import nasw_ext as ne
from miniprot_tpu_torch.kernels import sketch_gpu

pytestmark = pytest.mark.gpu

OPT = (11, 1, 23, 29, 100, 5, 0.5)


@pytest.fixture
def cuda_card():
    from miniprot_tpu_torch.kernels import on_gpu_backend
    if not on_gpu_backend():
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    return torch.device("cuda")


def _setup():
    T = tables.get_tables(1)
    mat = tables.BLOSUM62.copy()
    tables.set_stop_sc(mat, 23)
    return T, mat, tables.splice_model_scores(1)


def _ext_batch(dev, al_pad, nl_pad, n, seed, opt=OPT):
    T, mat, sp = _setup()
    rng = np.random.default_rng(seed)
    batch = ne.RawExtBatch(al_pad, nl_pad, mat, opt, sp=sp, device=dev,
                           capacity=n)
    for _ in range(n):
        nl = int(rng.integers(nl_pad // 2, nl_pad))
        al = int(rng.integers(1, al_pad + 1))
        left = bool(rng.integers(0, 2))
        nt4 = rng.integers(0, 5, nl).astype(np.uint8)
        aas = T.aa20[rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al)]
        batch.add_raw(nt4, aas, io=int(rng.choice([19, 29])), ext_left=left)
    return batch


def _ext_inputs(batch):
    """The K1 arguments a RawExtBatch launch builds on its device."""
    n, dev = batch.n, batch.device
    thr = ne._logpen_thresholds(float(np.float32(batch.ie_coef)), batch.nl)
    als = ne._upload(batch.als[:n], dev)
    nlv = ne._upload(batch.nlv[:n], dev)
    nas, D, A = ne._prep_seq_device(
        ne._upload(batch.nt[:n], dev), ne._upload(batch.leftb[:n], dev),
        ne._upload(batch.iov[:n], dev), nlv, sp=batch.sp,
        codon=tables.get_tables(1).codon, n_rows=batch.nl)
    logpen = ne._logpen_device(als, thr, batch.nl, dev)
    return (nas, D, A, logpen, nlv, als, ne._upload(batch.prof[:n], dev),
            ne._opts(batch))


@pytest.mark.parametrize("al_pad,nl_pad", [(128, 600), (512, 900),
                                           (1024, 2112)])
def test_ext_kernel_matches_plain(cuda_card, al_pad, nl_pad):
    args = _ext_inputs(_ext_batch(cuda_card, al_pad, nl_pad, 24, al_pad))
    got = ne.ext_dp(*args)
    want = ne.ext_dp_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ext_kernel_go0_matches_plain(cuda_card):
    """K1's go == 0 form (I inside each SSE lane plus one step into the
    next) against its plain version."""
    args = _ext_inputs(_ext_batch(cuda_card, 512, 900, 24, 3,
                                  (0,) + OPT[1:]))
    got = ne.ext_dp(*args)
    want = ne.ext_dp_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _scan_batch(dev, W, nl_pad, n, seed):
    T, mat, sp = _setup()
    rng = np.random.default_rng(seed)
    cls = sk.SmallScanCigarBatch if W == 32 else sk.RawScanCigarBatch
    batch = cls(W, nl_pad, mat, OPT, sp=sp, device=dev)
    for _ in range(n):
        nl = int(rng.integers(3, nl_pad))
        al = int(rng.integers(1, W + 1))
        nt4 = rng.integers(0, 5, nl).astype(np.uint8)
        aas = T.aa20[rng.choice(list(b"ARNDCQEGHILKMFPSTWYVX*"), al)]
        batch.add_raw(nt4, aas, io=29)
    return batch


def _scan_inputs(batch):
    n, dev, R = batch.n, batch.device, batch._rows()
    nas, D, A = ne._prep_seq_device(
        ne._upload(batch.nt[:n, :R + 8], dev),
        torch.zeros(n, dtype=torch.int8, device=dev),
        ne._upload(batch.iov[:n], dev), ne._upload(batch.nlv[:n], dev),
        sp=batch.sp, codon=tables.get_tables(1).codon, n_rows=R)
    return (nas, D, A, ne._upload(batch.nlv[:n], dev),
            ne._upload(batch.alv[:n], dev), ne._upload(batch.prof[:n], dev),
            (batch.go, batch.ge, batch.fs), R)


@pytest.mark.parametrize("W,nl_pad,n", [(32, 700, 300), (128, 600, 40),
                                        (512, 500, 20)])
def test_scan_and_walk_kernels_match_plain(cuda_card, W, nl_pad, n):
    batch = _scan_batch(cuda_card, W, nl_pad, n, W + 1)
    args = _scan_inputs(batch)
    tb, hint, score = sk.scan_cigar_dp(*args)
    tb_p, hint_p, score_p = sk.scan_cigar_dp_plain(*args)
    torch.cuda.synchronize()
    valid = sk.valid_rows(args[3], args[7])
    assert torch.equal(torch.where(valid, tb, 0), tb_p)
    assert torch.equal(torch.where(valid, hint, 0), hint_p)
    assert torch.equal(score, score_p)
    rounds = batch.rounds()
    walk = sk.run_walk(tb_p, hint_p, args[3], args[4], rounds)
    walk_p = sk.run_walk_plain(tb_p, hint_p, args[3], args[4], rounds)
    torch.cuda.synchronize()
    for a, b in zip(walk, walk_p):
        assert torch.equal(a, b)


def test_batches_on_card_match_host_engine(cuda_card):
    """The batch classes on the card decode to the host C engine's
    scores and CIGARs (the port's own native.dp16)."""
    from miniprot_tpu_torch import native
    from miniprot_tpu_torch.native import DPF_CIGAR
    T, mat, sp = _setup()
    kw = dict(mat=mat, nt4=T.nt4, aa20=T.aa20, codon=T.codon, sp=sp,
              sp_null_bonus=-7, go=11, ge=1, io=29, fs=23, xdrop=100,
              end_bonus=5, ie_coef=0.5)
    rng = np.random.default_rng(5)
    batch = sk.RawScanCigarBatch(128, 1024, mat, OPT, sp=sp,
                                 device=cuda_card)
    cases = []
    for _ in range(50):
        nl = int(rng.integers(200, 1000))
        al = int(rng.integers(30, 129))
        ns = rng.choice(list(b"ACGTN"), nl,
                        p=[.24, .24, .24, .24, .04]).astype(np.uint8)
        aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al).astype(np.uint8)
        cases.append((ns, aa))
        batch.add_raw(T.nt4[ns], T.aa20[aa], io=29)
    for (ns, aa), r in zip(cases, batch.run()):
        rsc, _, _, rcig = native.dp16(ns, aa, flag=DPF_CIGAR, **kw)
        assert r is not None and r[0] == rsc and np.array_equal(r[1], rcig)


@pytest.mark.parametrize("W,nl_pad,n,go,dp32", [
    (32, 700, 300, 11, False), (128, 600, 40, 0, False),
    (512, 500, 20, 11, False), (128, 600, 40, 11, True)])
def test_striped_and_walk_kernels_match_plain(cuda_card, W, nl_pad, n, go,
                                              dp32):
    """K4 (both forms, go == 0 included) and K5 against their plain
    versions on the same device inputs."""
    T, mat, sp = _setup()
    rng = np.random.default_rng(W + go)
    opt = (go,) + OPT[1:]
    raw_cls = st.SmallCigarBatch if W <= 32 else st.RawCigarBatch
    batch = (st.Dp32Batch(W, nl_pad, mat, opt, device=cuda_card) if dp32
             else raw_cls(W, nl_pad, mat, opt, sp=sp, device=cuda_card))
    for _ in range(n):
        nl = int(rng.integers(3, nl_pad))
        al = int(rng.integers(1, W + 1))
        ns = rng.choice(list(b"ACGTN"), nl).astype(np.uint8)
        aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYVX*"), al).astype(np.uint8)
        if dp32:
            nas, aas, d, a = ne.prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                             io=29, ext_left=False)
            batch.add(nas, aas, d, a)
        else:
            batch.add_raw(T.nt4[ns], T.aa20[aa], io=29)
    dev, n = cuda_card, batch.n
    nlv = ne._upload(batch.nlv[:n], dev)
    alv = ne._upload(batch.alv[:n], dev)
    args = (*batch._tracks(), nlv, alv, ne._upload(batch.aas[:n], dev),
            ne._upload(batch.mat, dev), (batch.go, batch.ge, batch.fs),
            batch._rows())
    dp, plain = ((st.striped_cigar_dp32, st.striped_cigar_dp32_plain)
                 if dp32 else (st.striped_cigar_dp, st.striped_cigar_dp_plain))
    tb, score = dp(*args)
    tb_p, score_p = plain(*args)
    torch.cuda.synchronize()
    valid = st.valid_cells(nlv, alv, tb.shape[1], tb.shape[2],
                           batch.VLANES)
    assert torch.equal(torch.where(valid, tb, 0), tb_p)
    assert torch.equal(score, score_p)
    if not dp32:
        walk = st.cell_walk(tb_p, nlv, alv, batch.steps())
        walk_p = st.cell_walk_plain(tb_p, nlv, alv, batch.steps())
        torch.cuda.synchronize()
        for a, b in zip(walk, walk_p):
            assert torch.equal(a, b)


def test_sketch_kernel_matches_plain(cuda_card):
    rng = np.random.default_rng(17)
    for n in (5, 3000, 200_000):
        seq = torch.from_numpy(rng.choice(np.arange(5, dtype=np.uint8), n,
                                          p=[.24, .24, .24, .24, .04]))
        hs, ps, keep = sketch_gpu.sketch_frames(seq.to(cuda_card), 30, 6, 1)
        hp, pp, kp = sketch_gpu.sketch_frames_plain(seq.to(cuda_card), 30, 6,
                                                    1)
        torch.cuda.synchronize()
        assert torch.equal(keep, kp)
        assert torch.equal(hs[keep], hp[kp]) and torch.equal(ps[keep], pp[kp])
