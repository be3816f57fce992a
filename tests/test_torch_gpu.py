"""The port's CUDA kernels K1-K7 against their plain PyTorch versions on
the card (exact: the DPs, the sketch and the prep are integer
arithmetic), and the raw batches' launches free of stream
synchronizations.

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
from miniprot_tpu_torch.testgen import orf_strand

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
    nas, D, A, logpen = ne.prep_tracks(
        ne._upload(batch.nt[:n], dev), ne._upload(batch.leftb[:n], dev),
        ne._upload(batch.iov[:n], dev), nlv, sp=batch.sp,
        codon=tables.get_tables(1).codon, n_rows=batch.nl, als=als, thr=thr)
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
    nas, D, A = batch._tracks()
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


@pytest.mark.parametrize("W,n,go", [(W, n, go)
                                     for W in (32, 128, 300, 512, 1000, 1024)
                                     for n in (1, 9, 129) for go in (0, 11)])
def test_dp32_kernel_matches_plain_and_host(cuda_card, W, n, go):
    """K4's B4' form (striped32_kernel) at every class width and at W =
    300 (rows only 8-byte aligned) and 1000, on 1, 9 and 129 problems:
    al = 1, al = W and al not a multiple of 4 (pad positions), nl = 3
    beside full windows.  Exact against the plain version on every valid
    word and score, and through Dp32Batch.collect against the host
    engine's dp32 (score and CIGAR) on a few problems."""
    from miniprot_tpu_torch import native
    from miniprot_tpu_torch.native import DPF_CIGAR
    T, mat, sp = _setup()
    rng = np.random.default_rng(3 * W + n + go)
    opt = (go,) + OPT[1:]
    nl_pad = 320
    batch = st.Dp32Batch(W, nl_pad, mat, opt, device=cuda_card, capacity=n)
    cases = []
    for k in range(n):
        al = (1, W, W - 1)[k] if k < 3 else int(rng.integers(1, W + 1))
        nl = (3, nl_pad)[k % 2] if k < 4 else int(rng.integers(3, nl_pad + 1))
        ns = rng.choice(list(b"ACGTN"), nl).astype(np.uint8)
        aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYVX*"), al).astype(np.uint8)
        nas, aas, d, a = ne.prep_problem(ns, aa, sp=sp, sp_null_bonus=-7,
                                         io=29, ext_left=False)
        batch.add(nas, aas, d, a)
        cases.append((ns, aa))
    nlv, alv = batch._lens()
    args = (*batch._tracks(), nlv, alv, ne._upload(batch.aas[:n], cuda_card),
            ne._upload(batch.mat, cuda_card), (batch.go, batch.ge, batch.fs),
            batch._rows())
    tb, score = st.striped_cigar_dp32(*args)
    tb_p, score_p = st.striped_cigar_dp32_plain(*args)
    torch.cuda.synchronize()
    valid = st.valid_cells(nlv, alv, tb.shape[1], W, st.VL32)
    assert torch.equal(torch.where(valid, tb, 0), tb_p)
    assert torch.equal(score, score_p)
    res = batch.collect((tb, score))
    for (ns, aa), (sc, cig) in list(zip(cases, res))[:4]:
        rsc, rcig = native.dp32(ns, aa, flag=DPF_CIGAR, mat=mat, nt4=T.nt4,
                                aa20=T.aa20, codon=T.codon, sp=sp,
                                sp_null_bonus=-7, go=go, ge=OPT[1], io=29,
                                fs=OPT[2])
        assert sc == rsc and np.array_equal(cig, rcig)


def test_dp32_wider_than_1024_raises_on_card(cuda_card):
    """W = 1028 has no B4' geometry: the wrapper raises, no launch."""
    T, mat, sp = _setup()
    batch = st.Dp32Batch(1028, 64, mat, OPT, device=cuda_card, capacity=1)
    ns = np.frombuffer(b"ACGT" * 12, np.uint8)
    nas, aas, d, a = ne.prep_problem(ns, np.frombuffer(b"ARND", np.uint8),
                                     sp=sp, sp_null_bonus=-7, io=29,
                                     ext_left=False)
    batch.add(nas, aas, d, a)
    with pytest.raises(ValueError):
        batch.launch()


def test_sketch_kernel_matches_plain(cuda_card):
    """K6's packed entries equal its plain version in order (and, sorted,
    the host sketch_nt4): random strands of 5, 3000 and 200,000 bases
    and of one tile (3 TILE_SLOTS bases) +- 1; long-ORF strands with -L
    past the 32-slot staged halo and past a whole tile."""
    from miniprot_tpu_torch.sketch import sketch_nt4
    rng = np.random.default_rng(17)
    tile = 3 * sketch_gpu.TILE_SLOTS
    cases = [(rng.choice(np.arange(5, dtype=np.uint8), n,
                         p=[.24, .24, .24, .24, .04]), 30)
             for n in (5, 3000, 200_000, tile - 1, tile, tile + 1)]
    cases += [(orf_strand(rng, 300_000, run), mal)
              for run, mal in ((300, 100), (3000, 2000), (3000, 30))]
    for seq, mal in cases:
        args = (mal, 6, 1, 8, 77)
        got = sketch_gpu.sketch_entries(torch.from_numpy(seq).to(cuda_card),
                                        *args)
        want = sketch_gpu.sketch_entries_plain(
            torch.from_numpy(seq).to(cuda_card), *args)
        assert torch.equal(got, want), (len(seq), mal)
        host = np.sort(sketch_nt4(seq, *args))
        assert np.array_equal(np.sort(got.cpu().numpy().view(np.uint64)),
                              host)
        assert np.array_equal(np.sort(sketch_gpu.sketch_nt4_device(
            seq, *args, device=cuda_card)), host)
    assert len(want) > 0


def test_sketch_launch_does_not_synchronize(cuda_card):
    """sketch_launch makes no blocking copy (the tables go by value):
    under set_sync_debug_mode("error") a launch runs; the count read
    after it is the one synchronization."""
    seq = torch.from_numpy(orf_strand(np.random.default_rng(3), 100_000,
                                       500)).to(cuda_card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run = sketch_gpu.sketch_launch(seq, 30, 6, 1, 8, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = torch.cat(run.regions())
    assert torch.equal(got, sketch_gpu.sketch_entries_plain(seq, 30, 6, 1, 8,
                                                            0))


def test_index_build_on_card_matches_host(cuda_card, tmp_path):
    """Index.build(sketch_device=card) equals the host build array for
    array and frees sketch_nt4_device's pinned buffers; the dense
    sketch_frames, which no kernel computes, raises on the card."""
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt
    from miniprot_tpu_torch.testgen import make_workload
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=400_000, n_genes=4, seed=3, n_ctg=3,
                  max_intron=1500, rev_frac=0.5)
    a = Index.build(fa, IdxOpt())
    b = Index.build(fa, IdxOpt(), sketch_device=cuda_card)
    assert np.array_equal(a.ki, b.ki)
    assert np.array_equal(a.kb, b.kb)
    assert np.array_equal(a.bo, b.bo)
    assert not sketch_gpu._pinned
    with pytest.raises(ValueError, match="dense form"):
        sketch_gpu.sketch_frames(torch.zeros(100, dtype=torch.uint8,
                                             device=cuda_card), 30, 6, 1)


def _homolog(rng, T, al, nl):
    """nt4 window spelling a random protein of length al in codons (10%
    of them substituted), then random sequence up to nl; and the aa20
    query."""
    aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al).astype(np.uint8)
    rev = np.full(22, -1, np.int64)
    for c in range(63, -1, -1):
        rev[T.codon[c]] = c
    cod = rev[T.aa20[aa]]
    mut = rng.random(al) < 0.1
    cod[mut] = rng.integers(0, 64, int(mut.sum()))
    nt4 = np.stack([(cod >> 4) & 3, (cod >> 2) & 3, cod & 3], 1).reshape(-1)
    nt4 = np.concatenate([nt4, rng.integers(0, 4, max(0, nl - len(nt4)))])
    return nt4[:nl].astype(np.uint8), T.aa20[aa]


def _edge_lengths(rng, width, nl_pad, n):
    """(nl, al) pairs mixing a 3-row window beside windows near the
    bucket (neighbours in one block), al = 1, al = width and al on both
    sides of an SSE-lane boundary (ceil(al/8) steps there)."""
    als = [1, width, 8 * (width // 16), 8 * (width // 16) + 1, width - 7,
           width - 8, 9]
    out = []
    for k in range(n):
        nl = 3 if k % 4 == 0 else nl_pad - int(rng.integers(0, 8))
        al = als[k % len(als)] if k < 2 * len(als) \
            else int(rng.integers(1, width + 1))
        out.append((nl, al))
    return out


@pytest.mark.parametrize("W,warps", [(W, w) for W in sk.SCAN_WIDTHS
                                     for w in sk.SCAN_GEOMETRIES[W]])
def test_scan_kernel_geometry_edges(cuda_card, W, warps):
    """K2 in each geometry against its plain version: n not a multiple
    of the problems per block, nl = 3 beside nl near the bucket, al = 1,
    al = W and al on both sides of a segment-length step, homologs and
    random windows."""
    T, mat, sp = _setup()
    rng = np.random.default_rng(100 + W + warps)
    nl_pad = 400
    batch = (sk.SmallScanCigarBatch if W == 32 else sk.RawScanCigarBatch)(
        W, nl_pad, mat, OPT, sp=sp, device=cuda_card, capacity=31)
    for k, (nl, al) in enumerate(_edge_lengths(rng, W, nl_pad, 31)):
        if k % 2:
            nt4, aas = _homolog(rng, T, al, nl)
        else:
            nt4 = rng.integers(0, 5, nl).astype(np.uint8)
            aas = T.aa20[rng.choice(list(b"ARNDCQEGHILKMFPSTWYVX*"), al)]
        batch.add_raw(nt4, aas, io=29)
    args = _scan_inputs(batch)
    tb, hint, score = sk.scan_cigar_dp(*args, warps=warps)
    tb_p, hint_p, score_p = sk.scan_cigar_dp_plain(*args)
    torch.cuda.synchronize()
    valid = sk.valid_rows(args[3], args[7])
    assert torch.equal(torch.where(valid, tb, 0), tb_p)
    assert torch.equal(torch.where(valid, hint, 0), hint_p)
    assert torch.equal(score, score_p)


def test_scan_kernel_at_engine_capacity(cuda_card):
    """A W=128 launch as large as the engine's scan batches get
    (device.cig_capacity at the 2048-row bucket), in its default
    geometry, against the plain version."""
    from miniprot_tpu_torch import device
    cap = device.cig_capacity(sk.RawScanCigarBatch, 2048, 128,
                              int(80e9 * device.CIG_TB_FRACTION))
    assert cap >= 512 and sk.scan_warps(128, cap) == 1
    T, mat, sp = _setup()
    rng = np.random.default_rng(77)
    batch = sk.RawScanCigarBatch(128, 300, mat, OPT, sp=sp, device=cuda_card,
                                 capacity=cap)
    for _ in range(cap):
        al = int(rng.integers(1, 129))
        nt4, aas = _homolog(rng, T, al, int(rng.integers(3, 300)))
        batch.add_raw(nt4, aas, io=29)
    args = _scan_inputs(batch)
    tb, hint, score = sk.scan_cigar_dp(*args)
    tb_p, hint_p, score_p = sk.scan_cigar_dp_plain(*args)
    torch.cuda.synchronize()
    valid = sk.valid_rows(args[3], args[7])
    assert torch.equal(torch.where(valid, tb, 0), tb_p)
    assert torch.equal(torch.where(valid, hint, 0), hint_p)
    assert torch.equal(score, score_p)


@pytest.mark.parametrize("AL,go", [(AL, go) for AL in ne.EXT_WIDTHS
                                   for go in (11, 0)])
def test_ext_kernel_geometry_edges(cuda_card, AL, go):
    """K1 at each width, at go 11 and go 0, against its plain version:
    homologs of different lengths followed by random sequence, so the
    x-drop fires at different rows for problems of one block; nl = 3,
    al = 1, al = AL and al across an SSE-lane step; n not a multiple of
    the problems per block."""
    T, mat, sp = _setup()
    rng = np.random.default_rng(AL + ne.EXT_WARPS[AL] + go)
    nl_pad = 3 * AL + 400      # room for the x-drop after each homolog
    n = 23
    batch = ne.RawExtBatch(AL, nl_pad, mat, (go,) + OPT[1:], sp=sp,
                           device=cuda_card, capacity=n)
    for k, (nl, al) in enumerate(_edge_lengths(rng, AL, nl_pad, n)):
        nt4, aas = _homolog(rng, T, al, nl)
        left = bool(k % 3 == 1)
        if left:
            nt4, aas = nt4[::-1], aas[::-1]
        batch.add_raw(nt4, aas, io=29, ext_left=left)
    args = _ext_inputs(batch)
    rows = torch.zeros(n, dtype=torch.int64, device=cuda_card)
    got = ne.ext_dp(*args)
    want = ne.ext_dp_plain(*args, rows_done=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # the x-drop (or the window's end) stopped the problems at many rows
    assert len(set(rows.tolist())) > n // 4


def _striped_args(batch):
    """K4's arguments as a striped batch's launch builds them."""
    n, dev = batch.n, batch.device
    nlv, alv = batch._lens()
    return (*batch._tracks(), nlv, alv, ne._upload(batch.aas[:n], dev),
            ne._upload(batch.mat, dev), (batch.go, batch.ge, batch.fs),
            batch._rows())


def _striped_edge_batch(dev, W, go, n, seed, nl_pad=400):
    """Edge lengths (_edge_lengths) plus, for the multi-warp forms at
    go == 0, the al whose stripe segments start at a warp's last
    position (W=128 in 2 warps: slen 9; W=512: slen 51)."""
    T, mat, sp = _setup()
    rng = np.random.default_rng(seed)
    cls = st.SmallCigarBatch if W == 32 else st.RawCigarBatch
    batch = cls(W, nl_pad, mat, (go,) + OPT[1:], sp=sp, device=dev,
                capacity=n)
    lens = _edge_lengths(rng, W, nl_pad, n)
    extra = {128: (65, 68, 72), 512: (401, 405, 408)}.get(W, ())
    for k, al in enumerate(extra):
        lens[2 * len(extra) + k] = (nl_pad - k, al)
    lens[1] = (2, lens[1][1])                       # nl < 3
    for k, (nl, al) in enumerate(lens):
        if k % 2:
            nt4, aas = _homolog(rng, T, al, nl)
        else:
            nt4 = rng.integers(0, 5, nl).astype(np.uint8)
            aas = T.aa20[rng.choice(list(b"ARNDCQEGHILKMFPSTWYVX*"), al)]
        batch.add_raw(nt4, aas, io=29)
    return batch


@pytest.mark.parametrize("W,go", [(W, go) for W in st.STRIPED_WIDTHS
                                  for go in (0, 11)])
def test_striped_kernel_geometry_edges(cuda_card, W, go):
    """K4's B4 form at each width (its geometry, STRIPED_WARPS), at go 0
    and go 11, exact against its plain version: n not a multiple of the
    problems per block, nl = 2 and nl = 3 beside nl near the bucket in
    one launch, al = 1, al = W, al on both sides of a segment-length
    step, and (multi-warp) segments that start at a warp's last
    position."""
    batch = _striped_edge_batch(cuda_card, W, go, 31, 200 + W + go)
    args = _striped_args(batch)
    tb, score = st.striped_cigar_dp(*args)
    tb_p, score_p = st.striped_cigar_dp_plain(*args)
    torch.cuda.synchronize()
    valid = st.valid_cells(args[3], args[4], tb.shape[1], W)
    assert torch.equal(torch.where(valid, tb, 0), tb_p)
    assert torch.equal(score, score_p)


def test_striped_kernel_at_engine_capacity(cuda_card):
    """A W=128 striped launch as large as the engine's striped batches
    get (device.cig_capacity on their tb-only planes at the 2048-row
    bucket), at go 0, against the plain version."""
    from miniprot_tpu_torch import device
    cap = device.cig_capacity(st.RawCigarBatch, 2048, 128,
                              int(80e9 * device.CIG_TB_FRACTION))
    assert cap >= 512
    T, mat, sp = _setup()
    rng = np.random.default_rng(78)
    batch = st.RawCigarBatch(128, 300, mat, (0,) + OPT[1:], sp=sp,
                             device=cuda_card, capacity=cap)
    for _ in range(cap):
        al = int(rng.integers(1, 129))
        nt4, aas = _homolog(rng, T, al, int(rng.integers(3, 300)))
        batch.add_raw(nt4, aas, io=29)
    args = _striped_args(batch)
    tb, score = st.striped_cigar_dp(*args)
    tb_p, score_p = st.striped_cigar_dp_plain(*args)
    torch.cuda.synchronize()
    valid = st.valid_cells(args[3], args[4], tb.shape[1], 128)
    assert torch.equal(torch.where(valid, tb, 0), tb_p)
    assert torch.equal(score, score_p)


def _gapped_homolog(rng, T, al, intron, insert):
    """nt4 of a protein of length al spelled in codons (10% substituted)
    with a GT..AG intron of ``intron`` bases after its first half, and
    the aa20 query with ``insert`` extra residues (not in the genome)
    after its third quarter."""
    nt4, aas = _homolog(rng, T, al, 3 * al)
    cut = 3 * (al // 2)
    body = rng.integers(0, 4, intron).astype(np.uint8)
    body[:2], body[-2:] = (2, 3), (0, 2)             # GT ... AG
    nt4 = np.concatenate([nt4[:cut], body, nt4[cut:]])
    ins = T.aa20[rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), insert)]
    at = 3 * al // 4
    return nt4, np.concatenate([aas[:at], ins, aas[at:]])


def _runs(states, s):
    """Longest run of state s in each walk's stream."""
    out = []
    for row in states.tolist():
        best = cur = 0
        for x in row:
            cur = cur + 1 if x == s else 0
            best = max(best, cur)
        out.append(best)
    return out


def test_walk_kernel_tiles_and_ends(cuda_card):
    """K5 exact against its plain version on walks that leave a tile
    through its top (match runs past 32 steps, introns past 96 rows),
    through its left edge (insertions past 32 residues), and that end
    by i < 2, by j < 0 and at the step budget."""
    T, mat, sp = _setup()
    rng = np.random.default_rng(91)
    batch = st.RawCigarBatch(128, 1400, mat, OPT, sp=sp, device=cuda_card,
                             capacity=24)
    for k in range(24):
        if k % 3 == 2:                   # random: walks end by j < 0
            nl, al = int(rng.integers(600, 1400)), int(rng.integers(5, 60))
            nt4 = rng.integers(0, 4, nl).astype(np.uint8)
            aas = T.aa20[rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al)]
        else:
            al = int(rng.integers(60, 90))
            nt4, aas = _gapped_homolog(rng, T, al, int(rng.integers(150, 700)),
                                       int(rng.integers(34, 40)))
        batch.add_raw(nt4, aas, io=29)
    tb, _, nlv, alv = batch._launch_dp()
    for steps in (batch.steps(), 150):
        walk = st.cell_walk(tb, nlv, alv, steps)
        want = st.cell_walk_plain(tb, nlv, alv, steps)
        torch.cuda.synchronize()
        for a, b in zip(walk, want):
            assert torch.equal(a, b)
    states, fi, fj = (t.cpu() for t in st.cell_walk_plain(
        tb, nlv, alv, batch.steps()))
    assert max(_runs(states, 0)) > 32 and max(_runs(states, 1)) > 32
    assert max(_runs(states, 3)) > 96
    assert bool((fi < 2).any()) and bool((fj < 0).any())
    _, fi, fj = st.cell_walk_plain(tb, nlv, alv, 150)
    assert bool(((fi >= 2) & (fj >= 0)).any())      # stopped at 150 steps


def _prep_inputs(dev, n, R, seed, *, sp_model=1, code=1, ie_coef=0.5,
                 nls=()):
    """A raw batch's K7 inputs on the card: nt4 codes with N, mixed
    left/right problems, io 0-60, the given lengths first."""
    rng = np.random.default_rng(seed)
    nt8 = rng.choice(np.arange(5), (n, R + 8),
                     p=[.24, .24, .24, .24, .04]).astype(np.int8)
    nlv = rng.integers(1, R + 1, n).astype(np.int32)
    nlv[:len(nls[:n])] = nls[:n]
    arrs = (nt8, rng.integers(0, 2, n).astype(np.int8),
            rng.integers(0, 61, n).astype(np.int32), nlv,
            rng.integers(1, 1025, n).astype(np.int32))
    nt8, left, iov, nlv, als = (torch.from_numpy(a).to(dev) for a in arrs)
    kw = dict(sp=tables.splice_model_scores(sp_model),
              codon=tables.get_tables(code).codon, n_rows=R,
              thr=ne._logpen_thresholds(float(np.float32(ie_coef)), R))
    return (nt8, left, iov, nlv), als, kw


@pytest.mark.parametrize("n,R,sp_model,code,ie_coef", [
    (1, 2112, 1, 1, 0.5),
    (3, 700, 2, 11, 0.5),          # R + 8 not a multiple of the strip
    (129, 2111, 1, 1, 0.5),        # rows not 16-byte aligned
    (37, 4096, 2, 1, 8.0),
    (2, 101376, 1, 11, 8.0),       # the largest bucket, most thresholds
])
def test_prep_kernel_matches_plain(cuda_card, n, R, sp_model, code, ie_coef):
    """K7 against _prep_seq_device + _logpen_device on every element, pad
    rows included: ext batches (left flags and the log penalty) and
    forward CIGAR batches (no left flags, no log penalty)."""
    raw, als, kw = _prep_inputs(cuda_card, n, R, n + R, sp_model=sp_model,
                                code=code, ie_coef=ie_coef,
                                nls=(1, 2, 3, 4, R, R - 1, 5))
    got = ne.prep_tracks(*raw, als=als, **kw)
    want = ne.prep_tracks(*(t.cpu() for t in raw), als=als.cpu(), **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    kw.pop("thr")
    got = ne.prep_tracks(raw[0], None, *raw[2:], **kw)
    want = ne.prep_tracks(raw[0].cpu(), None, *(t.cpu() for t in raw[2:]),
                          **kw)
    torch.cuda.synchronize()
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _raw_batches(dev):
    """One small batch of each raw family, filled."""
    T, mat, sp = _setup()
    rng = np.random.default_rng(41)
    out = [_ext_batch(dev, 128, 600, 12, 3)]
    for cls, W in ((sk.RawScanCigarBatch, 128), (sk.SmallScanCigarBatch, 32),
                   (st.RawCigarBatch, 128), (st.SmallCigarBatch, 32)):
        batch = cls(W, 600, mat, OPT, sp=sp, device=dev, capacity=12)
        for _ in range(12):
            nl = int(rng.integers(3, 600))
            al = int(rng.integers(1, W + 1))
            batch.add_raw(rng.integers(0, 5, nl).astype(np.uint8),
                          T.aa20[rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"),
                                            al)], io=29)
        out.append(batch)
    return out


def test_raw_launches_do_not_synchronize(cuda_card):
    """launch() of every raw batch family (K7 and its DP and walk
    kernels) queues its work without a stream synchronization: under
    torch.cuda.set_sync_debug_mode("error") a blocking copy raises.  The
    results equal those of a launch outside the mode."""
    batches = _raw_batches(cuda_card)
    for batch in batches:          # build the library, warm the allocators
        batch.run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [batch.launch() for batch in batches]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for batch, h in zip(batches, handles):
        for got, want in zip(batch.collect(h), batch.run()):
            assert (got is None) == (want is None)
            if got is None:
                continue
            assert len(got) == len(want)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _walk_case(dev, W, n, nl_pad, seed):
    """tb/hint planes of n problems from the scan plain version on the
    card: homologs (long match runs) beside random pairs."""
    T, mat, sp = _setup()
    rng = np.random.default_rng(seed)
    cls = sk.SmallScanCigarBatch if W == 32 else sk.RawScanCigarBatch
    batch = cls(W, nl_pad, mat, OPT, sp=sp, device=dev, capacity=n)
    for k in range(n):
        al = int(rng.integers(1, W + 1))
        if k % 2:
            nt4, aas = _homolog(rng, T, al, int(rng.integers(3, nl_pad)))
        else:
            nt4 = rng.integers(0, 5, int(rng.integers(3, nl_pad))).astype(
                np.uint8)
            aas = T.aa20[rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), al)]
        batch.add_raw(nt4, aas, io=29)
    nlv, alv = batch._lens()
    tb, hint, _ = sk.scan_cigar_dp_plain(
        *batch._tracks(), nlv, alv, ne._upload(batch.prof[:n], dev),
        (batch.go, batch.ge, batch.fs), batch._rows())
    return tb, hint, nlv, alv, batch.rounds()


def _random_planes(dev, W, n, TR, seed):
    """Planes no DP writes: random states 0-9 under random upper word
    bits, now and then one of the stepless states 10-15; hints mostly
    0-3, now and then any uint16 payload.  The walks end by i < 2, by
    j < 0 with i >= 2, and at the round cap."""
    rng = np.random.default_rng(seed)
    word = rng.integers(0, 10, (n, TR, W)) | rng.integers(0, 2048,
                                                           (n, TR, W)) << 4
    word = np.where(rng.random((n, TR, W)) < 0.002,
                    rng.integers(10, 16, (n, TR, W)), word)
    hint = np.where(rng.random((n, TR, W)) < 0.01,
                    rng.integers(-32768, 32768, (n, TR, W)),
                    rng.integers(0, 4, (n, TR, W)))
    nlv = rng.integers(3, TR + 1, n).astype(np.int32)
    alv = rng.integers(1, W + 1, n).astype(np.int32)
    return (*(torch.from_numpy(a.astype(np.int16)).to(dev)
              for a in (word, hint)),
            *(torch.from_numpy(a).to(dev) for a in (nlv, alv)), 300)


@pytest.mark.parametrize("W,n,nl_pad,planes", [
    (128, 1, 900, "scan"), (128, 33, 700, "scan"), (32, 513, 400, "scan"),
    (128, 33, 700, "random"), (32, 513, 400, "random")])
def test_run_walk_kernel_matches_plain(cuda_card, W, n, nl_pad, planes):
    """K3 against run_walk_plain: the batch's round budget and round
    counts that are not multiples of 16 or 32, small enough that walks
    hit the cap; on K2's planes the walks end by i < 2 (and j = -1), on
    random planes also by j < 0 with i >= 2."""
    make = _walk_case if planes == "scan" else _random_planes
    tb, hint, nlv, alv, budget = make(cuda_card, W, n, nl_pad, n + W)
    ends = set()
    for rounds in (budget, 1, 7, 33, 45):
        got = sk.run_walk(tb, hint, nlv, alv, rounds)
        want = sk.run_walk_plain(tb, hint, nlv, alv, rounds)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        fi, fj = (t.cpu() for t in want[2:])
        ends |= {"cap" if i >= 2 and j >= 0 else "j<0" if i >= 2 else "i<2"
                 for i, j in zip(fi.tolist(), fj.tolist())}
    assert ends == ({"cap", "i<2"} if planes == "scan"
                    else {"cap", "i<2", "j<0"})


def test_flush_begin_does_not_synchronize(cuda_card):
    """A whole flush_begin of a real round (K7, K1, K2 and K3 launches,
    the collect wave's copies and events, the host DPs) runs under
    torch.cuda.set_sync_debug_mode("error"); flush_end then gives the
    host C engine's results."""
    from miniprot_tpu_torch.device import GpuExtEngine
    from miniprot_tpu_torch.native import (DPF_CIGAR, DPF_EXT_LEFT,
                                           DPF_EXT_RIGHT)
    from miniprot_tpu_torch.options import MapOpt
    from miniprot_tpu_torch.testgen import submit_round
    engine = GpuExtEngine(MapOpt(), cuda_card)
    rng = np.random.default_rng(12)
    submit_round(engine, rng, 24, 24)
    engine.flush()                 # build the library, warm the allocators
    ext, cig = submit_round(engine, rng, 24, 24)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fl = engine.flush_begin()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    res = engine.flush_end(fl)
    assert engine.batches["ext"] >= 2 and engine.batches["cig"] >= 2
    assert engine.batches["cig_small"] >= 2
    for (ns, aa, left), r in zip(ext, res):
        sc, ntl, aal, _ = engine.env.dp(
            ns, aa, DPF_EXT_LEFT if left else DPF_EXT_RIGHT)
        assert r == (sc, ntl, aal)
    for (ns, aa), (gsc, gcig) in zip(cig, res[-1]):
        sc, _, _, c = engine.env.dp(ns, aa, DPF_CIGAR)
        assert gsc == sc and np.array_equal(gcig, c)


def test_server_round_trip_on_card(cuda_card, tmp_path):
    """MapServer on the card answers with map_file's bytes (the host
    engine's), twice, and an empty request with nothing; each request
    launches the kernels a map_file on the card launches for the same
    input."""
    import io
    import threading

    from miniprot_tpu_torch import kernels, server
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.pipeline import map_file
    from miniprot_tpu_torch.testgen import make_workload
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=400_000, n_genes=12, seed=4, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    mi = Index.build(fa, IdxOpt())
    opt = MapOpt()
    opt.bw = opt.max_intron = 4000
    want = io.StringIO()
    map_file(mi, faa, opt, n_threads=1, out=want, device=None)
    kernels.reset_launch_counts()
    map_file(mi, faa, opt, n_threads=2, out=io.StringIO(), device="cuda")
    direct = kernels.launch_counts()
    assert all(direct[k] > 0 for k in ("track_prep", "ext_dp", "run_walk"))
    srv = server.MapServer(("127.0.0.1", 0), mi, opt, 2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        payload = open(faa, "rb").read()
        kernels.reset_launch_counts()
        got = [server.query(host, port, payload) for _ in range(2)]
        launches = kernels.launch_counts()
        assert server.query(host, port, b"") == b""
    finally:
        srv.shutdown()
        srv.server_close()
    assert got[0] == got[1] == want.getvalue().encode()
    assert launches == {k: 2 * v for k, v in direct.items()}


def test_bench_records_on_card(cuda_card):
    """run_bench_op on the card: every key of the record, each rate and
    peak share finite and above 0, the readings' spread at least 0."""
    import math

    from miniprot_tpu_torch.benchmarks import run_bench_op
    ext = run_bench_op("ext")
    assert set(ext) == {"ext_gcups_reps", "ext_gcups_spread", "value",
                        "ext_peak_share", "device"}
    assert len(ext["ext_gcups_reps"]) == 3 and ext["ext_gcups_spread"] >= 0
    assert all(math.isfinite(x) and x > 0
               for x in ext["ext_gcups_reps"] + [ext["value"],
                                                 ext["ext_peak_share"]])
    cig = run_bench_op("cigar")
    assert set(cig) == {
        "cigar_gcups_device_small", "cigar_gcups_device",
        "cigar_gcups_device_genic", "cigar_gcups_striped_small",
        "cigar_gcups_striped", "cigar_peak_share", "cigar_gcups_host_small",
        "cigar_gcups_host", "device"}
    assert all(math.isfinite(v) and v > 0 for k, v in cig.items()
               if k != "device")
    assert cig["device"] == torch.cuda.get_device_name(0)


def _small_map_workload(tmp_path):
    """A testgen genome whose map launches K7, K1, K2 and K3 on the card
    (as test_server_round_trip_on_card's), its index, and the host
    engine's output at -G 4k."""
    import io

    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.pipeline import map_file
    from miniprot_tpu_torch.testgen import make_workload
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=400_000, n_genes=12, seed=4, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    mi = Index.build(fa, IdxOpt())
    opt = MapOpt()
    opt.bw = opt.max_intron = 4000
    want = io.StringIO()
    map_file(mi, faa, opt, n_threads=1, out=want, device=None)
    return fa, faa, mi, opt, want.getvalue()


@pytest.mark.parametrize("winner", ["device", "host"])
def test_route_probe_map_on_card_matches_host(cuda_card, tmp_path,
                                              monkeypatch, winner):
    """map_file(route_probe=True) on the card, the probe's gates shrunk
    and its clock faked to pick ``winner``: the host engine's bytes."""
    import io

    from miniprot_tpu_torch import pipeline
    fa, faa, mi, opt, want = _small_map_workload(tmp_path)
    monkeypatch.setattr(pipeline, "ROUTE_MIN_BATCH", 6)
    monkeypatch.setattr(pipeline, "ROUTE_BLOCK_MIN", 2)
    monkeypatch.setattr(pipeline, "_route_cache_path",
                        lambda: str(tmp_path / "route.json"))
    ticks = iter([0.0, 1.0, 10.0, 12.0] if winner == "device"
                 else [0.0, 2.0, 10.0, 11.0])
    monkeypatch.setattr(pipeline, "_clock", lambda: next(ticks))
    got, stats = io.StringIO(), {}
    pipeline.map_file(mi, faa, opt, n_threads=2, out=got, device="cuda",
                      stats=stats, route_probe=True)
    assert got.getvalue() == want and stats["route_choice"] == winner


def test_profile_trace_on_card_has_kernel_events(cuda_card, tmp_path):
    """cli.main --profile-trace on the card: the output is the host
    engine's, and the trace holds device events for K7, K1, K2 and K3,
    as many as the map launched of each."""
    from miniprot_tpu_torch import cli, kernels
    fa, faa, mi, _, want = _small_map_workload(tmp_path)
    mpi, out = str(tmp_path / "g.mpi"), str(tmp_path / "out.paf")
    mi.dump(mpi)
    kernels.reset_launch_counts()
    assert cli.main([mpi, faa, "-G4k", "-t2", "-o", out,
                     f"--profile-trace={tmp_path / 'tr'}"]) == 0
    launches = kernels.launch_counts()
    assert open(out).read() == want
    times = kernels.trace_kernel_times(str(tmp_path / "tr" / "trace.json"))
    for counter in ("track_prep", "ext_dp", "run_walk"):
        fn = kernels.KERNEL_FUNCTIONS[counter]
        assert launches[counter] > 0 and times[fn][0] == launches[counter]
    scans = launches["scan_cigar_dp"] + launches["scan_cigar_dp_small"]
    assert scans > 0 and times["scan_cigar_kernel"][0] == scans
    assert all(ms > 0 for _, ms in times.values())
