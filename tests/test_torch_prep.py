"""The port's device prep of raw batches (kernels/nasw_ext.py: the
wrapper prep_tracks of kernel K7, its plain versions _prep_seq_device
and _logpen_device, and K7's parameter block) on the CPU, against the
JAX package's _prep_seq_device and _prep_tracks_device run eagerly on
the CPU (the JAX layout is (rows, lanes): transposed here).  Exact on
every element, pad rows included: the prep is integer arithmetic."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniprot_tpu import tables as jtables
from miniprot_tpu.kernels import nasw_pallas as jp
from miniprot_tpu_torch import kernels, tables
from miniprot_tpu_torch.kernels import nasw_ext as ne

CSRC = pathlib.Path(kernels.__file__).parent / "csrc"
B_LANES = 128           # the JAX _prep_tracks_device's fixed lane count


def _inputs(rng, n, R, nls=()):
    """Random raw tracks: nt4 codes with N, mixed left/right problems, io
    0-60, the given lengths first (as many as fit) and random ones in
    [1, R] after."""
    nt8 = rng.choice(np.arange(5), (n, R + 8),
                     p=[.24, .24, .24, .24, .04]).astype(np.int8)
    left = rng.integers(0, 2, n).astype(np.int8)
    iov = rng.integers(0, 61, n).astype(np.int32)
    nlv = rng.integers(1, R + 1, n).astype(np.int32)
    nlv[:len(nls[:n])] = nls[:n]
    als = rng.integers(1, 1025, n).astype(np.int32)
    return nt8, left, iov, nlv, als


def _jax_tracks(nt8, left, iov, nlv, als, *, sp, codon, thr, R):
    """nas, D, A, logpen of the JAX device prep, problem-major: the
    tracks from _prep_seq_device over all problems, the log penalty from
    _prep_tracks_device over 128-lane groups."""
    n = nt8.shape[0]
    nas, D, A = (np.asarray(x).T for x in jp._prep_seq_device(
        jnp.asarray(nt8.T), jnp.asarray(left[None]), jnp.asarray(iov[None]),
        jnp.asarray(nlv[None]), sp=sp, codon=codon, n_rows=R, width=n))
    pen = np.zeros((n, R), np.int32)
    for g in range(0, n, B_LANES):
        k = min(B_LANES, n - g)
        pad = np.zeros((R + 8, B_LANES), np.int8)
        pad[:, :k] = nt8[g:g + k].T

        def lanes(v, fill):
            out = np.full((1, B_LANES), fill, v.dtype)
            out[0, :k] = v[g:g + k]
            return jnp.asarray(out)

        out = jp._prep_tracks_device(
            jnp.asarray(pad), lanes(left, 0), lanes(iov, 0), lanes(als, 1),
            lanes(nlv, 1), sp=sp, codon=codon, thr=thr, n_rows=R, al=8)
        pen[g:g + k] = np.asarray(out[3]).T[:k]
    return nas, D, A, pen


@pytest.mark.parametrize("sp_model,code,ie_coef,R,n", [
    (1, 1, 0.5, 300, 37),
    (2, 1, 0.5, 300, 37),
    (1, 11, 0.5, 257, 133),
    (2, 11, 8.0, 300, 37),
    # the largest NL bucket at ie_coef 8: the most thresholds K7 takes
    (1, 1, 8.0, 101376, 3),
])
def test_plain_prep_matches_jax_device_prep(sp_model, code, ie_coef, R, n):
    rng = np.random.default_rng(R + n + code)
    sp = tables.splice_model_scores(sp_model)
    codon = tables.get_tables(code).codon
    assert np.array_equal(sp, jtables.splice_model_scores(sp_model))
    assert np.array_equal(codon, jtables.get_tables(code).codon)
    nt8, left, iov, nlv, als = _inputs(rng, n, R, (R, R - 1, 1, 2, 3, 4, 5))
    thr = ne._logpen_thresholds(float(np.float32(ie_coef)), R)
    assert thr == jp._logpen_thresholds(float(np.float32(ie_coef)), R)
    got = ne.prep_tracks(torch.from_numpy(nt8), torch.from_numpy(left),
                         torch.from_numpy(iov), torch.from_numpy(nlv), sp=sp,
                         codon=codon, n_rows=R, als=torch.from_numpy(als),
                         thr=thr)
    want = _jax_tracks(nt8, left, iov, nlv, als, sp=sp, codon=codon, thr=thr,
                       R=R)
    for name, g, w in zip(("nas", "D", "A", "logpen"), got, want):
        assert g.shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name


def test_plain_prep_forward_batch_matches_jax():
    """A CIGAR batch's prep: no left flags (all forward), no log
    penalty; prep_tracks returns three tracks."""
    rng = np.random.default_rng(5)
    R, n = 411, 20
    sp = tables.splice_model_scores(1)
    codon = tables.get_tables(1).codon
    nt8, _, iov, nlv, als = _inputs(rng, n, R, (1, 4, R))
    got = ne.prep_tracks(torch.from_numpy(nt8), None, torch.from_numpy(iov),
                         torch.from_numpy(nlv), sp=sp, codon=codon, n_rows=R)
    assert len(got) == 3
    want = _jax_tracks(nt8, np.zeros(n, np.int8), iov, nlv, als, sp=sp,
                       codon=codon, thr=(), R=R)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_prep_tracks_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(8)
    R, n = 200, 9
    sp = tables.splice_model_scores(2)
    codon = tables.get_tables(11).codon
    nt8, left, iov, nlv, als = (torch.from_numpy(a)
                                for a in _inputs(rng, n, R, (1, R)))
    thr = ne._logpen_thresholds(0.5, R)
    got = ne.prep_tracks(nt8, left, iov, nlv, sp=sp, codon=codon, n_rows=R,
                         als=als, thr=thr)
    want = (*ne._prep_seq_device(nt8, left, iov, nlv, sp=sp, codon=codon,
                                 n_rows=R),
            ne._logpen_device(als, thr, R, torch.device("cpu")))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fwd = ne.prep_tracks(nt8, None, iov, nlv, sp=sp, codon=codon, n_rows=R)
    zero = torch.zeros(n, dtype=torch.int8)
    for g, w in zip(fwd, ne._prep_seq_device(nt8, zero, iov, nlv, sp=sp,
                                             codon=codon, n_rows=R)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("sp_model,code,ie_coef,R", [
    (1, 1, 0.5, 2112), (2, 11, 8.0, 101376)])
def test_track_params_hold_the_tables(sp_model, code, ie_coef, R):
    sp = tables.splice_model_scores(sp_model)
    codon = tables.get_tables(code).codon
    thr = ne._logpen_thresholds(ie_coef, R)
    p = ne.track_params(sp, codon, thr)
    assert p.shape == (1,) and p.dtype == ne.TRACK_PARAMS
    assert p.nbytes == 64 + 4 * (6 + 1 + ne.TRACK_THR_CAP)
    assert np.array_equal(p["codon"][0], codon)
    assert np.array_equal(p["sp"][0], sp)
    assert int(p["nthr"][0]) == len(thr) <= ne.TRACK_THR_CAP
    assert tuple(p["thr"][0, :len(thr)]) == thr
    assert not p["thr"][0, len(thr):].any()


def test_track_params_raise_above_the_cap():
    sp = tables.splice_model_scores(1)
    codon = tables.get_tables(1).codon
    thr = tuple(range(ne.TRACK_THR_CAP + 1))
    with pytest.raises(ValueError, match="thresholds"):
        ne.track_params(sp, codon, thr)
    x = torch.zeros((2, 18), dtype=torch.int8)
    v = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="thresholds"):
        ne.prep_tracks(x, None, v, v, sp=sp, codon=codon, n_rows=10, als=v,
                       thr=thr)
    ne.track_params(sp, codon, thr[:-1])


def test_track_params_mirror_the_kernel_struct():
    """TRACK_PARAMS lists track_prep.cu's TrackParams field for field
    (name, C type, count): the C entry copies the host struct as is."""
    text = (CSRC / "track_prep.cu").read_text()
    body = re.search(r"struct TrackParams \{(.*?)\};", text, re.S).group(1)
    consts = {"kMaxThr": ne.TRACK_THR_CAP}
    assert re.search(r"kMaxThr = (\d+);", text).group(1) == str(
        ne.TRACK_THR_CAP)
    fields = []
    for ctype, name, count in re.findall(
            r"(u?int\d+_t) (\w+)(?:\[(\w+)\])?;", body):
        dt = np.dtype(ctype[:-2])
        fields.append((name, dt, consts[count] if count in consts
                       else int(count or 1)))
    got = [(name, ne.TRACK_PARAMS[name].base,
            int(np.prod(ne.TRACK_PARAMS[name].shape)))
           for name in ne.TRACK_PARAMS.names]
    assert got == fields


def test_engine_counts_host_seconds_in_launch():
    """GpuExtEngine adds up the host seconds spent inside each batch's
    launch(), ext and CIGAR batches alike."""
    from miniprot_tpu_torch.device import GpuExtEngine
    from miniprot_tpu_torch.options import MapOpt
    rng = np.random.default_rng(3)
    engine = GpuExtEngine(MapOpt(), "cpu")
    aa = rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), 60).astype(np.uint8)
    ns = rng.choice(list(b"ACGT"), 1500).astype(np.uint8)
    engine.submit(("ext", ns, aa, None, 29, False))
    engine.submit(("cigars", [(ns[:600], aa, None)]))
    res = engine.flush()
    assert len(res) == 2 and engine.n_device == 2
    assert engine.launch_s > 0
