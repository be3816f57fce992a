"""Extension DP (score-only) on the card: CUDA kernel K1 and its plain
PyTorch version.  Counterpart of miniprot_tpu/kernels/nasw_pallas.py.

The DP is the reference's splice/frameshift-aware extension
(nasw-sse.c:340-443): per genome row i and protein position q,

    H(i,q) = max{ H(i-3,q-1) + S,  D(i,q),  A/B/C intron exits,
                  max(H(i-1..i-2, q..q-1)) - fs,  I(i,q) }
    D(i,q) = max(H(i-3,q) - go, D(i-3,q)) - (fs at a stop codon else ge)
    I(i,q) = max_{k<q}(Hni(i,k) + k*ge) - go - q*ge   (exact lazy-F)

with the row max plus the end bonus, the log-length-adjusted best row,
x-drop termination and the first position reaching the max (aa_len).
Scores are int32 without saturation, exact under
device.ext_fits_int16 (the proof is in nasw_pallas.py's docstring).

The exact I holds for go >= 1.  At go == 0 the reference's lazy-F
fixup breaks at its first step (its test I - ge <= max(H, I) - go - ge
always holds), so I runs only inside each SSE lane — the run of
slen = ceil(al/8) positions a lane owns — plus one step from each
lane's last position into the next lane's first:

    I(q) = max_{lane start <= k < q}(Hni(i,k) + k*ge) - q*ge
    H(q) = max(H(q), H(q-1) - ge)  at the starts of lanes 1..7

The JAX ext kernel applies the exact I at go == 0 too and so differs
from the host engine there (ROADMAP Queue C).

Layout here is problem-major: every per-problem array has the problem
on dim 0 (nas (n, R), D/A (n, R+8), profile (n, 22, AL)); the TPU's
128-lane batches, 264-row grid chunks and packed 6-select profile are
not carried over.  ``ext_dp`` launches K1 for CUDA tensors and runs
``ext_dp_plain`` for CPU tensors; ``prep_tracks`` builds a raw batch's
tracks the same way, K7 on the card and the torch-ops port of the JAX
device prep (``_prep_seq_device``, ``_logpen_device``) on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from . import (LAUNCHES, call, require, resolve_device, stream_ptr,
               to_host)

NEG = -(1 << 29)
B_LANES = 128           # default problems per batch (the engine's unit)
# padded protein widths K1 is built for (ext_dp.cu's launch switch): the
# engine's AL_BUCKETS
EXT_WIDTHS = (128, 512, 1024)
# K1's geometry: warps per problem for each width (ext_dp.cu's launch
# switch; measured in PERF.md)
EXT_WARPS = {128: 1, 512: 4, 1024: 4}


def _donor_fwd(nt: np.ndarray, sp) -> np.ndarray:
    """Vectorized forward donor track (nasw-sse.c:120-127)."""
    nl = len(nt)
    donor = np.full(nl + 1, sp[3], np.int32)
    if nl < 4:
        return donor
    n0, n1, n2, n3 = nt[:-3], nt[1:-2], nt[2:-1], nt[3:]
    gt = (n1 == 2) & (n2 == 3)
    gtr = gt & ((n3 == 0) | (n3 == 2))
    t = np.full(nl - 3, 3, np.int32)
    t[(n1 == 0) & (n2 == 3)] = 2                       # AT.
    t[(n1 == 2) & (n2 == 1) & (n0 == 2)] = 1           # GGC.
    t[gt & ~gtr] = 0
    t[gtr & (n0 != 2)] = 4
    t[gtr & (n0 == 2)] = -1
    donor[:nl - 3] = np.where(t < 0, 0, sp[np.maximum(t, 0)])
    return donor


def _acceptor_fwd(nt: np.ndarray, sp) -> np.ndarray:
    """Vectorized forward acceptor track (nasw-sse.c:128-137)."""
    nl = len(nt)
    acceptor = np.full(nl + 1, sp[3], np.int32)
    if nl < 2:
        return acceptor
    i = np.arange(1, nl)
    ag = (nt[i - 1] == 0) & (nt[i] == 2)
    yag = ag & (i >= 2) & (np.isin(nt[np.maximum(i - 2, 0)], (1, 3)))
    t = np.full(nl - 1, 3, np.int32)
    t[(nt[i - 1] == 0) & (nt[i] == 1)] = 2             # .AC
    t[ag & ~yag] = 0
    t[yag] = -1
    notY = (~np.isin(nt, (1, 3))).astype(np.int32) * int(sp[5])
    pad = np.concatenate([np.zeros(6, np.int32), notY])
    penY = pad[i + 2] + pad[i + 1] + pad[i]            # j = i-4, i-5, i-6
    acc = np.where(t < 0, 0, sp[np.maximum(t, 0)])
    acc = np.where((t == -1) | (t == 0), acc + penY, acc)
    acceptor[1:nl] = acc
    return acceptor


def _donor_rev(ntr: np.ndarray, sp) -> np.ndarray:
    """Reversed-sequence donor track (plays the acceptor role;
    nasw-sse.c:171-180)."""
    nl = len(ntr)
    donor = np.full(nl + 1, sp[3], np.int32)
    if nl < 4:
        return donor
    n1, n2, n3 = ntr[1:-2], ntr[2:-1], ntr[3:]
    ga = (n1 == 2) & (n2 == 0)
    gay = ga & ((n3 == 1) | (n3 == 3))
    t = np.full(nl - 3, 3, np.int32)
    t[(n1 == 1) & (n2 == 0)] = 2                       # CA.
    t[ga & ~gay] = 0
    t[gay] = -1
    notY = (~np.isin(ntr, (1, 3))).astype(np.int32) * int(sp[5])
    pad = np.concatenate([notY, np.zeros(8, np.int32)])
    i = np.arange(nl - 3)
    penY = pad[i + 5] + pad[i + 6] + pad[i + 7]        # j = i+5..i+7, j < nl
    penY = np.where(i + 5 < nl, pad[i + 5], 0) \
        + np.where(i + 6 < nl, pad[i + 6], 0) \
        + np.where(i + 7 < nl, pad[i + 7], 0)
    dn = np.where(t < 0, 0, sp[np.maximum(t, 0)])
    dn = np.where((t == -1) | (t == 0), dn + penY, dn)
    donor[:nl - 3] = dn
    return donor


def _acceptor_rev(ntr: np.ndarray, sp) -> np.ndarray:
    """Reversed-sequence acceptor track (plays the donor role;
    nasw-sse.c:181-188)."""
    nl = len(ntr)
    acceptor = np.full(nl + 1, sp[3], np.int32)
    if nl < 2:
        return acceptor
    i = np.arange(1, nl)
    nim1 = ntr[i - 1]
    ni = ntr[i]
    nip1 = np.concatenate([ntr[2:], [255]])            # ntr[i+1], guarded
    tg = (nim1 == 3) & (ni == 2)
    tg_ok = tg & (i >= 2) & np.isin(ntr[np.maximum(i - 2, 0)], (0, 2))
    t = np.full(nl - 1, 3, np.int32)
    t[(nim1 == 3) & (ni == 0)] = 2                     # .TA
    t[(nim1 == 1) & (ni == 2) & (i + 1 < nl) & (nip1 == 1)] = 1  # .CG(C)
    t[tg & ~tg_ok] = 0
    t[tg_ok & ~((i + 1 < nl) & (nip1 == 2))] = 4
    t[tg_ok & (i + 1 < nl) & (nip1 == 2)] = -1
    acceptor[1:nl] = np.where(t < 0, 0, sp[np.maximum(t, 0)])
    return acceptor


def _apply_spsc(donor, acceptor, ss, io, sp_null_bonus, rev: bool):
    """Merge external splice scores (nasw-sse.c:138-152 / 189-202)."""
    nl = len(ss)
    max_spsc = (io + 1) // 2 - 1
    spsc = np.minimum((ss.astype(np.int32) >> 1).astype(np.int8).astype(np.int32) - 64,
                      max_spsc)
    unset = ss == 0xFF
    is_acc = (ss & 1) != 0
    if not rev:
        idx = np.arange(1, nl)
        d_adj = np.where(unset[idx], -sp_null_bonus,
                         np.where(is_acc[idx], 0, -spsc[idx]))
        a_adj = np.where(unset[idx], -sp_null_bonus,
                         np.where(is_acc[idx], -spsc[idx], 0))
        donor[idx - 1] += d_adj
        acceptor[idx - 1] += a_adj
    else:
        idx = np.arange(nl)
        d_adj = np.where(unset, -sp_null_bonus, np.where(is_acc, -spsc, 0))
        a_adj = np.where(unset, -sp_null_bonus, np.where(is_acc, 0, -spsc))
        donor[nl - 1 - idx] += d_adj[idx]
        acceptor[nl - 1 - idx] += a_adj[idx]
    return donor, acceptor


def prep_problem(nsq: np.ndarray, asq: np.ndarray, *, sp, sp_null_bonus, io,
                 ext_left: bool, ss=None, trans_code: int | None = None):
    """Host-side prep: nas/donor/acceptor tracks for one problem.

    Vectorized equivalent of ns_prep_seq / ns_prep_seq_left
    (nasw-sse.c:106-210); returns (nas, aas, donor, acceptor) with
    donor/acceptor of length nl+1.  Cross-validated against the C prep
    in tests/test_pallas.py.
    """
    T = tables.get_tables(trans_code)
    nl = len(nsq)
    nt = T.nt4[nsq]
    aas = T.aa20[asq]
    sp = np.asarray(sp, np.int32)
    if ext_left:
        aas = aas[::-1].copy()
        ntr = nt[::-1].copy()
        donor = _donor_rev(ntr, sp)
        acceptor = _acceptor_rev(ntr, sp)
        if ss is not None:
            donor, acceptor = _apply_spsc(donor, acceptor, np.asarray(ss), io,
                                          sp_null_bonus, rev=True)
        nas = _translate(nt, T)[::-1]
        nas = np.concatenate([[21, 21], nas[:-2]]).astype(np.uint8)
    else:
        donor = _donor_fwd(nt, sp)
        acceptor = _acceptor_fwd(nt, sp)
        if ss is not None:
            donor, acceptor = _apply_spsc(donor, acceptor, np.asarray(ss), io,
                                          sp_null_bonus, rev=False)
        nas = _translate(nt, T)
    return nas, aas, donor, acceptor


def _translate(nt: np.ndarray, T) -> np.ndarray:
    """nas[i] = aa of codon ending at i, X where incomplete/ambiguous."""
    nl = len(nt)
    nas = np.full(nl, 21, np.uint8)
    if nl >= 3:
        ok = (nt[:-2] < 4) & (nt[1:-1] < 4) & (nt[2:] < 4)
        cod = ((nt[:-2].astype(np.int32) << 4)
               | (nt[1:-1].astype(np.int32) << 2) | nt[2:])
        nas[2:] = np.where(ok, T.codon[np.where(ok, cod, 0)], 21)
    return nas


@functools.lru_cache(maxsize=128)
def _logpen_thresholds(ie_coef, max_x):
    """x values where the reference's int log-penalty increments.

    pen(x) = 0 for x < 2 else (int)(ie_coef*ns_log2(x)+.5)
    (nasw-sse.c:426); returns the ascending thresholds t_k so that
    pen(x) == #{k: t_k <= x}.  The curve is nondecreasing on x >= 2
    (asserted) so the threshold form is exact.
    """
    xs = np.arange(2, max(max_x, 2) + 1)
    pen = (np.float32(ie_coef) * tables.mp_log2_f32(xs)
           + np.float32(0.5)).astype(np.int32)
    assert np.all(np.diff(pen) >= 0), "log-penalty curve not monotone"
    pen = np.concatenate([[0, 0], pen])  # x = 0, 1
    kmax = int(pen[-1])
    thr = np.searchsorted(pen, np.arange(1, kmax + 1), side="left")
    return tuple(int(v) for v in thr)



# ---------------------------------------------------------------------------
# Device-side problem prep: kernel K7 (prep_tracks) and its plain version
# (torch ops; XLA ops in the JAX package)
# ---------------------------------------------------------------------------


def _sd(x, k, fill):
    """Shift along rows (dim 1) by k: out[:, i] = x[:, i-k], fill first."""
    if k == 0:
        return x
    top = torch.full((x.shape[0], k), fill, dtype=x.dtype, device=x.device)
    return torch.cat([top, x[:, :-k]], dim=1)


def _su(x, k, fill):
    """Shift along rows by -k: out[:, i] = x[:, i+k], fill last."""
    if k == 0:
        return x
    bot = torch.full((x.shape[0], k), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, k:], bot], dim=1)


def _sp_sel(t, sp):
    """sp[t] for t in {-1..4}: t<0 -> 0."""
    v = torch.full_like(t, int(sp[3]))
    for k in (0, 1, 2, 4):
        v = torch.where(t == k, int(sp[k]), v)
    return torch.where(t < 0, 0, v)


def _prep_seq_device(nt8, left, iov, nlv, *, sp, codon, n_rows):
    """nas + folded donor/acceptor tracks from raw nt4 codes.

    nt8: (n, n_rows+8) int8 nt4 codes (already reversed for left-
    extension problems); left/iov/nlv: (n,) per-problem scalars.
    Returns (nas (n, n_rows) int8, D, A (n, n_rows+8) int32) equal to
    the host prep (prep_problem + *Batch.add) bit for bit (port of
    nasw_pallas._prep_seq_device, nasw-sse.c:91-210).
    """
    n, R8 = nt8.shape
    dev = nt8.device
    nt = nt8.to(torch.int32)
    left = left.to(torch.bool).view(n, 1)
    nl = nlv.to(torch.int32).view(n, 1)
    iov = iov.to(torch.int32).view(n, 1)
    rows = torch.arange(R8, dtype=torch.int32, device=dev).view(1, R8)
    ntm1 = _sd(nt, 1, 4)
    ntm2 = _sd(nt, 2, 4)
    ntp1 = _su(nt, 1, 4)
    ntp2 = _su(nt, 2, 4)
    ntp3 = _su(nt, 3, 4)

    # nas: translated codon ending at row i (nasw-sse.c:91-104); left
    # problems read the reversed codon, shifted by the host's 2-row pad
    ok3 = (ntm2 < 4) & (ntm1 < 4) & (nt < 4) & (rows >= 2)
    okl = ok3 & (rows <= nl - 1)
    cod_f = (ntm2 << 4) | (ntm1 << 2) | nt
    cod_l = (nt << 4) | (ntm1 << 2) | ntm2
    ok = torch.where(left, okl, ok3)
    cod = torch.where(ok, torch.where(left, cod_l, cod_f), 0)
    codon_t = torch.as_tensor(np.asarray(codon, np.int32), device=dev)
    nas = torch.where(ok, codon_t[cod.long()], 21)

    sp3 = int(sp[3])
    sp5 = int(sp[5])

    # forward donor (nasw-sse.c:120-127): donor[i] from nt[i..i+3]
    gt = (ntp1 == 2) & (ntp2 == 3)
    gtr = gt & ((ntp3 == 0) | (ntp3 == 2))
    t = torch.full_like(nt, 3)
    t = torch.where((ntp1 == 0) & (ntp2 == 3), 2, t)                 # AT.
    t = torch.where((ntp1 == 2) & (ntp2 == 1) & (nt == 2), 1, t)     # GGC.
    t = torch.where(gt & ~gtr, 0, t)
    t = torch.where(gtr & (nt != 2), 4, t)
    t = torch.where(gtr & (nt == 2), -1, t)
    donor_f = torch.where(rows <= nl - 4, _sp_sel(t, sp), sp3)

    # forward acceptor (nasw-sse.c:128-137): acceptor[i] from nt[i-2..i]
    # plus the poly-Y window notY[i-6..i-4]
    notY = torch.where((nt != 1) & (nt != 3), sp5, 0)
    ag = (ntm1 == 0) & (nt == 2)
    yag = ag & (rows >= 2) & ((ntm2 == 1) | (ntm2 == 3))
    t = torch.full_like(nt, 3)
    t = torch.where((ntm1 == 0) & (nt == 1), 2, t)                   # .AC
    t = torch.where(ag & ~yag, 0, t)
    t = torch.where(yag, -1, t)
    penY = _sd(notY, 4, 0) + _sd(notY, 5, 0) + _sd(notY, 6, 0)
    acc = _sp_sel(t, sp)
    acc = torch.where((t == -1) | (t == 0), acc + penY, acc)
    acceptor_f = torch.where((rows >= 1) & (rows <= nl - 1), acc, sp3)

    # reversed-sequence donor (acceptor role; nasw-sse.c:171-180)
    ga = (ntp1 == 2) & (ntp2 == 0)
    gay = ga & ((ntp3 == 1) | (ntp3 == 3))
    t = torch.full_like(nt, 3)
    t = torch.where((ntp1 == 1) & (ntp2 == 0), 2, t)                 # CA.
    t = torch.where(ga & ~gay, 0, t)
    t = torch.where(gay, -1, t)
    penY = (torch.where(rows + 5 < nl, _su(notY, 5, 0), 0)
            + torch.where(rows + 6 < nl, _su(notY, 6, 0), 0)
            + torch.where(rows + 7 < nl, _su(notY, 7, 0), 0))
    dn = _sp_sel(t, sp)
    dn = torch.where((t == -1) | (t == 0), dn + penY, dn)
    donor_r = torch.where(rows <= nl - 4, dn, sp3)

    # reversed-sequence acceptor (donor role; nasw-sse.c:181-188)
    tg = (ntm1 == 3) & (nt == 2)
    tg_ok = tg & (rows >= 2) & ((ntm2 == 0) | (ntm2 == 2))
    in_p1 = rows + 1 < nl
    t = torch.full_like(nt, 3)
    t = torch.where((ntm1 == 3) & (nt == 0), 2, t)                   # .TA
    t = torch.where((ntm1 == 1) & (nt == 2) & in_p1 & (ntp1 == 1), 1, t)
    t = torch.where(tg & ~tg_ok, 0, t)
    t = torch.where(tg_ok & ~(in_p1 & (ntp1 == 2)), 4, t)
    t = torch.where(tg_ok & in_p1 & (ntp1 == 2), -1, t)
    acceptor_r = torch.where((rows >= 1) & (rows <= nl - 1),
                             _sp_sel(t, sp), sp3)

    donor = torch.where(left, donor_r, donor_f)
    acceptor = torch.where(left, acceptor_r, acceptor_f)
    # *Batch.add copies only rows [0, nl] (the rest stays 0) and folds io
    in_track = rows <= nl
    D = torch.where(in_track, donor + iov, 0).to(torch.int32)
    A = torch.where(in_track, acceptor, 0).to(torch.int32)
    return nas[:, :n_rows].to(torch.int8).contiguous(), D, A


def _logpen_device(als, thr, n_rows, device):
    """(n, n_rows) int32 log-length penalty pen(row - 3*al): the number
    of thresholds <= x (no device float log: bit parity with
    mp_log2_f32 whatever the compiler contracts)."""
    x = (torch.arange(n_rows, dtype=torch.int32, device=device).view(1, -1)
         - 3 * als.to(torch.int32).view(-1, 1))
    if not thr:
        return torch.zeros_like(x)
    thr_t = torch.as_tensor(thr, dtype=torch.int32, device=device)
    return torch.searchsorted(thr_t, x.contiguous(), right=True,
                              out_int32=True)


# K7's parameter block, passed by value at launch (track_prep.cu's
# TrackParams, field for field): the codon table, the splice scores and
# the log-penalty thresholds.  The engine sends ie_coef > 8 to the host,
# and 8 * log2(101376) + .5 gives 133 thresholds in the largest bucket.
TRACK_THR_CAP = 160
TRACK_PARAMS = np.dtype([("codon", np.uint8, 64), ("sp", np.int32, 6),
                         ("nthr", np.int32), ("thr", np.int32,
                                              TRACK_THR_CAP)])


def track_params(sp, codon, thr=()) -> np.ndarray:
    """K7's parameter block for a batch: a (1,) TRACK_PARAMS array;
    more than TRACK_THR_CAP thresholds raise."""
    if len(thr) > TRACK_THR_CAP:
        raise ValueError(f"track_prep: {len(thr)} log-penalty thresholds, "
                         f"the kernel takes at most {TRACK_THR_CAP}")
    p = np.zeros(1, TRACK_PARAMS)
    p["codon"][0] = np.asarray(codon, np.uint8)
    p["sp"][0] = np.asarray(sp, np.int32).reshape(-1)[:6]
    p["nthr"] = len(thr)
    p["thr"][0, :len(thr)] = thr
    return p


def _ptr(t):
    """A tensor's device pointer; None (NULL) for an absent input."""
    return None if t is None else t.data_ptr()


def prep_tracks(nt8, left, iov, nlv, *, sp, codon, n_rows, als=None,
                thr=None):
    """The DP input tracks of a raw batch from its nt4 codes.

    nt8 (n, n_rows+8) int8 codes (already reversed for left-extension
    problems); left (n,) int8 (nonzero: a left extension) or None (all
    forward); iov, nlv (n,) int32; als (n,) int32 for an ext batch,
    with thr its log-penalty thresholds (_logpen_thresholds).  Returns
    nas (n, n_rows) int8, D, A (n, n_rows+8) int32 and, with als,
    logpen (n, n_rows) int32.  CUDA tensors launch K7, which takes the
    tables by value (no copy to the card); CPU tensors run
    _prep_seq_device and _logpen_device.
    """
    thr = tuple(thr or ())
    params = track_params(sp, codon, thr)
    n, RD = nt8.shape
    if not nt8.is_cuda:
        if left is None:
            left = torch.zeros(n, dtype=torch.int8)
        out = _prep_seq_device(nt8, left, iov, nlv, sp=sp, codon=codon,
                               n_rows=n_rows)
        if als is None:
            return out
        return (*out, _logpen_device(als, thr, n_rows, nt8.device))
    require(nt8, torch.int8, 2, "nt8")
    require(iov, torch.int32, 1, "iov")
    require(nlv, torch.int32, 1, "nlv")
    if left is not None:
        require(left, torch.int8, 1, "left")
    if als is not None:
        require(als, torch.int32, 1, "als")
    if RD != n_rows + 8 or any(t is not None and t.shape[0] != n
                               for t in (left, iov, nlv, als)):
        raise ValueError("prep_tracks: inconsistent shapes")
    dev = nt8.device
    nas = torch.empty((n, n_rows), dtype=torch.int8, device=dev)
    D = torch.empty((n, RD), dtype=torch.int32, device=dev)
    A = torch.empty((n, RD), dtype=torch.int32, device=dev)
    logpen = (None if als is None
              else torch.empty((n, n_rows), dtype=torch.int32, device=dev))
    if n:
        call("mp_track_prep", nt8.data_ptr(), _ptr(left), iov.data_ptr(),
             nlv.data_ptr(), _ptr(als), nas.data_ptr(), D.data_ptr(),
             A.data_ptr(), _ptr(logpen), n, n_rows, params.ctypes.data,
             stream_ptr(nt8))
        LAUNCHES["track_prep"] += 1
    return (nas, D, A) if als is None else (nas, D, A, logpen)


def _host_logpen(ie_coef, n_rows, al):
    """Host-prep logpen row (ExtBatch.add in nasw_pallas.py)."""
    x = np.arange(n_rows) - 3 * al
    return np.where(x < 2, 0,
                    (ie_coef * tables.mp_log2_f32(np.maximum(x, 2))
                     + np.float32(0.5)).astype(np.int32))


# ---------------------------------------------------------------------------
# The DP: kernel K1 and its plain version
# ---------------------------------------------------------------------------


def ext_dp(nas, D, A, logpen, nlv, alv, prof, opts):
    """Score-only extension DP for n problems.

    nas (n, R) int8 aa codes per genome row; D, A (n, R+8) int32 donor
    (+io) and acceptor tracks; logpen (n, R) int32; nlv, alv (n,) int32
    genome and protein lengths; prof (n, 22, AL) int8 with
    prof[b, c, q] = mat[c, query_b[q]]; opts = (go, ge, fs, xdrop,
    end_bonus).  Returns (n, 3) int32 rows (max_sc, max_i, aa_len - 1).
    CUDA tensors launch K1 (EXT_WARPS[AL] warps per problem); CPU
    tensors run ext_dp_plain.
    """
    if not nas.is_cuda:
        return ext_dp_plain(nas, D, A, logpen, nlv, alv, prof, opts)
    n, R = nas.shape
    AL = prof.shape[2]
    if AL not in EXT_WIDTHS:
        raise ValueError(f"ext_dp: unsupported AL={AL}")
    require(nas, torch.int8, 2, "nas")
    for name, t in (("D", D), ("A", A), ("logpen", logpen)):
        require(t, torch.int32, 2, name)
    require(nlv, torch.int32, 1, "nlv")
    require(alv, torch.int32, 1, "alv")
    require(prof, torch.int8, 3, "prof", align=8)
    if D.shape != (n, R + 8) or A.shape != (n, R + 8) \
            or logpen.shape != (n, R) or prof.shape[:2] != (n, 22):
        raise ValueError("ext_dp: inconsistent shapes")
    out = torch.empty((n, 3), dtype=torch.int32, device=nas.device)
    if n == 0:
        return out
    go, ge, fs, xdrop, end_bonus = (int(v) for v in opts)
    call("mp_ext_dp",
         nas.data_ptr(), D.data_ptr(), A.data_ptr(), logpen.data_ptr(),
         nlv.data_ptr(), alv.data_ptr(), prof.data_ptr(), out.data_ptr(),
         n, R, R + 8, AL, go, ge, fs, xdrop, end_bonus, EXT_WARPS[AL],
         stream_ptr(nas))
    LAUNCHES["ext_dp"] += 1
    return out


def ext_dp_plain(nas, D, A, logpen, nlv, alv, prof, opts, rows_done=None):
    """Plain PyTorch version of K1 (same arguments and result): one
    genome row per step over all problems and positions, the I state by
    torch.cummax.  Mirrors nasw_pallas._ext_kernel, including the padded
    positions q >= al that take part in the row max, except the [-1]
    column after row 2 and the I state at go == 0, where it follows the
    host engine (dp16_ext_w).
    rows_done, when given, is an (n,) tensor that receives the number of
    genome rows each problem ran before x-drop or its end (the work K1
    does for these inputs)."""
    dev = nas.device
    n, R = nas.shape
    AL = prof.shape[2]
    go, ge, fs, xdrop, end_bonus = (int(v) for v in opts)
    i32 = torch.int32
    nlv = nlv.to(i32)
    alv = alv.to(i32)
    q = torch.arange(AL, dtype=i32, device=dev).view(1, AL)
    qge = q * ge
    qpad = q >= alv.view(n, 1)
    endb = torch.where(q == alv.view(n, 1) - 1, end_bonus, 0).to(i32)
    # go == 0: the SSE lanes (runs of slen = ceil(al/8) positions) and
    # the lane starts that take the one lazy-F step (module docstring)
    sl = torch.clamp((alv + 7) // 8, min=1).view(n, 1)
    lane = q // sl
    seg0 = q % sl == 0
    segkey = lane.to(torch.int64) << 34
    lane_start = seg0 & (lane >= 1) & (lane < 8)
    prof = prof.to(i32)
    D = D.to(i32)
    A = A.to(i32)
    full = functools.partial(torch.full, (n, AL), NEG, dtype=i32, device=dev)
    H1, H2, H3 = full(), full(), full()          # H(i-1), H(i-2), H(i-3)
    D1, D2, D3 = full(), full(), full()
    Ac, Bc, Cc = full(), full(), full()
    hmax = full()
    msc = torch.full((n,), NEG, dtype=i32, device=dev)
    mscl = msc.clone()
    mi = torch.full((n,), -1, dtype=i32, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    ar = torch.arange(n, device=dev)

    def left(H, fill):
        col = torch.full((n, 1), fill, dtype=i32, device=dev)
        return torch.cat([col, H[:, :-1]], dim=1)

    max_nl = int(nlv.max()) if n else 0
    for i in range(2, min(max_nl, R)):
        if not bool(act.any()):
            break
        c = nas[:, i].long()
        S = prof[ar, c]                           # (n, AL)
        S = torch.where(qpad, NEG, S)
        gei = torch.where(c == 20, fs, ge).to(i32).view(n, 1)
        # the [-1] column: H(-1,-1)=0, H(0,-1)=H(1,-1)=-fs, seen at row 2
        # only — from row 3 on the reference rebuilds it from the
        # previous rows' last stripe, NEG at lane 0 (nasw-sse.c:267-271)
        first = i == 2
        H3m1 = left(H3, 0 if first else NEG)
        H1m1 = left(H1, -fs if first else NEG)
        H2m1 = left(H2, -fs if first else NEG)
        dm1, d0, dp1 = (D[:, i - 1:i], D[:, i:i + 1], D[:, i + 1:i + 2])
        a0, am1, am2 = (A[:, i:i + 1], A[:, i - 1:i], A[:, i - 2:i - 1])
        h = H3m1 + S
        Dn = torch.maximum(H3 - go, D3) - gei
        h = torch.maximum(h, Dn)
        Ac = torch.maximum(H1 - dm1, Ac)
        h = torch.maximum(h, Ac - a0)
        Bc = torch.maximum(H1m1 - d0, Bc)
        h = torch.maximum(h, Bc - am2)
        Cc = torch.maximum(H1m1 - dp1, Cc)
        h = torch.maximum(h, Cc - am1)
        h = torch.maximum(h, torch.maximum(torch.maximum(H1, H2),
                                           torch.maximum(H1m1, H2m1)) - fs)
        if go > 0:
            M = torch.cummax(h + qge, dim=1).values
            h = torch.maximum(h, left(M, NEG) - qge - go)
        else:
            SM = torch.cummax(segkey + (h + qge).to(torch.int64) + (1 << 32),
                              dim=1).values - segkey - (1 << 32)
            h = torch.maximum(h, torch.where(seg0, NEG,
                                             left(SM.to(i32), NEG) - qge))
            h = torch.where(lane_start, torch.maximum(h, left(h, NEG) - ge), h)
        # extension bookkeeping
        tmp_sc = (h + endb).max(dim=1).values
        tmp_log = tmp_sc - logpen[:, i].to(i32)
        in_range = (i < nlv) & act
        improved = (tmp_log > mscl) & in_range
        msc = torch.where(improved, tmp_sc, msc)
        mscl = torch.where(improved, tmp_log, mscl)
        mi = torch.where(improved, i, mi)
        hmax = torch.where(improved.view(n, 1), h, hmax)
        dropped = (mscl - tmp_log > xdrop) & in_range
        if rows_done is not None:
            rows_done += in_range.to(rows_done.dtype)
        act = act & ~(dropped | (i + 1 >= nlv))
        H3, H2, H1 = H2, H1, h
        D3, D2, D1 = D2, D1, Dn
    # aa_len: first real position whose Hmax + end bonus reaches max_sc
    hit = (hmax + endb == msc.view(n, 1)) & ~qpad
    big = torch.full_like(hmax, 1 << 30)
    jm = torch.where(hit, q.expand(n, AL), big).min(dim=1).values
    jm = torch.where(jm == (1 << 30), alv - 1, jm)
    return torch.stack([msc, mi, jm], dim=1).to(i32)


# ---------------------------------------------------------------------------
# Batches (the engine's unit): host arrays filled per problem, uploaded
# and launched in one call, collected later
# ---------------------------------------------------------------------------


def _upload(arr: np.ndarray, device):
    """numpy -> device tensor; pinned + non-blocking toward the card so
    a launch never waits on the previous batch's kernel."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _opts(batch):
    return (batch.go, batch.ge, batch.fs, batch.xdrop, batch.end_bonus)


class ExtBatch:
    """Extension problems with host-prepped tracks (the --spsc path)."""

    def __init__(self, al_pad: int, nl_pad: int, mat: np.ndarray,
                 opt_scalars, *, device=None, capacity: int = B_LANES):
        self.al = al_pad
        self.nl = nl_pad
        (self.go, self.ge, self.fs, self.default_io, self.xdrop,
         self.end_bonus, self.ie_coef) = opt_scalars
        self.mat = np.asarray(mat).reshape(22, 22)
        self.device = resolve_device(device)
        self.capacity = capacity
        self.nas = np.zeros((capacity, self.nl), np.int8)
        self.D = np.zeros((capacity, self.nl + 8), np.int16)
        self.A = np.zeros((capacity, self.nl + 8), np.int16)
        self.logpen = np.zeros((capacity, self.nl), np.int8)
        self.nlv = np.zeros(capacity, np.int32)
        self.als = np.ones(capacity, np.int32)
        self.prof = np.zeros((capacity, 22, self.al), np.int8)
        self.n = 0

    def add(self, nas, aas, donor, acceptor, io=None):
        b = self.n
        io = self.default_io if io is None else io
        nl, al = len(nas), len(aas)
        assert nl <= self.nl and al <= self.al and b < self.capacity
        self.nas[b, :nl] = nas
        self.D[b, :nl + 1] = donor.astype(np.int32)[:nl + 1] + io
        self.A[b, :nl + 1] = acceptor.astype(np.int32)[:nl + 1]
        pen = _host_logpen(self.ie_coef, self.nl, al)
        assert pen.max() <= 127, "ie_coef too large for int8 logpen stream"
        self.logpen[b] = pen
        self.nlv[b] = nl
        self.als[b] = al
        self.prof[b, :, :al] = self.mat[:, aas]
        self.n += 1
        return b

    def launch(self):
        """Upload and launch; returns the (n, 3) result tensor without
        waiting for the card."""
        n, dev = self.n, self.device
        i32 = torch.int32
        return ext_dp(_upload(self.nas[:n], dev),
                      _upload(self.D[:n], dev).to(i32),
                      _upload(self.A[:n], dev).to(i32),
                      _upload(self.logpen[:n], dev).to(i32),
                      _upload(self.nlv[:n], dev), _upload(self.als[:n], dev),
                      _upload(self.prof[:n], dev), _opts(self))

    def collect(self, handle):
        """[(score, genome end + 1, query end + 1)] per problem, from
        launch()'s handle or its to_host copy."""
        (out,) = to_host(handle).arrays()
        return [(int(out[b, 0]), int(out[b, 1]) + 1, int(out[b, 2]) + 1)
                for b in range(self.n)]

    def run(self):
        return self.collect(self.launch())


class RawExtBatch:
    """Extension problems shipped as raw nt4 windows; the tracks are
    rebuilt on the device (prep_tracks: K7) before K1."""

    def __init__(self, al_pad: int, nl_pad: int, mat: np.ndarray,
                 opt_scalars, *, sp, trans_code: int = 1, device=None,
                 capacity: int = B_LANES):
        self.al = al_pad
        self.nl = nl_pad
        (self.go, self.ge, self.fs, self.default_io, self.xdrop,
         self.end_bonus, self.ie_coef) = opt_scalars
        self.mat = np.asarray(mat).reshape(22, 22)
        self.sp = np.asarray(sp, np.int32).reshape(-1)
        self.trans_code = trans_code
        self.device = resolve_device(device)
        self.capacity = capacity
        self.nt = np.zeros((capacity, self.nl + 8), np.int8)
        self.leftb = np.zeros(capacity, np.int8)
        self.iov = np.zeros(capacity, np.int32)
        self.als = np.ones(capacity, np.int32)
        self.nlv = np.zeros(capacity, np.int32)
        self.prof = np.zeros((capacity, 22, self.al), np.int8)
        self.n = 0

    def add_raw(self, nt4: np.ndarray, aas: np.ndarray, *, io=None,
                ext_left=False):
        """Queue one problem from nt4 codes + aa20 query codes (both
        already reversed by the caller for left extensions)."""
        b = self.n
        io = self.default_io if io is None else io
        nl, al = len(nt4), len(aas)
        assert nl <= self.nl and al <= self.al and b < self.capacity
        self.nt[b, :nl] = nt4
        self.leftb[b] = 1 if ext_left else 0
        self.iov[b] = io
        self.als[b] = al
        self.nlv[b] = nl
        self.prof[b, :, :al] = self.mat[:, aas]
        self.n += 1
        return b

    def stage(self) -> tuple:
        """The batch's inputs uploaded to its device (non-blocking toward
        the card): what launch() runs on, and may run on again."""
        n, dev = self.n, self.device
        return tuple(_upload(a[:n], dev) for a in (
            self.nt, self.leftb, self.iov, self.nlv, self.als, self.prof))

    def launch(self, staged=None):
        """K7 then K1 on stage()'s tensors (staged here when None);
        returns the (n, 3) result tensor without waiting for the card."""
        nt, left, iov, nlv, als, prof = (self.stage() if staged is None
                                         else staged)
        thr = _logpen_thresholds(float(np.float32(self.ie_coef)), self.nl)
        nas, D, A, logpen = prep_tracks(
            nt, left, iov, nlv, sp=self.sp,
            codon=tables.get_tables(self.trans_code).codon, n_rows=self.nl,
            als=als, thr=thr)
        return ext_dp(nas, D, A, logpen, nlv, als, prof, _opts(self))

    collect = ExtBatch.collect
    run = ExtBatch.run
