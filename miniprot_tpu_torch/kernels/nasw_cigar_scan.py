"""Full CIGAR DP with traceback words (K2) and its run-walk (K3), with
their plain PyTorch versions.  Counterpart of
miniprot_tpu/kernels/nasw_cigar_scan.py.

The DP is the reference's saturating-int16 ns_global_gs16b with
NS_F_CIGAR (nasw-sse.c:444-541).  The traceback words are rebuilt from
two prefix quantities per genome row instead of the reference's striped
lazy-F loop, exactly as the JAX scan kernel does (its module docstring
holds the proof; it needs go >= 1):

  base_q  = max of the order-free candidates (match, D, A, B, C, fs1..4)
  Iused_q = the I chain inside q's stripe segment (segments of
            slen_p = ceil(al_p / 8) positions)   -> state nibble, bit 4
  Istar_q = the I chain over all p < q (lazy-F fixpoint) -> bit 9, H

plus run-length hints (how many more steps the walk takes in the same
state from each cell), so the walk consumes a whole gap or match run in
one round.

Per-problem results do not depend on how problems are batched, so the
port picks its own geometry: problem-major arrays, one to four warps
per problem (scan_warps), tb/hint planes (n, rows, W) int16 per
problem.  The TPU's 128-lane tiles and the 4-way interleave of its
al <= 32 class are not carried over; the small class is simply W = 32
with at least 512 problems per launch (the engine sizes scan batches
with device.cig_capacity).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables as _tables
from . import (LAUNCHES, as_device, call, require, stream_ptr, to_host,
               warps_for)
from .nasw_ext import _upload, prep_tracks

NEG16 = -32768           # int16 saturation floor
NEGI = -(1 << 29)        # scan identity (below any clipped int16 value)
VL = 8                   # reference SSE lanes per stripe
B = 128                  # problems per batch (big classes)
SMALL_W = 32             # the al <= 32 class
SMALL_CAPACITY = 512
# class widths K2 is built for (scan_cigar.cu's launch switch): the
# engine's CIG_SLEN_CLASSES times 8
SCAN_WIDTHS = (32, 128, 512)
# K2's geometries: warps per problem for each class width, the one-warp
# form first and the spread form for small launches last
# (kernels.warps_for; measured in PERF.md)
SCAN_GEOMETRIES = {32: (1,), 128: (1, 2), 512: (4,)}


def scan_warps(W: int, n: int) -> int:
    """Warps per problem K2 runs a launch of n problems of width W
    with."""
    return warps_for(SCAN_GEOMETRIES[W], n)


# per-state step deltas for a run of e emits (nasw_cigar_pallas
# _BT_DI/_BT_DJ): di = e*DIM[s] + DIC[s], dj = e*DJM[s] + DJC[s]
_DIM = (3, 0, 3, 1, 1, 1, 0, 0, 0, 0)
_DIC = (0, 0, 0, 0, 0, 0, 1, 2, 1, 2)
_DJM = (1, 1, 0, 0, 0, 0, 0, 0, 0, 0)
_DJC = (0, 0, 0, 0, 1, 1, 0, 0, 1, 1)


def _rounds_cap() -> int:
    """Walk-round budget.  Every round consumes a whole run, so real
    paths take O(#segments) rounds; a lane still unfinished at the cap
    comes back as None from collect and the engine redoes it on the
    host engine (identical result)."""
    return 2048


def _sat(x):
    return torch.clamp(x, -32768, 32767)


def _sadd(a, b):
    return _sat(a + b)


def _ssub(a, b):
    return _sat(a - b)


def _left(x, fill):
    """x moved one position along dim 1: out[:, q] = x[:, q-1], fill at
    q = 0."""
    col = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([col, x[:, :-1]], dim=1)


def _row_terms(i, nas, D, A, S, H, D3, carries, opts, neg, add, sub):
    """The order-free terms of genome row i of the NS_F_CIGAR recurrence
    (nasw-sse.c:444-520 without I), all problems and positions at once,
    in position order.  S = the row's scores; H = (H1, H2, H3) the
    previous rows; D3 = D(i-3); carries = the A/B/C intron carries;
    add/sub = saturating or plain arithmetic, neg its floor.  Returns
    match, the candidates after I in the strict-> priority order (D, A,
    B, C, the four frameshift moves), the extension bits (b5..b8) and
    the new carries."""
    go, ge, fs = opts
    H1, H2, H3 = H
    Ac, Bc, Cc = carries
    c = nas[:, i].long()
    gei = torch.where(c == 20, fs, ge).to(torch.int32).view(-1, 1)
    dm1, d0, dp1 = (D[:, i - 1:i], D[:, i:i + 1], D[:, i + 1:i + 2])
    a0, am1, am2 = (A[:, i:i + 1], A[:, i - 1:i], A[:, i - 2:i - 1])
    # the [-1] column: H(-1,-1)=0, H(0,-1)=H(1,-1)=-fs at row 2 only
    first = i == 2
    H3m1 = _left(H3, 0 if first else neg)
    H1m1 = _left(H1, -fs if first else neg)
    H2m1 = _left(H2, -fs if first else neg)
    match = add(H3m1, S)
    ud = sub(H3, go)
    b5 = D3 > ud
    Dn = sub(torch.maximum(ud, D3), gei)
    ua = sub(H1, dm1)
    b6 = Ac > ua
    Ac = torch.maximum(ua, Ac)
    ub = sub(H1m1, d0)
    b7 = Bc > ub
    Bc = torch.maximum(ub, Bc)
    uc = sub(H1m1, dp1)
    b8 = Cc > uc
    Cc = torch.maximum(uc, Cc)
    cands = (Dn, sub(Ac, a0), sub(Bc, am2), sub(Cc, am1), sub(H1, fs),
             sub(H2, fs), sub(H1m1, fs), sub(H2m1, fs))
    return match, cands, (b5, b6, b7, b8), (Ac, Bc, Cc)


def _state_nibble(match, I, cands):
    """The pass-1 state nibble: where the strict-> priority chain over
    (match, I, *cands) ends, i.e. the first of them to reach the max."""
    h = match
    y = torch.where(I > h, 1, 0).to(torch.int32)
    h = torch.maximum(h, I)
    for code, cand in enumerate(cands, 2):
        y = torch.where(cand > h, code, y)
        h = torch.maximum(h, cand)
    return y


def _pad_rows(nl_pad: int) -> int:
    """A batch's row count: nl_pad rounded up to a multiple of 256."""
    return ((nl_pad + 255) // 256) * 256


# ---------------------------------------------------------------------------
# K2: the scan CIGAR DP
# ---------------------------------------------------------------------------


def scan_cigar_dp(nas, D, A, nlv, alv, prof, opts, rows, warps=None):
    """Traceback words, run-length hints and end scores for n problems.

    nas (n, R) int8; D, A (n, R+8) int32 tracks (donor folded with io);
    nlv, alv (n,) int32; prof (n, 22, W) int8; opts = (go, ge, fs) with
    go >= 1; rows = the tb rows to allocate (>= max nl, <= R).
    Returns tb, hint (n, rows, W) int16 (rows [2, nl_b) of problem b are
    defined; the walk reads nothing else) and score (n,) int32.
    CUDA tensors launch K2 with ``warps`` per problem (one of
    SCAN_GEOMETRIES[W]; by default scan_warps, which the engine uses:
    tests and chip_smoke.py name each geometry); CPU tensors run
    scan_cigar_dp_plain.
    """
    go = int(opts[0])
    if go < 1:
        raise ValueError("scan CIGAR DP needs go >= 1 (the scan/striped "
                         "equivalence proof); go == 0 takes the striped DP")
    if not nas.is_cuda:
        return scan_cigar_dp_plain(nas, D, A, nlv, alv, prof, opts, rows)
    n, R = nas.shape
    W = prof.shape[2]
    if W not in SCAN_WIDTHS:
        raise ValueError(f"scan_cigar_dp: unsupported W={W}")
    warps = scan_warps(W, n) if warps is None else warps
    if warps not in SCAN_GEOMETRIES[W]:
        raise ValueError(f"scan_cigar_dp: no {warps}-warp geometry at W={W}")
    require(nas, torch.int8, 2, "nas")
    require(D, torch.int32, 2, "D")
    require(A, torch.int32, 2, "A")
    require(nlv, torch.int32, 1, "nlv")
    require(alv, torch.int32, 1, "alv")
    require(prof, torch.int8, 3, "prof", align=4)
    if D.shape != (n, R + 8) or A.shape != (n, R + 8) \
            or prof.shape[:2] != (n, 22) or rows > R:
        raise ValueError("scan_cigar_dp: inconsistent shapes")
    dev = nas.device
    tb = torch.empty((n, rows, W), dtype=torch.int16, device=dev)
    hint = torch.empty((n, rows, W), dtype=torch.int16, device=dev)
    score = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return tb, hint, score
    call("mp_scan_cigar",
         nas.data_ptr(), D.data_ptr(), A.data_ptr(), nlv.data_ptr(),
         alv.data_ptr(), prof.data_ptr(), tb.data_ptr(), hint.data_ptr(),
         score.data_ptr(), n, R, R + 8, W, rows, go, int(opts[1]),
         int(opts[2]), warps, stream_ptr(nas))
    LAUNCHES["scan_cigar_dp_small" if W <= SMALL_W else "scan_cigar_dp"] += 1
    return tb, hint, score


def scan_cigar_dp_plain(nas, D, A, nlv, alv, prof, opts, rows):
    """Plain PyTorch version of K2 (same arguments and results): one
    genome row per step over all problems and positions.  The segmented
    I scan is one cummax over (segment id << 32 | value) keys; rows
    outside [2, nl_b) are left 0."""
    dev = nas.device
    n, R = nas.shape
    W = prof.shape[2]
    go, ge, fs = (int(v) for v in opts)
    i32, i64 = torch.int32, torch.int64
    nlv = nlv.to(i32)
    alv = alv.to(i32)
    q = torch.arange(W, dtype=i32, device=dev).view(1, W)
    qge = q * ge
    qpad = q >= alv.view(n, 1)
    slen = torch.clamp((alv + VL - 1) // VL, min=1).view(n, 1)
    qmod = q % slen
    seg0 = qmod == 0
    segkey = (q // slen).to(i64) << 32
    prof = prof.to(i32)
    D = D.to(i32)
    A = A.to(i32)
    tb = torch.zeros((n, rows, W), dtype=torch.int16, device=dev)
    hint = torch.zeros((n, rows, W), dtype=torch.int16, device=dev)
    score = torch.full((n,), NEG16, dtype=i32, device=dev)

    def full(v):
        return torch.full((n, W), v, dtype=i32, device=dev)

    H1, H2, H3 = full(NEG16), full(NEG16), full(NEG16)
    D1, D2, D3 = full(NEG16), full(NEG16), full(NEG16)
    Ac, Bc, Cc = full(NEG16), full(NEG16), full(NEG16)
    C01, C02, C03 = full(0), full(0), full(0)      # match-run ring
    CD1, CD2, CD3 = full(0), full(0), full(0)      # D-run ring
    CA, CB, CC = full(0), full(0), full(0)
    ar = torch.arange(n, device=dev)
    last = (alv - 1).long()
    max_nl = min(int(nlv.max()) if n else 0, rows)
    for i in range(2, max_nl):
        S = torch.where(qpad, NEG16, prof[ar, nas[:, i].long()])
        match, cands, (b5, b6, b7, b8), (Ac, Bc, Cc) = _row_terms(
            i, nas, D, A, S, (H1, H2, H3), D3, (Ac, Bc, Cc), (go, ge, fs),
            NEG16, _sadd, _ssub)
        base = match
        for x in cands:
            base = torch.maximum(base, x)
        # the two I scans
        u = _sat(base - go) + qge
        SM = torch.cummax(segkey + (u.to(i64) + (1 << 31)), dim=1).values
        SM = (SM - segkey - (1 << 31)).to(i32)
        Iused = torch.maximum(torch.where(seg0, NEGI, _left(SM, NEGI)) - qge,
                              torch.tensor(NEG16, dtype=i32, device=dev))
        FM = torch.cummax(u, dim=1).values
        Istar = torch.clamp(_left(FM, NEGI) - qge, min=NEG16)
        hp1 = torch.maximum(base, Iused)
        Hfin = torch.maximum(base, Istar)
        b9 = Istar > hp1
        t4 = _sat(hp1 - go)
        b4 = ~seg0 & (_left(Iused, NEGI) > _left(t4, 0))
        s0 = torch.where(b9, 1, _state_nibble(match, Iused, cands))
        word = (s0 | (b4.to(i32) << 4) | (b5.to(i32) << 5)
                | (b6.to(i32) << 6) | (b7.to(i32) << 7)
                | (b8.to(i32) << 8) | (b9.to(i32) << 9))
        tb[:, i] = word.to(torch.int16)
        # run-length hints (an I run never crosses a segment start)
        cnt1 = q - torch.cummax(torch.where(b4, -1, q.expand(n, W)),
                                dim=1).values
        cntD = torch.where(b5, CD3 + 1, 0)
        CA = torch.where(b6, CA + 1, 0)
        CB = torch.where(b7, CB + 1, 0)
        CC = torch.where(b8, CC + 1, 0)
        fin0 = s0 == 0
        cnt0 = torch.where(fin0, _left(C03, 0) + 1, 0)
        hv = torch.where(fin0, cnt0 - 1, 0)
        hv = torch.where(s0 == 1, cnt1, hv)
        hv = torch.where(s0 == 2, cntD, hv)
        hv = torch.where(s0 == 3, CA, hv)
        hv = torch.where(s0 == 4, CB, hv)
        hv = torch.where(s0 == 5, CC, hv)
        hint[:, i] = hv.to(torch.int16)
        score = torch.where(nlv - 1 == i, Hfin[ar, last], score)
        H3, H2, H1 = H2, H1, Hfin
        D3, D2, D1 = D2, D1, cands[0]
        C03, C02, C01 = C02, C01, cnt0
        CD3, CD2, CD1 = CD2, CD1, cntD
    # rows past a problem's own nl were computed for the batch only
    valid = valid_rows(nlv, rows)
    tb = torch.where(valid, tb, 0)
    hint = torch.where(valid, hint, 0)
    return tb, hint, score


def valid_rows(nlv, rows):
    """(n, rows, 1) mask of the tb rows a problem defines: [2, nl)."""
    r = torch.arange(rows, device=nlv.device).view(1, rows, 1)
    return (r >= 2) & (r < nlv.view(-1, 1, 1))


# ---------------------------------------------------------------------------
# K3: the run-walk
# ---------------------------------------------------------------------------


def run_walk(tb, hint, nlv, alv, rounds):
    """Follow each problem's traceback from (nl-1, al-1), one whole run
    per round: read (word, hint) at (i, j), emit (state, count), step by
    count cells.  Returns states (n, rounds) int8 (15 = padding),
    counts (n, rounds) int16 (uint16 payload), i_final, j_final (n,)
    int32; a problem with i_final >= 2 and j_final >= 0 hit the round
    cap.  CUDA tensors launch K3 (a warp per problem); CPU tensors run
    run_walk_plain."""
    if not tb.is_cuda:
        return run_walk_plain(tb, hint, nlv, alv, rounds)
    require(tb, torch.int16, 3, "tb")
    require(hint, torch.int16, 3, "hint")
    require(nlv, torch.int32, 1, "nlv")
    require(alv, torch.int32, 1, "alv")
    n, TR, W = tb.shape
    if hint.shape != tb.shape:
        raise ValueError("run_walk: tb/hint shapes differ")
    dev = tb.device
    states = torch.empty((n, rounds), dtype=torch.int8, device=dev)
    counts = torch.empty((n, rounds), dtype=torch.int16, device=dev)
    fi = torch.empty(n, dtype=torch.int32, device=dev)
    fj = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return states, counts, fi, fj
    call("mp_run_walk",
         tb.data_ptr(), hint.data_ptr(), nlv.data_ptr(), alv.data_ptr(),
         states.data_ptr(), counts.data_ptr(), fi.data_ptr(), fj.data_ptr(),
         n, TR, W, rounds, stream_ptr(tb))
    LAUNCHES["run_walk"] += 1
    return states, counts, fi, fj


def run_walk_plain(tb, hint, nlv, alv, rounds):
    """Plain PyTorch version of K3 (a port of the JAX _run_backtrack
    while_loop): all problems advance one round per step."""
    dev = tb.device
    n, TR, W = tb.shape
    i64 = torch.int64
    pad = (0,) * 6
    dim, dic, djm, djc = (torch.tensor(t + pad, dtype=i64, device=dev)
                          for t in (_DIM, _DIC, _DJM, _DJC))
    i = nlv.to(i64) - 1
    j = alv.to(i64) - 1
    states = torch.full((n, rounds), 15, dtype=torch.int8, device=dev)
    counts = torch.zeros((n, rounds), dtype=torch.int16, device=dev)
    tbf = tb.reshape(-1)
    hf = hint.reshape(-1)
    base = torch.arange(n, dtype=i64, device=dev) * (TR * W)
    for k in range(rounds):
        active = (i >= 2) & (j >= 0)
        if not bool(active.any()):
            break
        idx = base + i.clamp(0, TR - 1) * W + j.clamp(0, W - 1)
        s = tbf[idx].to(i64) & 0xF
        e = (hf[idx].to(i64) & 0xFFFF) + 1
        states[:, k] = torch.where(active, s, 15).to(torch.int8)
        counts[:, k] = torch.where(active, e, 0).to(torch.int32).to(
            torch.int16)
        i = torch.where(active, i - (e * dim[s] + dic[s]), i)
        j = torch.where(active, j - (e * djm[s] + djc[s]), j)
    return states, counts, i.to(torch.int32), j.to(torch.int32)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


class TrackBatch:
    """Host side shared by the CIGAR batches of both kernel families
    (this module's scan batches and nasw_cigar_striped's): the
    per-problem lengths, the query in the family's own form
    (_alloc_query / _put_query), the traceback-plane byte count (PLANES
    int16 planes per cell) and, through HostTracks or RawTracks, the
    genome tracks on the device.  A family adds its launch/collect
    pair."""

    CAPACITY = B
    PLANES = 1

    def __init__(self, al_pad, nl_pad, mat, opt_scalars, *, device=None,
                 capacity=None):
        self.al = self._width(al_pad)          # W, the class width
        self.nl = _pad_rows(nl_pad)
        (self.go, self.ge, self.fs, self.default_io, self.xdrop,
         self.end_bonus, self.ie_coef) = opt_scalars
        self.mat = np.asarray(mat).reshape(22, 22).astype(np.int8)
        self.device = as_device(device)
        self.capacity = capacity or self.CAPACITY
        self.alv = np.ones(self.capacity, np.int32)
        self.nlv = np.zeros(self.capacity, np.int32)
        self.dims = []
        self.n = 0
        self._alloc_query()

    @classmethod
    def _width(cls, al_pad: int) -> int:
        return al_pad

    @classmethod
    def planes_bytes(cls, nl_pad, W, capacity=None) -> int:
        """Device bytes of a full batch's traceback planes."""
        return 2 * cls.PLANES * _pad_rows(nl_pad) * W * (capacity
                                                         or cls.CAPACITY)

    def tb_bytes(self) -> int:
        return self.planes_bytes(self.nl, self.al, self.capacity)

    def _add_query(self, aas, nl) -> int:
        b, al = self.n, len(aas)
        assert 1 <= al <= self.al and nl <= self.nl and b < self.capacity
        self._put_query(b, aas)
        self.alv[b] = al
        self.nlv[b] = nl
        self.dims.append((nl, al))
        self.n += 1
        return b

    def _rows(self) -> int:
        return max(3, max((nl for nl, _ in self.dims), default=3))

    def _lens(self):
        """(nlv, alv) of the batch on its device."""
        return (_upload(self.nlv[:self.n], self.device),
                _upload(self.alv[:self.n], self.device))

    def stage(self) -> tuple:
        """The batch's inputs uploaded to its device (non-blocking toward
        the card): what launch() runs on, and may run on again."""
        nlv, alv = self._lens()
        return self._track_inputs(), nlv, alv, self._query_inputs()

    def _tracks(self):
        """(nas, D, A) on the batch's device, as launch() computes them."""
        return self._prep(self._track_inputs(), self._lens()[0])

    def run(self):
        return self.collect(self.launch())


class HostTracks(TrackBatch):
    """Tracks prepped on the host (--spsc jobs): nas, and the donor
    (folded with io) and acceptor streams."""

    def __init__(self, al_pad, nl_pad, mat, opt_scalars, **kw):
        super().__init__(al_pad, nl_pad, mat, opt_scalars, **kw)
        cap = self.capacity
        self.nas = np.zeros((cap, self.nl), np.int8)
        self.D = np.zeros((cap, self.nl + 8), np.int16)
        self.A = np.zeros((cap, self.nl + 8), np.int16)

    def add(self, nas, aas, donor, acceptor, io=None):
        io = self.default_io if io is None else io
        nl = len(nas)
        b = self._add_query(aas, nl)
        self.nas[b, :nl] = nas
        self.D[b, :nl + 1] = donor.astype(np.int32)[:nl + 1] + io
        self.A[b, :nl + 1] = acceptor.astype(np.int32)[:nl + 1]
        return b

    def _track_inputs(self):
        n, dev, R = self.n, self.device, self._rows()
        return (_upload(self.nas[:n, :R], dev),
                _upload(self.D[:n, :R + 8], dev).to(torch.int32),
                _upload(self.A[:n, :R + 8], dev).to(torch.int32))

    def _prep(self, inputs, nlv):
        return inputs


class RawTracks(TrackBatch):
    """Raw nt4 windows; the tracks are rebuilt on the device
    (prep_tracks: K7).  CIGAR jobs here are forward-strand and carry no
    --spsc track, so the folded donor stream is non-negative by
    construction."""

    def __init__(self, al_pad, nl_pad, mat, opt_scalars, *, sp,
                 trans_code: int = 1, **kw):
        super().__init__(al_pad, nl_pad, mat, opt_scalars, **kw)
        self.sp = np.asarray(sp, np.int32).reshape(-1)
        self.trans_code = trans_code
        self.nt = np.zeros((self.capacity, self.nl + 8), np.int8)
        self.iov = np.zeros(self.capacity, np.int32)

    def add_raw(self, nt4: np.ndarray, aas: np.ndarray, io=None):
        io = self.default_io if io is None else io
        nl = len(nt4)
        b = self._add_query(aas, nl)
        self.nt[b, :nl] = nt4
        self.iov[b] = io
        return b

    def _track_inputs(self):
        n, dev, R = self.n, self.device, self._rows()
        return (_upload(self.nt[:n, :R + 8], dev),
                _upload(self.iov[:n], dev))

    def _prep(self, inputs, nlv):
        """K7 on the staged raw windows: (nas, D, A)."""
        nt, iov = inputs
        return prep_tracks(
            nt, None, iov, nlv, sp=self.sp,
            codon=_tables.get_tables(self.trans_code).codon,
            n_rows=self._rows())


class _ScanBatch(TrackBatch):
    """The scan family: the query as a (22, W) profile, K2 + K3, and
    two planes per cell (tb and the run-length hint)."""

    PLANES = 2

    def _alloc_query(self):
        self.prof = np.zeros((self.capacity, 22, self.al), np.int8)

    def _query_inputs(self):
        return _upload(self.prof[:self.n], self.device)

    def _put_query(self, b, aas):
        assert self.go >= 1, "go==0 breaks scan/striped equivalence; " \
            "use the striped batches (nasw_cigar_striped)"
        self.prof[b, :, :len(aas)] = self.mat[:, aas]

    def _rows_used(self):
        max_nl = max((nl for nl, _ in self.dims), default=self.nl)
        rows_used = 2048
        while rows_used < max_nl:
            rows_used <<= 1
        return min(self.nl, rows_used)

    def rounds(self) -> int:
        return min(self._rows_used() + self.al + 2, _rounds_cap())

    def launch(self, staged=None):
        """K7 (raw windows), K2 then K3 on stage()'s tensors (staged here
        when None); returns the device handles without waiting."""
        tracks, nlv, alv, prof = self.stage() if staged is None else staged
        tb, hint, score = scan_cigar_dp(
            *self._prep(tracks, nlv), nlv, alv, prof,
            (self.go, self.ge, self.fs), self._rows())
        states, counts, fi, fj = run_walk(tb, hint, nlv, alv, self.rounds())
        return states, counts, fi, fj, score

    def collect(self, handles):
        from .. import native
        states, counts, fi, fj, score = to_host(handles).arrays()
        counts = counts.view(np.uint16)
        out = []
        for b in range(self.n):
            if fi[b] >= 2 and fj[b] >= 0:
                # the walk hit its round cap with this problem unfinished
                out.append(None)
                continue
            # expand (state, count) runs; padding rounds carry count 0
            exp = np.repeat(states[b], counts[b]).astype(np.uint8)
            out.append((int(score[b]),
                        native.cigar_from_states(exp, int(fi[b]),
                                                 int(fj[b]))))
        return out


class ScanCigarBatch(HostTracks, _ScanBatch):
    """Scan CIGAR problems with host-prepped tracks (--spsc jobs)."""


class RawScanCigarBatch(RawTracks, _ScanBatch):
    """Scan CIGAR problems shipped as raw nt4 windows (device prep)."""


class SmallScanCigarBatch(RawScanCigarBatch):
    """The al <= 32 class: W = 32 (one warp per problem on the card),
    up to 512 problems per launch."""

    CAPACITY = SMALL_CAPACITY

    @classmethod
    def _width(cls, al_pad: int) -> int:
        assert al_pad <= SMALL_W
        return SMALL_W
