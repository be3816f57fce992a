"""Striped full-CIGAR DP (K4) and its per-cell walk (K5), with their
plain PyTorch versions and the batch classes.  Counterpart of
miniprot_tpu/kernels/nasw_cigar_pallas.py.

The DP is the reference's ns_global_gs16b with NS_F_CIGAR
(nasw-sse.c:444-541) in its own striped (Farrar) evaluation order:
VL lanes per stripe vector, the stripes of a genome row in sequence,
then the lazy-F fixup with its early break.  The traceback bits depend
on that order, and the scan kernel (nasw_cigar_scan.py) reproduces
them only for go >= 1, so this path serves every CIGAR job at go == 0
and, on request (cig_impl="striped"), all of them.  The same DP with 4
plain int32 lanes is ns_global_gs32b (nasw-sse.c:558-750), the
library's 32-bit DP (Dp32Batch; the mapper does not run it).

Each problem runs its own stripe count slen = ceil(al / VL).  The
traceback words are stored (n, rows, W) int16 per problem, W = the
class width, in striped column order: position q sits in column
(q % slen)*VL + q // slen (the host engine's layout).  The walk reads
them on the card and ships one state per step; the host replays the
states with native.cigar_from_states.  The 32-bit form ships its words
and the host decodes them with native.backtrack_strided (vl = 4).

The plain versions compute the same words in position order: the first
pass of a row (the stripe loop) is the segmented I scan of
nasw_cigar_scan.py (a lane's stripes are one run of positions), and the
lazy-F fixup is evaluated on its whole (pass, stripe, lane) step grid
at once, up to each problem's own break (_striped_plain).  K4 computes
the row as the scan kernel does (the fixup is the full-row I scan at go
>= 1 and one step at each segment start at go == 0;
tests/test_torch_striped.py holds both identities against
_striped_plain, for the B4 and the B4' form) and stores it in striped
column order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import LAUNCHES, call, require, stream_ptr, to_host
from .nasw_cigar_scan import (SCAN_WIDTHS, SMALL_CAPACITY, HostTracks,
                              RawTracks, TrackBatch, _left, _row_terms, _sadd,
                              _ssub, _state_nibble)
from .nasw_ext import _upload

NEG16 = -32768           # int16 saturation floor (B4)
NEG32 = -0x40000000      # gs32b init value (B4')
VL = 8                   # lanes per stripe, saturating int16
VL32 = 4                 # lanes per stripe, int32
# class widths K4's B4 form is built for, and the warps per problem that
# mp_striped_cigar's launch switch fixes for each (reported, not passed):
# K2's spread geometries (a warp per problem at W=128 lost to two at 128
# and at 512 problems, and the maps launch fewer; PERF.md)
STRIPED_WIDTHS = SCAN_WIDTHS
STRIPED_WARPS = {32: 1, 128: 2, 512: 4}
# K4's B4' form takes any W that is a multiple of 4 up to 1024 on the
# geometry of the class width above it (mp_striped_cigar32's switch:
# 1 warp at 1 position per thread, 2 at 2, 4 at 4, 4 at 8)
DP32_WARPS = {32: 1, 128: 2, 512: 4, 1024: 4}


def dp32_class(W: int) -> int:
    """The class width whose geometry B4' runs at row width W."""
    return min(c for c in DP32_WARPS if c >= W)

# per-state genome rows / query columns consumed (bt_step in mpnative.c)
_BT_DI = (3, 0, 3, 1, 1, 1, 1, 2, 1, 2, 0, 0, 0, 0, 0, 0)
_BT_DJ = (1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0)


# ---------------------------------------------------------------------------
# K4: the striped CIGAR DP
# ---------------------------------------------------------------------------


def striped_cigar_dp(nas, D, A, nlv, alv, aas, mat, opts, rows):
    """Traceback words and end scores of n problems, 8 saturating int16
    lanes per stripe (B4).

    nas (n, R) int8 aa codes per genome row; D, A (n, R+8) int32 tracks
    (donor folded with io); nlv, alv (n,) int32 with 1 <= al <= W;
    aas (n, W) int8 query codes in position order; mat (22, 22) int8;
    opts = (go, ge, fs); rows = the tb rows to allocate (>= max nl,
    <= R).  Returns tb (n, rows, W) int16 in striped column order (rows
    [2, nl_b) and columns of stripes < slen_b are defined) and score
    (n,) int32 = H(nl-1, al-1).  CUDA tensors launch K4 (W one of
    STRIPED_WIDTHS, STRIPED_WARPS[W] warps per problem); CPU tensors run
    striped_cigar_dp_plain."""
    if not nas.is_cuda:
        return _striped_plain(VL, nas, D, A, nlv, alv, aas, mat, opts, rows)
    W = aas.shape[1]
    if W not in STRIPED_WIDTHS:
        raise ValueError(f"striped_cigar_dp: unsupported W={W}")
    return _launch_striped("mp_striped_cigar", "striped_cigar_dp", nas, D, A,
                           nlv, alv, aas, mat, opts, rows)


def striped_cigar_dp32(nas, D, A, nlv, alv, aas, mat, opts, rows):
    """The same with 4 plain int32 lanes per stripe (B4', gs32b): no
    saturation, NEG32 floor, at most 4 lazy-F passes.  Scores may pass
    the int16 range.  Any W that is a multiple of 4 up to 1024 (W is the
    row stride of aas and tb; CUDA tensors launch K4's striped32_kernel
    on DP32_WARPS[the class width above W] warps per problem); a wider W
    raises on either device."""
    W = aas.shape[1]
    if W % VL32 or not 0 < W <= max(DP32_WARPS):
        raise ValueError(f"striped_cigar_dp32: W={W} is not a multiple of "
                         f"{VL32} in [4, {max(DP32_WARPS)}]")
    if not nas.is_cuda:
        return _striped_plain(VL32, nas, D, A, nlv, alv, aas, mat, opts,
                              rows)
    return _launch_striped("mp_striped_cigar32", "striped_cigar_dp32", nas,
                           D, A, nlv, alv, aas, mat, opts, rows)


def _launch_striped(entry, counter, nas, D, A, nlv, alv, aas, mat, opts,
                    rows):
    n, R = nas.shape
    W = aas.shape[1]
    require(nas, torch.int8, 2, "nas")
    require(D, torch.int32, 2, "D")
    require(A, torch.int32, 2, "A")
    require(nlv, torch.int32, 1, "nlv")
    require(alv, torch.int32, 1, "alv")
    require(aas, torch.int8, 2, "aas")
    require(mat, torch.int8, 2, "mat")
    if D.shape != (n, R + 8) or A.shape != (n, R + 8) \
            or aas.shape[0] != n or mat.shape != (22, 22) or rows > R:
        raise ValueError("striped_cigar_dp: inconsistent shapes")
    dev = nas.device
    tb = torch.empty((n, rows, W), dtype=torch.int16, device=dev)
    score = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return tb, score
    go, ge, fs = (int(v) for v in opts)
    call(entry,
         nas.data_ptr(), D.data_ptr(), A.data_ptr(), nlv.data_ptr(),
         alv.data_ptr(), aas.data_ptr(), mat.data_ptr(), tb.data_ptr(),
         score.data_ptr(), n, R, R + 8, W, rows, go, ge, fs,
         stream_ptr(nas))
    LAUNCHES[counter] += 1
    return tb, score


def striped_cigar_dp_plain(nas, D, A, nlv, alv, aas, mat, opts, rows):
    """Plain PyTorch version of K4's B4 form (same arguments and
    results; undefined tb cells are 0)."""
    return _striped_plain(VL, nas, D, A, nlv, alv, aas, mat, opts, rows)


def striped_cigar_dp32_plain(nas, D, A, nlv, alv, aas, mat, opts, rows):
    """Plain PyTorch version of K4's B4' form."""
    return _striped_plain(VL32, nas, D, A, nlv, alv, aas, mat, opts, rows)


def _striped_plain(vl, nas, D, A, nlv, alv, aas, mat, opts, rows,
                   passes=None):
    """One genome row per step over all problems, in position order.

    Pass 1 (the stripe loop): lane k's stripes j = 0..slen-1 are the
    positions k*slen + j, and the I chain inside a lane unrolls to
    I(q) = max(floor, max_{seg start <= p < q}(sub(base_p, go) + p*ge)
    - q*ge), base = the order-free candidates, floor = NEG16 when
    saturating and NEG32 - (j+1)*ge in int32.

    The lazy-F fixup: I does not depend on H, so the I of every
    (pass P, stripe j, lane k) step is known up front — lane k-1-P's
    starting I decayed by (P*slen + j)*ge, or the NEG that entered lane
    0 at pass P-k.  H before step (P, j) is the pass-1 H raised by the
    earlier passes' I at that cell.  The steps run are those up to and
    including the first whose break test holds (all lanes), or all
    ``passes`` passes (the reference's VL; a test raises it to show the
    cap changes no word)."""
    sat = vl == VL
    NP = passes or vl
    NEG = NEG16 if sat else NEG32
    dev = nas.device
    n, R = nas.shape
    W = aas.shape[1]
    SC = W // vl                              # stripe capacity
    go, ge, fs = (int(v) for v in opts)
    goe = go + ge
    i32, i64 = torch.int32, torch.int64
    BIG = -(1 << 40)

    add, sub = (_sadd, _ssub) if sat else (torch.add, torch.sub)
    nlv = nlv.to(i32)
    alv = alv.to(i32)
    q = torch.arange(W, dtype=i32, device=dev).view(1, W)
    sl = torch.clamp((alv + vl - 1) // vl, min=1).view(n, 1)
    jq = q % sl                               # stripe of position q
    seg0 = jq == 0
    segkey = (q // sl).to(i64) << 34          # one segment per lane
    qge = q.to(i64) * ge
    floor = (torch.full_like(jq, NEG) if sat
             else NEG - (jq + 1) * ge).to(i64)
    prof = mat.to(i32).view(22, 22)[:, aas.long().clamp(min=0)]
    prof = torch.where((q >= alv.view(n, 1)).view(1, n, W), NEG,
                       prof).permute(1, 0, 2)          # (n, 22, W)
    D = D.to(i32)
    A = A.to(i32)
    # striped column c = j*vl + k holds position k*slen + j (j < slen);
    # columns of stripes past slen map to the spare position W
    col = torch.arange(W, device=dev).view(1, W)
    col_ok = col // vl < sl
    col_pos = torch.where(col_ok, (col % vl) * sl + col // vl, W)
    lane_end = torch.arange(vl, device=dev).view(1, vl) * sl + sl - 1
    # lazy-F step grid (pass P, stripe j, lane k)
    sl4 = sl.view(n, 1, 1, 1).to(i64)
    Pp = torch.arange(NP, device=dev).view(1, NP, 1, 1)
    jj = torch.arange(SC, device=dev).view(1, 1, SC, 1)
    kk = torch.arange(vl, device=dev).view(1, 1, 1, vl)
    origin = kk - 1 - Pp                      # lane whose start I arrives
    decay = (Pp * sl4 + jj) * ge
    neg_in = (torch.full_like(decay, NEG) if sat
              else NEG - (kk * sl4 + jj) * ge)
    j_ok = (jj < sl4).view(n, 1, SC, 1)
    step = torch.arange(NP * SC, device=dev).view(1, NP * SC)
    tb = torch.zeros((n, rows, W), dtype=torch.int16, device=dev)
    score = torch.full((n,), NEG, dtype=i32, device=dev)

    def full(v):
        return torch.full((n, W), v, dtype=i32, device=dev)

    H1, H2, H3 = full(NEG), full(NEG), full(NEG)
    D1, D2, D3 = full(NEG), full(NEG), full(NEG)
    Ac, Bc, Cc = full(NEG), full(NEG), full(NEG)
    ar = torch.arange(n, device=dev)
    last = (alv - 1).long()
    max_nl = min(int(nlv.max()) if n else 0, rows)
    for i in range(2, max_nl):
        match, cands, (b5, b6, b7, b8), (Ac, Bc, Cc) = _row_terms(
            i, nas, D, A, prof[ar, nas[:, i].long()], (H1, H2, H3), D3,
            (Ac, Bc, Cc), (go, ge, fs), NEG, add, sub)
        base = match
        for x in cands:
            base = torch.maximum(base, x)
        # pass 1: the I chain of each lane (a segmented prefix max)
        u = sub(base, go).to(i64) + qge
        SM = torch.cummax(segkey + (u + (1 << 32)), dim=1).values
        SM = SM - segkey - (1 << 32)
        I1 = torch.maximum(torch.where(seg0, BIG, _left(SM, 0)) - qge,
                           floor).to(i32)
        hp1 = torch.maximum(base, I1)
        # bit 4: the incoming I beat last_h - go (last_h = the previous
        # stripe's h; both NEG at a lane's first stripe)
        b4 = torch.where(seg0, NEG, _left(I1, NEG)) > sub(
            torch.where(seg0, NEG, _left(hp1, NEG)), go)
        y = _state_nibble(match, I1, cands)
        word = (y | (b4.to(i32) << 4) | (b5.to(i32) << 5)
                | (b6.to(i32) << 6) | (b7.to(i32) << 7) | (b8.to(i32) << 8))
        # lazy-F (nasw-sse.c:521-537) on the (P, j, k) step grid
        I0 = torch.maximum(sub(hp1.gather(1, lane_end), goe),
                           sub(I1.gather(1, lane_end), ge)).to(i64)
        Iv = torch.where(origin >= 0,
                         I0[:, origin.clamp(min=0)].squeeze(1) - decay,
                         neg_in)
        if sat:
            Iv = Iv.clamp(min=NEG)
        hp1x = torch.cat([hp1, hp1[:, :1]], dim=1)
        Hc = hp1x.gather(1, col_pos).view(n, 1, SC, vl).to(i64)
        Hcur = torch.maximum(Hc, torch.cat(
            [torch.full_like(Iv[:, :1], BIG),
             torch.cummax(Iv, dim=1).values[:, :-1]], dim=1))
        hn = torch.maximum(Hcur, Iv)
        brk = ((sub(Iv, ge) <= sub(hn, goe)).all(dim=3, keepdim=True)
               & j_ok).view(n, NP * SC)
        stop = torch.where(brk.any(dim=1), brk.to(i32).argmax(dim=1),
                           NP * SC)
        run = (step <= stop.view(n, 1)).view(n, NP, SC, 1) & j_ok
        b9 = ((Iv > Hcur) & run).any(dim=1).view(n, W)
        Hs = torch.maximum(Hc[:, 0], torch.where(run, Iv, BIG).amax(dim=1))
        H = hp1x.scatter(1, col_pos, Hs.view(n, W).to(i32))[:, :W]
        wordx = torch.cat([word, word[:, :1]], dim=1)
        tb[:, i] = torch.where(col_ok, wordx.gather(1, col_pos)
                               | (b9.to(i32) << 9), 0).to(torch.int16)
        score = torch.where(nlv - 1 == i, H[ar, last], score)
        H3, H2, H1 = H2, H1, H
        D3, D2, D1 = D2, D1, cands[0]
    valid = valid_cells(nlv, alv, rows, W, vl)
    return torch.where(valid, tb, 0), score


def valid_cells(nlv, alv, rows, W, vl=VL):
    """(n, rows, W) mask of the tb cells a problem defines: rows
    [2, nl) and the columns of its own stripes (j < slen)."""
    r = torch.arange(rows, device=nlv.device).view(1, rows, 1)
    sl = torch.clamp((alv.to(torch.int32) + vl - 1) // vl, min=1)
    c = torch.arange(W, device=nlv.device).view(1, 1, W)
    return ((r >= 2) & (r < nlv.view(-1, 1, 1))
            & (c // vl < sl.view(-1, 1, 1)))


# ---------------------------------------------------------------------------
# K5: the per-cell walk
# ---------------------------------------------------------------------------


def cell_walk(tb, nlv, alv, steps):
    """Walk each problem's striped B4 words from (nl-1, al-1), one cell
    per step (nasw_cigar_pallas._device_backtrack), for at most
    ``steps`` steps.  Returns states (n, steps) int8, one per step and
    15 past the walk's end, and i_final, j_final (n,) int32.  Each step
    consumes a genome row or a query column, so a walk ends within
    nl + al - 2 steps; _StripedBatch.steps() allots that.  CUDA tensors
    launch K5, which walks a warp per problem through tiles of the
    words staged in shared memory, a whole run of one state per round
    (the same states and final cells); CPU tensors run
    cell_walk_plain."""
    if not tb.is_cuda:
        return cell_walk_plain(tb, nlv, alv, steps)
    require(tb, torch.int16, 3, "tb")
    require(nlv, torch.int32, 1, "nlv")
    require(alv, torch.int32, 1, "alv")
    n, TR, W = tb.shape
    if W % VL:
        raise ValueError(f"cell_walk: W={W} is not a multiple of {VL}")
    dev = tb.device
    states = torch.empty((n, steps), dtype=torch.int8, device=dev)
    fi = torch.empty(n, dtype=torch.int32, device=dev)
    fj = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return states, fi, fj
    call("mp_cell_walk", tb.data_ptr(), nlv.data_ptr(), alv.data_ptr(),
         states.data_ptr(), fi.data_ptr(), fj.data_ptr(), n, TR, W, steps,
         stream_ptr(tb))
    LAUNCHES["cell_walk"] += 1
    return states, fi, fj


def cell_walk_plain(tb, nlv, alv, steps):
    """Plain PyTorch version of K5 (a port of the JAX _device_backtrack
    while_loop): all problems advance one cell per step."""
    dev = tb.device
    n, TR, W = tb.shape
    i64 = torch.int64
    di = torch.tensor(_BT_DI, dtype=i64, device=dev)
    dj = torch.tensor(_BT_DJ, dtype=i64, device=dev)
    i = nlv.to(i64) - 1
    j = alv.to(i64) - 1
    sl = torch.clamp((alv.to(i64) + VL - 1) // VL, min=1)
    last = torch.zeros(n, dtype=i64, device=dev)
    states = torch.full((n, steps), 15, dtype=torch.int8, device=dev)
    tbf = tb.reshape(-1)
    base = torch.arange(n, dtype=i64, device=dev) * (TR * W)
    for k in range(steps):
        active = (i >= 2) & (j >= 0)
        if not bool(active.any()):
            break
        jc = j.clamp(min=0)
        col = ((jc % sl) * VL + jc // sl).clamp(0, W - 1)
        x = tbf[base + i.clamp(0, TR - 1) * W + col].to(i64)
        x = torch.where((x >> 9) & 1 == 1, 1 | ((x >> 4) << 4), x)
        state = torch.where(last == 0, x & 0xF, last)
        is_gap = (state >= 1) & (state <= 5)
        ext = torch.where(is_gap, (x >> (state + 3)) & 1, 0)
        states[:, k] = torch.where(active, state, 15).to(torch.int8)
        step_j = torch.where((state == 4) | (state == 5), 1 - ext, dj[state])
        i = torch.where(active, i - di[state], i)
        j = torch.where(active, j - step_j, j)
        last = torch.where(active, torch.where(is_gap & (ext == 1), state, 0),
                           last)
    return states, i.to(torch.int32), j.to(torch.int32)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


class _StripedBatch(TrackBatch):
    """The striped family: the query as residue codes, K4 (+ K5), one
    tb plane per cell and a width rounded up to whole stripes."""

    VLANES = VL
    _dp = staticmethod(striped_cigar_dp)

    @classmethod
    def _width(cls, al_pad: int) -> int:
        return -(-al_pad // cls.VLANES) * cls.VLANES

    def _alloc_query(self):
        self.aas = np.zeros((self.capacity, self.al), np.int8)

    def _put_query(self, b, aas):
        self.aas[b, :len(aas)] = aas

    def steps(self) -> int:
        """Walk steps that finish every problem of the batch: a walk
        ends within nl + al - 2 steps (each one consumes a row or a
        column), so the stream's width is the largest of those (at
        least 1)."""
        return max((nl + al - 2 for nl, al in self.dims), default=1)

    def _launch_dp(self):
        """K4 on the batch's tracks: (tb, score, nlv, alv) on the card."""
        nlv, alv = self._lens()
        tb, score = self._dp(*self._tracks(), nlv, alv,
                             _upload(self.aas[:self.n], self.device),
                             _upload(self.mat, self.device),
                             (self.go, self.ge, self.fs), self._rows())
        return tb, score, nlv, alv

    def launch(self):
        """K4 then K5; returns the device handles without waiting."""
        tb, score, nlv, alv = self._launch_dp()
        return (*cell_walk(tb, nlv, alv, self.steps()), score)

    def collect(self, handles):
        from .. import native
        states, fi, fj, score = to_host(handles).arrays()
        return [(int(score[b]),
                 native.cigar_from_states(states[b], int(fi[b]), int(fj[b])))
                for b in range(self.n)]


class CigarBatch(HostTracks, _StripedBatch):
    """Striped CIGAR problems with host-prepped tracks (--spsc jobs)."""


class RawCigarBatch(RawTracks, _StripedBatch):
    """Striped CIGAR problems shipped as raw nt4 windows (device prep)."""


class SmallCigarBatch(RawCigarBatch):
    """The al <= 32 class on the striped kernel: 512 problems per launch
    or more (device.cig_capacity), as the scan path's small class."""

    CAPACITY = SMALL_CAPACITY


class Dp32Batch(CigarBatch):
    """Batched 32-bit full-CIGAR DPs (the gs32b library DP, B4'): the
    words come back to the host, which decodes them with
    native.backtrack_strided at the port's own stripe stride (4)."""

    VLANES = VL32
    _dp = staticmethod(striped_cigar_dp32)

    def launch(self):
        tb, score, _, _ = self._launch_dp()
        return tb, score

    def collect(self, handles):
        from .. import native
        tb, score = to_host(handles).arrays()
        out = []
        for b in range(self.n):
            nl, al = self.dims[b]
            slen = (al + VL32 - 1) // VL32
            cig = native.backtrack_strided(np.ascontiguousarray(tb[b, :nl]),
                                           slen, self.al, nl, al, vl=VL32)
            out.append((int(score[b]), cig))
        return out
