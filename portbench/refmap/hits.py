"""Region (hit) bookkeeping: chain->region records, primary/secondary
assignment, score-based selection and extension caps.

Python port of hit.c with identical tie-breaking: region sorting goes
through the native unstable radix sort exactly like the reference
(mp_sort_reg, hit.c:97-126), and parent/secondary logic mirrors
mp_set_parent / mp_select_sub (hit.c:128-236).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import native

PARENT_UNSET = -1
PARENT_TMP_PRI = -2


@dataclass
class Extra:
    """Alignment result (mp_extra_t, miniprot.h:108-118)."""
    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    blen: int = 0
    n_fs: int = 0
    n_stop: int = 0
    dist_stop: int = -1
    dist_start: int = -1
    n_iden: int = 0
    n_plus: int = 0
    cigar: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint32))


@dataclass
class Feat:
    """Per-exon feature (mp_feat_t, miniprot.h:120-127)."""
    vs: int = 0
    ve: int = 0
    qs: int = 0
    qe: int = 0
    type: int = 0          # 0=CDS, 1=stop_codon
    phase: int = 0
    n_fs: int = 0
    n_stop: int = 0
    score: int = 0
    n_iden: int = 0
    blen: int = 0
    donor: str = ""
    acceptor: str = ""


@dataclass
class Region:
    """One candidate alignment region (mp_reg1_t, miniprot.h:129-143)."""
    vid: int = 0
    qs: int = 0
    qe: int = 0
    vs: int = 0
    ve: int = 0
    chn_sc: int = 0
    chn_sc_ungap: int = 0
    hash: int = 0
    id: int = 0
    parent: int = 0
    n_sub: int = 0
    subsc: int = 0
    n_exon: int = 0
    a: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    feat: list[Feat] | None = None
    p: Extra | None = None

    @property
    def cnt(self) -> int:
        return len(self.a)


def reg_gen_from_block(mi, u: np.ndarray, a: np.ndarray) -> list[Region]:
    """Chains (block resolution) -> regions, splitting chains that span a
    contig-strand boundary (mp_reg_gen_from_block, hit.c:32-76).

    The block->contig lookups and field extractions are vectorized over
    all chains (the per-chain binary searches were measurable at
    high-occupancy workloads); the rare boundary-split branch stays
    per-chain."""
    if len(u) == 0:
        return []
    bo = mi.bo
    bbit = mi.opt.bbit
    cnts = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
    scs = (u >> np.uint64(32)).astype(np.int64)
    ks = np.zeros(len(u), np.int64)
    np.cumsum(cnts[:-1], out=ks[1:])
    ies = ks + cnts - 1
    blk = (a >> np.uint64(32)).astype(np.int64)
    qpos = (a & np.uint64(0xFFFFFFFF)).astype(np.int64)
    ts_all = np.searchsorted(bo, blk[ks], side="right").astype(np.int64) - 1
    te_all = np.searchsorted(bo, blk[ies], side="right").astype(np.int64) - 1
    # all chains scored in one native call (one ctypes trip per BLOCK
    # instead of per region; ~250 regions/query on tandem-heavy runs)
    ungap_all = native.chn_sc_ungap_approx_batch(ks, cnts, a, mi.opt.kmer)
    regs: list[Region] = []
    for ci in range(len(u)):
        n = int(cnts[ci])
        k = int(ks[ci])
        r = Region()
        is_, ie = k, int(ies[ci])
        ts, te = int(ts_all[ci]), int(te_all[ci])
        assert ts <= te
        if ts == te:
            r.vid = ts
        else:  # split at the contig boundary, keep the bigger side
            js = is_
            while js < k + n and blk[js] < bo[ts + 1]:
                js += 1
            assert js < k + n
            je = k + n - 1
            while je >= js and blk[je] >= bo[te]:
                je -= 1
            je += 1
            if js - k > k + n - je:
                r.vid, ie = ts, js - 1
            else:
                r.vid, is_ = te, je
        bov = int(bo[r.vid])
        r.vs = (int(blk[is_]) - bov) << bbit
        r.ve = (int(blk[ie]) - bov + 1) << bbit
        r.qs = int(qpos[is_])
        r.qe = int(qpos[ie])
        sc = int(scs[ci])
        r.chn_sc = sc if ts == te else int(float(sc) * (ie - is_ + 1) / n + 0.499)
        # a view, not a copy: regions never mutate their anchors in
        # place (refine REPLACES r.a wholesale), `a` is per-query
        # transient anyway, and the 127k copies/500 queries showed up
        # on the capstone profile
        r.a = a[k:k + n]
        r.chn_sc_ungap = int(ungap_all[ci])
        regs.append(r)
    return regs


def sort_reg(regs: list[Region]) -> list[Region]:
    """Sort by score desc with the reference's exact tie permutation
    (mp_sort_reg, hit.c:97-126)."""
    if len(regs) <= 1:  # the reference keeps n<=1 untouched (hit.c:103)
        return regs
    aux = []
    for i, r in enumerate(regs):
        if r.cnt > 0:
            score = r.p.dp_max if r.p is not None else r.chn_sc
            aux.append(((score & 0xFFFFFFFF) << 32 | r.hash, i))
    xy = np.array(aux, dtype=np.uint64).reshape(-1, 2)
    native.sort_pair(xy)
    return [regs[int(xy[i, 1])] for i in range(len(xy) - 1, -1, -1)]


def set_parent(mask_level: float, mask_len: int, regs: list[Region],
               sub_diff: int, hard_mask_level: int = 0) -> None:
    """Primary/secondary assignment by query overlap (mp_set_parent,
    hit.c:128-187).  Tandem-heavy queries carry hundreds of regions and
    the O(n*|w|) pure-Python scan was ~5% of capstone map time, so big
    lists route to the native port; small lists stay in Python — the
    14-array marshalling costs more than the loop below ~48 regions
    (measured A/B on the capstone slice).  `_set_parent_py` is also the
    differential oracle for the native port."""
    n = len(regs)
    if n < 48:
        return _set_parent_py(mask_level, mask_len, regs, sub_diff,
                              hard_mask_level)
    for i, r in enumerate(regs):
        r.id = i
    qs = np.fromiter((r.qs for r in regs), np.int64, n)
    qe = np.fromiter((r.qe for r in regs), np.int64, n)
    vid = np.fromiter((r.vid for r in regs), np.int64, n)
    vs = np.fromiter((r.vs for r in regs), np.int64, n)
    ve = np.fromiter((r.ve for r in regs), np.int64, n)
    cnt = np.fromiter((r.cnt for r in regs), np.int64, n)
    chn_sc = np.fromiter((r.chn_sc for r in regs), np.int32, n)
    has_p = np.fromiter((r.p is not None for r in regs), np.uint8, n)
    p_dp_max = np.fromiter(
        (r.p.dp_max if r.p is not None else 0 for r in regs), np.int32, n)
    parent = np.fromiter((r.parent for r in regs), np.int32, n)
    n_sub = np.fromiter((r.n_sub for r in regs), np.int32, n)
    subsc = np.fromiter((r.subsc for r in regs), np.int32, n)
    p_dp_max2 = np.fromiter(
        (r.p.dp_max2 if r.p is not None else 0 for r in regs), np.int32, n)
    native.set_parent_c(mask_level, mask_len, sub_diff, hard_mask_level,
                        qs, qe, vid, vs, ve, cnt, chn_sc, has_p, p_dp_max,
                        parent, n_sub, subsc, p_dp_max2)
    for i, r in enumerate(regs):
        r.parent = int(parent[i])
        r.n_sub = int(n_sub[i])
        r.subsc = int(subsc[i])
        if r.p is not None:
            r.p.dp_max2 = int(p_dp_max2[i])


def _set_parent_py(mask_level: float, mask_len: int, regs: list[Region],
                   sub_diff: int, hard_mask_level: int = 0) -> None:
    """Pure-Python mp_set_parent — the differential oracle for the
    native port (tests/test_properties.py)."""
    n = len(regs)
    if n <= 0:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    for i in range(1, n):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        uncov_len = 0
        if not hard_mask_level:
            cov = []
            for j in w:
                rp = regs[j]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                cov.append((max(sj, si) << 32) | min(ej, ei))
            if not cov:
                ri.parent = i
                ri.n_sub = 0
                w.append(i)
                continue
            # plain list sort: cov is tiny and scalar-u64 ordering is
            # value-determined, so this matches the radix sort exactly
            # without an array allocation per region pair group
            cov.sort()
            x = si
            for cv in cov:
                cs, ce = cv >> 32, cv & 0xFFFFFFFF
                if cs > x:
                    uncov_len += cs - x
                if ce > x:
                    x = ce
            if ei > x:
                uncov_len += ei - x
        placed = False
        for j in w:
            rp = regs[j]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                continue
            mn = min(ej - sj, ei - si)
            mx = max(ej - sj, ei - si)
            if si < sj:
                ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
            else:
                ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
            # float32 arithmetic, exactly as hit.c:168:
            # (float)ol/min - (float)uncov_len/max > mask_level
            ovl = np.float32(np.float32(np.float32(ol) / np.float32(mn))
                             - np.float32(np.float32(uncov_len) / np.float32(mx)))
            if ovl > np.float32(mask_level) and uncov_len <= mask_len:
                cnt_sub = 0
                sci = ri.chn_sc
                ri.parent = rp.parent
                rp.subsc = max(rp.subsc, sci)
                if ri.cnt >= rp.cnt:
                    cnt_sub = 1
                if (rp.p is not None and ri.p is not None
                        and (rp.vid != ri.vid or rp.vs != ri.vs or rp.ve != ri.ve or ol != mn)):
                    sci = ri.p.dp_max
                    rp.p.dp_max2 = max(rp.p.dp_max2, sci)
                    if rp.p.dp_max - ri.p.dp_max <= sub_diff:
                        cnt_sub = 1
                if cnt_sub:
                    rp.n_sub += 1
                placed = True
                break
        if not placed:
            ri.parent = i
            ri.n_sub = 0
            w.append(i)


def sync_regs(regs: list[Region]) -> None:
    """Remap parent indices after removals (mp_sync_regs, hit.c:189-210)."""
    if not regs:
        return
    max_id = max(r.id for r in regs)
    tmp = [-1] * (max_id + 1)
    for i, r in enumerate(regs):
        if r.id >= 0:
            tmp[r.id] = i
    for i, r in enumerate(regs):
        r.id = i
        if r.parent == PARENT_TMP_PRI:
            r.parent = i
        elif r.parent >= 0 and tmp[r.parent] >= 0:
            r.parent = tmp[r.parent]
        else:
            r.parent = PARENT_UNSET


def select_sub(pri_ratio: float, min_diff: int, best_n: int,
               regs: list[Region]) -> list[Region]:
    """Drop weak/duplicate secondaries (mp_select_sub, hit.c:212-236).
    Big lists route to the native port (same threshold rationale as
    set_parent); `_select_sub_py` is the differential oracle."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    n = len(regs)
    if n < 48:
        return _select_sub_py(pri_ratio, min_diff, best_n, regs)
    qs = np.fromiter((r.qs for r in regs), np.int64, n)
    qe = np.fromiter((r.qe for r in regs), np.int64, n)
    vid = np.fromiter((r.vid for r in regs), np.int64, n)
    vs = np.fromiter((r.vs for r in regs), np.int64, n)
    ve = np.fromiter((r.ve for r in regs), np.int64, n)
    parent = np.fromiter((r.parent for r in regs), np.int32, n)
    has_p = np.fromiter((r.p is not None for r in regs), np.uint8, n)
    p_dp_max = np.fromiter(
        (r.p.dp_max if r.p is not None else 0 for r in regs), np.int32, n)
    chn_sc = np.fromiter((r.chn_sc for r in regs), np.int32, n)
    ungap = np.fromiter((r.chn_sc_ungap for r in regs), np.int32, n)
    keep = native.select_sub_c(pri_ratio, min_diff, best_n, qs, qe, vid,
                               vs, ve, parent, has_p, p_dp_max, chn_sc,
                               ungap)
    out = [r for r, k in zip(regs, keep) if k]
    if len(out) != len(regs):
        sync_regs(out)
    return out


def _select_sub_py(pri_ratio: float, min_diff: int, best_n: int,
                   regs: list[Region]) -> list[Region]:
    """Pure-Python mp_select_sub — the differential oracle."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    chn_sc_ungap = max((r.chn_sc_ungap for r in regs), default=-1)
    out: list[Region] = []
    n_2nd = 0
    for i, r in enumerate(regs):
        p = r.parent
        rp = regs[p]
        sci = r.p.dp_max if r.p is not None else r.chn_sc
        scp = rp.p.dp_max if rp.p is not None else rp.chn_sc
        if p == i:
            out.append(r)
        elif ((np.float32(sci) >= np.float32(np.float32(scp) * np.float32(pri_ratio))
               or sci + min_diff >= scp) and n_2nd < best_n):
            if not (r.qs == rp.qs and r.qe == rp.qe and r.vid == rp.vid
                    and r.vs == rp.vs and r.ve == rp.ve):
                out.append(r)
                n_2nd += 1
        elif (r.p is None and rp.p is None and chn_sc_ungap > 0
              and np.float32(r.chn_sc_ungap)
              >= np.float32(np.float32(chn_sc_ungap) * np.float32(pri_ratio))
              and n_2nd < best_n):
            if not (r.qs == rp.qs and r.qe == rp.qe and r.vid == rp.vid
                    and r.vs == rp.vs and r.ve == rp.ve):
                out.append(r)
                n_2nd += 1
    if len(out) != len(regs):
        sync_regs(out)
    return out


def select_multi_exon(regs: list[Region], single_penalty: int) -> None:
    """Prefer a multi-exon hit over a barely-better single-exon one
    (anti-processed-pseudogene; mp_select_multi_exon, hit.c:238-250)."""
    n = len(regs)
    if n < 2 or regs[0].n_exon != 1:
        return
    i = 1
    while i < n and regs[i].n_exon < 2:
        i += 1
    if i == n:
        return
    if regs[0].p is None or regs[i].p is None:
        return
    if regs[0].p.dp_max < regs[i].p.dp_max + single_penalty:
        regs[0], regs[i] = regs[i], regs[0]


def cal_max_ext(nt, regs: list[Region], min_ext: int, max_ext: int) -> list[tuple[int, int]]:
    """Per-region extension caps so neighbors don't overlap
    (mp_cal_max_ext, hit.c:252-287).  nt is the NtDB or None (block round)."""
    n = len(regs)
    if n <= 0:
        return []
    b = np.empty((n, 2), np.uint64)
    for i, r in enumerate(regs):
        if nt is not None:
            c = nt.ctg[r.vid >> 1]
            b[i, 0] = r.vs + c.off + (c.len if r.vid & 1 else 0)
        else:
            b[i, 0] = int(r.a[0] >> np.uint64(32))
        b[i, 1] = i
    native.sort_pair(b)
    ext = [(0, 0)] * n
    for i in range(n):
        left = right = max_ext
        j = int(b[i, 1])
        r = regs[j]
        if i > 0:
            q = regs[int(b[i - 1, 1])]
            if q.vid == r.vid and q.qe >= r.qs:
                left = min(r.vs - q.ve, max_ext)
                left = max(left, min_ext)
        if i < n - 1:
            q = regs[int(b[i + 1, 1])]
            if q.vid == r.vid and r.qe >= q.qs:
                right = min(q.vs - r.ve, max_ext)
                right = max(right, min_ext)
        ext[j] = (left, right)
    return ext
