"""Alignment orchestration: per-region anchored DP with extensions.

Python port of align.c driving the native striped DP (or, on TPU, the
Pallas kernels): anchor filtering to "tight blocks", left/right
extension with the cheaper terminal-intron retry, per-gap global DP,
and the per-CIGAR-op accounting pass that produces alignment statistics
and per-exon features (mp_align / mp_extra_cal, align.c:82-342).
"""

from __future__ import annotations

import numpy as np

from . import native, tables
from .hits import Extra, Feat, Region
from .native import DPF_EXT_LEFT, DPF_EXT_RIGHT
from .options import MapOpt

C_M, C_I, C_D, C_N, C_F, C_G, C_U, C_V = 0, 1, 2, 3, 10, 11, 12, 13
CIGAR_STR = "MIDNSHP=XBFGUVE"


def filter_seed(a: np.ndarray, max_aa_dist: int, min_cnt: int, kmer2: int,
                trim_back: int) -> np.ndarray:
    """Mark (bit 31) anchors inside tight in-frame blocks, trimming the
    block edges (mp_filter_seed, align.c:6-31).  Returns modified a."""
    cnt = len(a)
    av = a.view(np.uint64)
    i = 0
    while i < cnt:
        j = i + 1
        while j < cnt:
            x0 = int(av[j - 1] >> np.uint64(32))
            y0 = int(av[j - 1] & np.uint64(0xFFFFFFFF))
            x1 = int(av[j] >> np.uint64(32))
            y1 = int(av[j] & np.uint64(0xFFFFFFFF))
            if (x1 - x0) % 3 != 0 or x1 - x0 > max_aa_dist * 3 or y1 - y0 > max_aa_dist:
                break
            j += 1
        if j - i >= min_cnt:
            t = int(av[j - 1] & np.uint64(0xFFFFFFFF))
            k = j - 2
            while k >= i:
                if t - int(av[k] & np.uint64(0xFFFFFFFF)) >= trim_back:
                    break
                k -= 1
            t = int(av[i] & np.uint64(0xFFFFFFFF)) + 1 - kmer2
            while i < k:
                if int(av[i] & np.uint64(0xFFFFFFFF)) + 1 - t >= trim_back:
                    break
                i += 1
            while i <= k:
                av[i] |= np.uint64(1) << np.uint64(31)
                i += 1
            i = j - 1
        i += 1
    return a


def score_ungapped(nseq: np.ndarray, aseq: np.ndarray, opt: MapOpt) -> int:
    """Frame-0 ungapped rescoring (mp_score_ungapped, align.c:33-43).

    NB: the reference's loop runs ``for (i=0; i < alen; i += 3)`` with
    alen in aa units, so only ceil(alen/3) codons are scored; this quirk
    is load-bearing for dp_score parity.
    """
    T = tables.get_tables()
    return int(native._lib.mx_score_ungapped(
        np.ascontiguousarray(nseq, dtype=np.uint8),
        np.ascontiguousarray(aseq, dtype=np.uint8), len(aseq),
        np.ascontiguousarray(opt.mat.reshape(-1), dtype=np.int8), opt.asize,
        T.codon, T.aa20))


class DpEnv:
    """Prepared DP parameters shared across calls for one query batch
    (mp_map2ns_opt, align.c:50-60)."""

    def __init__(self, opt: MapOpt):
        T = tables.get_tables()
        sp = tables.splice_model_scores(opt.sp_model).astype(np.float32)
        self.sp = (sp * np.float32(opt.sp_scale) + np.float32(0.499)).astype(np.int32)
        self.kw = dict(mat=opt.mat, nt4=T.nt4, aa20=T.aa20, codon=T.codon,
                       sp=self.sp, sp_null_bonus=opt.sp_null_bonus,
                       go=opt.go, ge=opt.ge, fs=opt.fs,
                       xdrop=opt.xdrop, end_bonus=opt.end_bonus,
                       ie_coef=opt.ie_coef, asize=opt.asize)
        self.ctx = native.Dp16Ctx(**self.kw)
        self.io = opt.io
        self.io_end = opt.io_end

    def dp_cigars(self, jobs):
        """Batched CIGAR DPs (mx_dp16x4) -> [(score, cigar), ...]."""
        clean = []
        for nsq, asq, ss in jobs:
            nsq = np.ascontiguousarray(nsq, dtype=np.uint8)
            asq = np.ascontiguousarray(asq, dtype=np.uint8)
            if ss is not None:
                ss = np.ascontiguousarray(ss, dtype=np.uint8)
            clean.append((nsq, asq, ss))
        return self.ctx.dp_cigars(clean, self.io)

    def dp(self, nsq, asq, flag, ss=None, io=None):
        nsq = np.ascontiguousarray(nsq, dtype=np.uint8)
        asq = np.ascontiguousarray(asq, dtype=np.uint8)
        if ss is not None:
            ss = np.ascontiguousarray(ss, dtype=np.uint8)
        return self.ctx.dp(nsq, asq, flag, self.io if io is None else io, ss)


def push_cigar(cig: list[int], op: int, length: int) -> None:
    """RLE cigar append; F/G never merge (ns_push_cigar, nasw.h:141-151)."""
    if not cig or op != (cig[-1] & 0xF) or op == C_F or op == C_G:
        cig.append(length << 4 | op)
    else:
        cig[-1] += length << 4



def extra_stop(r: Region, nt: np.ndarray, as_: int, ae: int) -> int:
    """bp to the next in-frame stop codon downstream (align.c:214-224)."""
    T = tables.get_tables()
    j = r.ve
    while j + 2 < ae:
        i = j - as_
        n0, n1, n2 = int(nt[i]), int(nt[i + 1]), int(nt[i + 2])
        aa = tables.AA_X if (n0 > 3 or n1 > 3 or n2 > 3) else int(T.codon[n0 << 4 | n1 << 2 | n2])
        if aa == 20:
            return j - r.ve
        j += 3
    return -1


def extra_start(r: Region, nt: np.ndarray, as_: int, ae: int) -> int:
    """bp to the closest upstream in-frame 'M' before a stop (align.c:226-237)."""
    T = tables.get_tables()
    j = r.vs
    while j >= as_ and j + 2 < ae:
        i = j - as_
        n0, n1, n2 = int(nt[i]), int(nt[i + 1]), int(nt[i + 2])
        aa = tables.AA_X if (n0 > 3 or n1 > 3 or n2 > 3) else int(T.codon[n0 << 4 | n1 << 2 | n2])
        if aa == 20:
            break
        if aa == 12:  # Met
            return r.vs - j
        j -= 3
    return -1


def extra_cal(r: Region, opt: MapOpt, nt: np.ndarray, l_nt: int,
              aa: np.ndarray, qlen: int, has_spsc: bool) -> None:
    """Per-CIGAR-op statistics + per-exon features (mp_extra_cal,
    align.c:82-201).  nt is the window starting at r.vs; aa starts at r.qs."""
    T = tables.get_tables()
    e = r.p
    mat = opt.mat
    has_stop = (r.qe == qlen and e.dist_stop == 0)
    n_intron = sum(1 for c in e.cigar if (int(c) & 0xF) in (C_N, C_U, C_V))
    r.n_exon = n_intron + 1
    feats: list[Feat] = []

    e.blen = e.n_iden = e.n_plus = e.n_fs = e.n_stop = e.dp_max = 0
    blen0 = n_iden0 = score0 = n_fs0 = n_stop0 = 0
    phase0 = 0
    vs0, qs0 = r.vs, r.qs
    acceptor0 = ""
    nl = al = 0
    # the per-codon inner loops run in C; this pass only accumulates and
    # builds the per-exon features
    stats = native.extra_stats(nt, aa, e.cigar, mat=mat, asize=opt.asize,
                               codon=T.codon, aa20=T.aa20, go=opt.go,
                               ge=opt.ge, fs=opt.fs)
    for k, c in enumerate(e.cigar):
        op, ln = int(c) & 0xF, int(c) >> 4
        ln3 = ln * 3
        e.n_stop += int(stats[k, 0])
        e.n_iden += int(stats[k, 1])
        e.n_plus += int(stats[k, 2])
        e.dp_max += int(stats[k, 3])
        if op == C_M:
            nl += ln3
            al += ln
            e.blen += ln3
        elif op == C_I:
            al += ln
            e.blen += ln3
        elif op == C_D:
            nl += ln3
            e.blen += ln3
        elif op == C_F:
            nl += ln
            e.blen += ln
            e.n_fs += 1
        elif op == C_G:
            nl += ln
            al += 1
            e.blen += 3
            e.n_fs += 1
        elif op in (C_N, C_U, C_V):
            if op in (C_U, C_V):  # split codon scored by extra_stats
                e.blen += 3
            f = Feat(type=0, vs=vs0, qs=qs0, qe=r.qs + al, phase=phase0)
            f.blen = e.blen - blen0
            f.n_iden = e.n_iden - n_iden0
            f.n_fs = e.n_fs - n_fs0
            f.n_stop = e.n_stop - n_stop0
            f.score = e.dp_max - score0
            if feats:
                f.acceptor = acceptor0
            if op == C_N:
                f.ve = r.vs + nl
                vs0, phase0 = r.vs + nl + ln, 0
            elif op == C_U:
                f.ve = r.vs + nl + 1
                vs0, phase0 = r.vs + nl + ln - 2, 2
            else:
                f.ve = r.vs + nl + 2
                vs0, phase0 = r.vs + nl + ln - 1, 1
            d0 = tables.NT_I2C[nt[f.ve - r.vs]] if f.ve - r.vs < l_nt else "."
            d1 = tables.NT_I2C[nt[f.ve - r.vs + 1]] if f.ve - r.vs + 1 < l_nt else "."
            f.donor = d0 + d1
            qs0 = f.qe
            n_fs0, n_stop0, score0 = e.n_fs, e.n_stop, e.dp_max
            blen0, n_iden0 = e.blen, e.n_iden
            a0 = tables.NT_I2C[nt[vs0 - r.vs - 2]] if vs0 - r.vs >= 2 else "."
            a1 = tables.NT_I2C[nt[vs0 - r.vs - 1]] if vs0 - r.vs >= 1 else "."
            acceptor0 = a0 + a1
            feats.append(f)
            nl += ln
            al += op != C_N
    f = Feat(type=0, vs=vs0, ve=r.vs + nl, qs=qs0, qe=r.qs + al, phase=phase0)
    f.blen = e.blen - blen0
    f.n_iden = e.n_iden - n_iden0
    f.n_fs = e.n_fs - n_fs0
    f.n_stop = e.n_stop - n_stop0
    f.score = e.dp_max - score0
    if feats:
        f.acceptor = acceptor0
    feats.append(f)
    if has_stop:
        ve_mRNA = r.ve + 3
        feats.append(Feat(type=1, vs=ve_mRNA - 3, ve=ve_mRNA, qs=r.qe + al,
                          qe=r.qe + al, phase=0, n_fs=0, blen=3, n_iden=0))
    r.feat = feats
    if nl != r.ve - r.vs or al != r.qe - r.qs:
        # only possible with --spsc tiny-UV edge cases (align.c:194-199)
        r.p = None
        r.feat = None


def _region_window(opt: MapOpt, mi, qlen: int, aa: np.ndarray, r: Region,
                   extl0: int, extr0: int, dbg_more_dp: bool):
    """Shared alignment-round prefix (align.c:241-275): anchor filter,
    extension caps, genome window + spsc track fetch.  Returns
    (i0, as_, ae, nt, ss), or None when no tight anchor block survives
    (the region dies).  Mutates r.a (bit-31 marks)."""
    assert r.cnt > 0
    i0 = 0
    if not dbg_more_dp:
        native.filter_seed(r.a, 6, 3, opt.kmer2, opt.kmer2 + 1)
        marked = (r.a >> np.uint64(31)) & np.uint64(1)
        nz = np.flatnonzero(marked)
        if len(nz) == 0:
            r.a = np.empty(0, np.uint64)
            return None
        i0 = int(nz[0])

    extl = extr = opt.max_ext
    if r.qs >= 10:
        extl = opt.max_intron // 2
    if qlen - r.qe >= 10:
        extr = opt.max_intron // 2
    if extl0 > 0:
        extl = min(extl, extl0)
    if extr0 > 0:
        extr = min(extr, extr0)
    ctg_len = mi.nt.ctg[r.vid >> 1].len
    as_ = r.vs - extl if r.vs > extl else 0
    ae = min(r.ve + extr, ctg_len)
    nt = mi.nt.get_by_v(r.vid, as_, ae)
    assert len(nt) == ae - as_
    ss = mi.nt.spsc_get_by_v(r.vid, as_, ae) if mi.nt.spsc is not None else None
    return i0, as_, ae, nt, ss


def _region_finish(opt: MapOpt, mi, qlen: int, aa: np.ndarray, r: Region,
                   score: int, cigar: np.ndarray, nt: np.ndarray,
                   as_: int, ae: int) -> None:
    """Shared alignment-round suffix: attach the Extra record, the
    start/stop-codon distances and the per-CIGAR-op stats/features
    (align.c:336-339)."""
    r.p = Extra(dp_score=score, cigar=cigar)
    r.p.dist_stop = extra_stop(r, nt, as_, ae)
    r.p.dist_start = extra_start(r, nt, as_, ae)
    extra_cal(r, opt, nt[r.vs - as_:], len(nt) - (r.vs - as_), aa[r.qs:],
              qlen, mi.nt.spsc is not None)


def align_region_steps(env: DpEnv, opt: MapOpt, mi, qlen: int, aa: np.ndarray,
                       r: Region, extl0: int, extr0: int,
                       dbg_more_dp: bool = False):
    """Per-region alignment as a generator (mp_align, align.c:239-342).

    Yields LISTS of DP requests — ("ext", nsq, asq, ss, io, ext_left)
    expecting (score, nt_len, aa_len) back, or ("cigars", jobs)
    expecting [(score, cigar), ...] — and receives the matching list of
    results at each send.  The rounds are arranged to minimize device
    round trips: round 1 issues the left AND right extensions together
    (the right extension's rectangle depends only on the anchor walk,
    not on the left result), round 2 only the io_end retries when
    needed, round 3 one merged CIGAR batch covering the left-clip
    rectangle, every anchor gap and the right-tail rectangle.
    """
    setup = _region_window(opt, mi, qlen, aa, r, extl0, extr0, dbg_more_dp)
    if setup is None:
        return
    i0, as_, ae, nt, ss = setup
    l_nt = len(nt)
    vs0 = r.vs
    cig: list[int] = []
    score = 0

    # anchor walk first: the right extension's rectangle depends only on
    # the last marked anchor, so both extensions issue in one round
    vs1 = vs0 + int(r.a[i0] >> np.uint64(32)) + 1
    as1 = int(r.a[i0] & np.uint64(0x7FFFFFFF)) + 1
    if dbg_more_dp:
        ne1s = ae1s = None
        r_ve, r_qe = r.ve, r.qe
    else:
        av = r.a[i0:r.cnt]
        mk = np.flatnonzero((av >> np.uint64(31)) & np.uint64(1))
        sel = av[mk]          # i0 itself is marked, so mk is non-empty
        ne1s = ((sel >> np.uint64(32)).astype(np.int64) + 1).tolist()
        ae1s = ((sel & np.uint64(0x7FFFFFFF)).astype(np.int64) + 1).tolist()
        r_ve = ne1s[-1] + vs0
        r_qe = ae1s[-1]

    # round 1: left (align.c:280-301) + right (align.c:316-327) extensions
    reqs = [("ext", nt[: vs1 - as_], aa[:as1],
             None if ss is None else ss[: vs1 - as_], env.io, True)]
    do_right = r_qe < qlen and r_ve < ae
    if do_right:
        reqs.append(("ext", nt[r_ve - as_:], aa[r_qe:],
                     None if ss is None else ss[r_ve - as_:], env.io, False))
    res1 = yield reqs
    _, nt_len, aa_len = res1[0]
    r_ntl = r_aal = 0
    if do_right:
        _, r_ntl, r_aal = res1[1]

    # round 2 (only when needed): io_end retries for terminal exons
    retry = []
    need_l = aa_len != as1 and nt_len < opt.max_ext and env.io > env.io_end
    if need_l:
        as_alt = vs1 - opt.max_ext if vs1 - as_ > opt.max_ext else as_
        retry.append(("ext", nt[as_alt - as_: vs1 - as_], aa[:as1],
                      None if ss is None else ss[as_alt - as_: vs1 - as_],
                      env.io_end, True))
    need_r = (do_right and r_aal < qlen - r_qe and r_ntl < opt.max_ext
              and env.io > env.io_end)
    if need_r:
        l_ext = min(ae - r_ve, opt.max_ext)
        retry.append(("ext", nt[r_ve - as_: r_ve - as_ + l_ext], aa[r_qe:],
                      None if ss is None else ss[r_ve - as_: r_ve - as_ + l_ext],
                      env.io_end, False))
    if retry:
        res2 = yield retry
        k = 0
        if need_l:
            _, ntl2, aal2 = res2[k]
            k += 1
            if aal2 == as1:
                nt_len, aa_len = ntl2, aal2
        if need_r:
            _, ntl2, aal2 = res2[k]
            if aal2 == qlen - r_qe:
                r_ntl, r_aal = ntl2, aal2

    r.vs = vs1 - nt_len
    r.qs = as1 - aa_len
    ne0 = r.vs - vs0
    ae0 = r.qs

    # plan the gap-patching DPs (align.c:303-314); trivial exact-size gaps
    # use the ungapped shortcut, the rest are batched as one request
    plan = []
    jobs = []
    triv = []  # (nt_off, aa_off, alen) batched into one native rescore call

    def _plan_gap(nt_s, nt_e, aa_s, aa_e):
        alen = aa_e - aa_s
        if nt_e - nt_s == alen * 3 and alen <= opt.kmer2:
            plan.append(("t", alen, len(triv)))
            triv.append((nt_s, aa_s, alen))
        else:
            plan.append(("d", len(jobs)))
            jobs.append((nt[nt_s:nt_e], aa[aa_s:aa_e],
                         None if ss is None else ss[nt_s:nt_e]))

    if dbg_more_dp:  # debug: one DP over the whole region (align.c:303-305)
        _plan_gap(r.vs - as_, r.ve - as_, ae0, r.qe)
    else:  # patch gaps between marked anchors (align.c:306-314)
        base = vs0 - as_
        # inlined _plan_gap: this loop runs once per marked anchor
        # (~250/query), the call overhead was measurable
        k2 = opt.kmer2
        plan_ap, triv_ap, jobs_ap = plan.append, triv.append, jobs.append
        nt_s = ne0 + base
        for ne1, ae1 in zip(ne1s, ae1s):
            nt_e = ne1 + base
            alen = ae1 - ae0
            if nt_e - nt_s == alen * 3 and alen <= k2:
                plan_ap(("t", alen, len(triv)))
                triv_ap((nt_s, ae0, alen))
            else:
                plan_ap(("d", len(jobs)))
                jobs_ap((nt[nt_s:nt_e], aa[ae0:ae1],
                         None if ss is None else ss[nt_s:nt_e]))
            ne0, ae0, nt_s = ne1, ae1, nt_e
        r.ve = ne0 + vs0
        r.qe = ae0

    # right-tail CIGAR rectangle (align.c:328-333) joins the same batch
    tail_idx = -1
    tail_triv = None
    if do_right:
        nseq = nt[r_ve - as_: r_ve - as_ + r_ntl]
        aseq = aa[r_qe: r_qe + r_aal]
        if len(nseq) == len(aseq) * 3 and len(aseq) <= opt.kmer2:
            tail_triv = (nseq, aseq)
        else:
            tail_idx = len(jobs)
            jobs.append((nseq, aseq,
                         None if ss is None else ss[r_ve - as_: r_ve - as_ + r_ntl]))

    # round 3: one merged CIGAR batch for left clip + gaps + right tail
    results = (yield [("cigars", jobs)])[0] if jobs else []
    tscores = env.ctx.score_ungapped_many(nt, aa, triv) if triv else None
    for step in plan:
        if step[0] == "t":
            push_cigar(cig, C_M, step[1])
            score += int(tscores[step[2]])
        else:
            sc, c = results[step[1]]
            score += sc
            for op in c:
                push_cigar(cig, int(op) & 0xF, int(op) >> 4)

    if do_right:
        if tail_triv is not None:
            nseq, aseq = tail_triv
            push_cigar(cig, C_M, len(aseq))
            score += env.ctx.score_ungapped(np.ascontiguousarray(nseq, dtype=np.uint8),
                                            np.ascontiguousarray(aseq, dtype=np.uint8))
        else:
            sc, c = results[tail_idx]
            score += sc
            for op in c:
                push_cigar(cig, int(op) & 0xF, int(op) >> 4)
        r.ve = r_ve + r_ntl
        r.qe = r_qe + r_aal

    _region_finish(opt, mi, qlen, aa, r, score,
                   np.array(cig, dtype=np.uint32), nt, as_, ae)


def run_steps_host(gen, env: DpEnv) -> None:
    """Drive an align_region_steps generator with the host-C DP."""
    try:
        reqs = next(gen)
        while True:
            outs = []
            for req in reqs:
                if req[0] == "ext":
                    _, nsq, asq, ss, io, ext_left = req
                    sc, ntl, aal, _ = env.dp(
                        nsq, asq, DPF_EXT_LEFT if ext_left else DPF_EXT_RIGHT,
                        ss=ss, io=io)
                    outs.append((sc, ntl, aal))
                else:  # "cigars": batch 4 similar problems per AVX-512 call
                    outs.append(env.dp_cigars(req[1]))
            reqs = gen.send(outs)
    except StopIteration:
        pass


def align_region(env: DpEnv, opt: MapOpt, mi, qlen: int, aa: np.ndarray,
                 r: Region, extl0: int, extr0: int, dbg_more_dp: bool = False) -> None:
    """Full per-region alignment on the host engine.

    Runs the whole DP-step plan in one native call (mx_align_region):
    extensions + io_end retries + gap/tail CIGAR DPs + cigar assembly.
    Identical results to driving align_region_steps with run_steps_host
    (the device path's generator)."""
    setup = _region_window(opt, mi, qlen, aa, r, extl0, extr0, dbg_more_dp)
    if setup is None:
        return
    i0, as_, ae, nt, ss = setup
    res = native.align_region(
        env.ctx, nt, ss, aa, qlen, r.a[i0:r.cnt], r.vs, as_, ae,
        r.ve, r.qe, dbg_more_dp, env.io, env.io_end,
        opt.kmer2, opt.max_ext)
    score, r.vs, r.qs, r.ve, r.qe, cigar, _cells, _ndp = res
    _region_finish(opt, mi, qlen, aa, r, score, cigar, nt, as_, ae)
