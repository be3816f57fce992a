"""Per-query mapping driver: seed -> chain -> refine -> align.

Python port of the mapping engine (map.c:32-240): protein modimer
lookup against the bucket index with a dynamic per-query occurrence cap,
two-level chaining (block resolution, then per-region re-seeding with
all 5-mers at base resolution), and the final anchored DP round.
"""

from __future__ import annotations

import numpy as np

from . import native
from .align import DpEnv, align_region
from .hits import (Region, cal_max_ext, reg_gen_from_block, select_multi_exon,
                   select_sub, set_parent, sort_reg)
from .index import Index
from .options import F_NO_ALIGN, F_NO_PRE_CHAIN, F_NO_SPLICE, MapOpt
from .sketch import sketch_nt4, sketch_prot


def _dbg_chain(mi: Index, regs, bbit: int, label: str) -> None:
    """Dump chain anchors (mp_dbg_chain, map.c:113-124)."""
    import sys as _sys
    for i, r in enumerate(regs):
        for ak in r.a:
            if bbit > 0:
                off = (int(ak >> np.uint64(32)) - int(mi.bo[r.vid])) << bbit
            else:
                off = r.vs + int(ak >> np.uint64(32))
            _sys.stderr.write(
                f"{label}\t{i}\t{int(ak >> np.uint64(32))}\t"
                f"{mi.nt.ctg[r.vid >> 1].name}\t{'+-'[r.vid & 1]}\t{off}\t"
                f"{int(ak & np.uint64(0xFFFFFFFF))}\n")


def _dbg_anchor(mi: Index, a: np.ndarray) -> None:
    """Dump raw seed anchors (map.c:179-184)."""
    import sys as _sys
    for ak in a:
        blk = int(ak >> np.uint64(32))
        i = mi.block2pos(blk)
        off = (blk - int(mi.bo[i])) << mi.opt.bbit
        _sys.stderr.write(f"X\t{blk}\t{mi.nt.ctg[i >> 1].name}\t"
                          f"{'+-'[i & 1]}\t{off}\t{int(ak & np.uint64(0xFFFFFFFF))}\n")


def cal_max_occ(mi: Index, sd: np.ndarray) -> int:
    """Boxplot outlier cap on k-mer occurrences (mp_cal_max_occ,
    map.c:126-141)."""
    n = len(sd)
    cnt = mi.bucket_counts(sd >> np.uint64(32)).astype(np.uint64)
    native.sort_u64(cnt)
    q25 = int(cnt[int(n * 0.25 + 0.499)])
    q75 = int(cnt[int(n * 0.75 + 0.499)])
    return int(q75 + (q75 - q25) * 1.5 + 10.0)


def refine_region(mi: Index, opt: MapOpt, aa: np.ndarray, r: Region,
                  extl: int, extr: int) -> None:
    """Second-round re-seeding at base resolution (mp_refine_reg,
    map.c:32-111), executed in one native call (mx_refine_region).
    Clears r.a if no chain survives.  refine_region_py is the Python
    plan this replaced — kept as the parity oracle."""
    from . import tables
    kmer = opt.kmer2
    ctg_len = mi.nt.ctg[r.vid >> 1].len
    as_ = r.vs - extl if r.vs > extl else 0
    ae = min(r.ve + extr, ctg_len)
    nt = mi.nt.get_by_v(r.vid, as_, ae)
    T = tables.get_tables(mi.opt.trans_code)
    res = native.refine_region_c(
        nt, aa, codon=T.codon, codon13=T.codon13,
        aa13=tables.get_tables(1).aa13,  # reduced alphabet is code-independent
        kmer=kmer, min_aa_len=mi.opt.min_aa_len, max_ava=opt.max_ava,
        max_dist_x=opt.max_intron, max_dist_y=opt.max_gap, bw=opt.bw,
        max_skip=opt.max_chn_max_skip, max_iter=opt.max_chn_iter,
        min_cnt=opt.min_chn_cnt, min_sc=opt.min_chn_sc,
        chn_coef_log=opt.chn_coef_log,
        is_spliced=not (opt.flag & F_NO_SPLICE))
    if res is None:
        r.a = np.empty(0, np.uint64)
        return
    r.a, r.chn_sc, r.qs, r.qe, vs_rel, ve_rel, r.chn_sc_ungap = res
    r.vs = as_ + vs_rel
    r.ve = as_ + ve_rel


def refine_region_py(mi: Index, opt: MapOpt, aa: np.ndarray, r: Region,
                     extl: int, extr: int) -> None:
    """Python plan for the second-round refinement (parity oracle for
    mx_refine_region; same primitives, same order)."""
    kmer = opt.kmer2
    is_splice = not (opt.flag & F_NO_SPLICE)
    ctg_len = mi.nt.ctg[r.vid >> 1].len
    as_ = r.vs - extl if r.vs > extl else 0
    ae = min(r.ve + extr, ctg_len)
    nt = mi.nt.get_by_v(r.vid, as_, ae)
    sd_g = sketch_nt4(nt, mi.opt.min_aa_len, kmer, 0, 0, 0, mi.opt.trans_code)
    sd_a = sketch_prot(aa, kmer, 0) | (np.uint64(1) << np.uint64(31))
    sd = np.concatenate([sd_g, sd_a])
    native.sort_u64(sd)

    # per-hash cross product of genome x protein positions (map.c:53-79);
    # within one hash the genome entries sort before the bit31-flagged
    # protein entries, so groups split cleanly.  Runs in C; emission
    # order is irrelevant because the result is value-sorted next.
    if len(sd) == 0:
        r.a = np.empty(0, np.uint64)
        return
    a = native.refine_pairs(sd, opt.max_ava)
    if len(a) == 0:
        r.a = np.empty(0, np.uint64)
        return
    native.sort_u64(a)
    a, u = native.chain(a, max_dist_x=opt.max_intron, max_dist_y=opt.max_gap,
                        bw=opt.bw, max_skip=opt.max_chn_max_skip,
                        max_iter=opt.max_chn_iter, min_cnt=opt.min_chn_cnt,
                        min_sc=opt.min_chn_sc, chn_coef_log=opt.chn_coef_log,
                        is_spliced=is_splice, kmer=kmer, bbit=0)
    if len(u) == 0:
        r.a = np.empty(0, np.uint64)
        return
    # keep the best chain (first max; map.c:89-96)
    scores = (u >> np.uint64(32)).astype(np.int64)
    max_i = int(np.argmax(scores))  # argmax returns first maximum
    k = int(np.cumsum(u & np.uint64(0xFFFFFFFF))[max_i - 1]) if max_i > 0 else 0
    n_a = int(u[max_i] & np.uint64(0xFFFFFFFF))
    ra = a[k:k + n_a].copy()
    r.chn_sc = int(u[max_i] >> np.uint64(32))
    r.qs = int(ra[0] & np.uint64(0xFFFFFFFF)) - (kmer - 1)
    r.qe = int(ra[-1] & np.uint64(0xFFFFFFFF)) + 1
    r.vs = as_ + int(ra[0] >> np.uint64(32)) + 1 - 3 * kmer
    r.ve = as_ + int(ra[-1] >> np.uint64(32)) + 1
    # rebase anchors to region-local nt coordinates (map.c:107-108)
    nt_off = ((ra >> np.uint64(32)).astype(np.int64) + (as_ - r.vs)).astype(np.uint64)
    ra = (nt_off << np.uint64(32)) | (ra & np.uint64(0xFFFFFFFF))
    r.a = ra
    r.chn_sc_ungap = native.chn_sc_ungap(r.a, kmer)


def seed_anchors(mi: Index, seq: np.ndarray, opt: MapOpt) -> np.ndarray:
    """Sketch one protein and gather its seed anchors
    blockId<<32|qpos from the local bucket table (map.c:155-177),
    unsorted, in one native call (mx_seed_anchors).  The mesh path
    (parallel/dist.mesh_map_queries) replaces this with the
    index-sharded device gather; both produce the same anchor
    multiset.  seed_anchors_py is the Python plan this replaced —
    kept as the parity oracle."""
    from . import tables
    io = mi.opt
    return native.seed_anchors_c(
        np.ascontiguousarray(seq), tables.get_tables(1).aa13, io.kmer,
        io.mod_bit, mi.ki, mi.kb, opt.max_occ)


def seed_anchors_py(mi: Index, seq: np.ndarray, opt: MapOpt) -> np.ndarray:
    """Python plan for the seed gather (parity oracle for
    mx_seed_anchors; same primitives, same order)."""
    io = mi.opt
    sd = sketch_prot(seq, io.kmer, io.mod_bit)
    native.sort_u64(sd)
    if len(sd) >= 8:
        max_occ = min(cal_max_occ(mi, sd), opt.max_occ)
    else:
        max_occ = opt.max_occ

    # bucket lookups -> anchors blockId<<32|qpos (map.c:163-177), ragged
    # gather vectorized over all of the query's seeds at once
    if not len(sd):
        return np.empty(0, np.uint64)
    h = (sd >> np.uint64(32)).astype(np.int64)
    ki_ext = mi.ki
    st = ki_ext[h]
    en = np.where(h + 1 < len(ki_ext), ki_ext[np.minimum(h + 1, len(ki_ext) - 1)],
                  mi.n_kb)
    n = en - st
    keep = n <= max_occ
    stk, nk = st[keep], n[keep]
    total = int(nk.sum())
    cum = np.zeros(len(nk), np.int64)
    np.cumsum(nk[:-1], out=cum[1:])
    base = np.repeat(stk - cum, nk)
    indices = base + np.arange(total)
    qpos = np.repeat(sd[keep] & np.uint64(0xFFFFFFFF), nk)
    return (mi.kb[indices].astype(np.uint64) << np.uint64(32)) | qpos


# scratch slots of the native engine above this size are released after
# each query
SCRATCH_TRIM_BYTES = 64 << 20


def trim_scratch() -> None:
    """Release the calling thread's native scratch slots above
    SCRATCH_TRIM_BYTES (each thread has its own; an exiting thread's
    are freed)."""
    native._lib.mx_scratch_trim(SCRATCH_TRIM_BYTES)


def map_query(mi: Index, seq: bytes | np.ndarray, opt: MapOpt,
              env: DpEnv | None = None, dbg: dict | None = None,
              anchors: np.ndarray | None = None) -> list[Region]:
    """Map one protein against the index (mp_map, map.c:143-240).

    anchors: pre-gathered seed anchors (the mesh path's device gather);
    default is the local seed_anchors() lookup."""
    if not isinstance(seq, np.ndarray):
        seq = np.frombuffer(seq, dtype=np.uint8)
    qlen = len(seq)
    is_splice = not (opt.flag & F_NO_SPLICE)
    io = mi.opt
    if env is None:
        env = DpEnv(opt)
    dbg = dbg or {}

    a = seed_anchors(mi, seq, opt) if anchors is None else anchors
    native.sort_u64(a)
    if dbg.get("anchor"):
        _dbg_anchor(mi, a)

    # pre-chain at block bandwidth (map.c:186-192)
    if not (opt.flag & F_NO_PRE_CHAIN) and is_splice:
        w = 1 << io.bbit
        a, u = native.chain(a, max_dist_x=w, max_dist_y=w, bw=w,
                            max_skip=opt.max_chn_max_skip, max_iter=opt.max_chn_iter,
                            min_cnt=2, min_sc=0, chn_coef_log=opt.chn_coef_log,
                            is_spliced=is_splice, kmer=io.kmer, bbit=io.bbit)
        native.sort_u64(a)

    # main chain (map.c:194-200)
    a, u = native.chain(a, max_dist_x=opt.max_intron, max_dist_y=opt.max_gap,
                        bw=opt.bw, max_skip=opt.max_chn_max_skip,
                        max_iter=opt.max_chn_iter, min_cnt=opt.min_chn_cnt,
                        min_sc=opt.min_chn_sc, chn_coef_log=opt.chn_coef_log,
                        is_spliced=is_splice, kmer=io.kmer, bbit=io.bbit)
    regs = reg_gen_from_block(mi, u, a)
    regs = sort_reg(regs)
    set_parent(opt.mask_level, opt.mask_len, regs, io.kmer, 0)
    regs = select_sub(float(np.float32(np.float32(opt.pri_ratio)
                                      * np.float32(opt.pri_ratio))),
                      io.kmer * 2, opt.best_n, regs)
    if dbg.get("chain"):  # the reference dumps after selection (map.c:203)
        _dbg_chain(mi, regs, io.bbit, "Y1")

    # refinement round (map.c:205-222)
    if not dbg.get("no_refine"):
        ext = cal_max_ext(None, regs, 100, opt.max_ext)
        kept = []
        for r, (el, er) in zip(regs, ext):
            refine_region(mi, opt, seq, r, el, er)
            if r.cnt > 0:
                kept.append(r)
        regs = sort_reg(kept)
        set_parent(opt.mask_level, opt.mask_len, regs, io.kmer, 0)
        regs = select_sub(float(np.float32(np.float32(opt.pri_ratio)
                                      * np.float32(opt.pri_ratio))),
                      io.kmer * 2, opt.best_n, regs)

    # alignment round (map.c:223-237)
    if not (opt.flag & F_NO_ALIGN):
        ext = cal_max_ext(mi.nt, regs, 100, opt.max_intron // 2)
        for r, (el, er) in zip(regs, ext):
            align_region(env, opt, mi, qlen, seq, r, el, er,
                         dbg_more_dp=bool(dbg.get("more_dp")))
        regs = finish_align(mi, opt, regs)
    # don't let one pathological DP pin its traceback scratch forever
    trim_scratch()
    return regs


def pre_align(mi: Index, seq: np.ndarray, opt: MapOpt,
              dbg: dict | None = None, anchors: np.ndarray | None = None):
    """Seed + chain + refine rounds; returns (regs, per-region ext caps)
    ready for the alignment round (map.c:143-226).

    anchors: pre-gathered seed anchors (the mesh path's device gather)."""
    saved = opt.flag
    opt.flag |= F_NO_ALIGN
    try:
        regs = map_query(mi, seq, opt, dbg=dbg, anchors=anchors)
    finally:
        opt.flag = saved
    ext = cal_max_ext(mi.nt, regs, 100, opt.max_intron // 2)
    return regs, ext


def finish_align(mi: Index, opt: MapOpt, regs: list[Region]) -> list[Region]:
    """Post-alignment ranking and selection (map.c:229-236)."""
    kept = [r for r in regs if r.p is not None]
    kept = sort_reg(kept)
    select_multi_exon(kept, opt.io)
    set_parent(opt.mask_level, opt.mask_len, kept, mi.opt.kmer, 0)
    return select_sub(opt.pri_ratio, mi.opt.kmer * 2, opt.best_n, kept)
