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


def refine_region(mi: Index, opt: MapOpt, aa: np.ndarray, r: Region,
                  extl: int, extr: int) -> None:
    """Second-round re-seeding at base resolution (mp_refine_reg,
    map.c:32-111), executed in one native call (mx_refine_region).
    Clears r.a if no chain survives."""
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



def seed_anchors(mi: Index, seq: np.ndarray, opt: MapOpt) -> np.ndarray:
    """Sketch one protein and gather its seed anchors
    blockId<<32|qpos from the local bucket table (map.c:155-177),
    unsorted, in one native call (mx_seed_anchors)."""
    from . import tables
    io = mi.opt
    return native.seed_anchors_c(
        np.ascontiguousarray(seq), tables.get_tables(1).aa13, io.kmer,
        io.mod_bit, mi.ki, mi.kb, opt.max_occ)



# scratch slots of the native engine above this size are released after
# each query
SCRATCH_TRIM_BYTES = 64 << 20


def trim_scratch() -> None:
    """Release the calling thread's native scratch slots above
    SCRATCH_TRIM_BYTES (each thread has its own; an exiting thread's
    are freed)."""
    native._lib.mx_scratch_trim(SCRATCH_TRIM_BYTES)


def map_query(mi: Index, seq: bytes | np.ndarray, opt: MapOpt,
              env: DpEnv | None = None) -> list[Region]:
    """Map one protein against the index (mp_map, map.c:143-240)."""
    if not isinstance(seq, np.ndarray):
        seq = np.frombuffer(seq, dtype=np.uint8)
    qlen = len(seq)
    is_splice = not (opt.flag & F_NO_SPLICE)
    io = mi.opt
    if env is None:
        env = DpEnv(opt)

    a = seed_anchors(mi, seq, opt)
    native.sort_u64(a)

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

    # refinement round (map.c:205-222)
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
            align_region(env, opt, mi, qlen, seq, r, el, er)
        regs = finish_align(mi, opt, regs)
    # don't let one pathological DP pin its traceback scratch forever
    trim_scratch()
    return regs



def finish_align(mi: Index, opt: MapOpt, regs: list[Region]) -> list[Region]:
    """Post-alignment ranking and selection (map.c:229-236)."""
    kept = [r for r in regs if r.p is not None]
    kept = sort_reg(kept)
    select_multi_exon(kept, opt.io)
    set_parent(opt.mask_level, opt.mask_len, kept, mi.opt.kmer, 0)
    return select_sub(opt.pri_ratio, mi.opt.kmer * 2, opt.best_n, kept)
