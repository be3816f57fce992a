"""ctypes bindings for the reference's native host runtime (mpnative.c):
only what the reference's map (``run.map_gff``) and index build
(``index.Index.build``) reach.

  sort_u64, sort_pair       - radix sorts matching ksort.h semantics
  chain                     - anchor chaining (chain.c semantics)
  chn_sc_ungap_approx_batch - ungapped chain rescoring (hit.c:6-30)
  Dp16Ctx, align_region     - the splice/frameshift DP (nasw-sse.c) and
                              a region's whole alignment
"""

from __future__ import annotations

import ctypes as ct

import numpy as np

from .build import ensure_built

_lib = ct.CDLL(ensure_built())

_u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")

_lib.mx_sort_u64_lsd.restype = ct.c_int64
_lib.mx_sort_u64_lsd.argtypes = [_u64p, ct.c_int64]
_sort_u64_raw = ct.CFUNCTYPE(ct.c_int64, ct.c_void_p, ct.c_int64)(
    ct.cast(_lib.mx_sort_u64_lsd, ct.c_void_p).value)
_lib.mx_sort_pair.argtypes = [_u64p, ct.c_int64]
_lib.mx_chain.restype = ct.c_int64
_lib.mx_chain.argtypes = [ct.c_int32] * 7 + [ct.c_float] + [ct.c_int32] * 3 + \
    [ct.c_int64, _u64p, _u64p, _u64p, ct.POINTER(ct.c_int64)]
# prebound raw-pointer entry points for the per-call hot path (skips
# ndpointer from_param marshalling; ~10us/call at mapping call rates)
_chain_raw = ct.CFUNCTYPE(
    ct.c_int64, *([ct.c_int32] * 7), ct.c_float, *([ct.c_int32] * 3),
    ct.c_int64, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p)(
        ct.cast(_lib.mx_chain, ct.c_void_p).value)
_chn_sc_ungap_batch_raw = ct.CFUNCTYPE(
    None, ct.c_int64, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int32,
    ct.c_void_p)(
        ct.cast(_lib.mx_chn_sc_ungap_approx_batch, ct.c_void_p).value)
_set_parent_raw = ct.CFUNCTYPE(
    None, ct.c_int64, ct.c_float, ct.c_int32, ct.c_int32, ct.c_int32,
    *([ct.c_void_p] * 15))(
        ct.cast(_lib.mx_set_parent, ct.c_void_p).value)
_select_sub_raw = ct.CFUNCTYPE(
    None, ct.c_int64, ct.c_float, ct.c_int32, ct.c_int32,
    *([ct.c_void_p] * 11))(
        ct.cast(_lib.mx_select_sub, ct.c_void_p).value)
_lib.mx_dp16.argtypes = [
    _u8p, ct.c_int32, _u8p, ct.c_int32,            # nsq, nl, asq, al
    ct.c_void_p,                                    # ss (may be None)
    _i8p, ct.c_int32,                               # mat, asize
    _u8p, _u8p, _u8p,                               # nt4, aa20, codon
    _i32p, ct.c_int32,                              # sp[6], sp_null_bonus
    ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,  # flag, go, ge, io, fs
    ct.c_int32, ct.c_int32, ct.c_float,             # xdrop, end_bonus, ie_coef
    ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
    _u32p, ct.POINTER(ct.c_int32),
]

DPF_CIGAR, DPF_EXT_LEFT, DPF_EXT_RIGHT = 0x1, 0x2, 0x4


def sort_u64(a: np.ndarray) -> np.ndarray:
    """In-place sort of a SCALAR uint64 array.

    Scalar u64 output is fully determined by the multiset (equal keys
    are indistinguishable), so any sort matches the reference's
    radix_sort_mp64 byte-for-byte; this uses the faster LSD radix with
    constant-byte pass skipping.  Only the 128-bit pair sort
    (sort_pair) must replicate the reference permutation."""
    assert a.dtype == np.uint64 and a.flags.c_contiguous
    if len(a) > 1:
        if _sort_u64_raw(a.ctypes.data, len(a)) < 0:
            raise MemoryError("mx_sort_u64_lsd")
    return a


def sort_pair(xy: np.ndarray) -> np.ndarray:
    """In-place sort of an (n, 2) uint64 array by column 0, reproducing the
    unstable permutation of the reference radix sort (radix_sort_mp128x)."""
    assert xy.dtype == np.uint64 and xy.ndim == 2 and xy.shape[1] == 2 and xy.flags.c_contiguous
    if len(xy) > 1:
        _lib.mx_sort_pair(xy.reshape(-1), len(xy))
    return xy


def chain(a: np.ndarray, *, max_dist_x: int, max_dist_y: int, bw: int,
          max_skip: int, max_iter: int, min_cnt: int, min_sc: int,
          chn_coef_log: float, is_spliced: bool, kmer: int, bbit: int):
    """Chain sorted anchors a (u64 = pos<<32|qpos).

    Returns (anchors, u) where anchors holds the selected chains'
    anchors concatenated in chain order and u[i] = score<<32|count.
    Mirrors mp_chain (chain.c:160-219).
    """
    a = np.ascontiguousarray(a, dtype=np.uint64)
    n = len(a)
    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    out_a = np.empty(n, np.uint64)
    out_u = np.empty(n, np.uint64)
    n_a_out = ct.c_int64(0)
    n_u = _chain_raw(max_dist_x, max_dist_y, bw, max_skip, max_iter,
                     min_cnt, min_sc, chn_coef_log, int(is_spliced),
                     kmer, bbit, n, a.ctypes.data, out_a.ctypes.data,
                     out_u.ctypes.data, ct.byref(n_a_out))
    return out_a[:n_a_out.value].copy(), out_u[:n_u].copy()


def chn_sc_ungap_approx_batch(ks: np.ndarray, cnts: np.ndarray,
                              a: np.ndarray, kmer: int) -> np.ndarray:
    """Score every chain of a block in one call (chain c covers
    a[ks[c] : ks[c]+cnts[c]]); one ctypes round trip instead of one per
    region."""
    ks = np.ascontiguousarray(ks, dtype=np.int64)
    cnts = np.ascontiguousarray(cnts, dtype=np.int64)
    a = np.ascontiguousarray(a, dtype=np.uint64)
    out = np.empty(len(ks), np.int32)
    _chn_sc_ungap_batch_raw(len(ks), ks.ctypes.data, cnts.ctypes.data,
                            a.ctypes.data, kmer, out.ctypes.data)
    return out


def select_sub_c(pri_ratio: float, min_diff: int, best_n: int,
                 qs, qe, vid, vs, ve, parent, has_p, p_dp_max, chn_sc,
                 chn_sc_ungap) -> np.ndarray:
    """mp_select_sub (hit.c:212-236) keep-flags over flattened region
    fields."""
    n = len(qs)
    keep = np.zeros(n, np.uint8)
    _select_sub_raw(n, pri_ratio, min_diff, best_n,
                    qs.ctypes.data, qe.ctypes.data, vid.ctypes.data,
                    vs.ctypes.data, ve.ctypes.data, parent.ctypes.data,
                    has_p.ctypes.data, p_dp_max.ctypes.data,
                    chn_sc.ctypes.data, chn_sc_ungap.ctypes.data,
                    keep.ctypes.data)
    return keep


def set_parent_c(mask_level: float, mask_len: int, sub_diff: int,
                 hard_mask_level: int, qs, qe, vid, vs, ve, cnt, chn_sc,
                 has_p, p_dp_max, parent, n_sub, subsc, p_dp_max2) -> None:
    """mp_set_parent (hit.c:128-187) over flattened region fields; the
    parent/n_sub/subsc/p_dp_max2 arrays update in place."""
    n = len(qs)
    wbuf = np.empty(n, np.int64)
    covbuf = np.empty(n, np.uint64)
    _set_parent_raw(n, mask_level, mask_len, sub_diff, hard_mask_level,
                    qs.ctypes.data, qe.ctypes.data, vid.ctypes.data,
                    vs.ctypes.data, ve.ctypes.data, cnt.ctypes.data,
                    chn_sc.ctypes.data, has_p.ctypes.data,
                    p_dp_max.ctypes.data, parent.ctypes.data,
                    n_sub.ctypes.data, subsc.ctypes.data,
                    p_dp_max2.ctypes.data, wbuf.ctypes.data,
                    covbuf.ctypes.data)


_lib.mx_score_ungapped.restype = ct.c_int32
_lib.mx_score_ungapped.argtypes = [_u8p, _u8p, ct.c_int32, _i8p, ct.c_int32,
                                   _u8p, _u8p]


# raw-pointer prototypes (void* args take plain integer addresses, which
# skips numpy's per-call ndpointer from_param conversion entirely)
_dp16_raw = ct.CFUNCTYPE(
    None, ct.c_void_p, ct.c_int32, ct.c_void_p, ct.c_int32, ct.c_void_p,
    ct.c_void_p, ct.c_int32, ct.c_void_p, ct.c_void_p, ct.c_void_p,
    ct.c_void_p, ct.c_int32,
    ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,
    ct.c_int32, ct.c_int32, ct.c_float,
    ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
    ct.c_void_p, ct.POINTER(ct.c_int32))(
        ct.cast(_lib.mx_dp16, ct.c_void_p).value)
_dp16x4_raw = ct.CFUNCTYPE(
    None, ct.c_int32, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
    ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_void_p, ct.c_void_p,
    ct.c_void_p, ct.c_void_p, ct.c_int32,
    ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,
    ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p)(
        ct.cast(_lib.mx_dp16x4, ct.c_void_p).value)
_score_ungapped_raw = ct.CFUNCTYPE(
    ct.c_int32, ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_void_p,
    ct.c_int32, ct.c_void_p, ct.c_void_p)(
        ct.cast(_lib.mx_score_ungapped, ct.c_void_p).value)
_score_ungapped_many_raw = ct.CFUNCTYPE(
    None, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_void_p,
    ct.c_int32, ct.c_void_p, ct.c_void_p, ct.c_void_p)(
        ct.cast(_lib.mx_score_ungapped_many, ct.c_void_p).value)


_X4_PAYS: bool | None = None


def _x4_pays(ctx: "Dp16Ctx") -> bool:
    """One-shot probe: does the 4-problem AVX-512 CIGAR batch beat four
    8-lane calls on this machine?  Cached for the process lifetime.
    Override with MPX_X4=0/1."""
    global _X4_PAYS
    if _X4_PAYS is None:
        import os
        import time
        envv = os.environ.get("MPX_X4")
        if envv is not None:
            _X4_PAYS = envv != "0"
            return _X4_PAYS
        rng = np.random.default_rng(0)
        nsq = np.frombuffer(bytes(rng.choice(list(b"ACGT"), 420).astype(np.uint8)), np.uint8).copy()
        asq = np.frombuffer(bytes(rng.choice(list(b"ARNDCQEGHILKMFPSTWYV"), 140).astype(np.uint8)), np.uint8).copy()
        jobs = [(nsq, asq, None)] * 4
        best = [float("inf"), float("inf")]  # [batched, singles]
        for _ in range(3):
            t0 = time.perf_counter()
            _X4_PAYS = True
            ctx.dp_cigars(jobs, 29)
            best[0] = min(best[0], time.perf_counter() - t0)
            t0 = time.perf_counter()
            for a, b, s in jobs:
                ctx.dp(a, b, 0x1, 29, s)
            best[1] = min(best[1], time.perf_counter() - t0)
        _X4_PAYS = best[0] < best[1] * 0.85
    return _X4_PAYS


class Dp16Ctx:
    """Pre-bound mx_dp16 invocation context.

    Converts the per-batch constant tables (matrix, alphabet tables,
    splice model) to raw integer addresses once, so per-gap DP calls pay
    no ndarray->argtype conversion (mapping makes ~20 DP + ~250 rescore
    calls per query; the conversions were ~30% of host map time)."""

    def __init__(self, *, mat, nt4, aa20, codon, sp, sp_null_bonus, go, ge,
                 fs, xdrop, end_bonus, ie_coef, asize=22):
        # keep refs so the buffers outlive the raw addresses
        self._mat = np.ascontiguousarray(mat.reshape(-1), dtype=np.int8)
        self._nt4 = np.ascontiguousarray(nt4, dtype=np.uint8)
        self._aa20 = np.ascontiguousarray(aa20, dtype=np.uint8)
        self._codon = np.ascontiguousarray(codon, dtype=np.uint8)
        self._sp = np.ascontiguousarray(sp, dtype=np.int32)
        self._pmat, self._pnt4, self._paa20, self._pcodon, self._psp = (
            self._mat.ctypes.data, self._nt4.ctypes.data,
            self._aa20.ctypes.data, self._codon.ctypes.data,
            self._sp.ctypes.data)
        self.sp_null_bonus = sp_null_bonus
        self.go, self.ge, self.fs = go, ge, fs
        self.xdrop, self.end_bonus, self.ie_coef = xdrop, end_bonus, ie_coef
        self.asize = asize

    _EMPTY_CIG = np.empty(16, np.uint32)

    def dp(self, nsq: np.ndarray, asq: np.ndarray, flag: int, io: int,
           ss: np.ndarray | None = None):
        nl, al = len(nsq), len(asq)
        # extension modes never emit CIGAR ops; skip the nl-sized buffer
        cig = (np.empty(nl + al + 16, np.uint32) if flag & DPF_CIGAR
               else Dp16Ctx._EMPTY_CIG)
        sc = ct.c_int32(0)
        ntl = ct.c_int32(0)
        aal = ct.c_int32(0)
        ncig = ct.c_int32(0)
        _dp16_raw(nsq.ctypes.data, nl, asq.ctypes.data, al,
                  ss.ctypes.data if ss is not None else None,
                  self._pmat, self.asize, self._pnt4, self._paa20,
                  self._pcodon, self._psp, self.sp_null_bonus,
                  flag, self.go, self.ge, io, self.fs,
                  self.xdrop, self.end_bonus, self.ie_coef,
                  ct.byref(sc), ct.byref(ntl), ct.byref(aal),
                  cig.ctypes.data, ct.byref(ncig))
        return int(sc.value), int(ntl.value), int(aal.value), cig[:ncig.value]

    def dp_cigars(self, jobs: list, io: int) -> list:
        """Run many CIGAR-mode DPs, batching 4 similar-size problems per
        AVX-512 call (mx_dp16x4; bit-identical to per-problem mx_dp16).

        jobs: list of (nsq, asq, ss_or_None) C-contiguous uint8 arrays.
        Returns [(score, cigar_array), ...] in job order.

        Whether 4-wide batching actually beats four 8-lane calls depends
        on the host's 512-bit integer throughput (full-rate on Ice
        Lake+/Zen4, half-rate on Skylake-X and most VMs), so the first
        call runs a one-shot probe and the loser is never used again —
        results are identical either way."""
        if not _x4_pays(self):
            out = []
            for nsq, asq, ss in jobs:
                sc, _, _, c = self.dp(nsq, asq, 0x1, io, ss)
                out.append((sc, c))
            return out
        res = [None] * len(jobs)
        for i, (nsq, asq, ss) in enumerate(jobs):
            if len(asq) == 0:  # degenerate: the single-call path guards slen==0
                sc, _, _, c = self.dp(nsq, asq, 0x1, io, ss)
                res[i] = (sc, c)
        order = sorted((i for i in range(len(jobs)) if res[i] is None),
                       key=lambda i: -len(jobs[i][0]))
        nq = np.empty(4, np.int64)
        aq = np.empty(4, np.int64)
        sq = np.empty(4, np.int64)
        nls = np.empty(4, np.int32)
        als = np.empty(4, np.int32)
        offs = np.empty(4, np.int64)
        scores = np.empty(4, np.int32)
        ncigs = np.empty(4, np.int32)
        chunks: list[list[int]] = []
        cur: list[int] = []
        cost = mnl = msl = 0
        for i in order:  # sorted by nl desc; gate on padding waste
            nl_i = len(jobs[i][0])
            sl_i = (len(jobs[i][1]) + 7) // 8
            if cur and (len(cur) == 4
                        or ((len(cur) + 1) * mnl * max(msl, sl_i)
                            > 1.3 * (cost + nl_i * sl_i))):
                chunks.append(cur)
                cur, cost = [], 0
            if not cur:
                mnl, msl = nl_i, sl_i
            else:
                msl = max(msl, sl_i)
            cur.append(i)
            cost += nl_i * sl_i
        if cur:
            chunks.append(cur)
        for chunk in chunks:
            n = len(chunk)
            tot = 0
            for k, i in enumerate(chunk):
                nsq, asq, ss = jobs[i]
                nq[k] = nsq.ctypes.data
                aq[k] = asq.ctypes.data
                sq[k] = 0 if ss is None else ss.ctypes.data
                nls[k] = len(nsq)
                als[k] = len(asq)
                offs[k] = tot
                tot += len(nsq) + len(asq) + 16
            cig = np.empty(tot, np.uint32)
            _dp16x4_raw(n, nq.ctypes.data, nls.ctypes.data,
                        aq.ctypes.data, als.ctypes.data, sq.ctypes.data,
                        self._pmat, self.asize, self._pnt4, self._paa20,
                        self._pcodon, self._psp, self.sp_null_bonus,
                        self.go, self.ge, io, self.fs,
                        scores.ctypes.data, cig.ctypes.data,
                        offs.ctypes.data, ncigs.ctypes.data)
            for k, i in enumerate(chunk):
                o = int(offs[k])
                res[i] = (int(scores[k]), cig[o:o + int(ncigs[k])].copy())
        return res

    def score_ungapped(self, nsq: np.ndarray, asq: np.ndarray) -> int:
        return _score_ungapped_raw(nsq.ctypes.data, asq.ctypes.data, len(asq),
                                   self._pmat, self.asize, self._pcodon,
                                   self._paa20)

    def score_ungapped_many(self, nt: np.ndarray, aa: np.ndarray,
                            triv: list[tuple[int, int, int]]) -> np.ndarray:
        """Score many (nt_off, aa_off, alen) trivial gaps of one region
        in a single native call."""
        tri = np.asarray(triv, np.int64)
        out = np.empty(len(triv), np.int32)
        _score_ungapped_many_raw(nt.ctypes.data, aa.ctypes.data,
                                 tri.ctypes.data, len(triv), self._pmat,
                                 self.asize, self._pcodon, self._paa20,
                                 out.ctypes.data)
        return out


_lib.mx_sketch_nt4.restype = ct.c_int64
_lib.mx_sketch_nt4.argtypes = [_u8p, ct.c_int64, ct.c_int32, ct.c_int32,
                               ct.c_int32, ct.c_int32, ct.c_int64,
                               _u8p, _u8p, _u64p]


_sketch_buf: np.ndarray | None = None


def release_sketch_buf() -> None:
    """Free the grow-only sketch buffer (it can reach ~12 bytes/bp of
    the largest contig; callers release it after an index build so it
    is not pinned — and forked into mapping workers — for the rest of
    the run)."""
    global _sketch_buf
    _sketch_buf = None


def sketch_nt4(seq: np.ndarray, min_aa_len: int, kmer: int, mod_bit: int,
               bbit: int, boff: int, codon: np.ndarray,
               codon13: np.ndarray, copy: bool = True) -> np.ndarray:
    """One-strand three-frame ORF modimer scan (mp_sketch_nt4,
    sketch.c:40-100).  Multiset-equal to sketch.sketch_nt4_numpy.

    The worst-case output bound is one window per codon-end position
    (n+8 entries); a grow-only module buffer is reused across calls so
    whole-chromosome index builds don't cycle multi-100MB mappings."""
    global _sketch_buf
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = len(seq)
    if _sketch_buf is None or len(_sketch_buf) < n + 8:
        _sketch_buf = np.empty(n + n // 2 + 64, np.uint64)
    cnt = _lib.mx_sketch_nt4(seq, n, min_aa_len, kmer, mod_bit, bbit, boff,
                             codon, codon13, _sketch_buf)
    if cnt < 0:
        raise MemoryError("mx_sketch_nt4")
    out = _sketch_buf[:cnt]
    return out.copy() if copy else out   # copy=False: view dies on next call


_lib.mx_filter_seed.argtypes = [ct.c_int64, _u64p, ct.c_int32, ct.c_int32,
                                ct.c_int32, ct.c_int32]


def filter_seed(a: np.ndarray, max_aa_dist: int, min_cnt: int, kmer2: int,
                trim_back: int) -> np.ndarray:
    """Mark tight anchor blocks in place (mp_filter_seed, align.c:6-31)."""
    assert a.dtype == np.uint64 and a.flags.c_contiguous
    _lib.mx_filter_seed(len(a), a, max_aa_dist, min_cnt, kmer2, trim_back)
    return a


_lib.mx_bb_reset.argtypes = [ct.c_int64, ct.c_int64]
_lib.mx_bb_add.restype = ct.c_int32
_lib.mx_bb_add.argtypes = [_u64p, ct.c_int64]
_lib.mx_bb_finish.restype = ct.c_int64
_lib.mx_bb_finish.argtypes = [_i64p, ct.c_int64, _u32p]


def bb_reset(n_bucket: int, reserve: int = 0) -> None:
    """Start a streaming fused bucket build (mx_bb_reset).  reserve
    pre-sizes the internal entry buffer (entries, not bytes)."""
    _lib.mx_bb_reset(n_bucket, reserve)


def bb_add(part: np.ndarray) -> None:
    """Consume one raw (hash, block) part: the entries are partitioned
    into the build's internal buffer immediately, so `part` may be a
    dying view (e.g. the sketch module buffer)."""
    assert part.dtype == np.uint64 and part.flags.c_contiguous
    if _lib.mx_bb_add(part, len(part)) < 0:
        raise MemoryError("mx_bb_add")


def bb_finish(ki: np.ndarray, kb: np.ndarray) -> int:
    """Finish the streaming build: count + scan + scatter + per-bucket
    sort/dedup, all partition-local (mx_bb_finish).  Writes all of ki,
    fills kb, returns the deduped kb length.  kb must hold the total
    number of added entries."""
    assert ki.dtype == np.int64 and kb.dtype == np.uint32
    r = int(_lib.mx_bb_finish(ki, len(ki), kb))
    if r < 0:
        raise MemoryError("mx_bb_finish")
    return r


_lib.mx_extra_stats.argtypes = [_u8p, _u8p, ct.c_int64, ct.c_int64,
                                _u32p, ct.c_int32, _i8p,
                                ct.c_int32, _u8p, _u8p,
                                ct.c_int32, ct.c_int32, ct.c_int32, _i32p]


def extra_stats(nt: np.ndarray, aa: np.ndarray, cigar: np.ndarray, *,
                mat: np.ndarray, asize: int, codon: np.ndarray,
                aa20: np.ndarray, go: int, ge: int, fs: int) -> np.ndarray:
    """Per-CIGAR-op (d_n_stop, d_n_iden, d_n_plus, d_score) deltas
    (the codon loops of mp_extra_cal, align.c:82-201)."""
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    out = np.empty((len(cigar), 4), np.int32)
    nt = np.ascontiguousarray(nt, dtype=np.uint8)
    aa = np.ascontiguousarray(aa, dtype=np.uint8)
    _lib.mx_extra_stats(nt, aa, len(nt), len(aa),
                        cigar, len(cigar),
                        np.ascontiguousarray(mat.reshape(-1), dtype=np.int8),
                        asize, codon, aa20, go, ge, fs, out.reshape(-1))
    return out


_lib.mx_write_cs.restype = ct.c_int64
_lib.mx_write_cs.argtypes = [_u8p, ct.c_int64, _u8p, ct.c_int64, _u32p,
                             ct.c_int32, _u8p, _u8p, ct.c_char_p]


def write_cs(nt: np.ndarray, aa: np.ndarray, cigar: np.ndarray, *,
             codon: np.ndarray, aa20: np.ndarray) -> str:
    """cs:Z: difference string body (mp_write_cs, format.c:102-187)."""
    nt = np.ascontiguousarray(nt, dtype=np.uint8)
    aa = np.ascontiguousarray(aa, dtype=np.uint8)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    buf = ct.create_string_buffer(3 * len(nt) + len(aa) + 24 * len(cigar) + 16)
    n = _lib.mx_write_cs(nt, len(nt), aa, len(aa), cigar, len(cigar),
                         codon, aa20, buf)
    if n < 0:
        raise ValueError("CIGAR does not consume the aligned window")
    return buf.raw[:n].decode("ascii")


_lib.mx_fa_pack.argtypes = [ct.c_char_p, ct.c_int64, ct.c_int64, _u8p,
                            _u8p, ct.c_int64]
_lib.mx_fa_pack.restype = ct.c_int64


def fa_pack(data: bytes, st: int, en: int, nt4: np.ndarray,
            packed: np.ndarray, off: int) -> int:
    """Append the bases of data[st:en] (newlines skipped, chars mapped
    via nt4) to the 4-bit packed stream at base offset off; returns the
    new base offset."""
    assert packed.dtype == np.uint8 and nt4.dtype == np.uint8
    assert 0 <= st <= en <= len(data)
    assert (off + (en - st) + 1) // 2 <= len(packed)
    return _lib.mx_fa_pack(data, st, en, nt4, packed, off)


_sketch_prot_raw = ct.CFUNCTYPE(
    ct.c_int64, ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int32,
    ct.c_int32, ct.c_void_p)(
        ct.cast(_lib.mx_sketch_prot, ct.c_void_p).value)


def sketch_prot(seq: np.ndarray, aa13: np.ndarray, kmer: int,
                mod_bit: int) -> np.ndarray:
    """Protein modimers, query-position order (mp_sketch_prot,
    sketch.c:18-38).  Multiset- and order-equal to sketch.sketch_prot's
    numpy pipeline."""
    n = len(seq)
    out = np.empty(n if n else 1, np.uint64)
    cnt = _sketch_prot_raw(seq.ctypes.data, n, aa13.ctypes.data, kmer,
                           mod_bit, out.ctypes.data)
    return out[:cnt]


_lib.mx_scratch_trim.argtypes = [ct.c_int64]


_lib.mx_unpack.argtypes = [_u8p, ct.c_int64, ct.c_int64, ct.c_int32, _u8p]


_unpack_raw = ct.CFUNCTYPE(
    None, ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_int32, ct.c_void_p)(
        ct.cast(_lib.mx_unpack, ct.c_void_p).value)


def unpack(packed: np.ndarray, s: int, e: int, rev: bool) -> np.ndarray:
    """Unpack genome bases [s, e) as nt4 codes, revcomp when rev
    (mp_ntseq_get, ntseq.c:89-106)."""
    n = max(0, e - s)
    out = np.empty(n, np.uint8)
    if n:
        _unpack_raw(packed.ctypes.data, s, e, int(rev), out.ctypes.data)
    return out


_lib.mx_align_region.argtypes = None  # called through the raw pointer below
_align_region_raw = ct.CFUNCTYPE(
    None,
    ct.c_void_p, ct.c_int64, ct.c_void_p,        # nt, l_nt, ss
    ct.c_void_p, ct.c_int32,                     # aa, qlen
    ct.c_void_p, ct.c_int64,                     # av, n_av
    ct.c_int64, ct.c_int64, ct.c_int64,          # vs0, as_, ae
    ct.c_int64, ct.c_int32, ct.c_int32,          # in_ve, in_qe, more_dp
    ct.c_void_p, ct.c_int32,                     # mat, asize
    ct.c_void_p, ct.c_void_p, ct.c_void_p,       # nt4, aa20, codon
    ct.c_void_p, ct.c_int32,                     # sp, sp_null_bonus
    ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,  # go ge io io_end fs
    ct.c_int32, ct.c_int32, ct.c_float,          # xdrop, end_bonus, ie_coef
    ct.c_int32, ct.c_int32, ct.c_int32,          # kmer2, max_ext, use_x4
    ct.c_void_p, ct.c_void_p, ct.c_void_p,       # out_score, out_vs, out_qs
    ct.c_void_p, ct.c_void_p,                    # out_ve, out_qe
    ct.c_void_p, ct.c_void_p,                    # cig, n_cig
    ct.c_void_p, ct.c_void_p,                    # out_cells, out_ndp
)(ct.cast(_lib.mx_align_region, ct.c_void_p).value)


def align_region(ctx: "Dp16Ctx", nt: np.ndarray, ss: np.ndarray | None,
                 aa: np.ndarray, qlen: int, av: np.ndarray,
                 vs0: int, as_: int, ae: int, in_ve: int, in_qe: int,
                 more_dp: bool, io: int, io_end: int,
                 kmer2: int, max_ext: int):
    """One-call host alignment of a region (mx_align_region): the whole
    per-region DP-step plan — extensions, io_end retries, anchor-gap
    CIGAR DPs with the trivial shortcut, right tail — executed natively.
    Bit-identical to driving align.align_region_steps with the host DP.

    Returns (score, vs, qs, ve, qe, cigar, cells, n_dp)."""
    n_av = len(av)
    cig = np.empty(len(nt) + qlen + 16 * (n_av + 4), np.uint32)
    sc = ct.c_int32(0)
    ovs = ct.c_int64(0)
    oqs = ct.c_int32(0)
    ove = ct.c_int64(0)
    oqe = ct.c_int32(0)
    ncig = ct.c_int32(0)
    cells = ct.c_int64(0)
    ndp = ct.c_int32(0)
    _align_region_raw(
        nt.ctypes.data, len(nt), ss.ctypes.data if ss is not None else None,
        aa.ctypes.data, qlen, av.ctypes.data, n_av,
        vs0, as_, ae, in_ve, in_qe, int(more_dp),
        ctx._pmat, ctx.asize, ctx._pnt4, ctx._paa20, ctx._pcodon,
        ctx._psp, ctx.sp_null_bonus,
        ctx.go, ctx.ge, io, io_end, ctx.fs,
        ctx.xdrop, ctx.end_bonus, ctx.ie_coef,
        kmer2, max_ext, int(_x4_pays(ctx)),
        ct.addressof(sc), ct.addressof(ovs), ct.addressof(oqs),
        ct.addressof(ove), ct.addressof(oqe),
        cig.ctypes.data, ct.addressof(ncig),
        ct.addressof(cells), ct.addressof(ndp))
    return (int(sc.value), int(ovs.value), int(oqs.value), int(ove.value),
            int(oqe.value), cig[:ncig.value].copy(), int(cells.value),
            int(ndp.value))


_lib.mx_refine_region.argtypes = None  # called through the raw pointer below
_refine_region_raw = ct.CFUNCTYPE(
    ct.c_int64,
    ct.c_void_p, ct.c_int64,                     # nt, l_nt
    ct.c_void_p, ct.c_int64,                     # aa, alen
    ct.c_void_p, ct.c_void_p, ct.c_void_p,       # codon, codon13, aa13
    ct.c_int32, ct.c_int32, ct.c_int64,          # kmer, min_aa_len, max_ava
    ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,  # mdx, mdy, bw, max_skip
    ct.c_int32, ct.c_int32, ct.c_int32, ct.c_float,  # max_iter, min_cnt, min_sc, coef
    ct.c_int32,                                  # is_spliced
    ct.c_void_p, ct.c_void_p, ct.c_void_p,       # out_a_ptr, out_i32, out_i64
)(ct.cast(_lib.mx_refine_region, ct.c_void_p).value)


def refine_region_c(nt: np.ndarray, aa: np.ndarray, *, codon: np.ndarray,
                    codon13: np.ndarray, aa13: np.ndarray, kmer: int,
                    min_aa_len: int, max_ava: int, max_dist_x: int,
                    max_dist_y: int, bw: int, max_skip: int, max_iter: int,
                    min_cnt: int, min_sc: int, chn_coef_log: float,
                    is_spliced: bool):
    """One-call second-round refinement (mx_refine_region): re-sketch,
    pair, re-chain, pick + rebase the best chain.  Returns None when
    the region dies, else (anchors, chn_sc, qs, qe, vs_rel, ve_rel,
    chn_sc_ungap) with vs/ve relative to the window start.  Mirrors
    mapper.refine_region's Python plan (the parity oracle)."""
    aptr = ct.c_void_p(0)
    i32 = (ct.c_int32 * 4)()
    i64 = (ct.c_int64 * 2)()
    n = _refine_region_raw(
        nt.ctypes.data, len(nt), aa.ctypes.data, len(aa),
        codon.ctypes.data, codon13.ctypes.data, aa13.ctypes.data,
        kmer, min_aa_len, max_ava,
        max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt, min_sc,
        chn_coef_log, int(is_spliced),
        ct.addressof(aptr), ct.addressof(i32), ct.addressof(i64))
    if n == 0:
        return None
    anchors = np.frombuffer((ct.c_uint64 * n).from_address(aptr.value),
                            dtype=np.uint64).copy()
    return (anchors, int(i32[0]), int(i32[1]), int(i32[2]),
            int(i64[0]), int(i64[1]), int(i32[3]))


_lib.mx_seed_anchors.argtypes = None  # called through the raw pointer below
_seed_anchors_raw = ct.CFUNCTYPE(
    ct.c_int64,
    ct.c_void_p, ct.c_int64, ct.c_void_p,        # seq, qlen, aa13
    ct.c_int32, ct.c_int32,                      # kmer, mod_bit
    ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int64,  # ki, n_ki, kb, n_kb
    ct.c_int64,                                  # max_occ cap
    ct.c_void_p,                                 # out_ptr
)(ct.cast(_lib.mx_seed_anchors, ct.c_void_p).value)


def seed_anchors_c(seq: np.ndarray, aa13: np.ndarray, kmer: int,
                   mod_bit: int, ki: np.ndarray, kb: np.ndarray,
                   max_occ: int) -> np.ndarray:
    """One-call per-query seed gather (mx_seed_anchors): protein sketch,
    sort, boxplot occurrence cap, bucket gather.  Returns unsorted
    anchors blockId<<32|qpos.  Mirrors mapper.seed_anchors (the parity
    oracle)."""
    aptr = ct.c_void_p(0)
    n = _seed_anchors_raw(seq.ctypes.data, len(seq), aa13.ctypes.data,
                          kmer, mod_bit, ki.ctypes.data, len(ki),
                          kb.ctypes.data, len(kb), max_occ,
                          ct.addressof(aptr))
    if n == 0:
        return np.empty(0, np.uint64)
    return np.frombuffer((ct.c_uint64 * n).from_address(aptr.value),
                         dtype=np.uint64).copy()
