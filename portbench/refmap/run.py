"""Map proteins on the reference host engine and write their GFF text.

``map_gff`` returns, for each protein, the text the port's
``pipeline._emit_query`` writes for it (this is a copy of that logic):
its hits after the output filters, each as ``##PAF`` plus GFF3 lines.
The mRNA ids are numbered from 1 within each protein; the benchmark
numbers both sides alike before it compares them.
"""

from __future__ import annotations

import multiprocessing as mp
import warnings

import numpy as np

from .align import DpEnv
from .format import write_output
from .index import Index
from .mapper import map_query
from .options import F_GFF, IdxOpt, MapOpt

_W: dict = {}


def make_opts(mapcfg: dict) -> tuple[IdxOpt, MapOpt]:
    """Index and map options from a configuration's ``map`` group:
    ``gff`` (GFF3 output) and ``intron_cap_genome_bp`` (the genome size
    that upstream ``-I`` derives the intron cap from)."""
    mo = MapOpt()
    if mapcfg.get("gff"):
        mo.flag |= F_GFF
    mo.set_max_intron(int(mapcfg["intron_cap_genome_bp"]))
    return IdxOpt(), mo


def emit(mi: Index, opt: MapOpt, name: str, seq: np.ndarray, regs) -> str:
    """One protein's output (pipeline._emit_query, map.c:297-313)."""
    out = []
    best_sc = -1
    if regs:
        r0 = regs[0]
        best_sc = r0.p.dp_max if r0.p is not None else r0.chn_sc
    gid = 0
    for j, r in enumerate(regs):
        if j >= opt.out_n:
            break
        sc = r.p.dp_max if r.p is not None else r.chn_sc
        if sc <= 0 or sc < float(best_sc) * opt.out_sim:
            continue
        if r.qe - r.qs < float(len(seq)) * opt.out_cov:
            continue
        gid += 1
        out.append(write_output(mi, opt, name, seq, r, gid, j + 1))
    if gid == 0:
        out.append(write_output(mi, opt, name, seq, None, 0, 0))
    return "".join(out)


def _map_one(item):
    name, seq_bytes = item
    seq = np.frombuffer(seq_bytes, dtype=np.uint8)
    try:
        regs = map_query(_W["mi"], seq, _W["opt"], env=_W["env"])
        return name, emit(_W["mi"], _W["opt"], name, seq, regs)
    except Exception as e:   # a protein the engine cannot map: reported
        return name, f"<error {type(e).__name__}: {e}>\n"


def map_gff(mi: Index, opt: MapOpt, prots, n_threads: int = 1) -> dict:
    """{name: output text} of each (name, sequence bytes) in ``prots``,
    mapped on a fork pool of ``n_threads`` processes."""
    _W.update(mi=mi, opt=opt, env=DpEnv(opt))
    try:
        if n_threads <= 1:
            return dict(map(_map_one, prots))
        with warnings.catch_warnings():
            # the workers touch only numpy and the reference's C library
            warnings.filterwarnings("ignore", message=".*fork.*")
            with mp.get_context("fork").Pool(n_threads) as pool:
                return dict(pool.imap_unordered(_map_one, prots,
                                                chunksize=4))
    finally:
        _W.clear()
