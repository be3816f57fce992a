"""Output formatting: PAF (+cs diff string), GFF3, GTF, residue alignment.

Byte-compatible port of format.c.  All writers operate on a Region with
its Extra/Feat records and the genome DB, emitting exactly the
reference's column layout, tags and attribute order.
"""

from __future__ import annotations

import numpy as np

from . import tables
from .align import C_D, C_F, C_G, C_I, C_M, C_N, C_U, C_V, CIGAR_STR
from .hits import Region
from .index import Index
from .options import (F_GFF, F_GTF, F_NO_CS, F_NO_PAF, F_SHOW_RESIDUE,
                      F_SHOW_TRANS, F_SHOW_UNMAP, MapOpt)

_NT_LOWER = "acgtn"
_NT_UPPER = "ACGTN"



def _up(b: int) -> str:
    """ASCII toupper (C semantics)."""
    return chr(b - 32) if 97 <= b <= 122 else chr(b)

def cigar_string(cigar: np.ndarray) -> str:
    return "".join(f"{int(c) >> 4}{CIGAR_STR[int(c) & 0xF]}" for c in cigar)


def _trans_aa(T, n0: int, n1: int, n2: int) -> int:
    if n0 > 3 or n1 > 3 or n2 > 3:
        return tables.AA_X
    return int(T.codon[n0 << 4 | n1 << 2 | n2])


def write_cs(mi: Index, aa: np.ndarray, r: Region) -> str:
    """The cs:Z: difference string (mp_write_cs, format.c:102-187).
    aa is the query slice starting at r.qs.  Dispatches to the native
    writer; the pure-Python version below is kept as the golden model
    (cross-checked in tests)."""
    from . import native
    if r.p is None:
        return ""
    T = tables.get_tables()
    nt = mi.nt.get_by_v(r.vid, r.vs, r.ve)
    return "cs:Z:" + native.write_cs(nt, aa[: r.qe - r.qs], r.p.cigar,
                                     codon=T.codon, aa20=T.aa20)


def write_cs_python(mi: Index, aa: np.ndarray, r: Region) -> str:
    """Pure-Python golden model for write_cs."""
    T = tables.get_tables()
    e = r.p
    if e is None:
        return ""
    out = ["cs:Z:"]
    nt = mi.nt.get_by_v(r.vid, r.vs, r.ve)
    nl = al = 0
    for c in e.cigar:
        op, ln = int(c) & 0xF, int(c) >> 4
        ln3 = ln * 3
        if op == C_M:
            t = 0
            i, j = nl, al
            for _ in range(ln):
                nt_aa = _trans_aa(T, int(nt[i]), int(nt[i + 1]), int(nt[i + 2]))
                aa_aa = int(T.aa20[aa[j]])
                if nt_aa != aa_aa:
                    if t > 0:
                        out.append(f":{t}")
                    out.append("*" + _NT_LOWER[nt[i]] + _NT_LOWER[nt[i + 1]]
                               + _NT_LOWER[nt[i + 2]] + _up(aa[j]))
                    t = 0
                else:
                    t += 1
                i += 3
                j += 1
            if t > 0:
                out.append(f":{t}")
            nl += ln3
            al += ln
        elif op == C_I:
            out.append("+" + "".join(_up(x) for x in aa[al:al + ln]))
            al += ln
        elif op == C_D:
            out.append("-" + "".join(_NT_LOWER[x] for x in nt[nl:nl + ln3]))
            nl += ln3
        elif op == C_F:
            out.append("-" + "".join(_NT_LOWER[x] for x in nt[nl:nl + ln]))
            nl += ln
        elif op == C_G:
            out.append("*" + "".join(_NT_LOWER[x] for x in nt[nl:nl + ln])
                       + _up(aa[al]))
            nl += ln
            al += 1
        elif op in (C_N, C_U, C_V):
            lshift = 0 if op == C_N else 1 if op == C_U else 2
            rshift = 0 if lshift == 0 else 3 - lshift
            if lshift > 0:
                out.append("*" + "".join(_NT_LOWER[x] for x in nt[nl:nl + lshift])
                           + _up(aa[al]))
            out.append("~" + _NT_LOWER[nt[nl + lshift]] + _NT_LOWER[nt[nl + lshift + 1]]
                       + str(ln - (lshift + rshift))
                       + _NT_LOWER[nt[nl + ln - rshift - 2]] + _NT_LOWER[nt[nl + ln - rshift - 1]])
            if rshift > 0:
                out.append("-" + "".join(_NT_LOWER[x] for x in nt[nl + ln - rshift:nl + ln]))
            if lshift:
                al += 1
            nl += ln
    assert nl == r.ve - r.vs and al == r.qe - r.qs
    return "".join(out)


def write_paf(mi: Index, opt: MapOpt, name: str, seq: np.ndarray,
              r: Region | None) -> str:
    """One PAF line (mp_write_paf, format.c:333-358)."""
    s = []
    if opt.flag & (F_GFF | F_GTF):
        s.append("##PAF\t")
    if r is None:
        s.append(f"{name}\t{len(seq)}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0\n")
        return "".join(s)
    ctg = mi.nt.ctg[r.vid >> 1]
    s.append(f"{name}\t{len(seq)}\t{r.qs}\t{r.qe}\t{'+-'[r.vid & 1]}\t{ctg.name}\t{ctg.len}\t")
    if r.vid & 1:
        s.append(f"{ctg.len - r.ve}\t{ctg.len - r.vs}\t")
    else:
        s.append(f"{r.vs}\t{r.ve}\t")
    if r.p is not None:
        e = r.p
        s.append(f"{e.n_iden * 3}\t{e.blen}\t0\tAS:i:{e.dp_score}\tms:i:{e.dp_max}\t"
                 f"np:i:{e.n_plus}\tfs:i:{e.n_fs}\tst:i:{e.n_stop}\t"
                 f"da:i:{e.dist_start}\tdo:i:{e.dist_stop}\t")
        s.append("cg:Z:" + cigar_string(e.cigar))
    else:
        s.append(f"{r.chn_sc}\t{r.chn_sc_ungap}\t{r.cnt}")
    if not (opt.flag & F_NO_CS):
        s.append("\t")
        s.append(write_cs(mi, seq[r.qs:], r))
    s.append("\n")
    return "".join(s)


def write_gff(mi: Index, opt: MapOpt, name: str, seq: np.ndarray, r: Region,
              gid: int, hit_idx: int) -> str:
    """GFF3 mRNA/CDS/stop_codon records (mp_write_gff, format.c:360-412)."""
    if r is None or r.p is None:
        return ""
    has_stop = r.qe == len(seq) and r.p.dist_stop == 0
    ve_mRNA = r.ve + 3 if has_stop else r.ve
    if 33 <= opt.gff_delim <= 126 and hit_idx >= 0:
        id_str = f"{name}{chr(opt.gff_delim)}{hit_idx}"
    else:
        id_str = f"{opt.gff_prefix}{gid:06d}"
    ctg = mi.nt.ctg[r.vid >> 1]
    vs = ctg.len - ve_mRNA if r.vid & 1 else r.vs
    ve = ctg.len - r.vs if r.vid & 1 else ve_mRNA
    s = [f"{ctg.name}\tminiprot\tmRNA\t{vs + 1}\t{ve}\t{r.p.dp_max}\t"
         f"{'+-'[r.vid & 1]}\t.\tID={id_str};Rank={hit_idx}"]
    s.append(f";Identity={r.p.n_iden * 3 / r.p.blen:.4f}")
    s.append(f";Positive={r.p.n_plus * 3 / r.p.blen:.4f}")
    if r.p.n_fs > 0:
        s.append(f";Frameshift={r.p.n_fs}")
    if r.p.n_stop > 0:
        s.append(f";StopCodon={r.p.n_stop}")
    s.append(f";Target={name} {r.qs + 1} {r.qe}\n")
    feats = r.feat or []
    for j, f in enumerate(feats):
        fe = f.ve
        if (has_stop and f.type == 0 and j + 1 < len(feats) and feats[j + 1].type == 1):
            fe += 3  # GFF3: last CDS includes the stop codon
        vs = ctg.len - fe if r.vid & 1 else f.vs
        ve = ctg.len - f.vs if r.vid & 1 else fe
        s.append(f"{ctg.name}\tminiprot\t{'stop_codon' if f.type == 1 else 'CDS'}\t"
                 f"{vs + 1}\t{ve}\t{f.score}\t{'+-'[r.vid & 1]}\t{f.phase}\t"
                 f"Parent={id_str};Rank={hit_idx}")
        if f.type == 0:
            s.append(f";Identity={f.n_iden * 3 / f.blen:.4f}")
            if f.acceptor and f.acceptor[:2] != "AG":
                s.append(f";Acceptor={f.acceptor}")
            if f.donor and f.donor[:2] != "GT":
                s.append(f";Donor={f.donor}")
            if f.n_fs > 0:
                s.append(f";Frameshift={f.n_fs}")
            if f.n_stop > 0:
                s.append(f";StopCodon={f.n_stop}")
            s.append(f";Target={name} {f.qs + 1} {f.qe}")
        s.append("\n")
    return "".join(s)


def write_gtf(mi: Index, opt: MapOpt, name: str, seq: np.ndarray, r: Region,
              gid: int) -> str:
    """GTF gene/transcript/exon/CDS records (mp_write_gtf, format.c:414-451)."""
    if r is None or r.p is None:
        return ""
    has_stop = r.qe == len(seq) and r.p.dist_stop == 0
    ve_mRNA = r.ve + 3 if has_stop else r.ve
    id_g = f"{opt.gff_prefix}G{gid:06d}"
    id_t = f"{opt.gff_prefix}T{gid:06d}"
    ctg = mi.nt.ctg[r.vid >> 1]
    vs = ctg.len - ve_mRNA if r.vid & 1 else r.vs
    ve = ctg.len - r.vs if r.vid & 1 else ve_mRNA
    strand = "+-"[r.vid & 1]
    s = [f"{ctg.name}\tminiprot\tgene\t{vs + 1}\t{ve}\t{r.p.dp_max}\t{strand}\t.\t"
         f'gene_id "{id_g}";\n',
         f"{ctg.name}\tminiprot\ttranscript\t{vs + 1}\t{ve}\t{r.p.dp_max}\t{strand}\t.\t"
         f'transcript_id "{id_t}"; gene_id "{id_g}";\n']
    for f in (r.feat or []):
        if f.type != 0:
            continue
        vs = ctg.len - f.ve if r.vid & 1 else f.vs
        ve = ctg.len - f.vs if r.vid & 1 else f.ve
        vs2, ve2 = vs, ve
        if f.ve == r.ve:  # last exon: extend for stop codon
            if r.vid & 1:
                vs2 = ctg.len - ve_mRNA
            else:
                ve2 = ve_mRNA
        s.append(f"{ctg.name}\tminiprot\texon\t{vs2 + 1}\t{ve2}\t{f.score}\t{strand}\t.\t"
                 f'transcript_id "{id_t}"; gene_id "{id_g}";\n')
        s.append(f"{ctg.name}\tminiprot\tCDS\t{vs + 1}\t{ve}\t{f.score}\t{strand}\t{f.phase}\t"
                 f'transcript_id "{id_t}"; gene_id "{id_g}";\n')
    return "".join(s)


def write_residue(mi: Index, opt: MapOpt, seq: np.ndarray, r: Region) -> str:
    """--aln 4-line residue view and/or --trans translation
    (mp_write_residue, format.c:189-331)."""
    T = tables.get_tables()
    e = r.p
    if e is None:
        return ""
    max_flank = opt.max_intron_flank
    aa = seq
    al, nl = r.qs, 0
    nt = mi.nt.get_by_v(r.vid, r.vs, r.ve + 3)
    l_nt = len(nt)
    s0, s1, s2, s3, s4 = [], [], [], [], []  # ATN, ATA, AAS, AQA, STA

    for c in e.cigar:
        op, ln = int(c) & 0xF, int(c) >> 4
        ln3 = ln * 3
        if op == C_M:
            i, j = nl, al
            for _ in range(ln):
                nt_aa = _trans_aa(T, int(nt[i]), int(nt[i + 1]), int(nt[i + 2]))
                aa_aa = int(T.aa20[aa[j]])
                sc = int(opt.mat[nt_aa, aa_aa])
                s0.append(_NT_UPPER[nt[i]] + _NT_UPPER[nt[i + 1]] + _NT_UPPER[nt[i + 2]])
                s1.append(tables.AA_I2C[nt_aa] + "..")
                s4.append(tables.AA_I2C[nt_aa])
                s2.append(("|" if nt_aa == aa_aa else "+" if sc > 0 else " ") + "  ")
                s3.append(_up(aa[j]) + "  ")
                i += 3
                j += 1
            nl += ln3
            al += ln
        elif op == C_I:
            for j in range(ln):
                s0.append("---")
                s1.append("-..")
                s2.append("   ")
                s3.append(_up(aa[al + j]) + "  ")
            al += ln
        elif op == C_D:
            i = nl
            for _ in range(ln):
                nt_aa = _trans_aa(T, int(nt[i]), int(nt[i + 1]), int(nt[i + 2]))
                s0.append(_NT_UPPER[nt[i]] + _NT_UPPER[nt[i + 1]] + _NT_UPPER[nt[i + 2]])
                s1.append(tables.AA_I2C[nt_aa] + "..")
                s4.append(tables.AA_I2C[nt_aa])
                s2.append("   ")
                s3.append("-  ")
                i += 3
            nl += ln3
        elif op == C_F:
            for l in range(ln):
                s0.append(_NT_UPPER[nt[nl + l]])
                s1.append("!")
                s2.append(" ")
                s3.append(" ")
            nl += ln
        elif op == C_G:
            for l in range(ln):
                s0.append(_NT_UPPER[nt[nl + l]])
                s1.append("$")
                s2.append(" ")
                s3.append(_up(aa[al]) if l == 0 else " ")
            nl += ln
            al += 1
        elif op in (C_N, C_U, C_V):
            intron_len = ln if op == C_N else ln - 3
            if op in (C_U, C_V):
                if op == C_U:
                    n0, n1, n2 = int(nt[nl]), int(nt[nl + ln - 2]), int(nt[nl + ln - 1])
                else:
                    n0, n1, n2 = int(nt[nl]), int(nt[nl + 1]), int(nt[nl + ln - 1])
                nt_aa = _trans_aa(T, n0, n1, n2)
                aa_aa = int(T.aa20[aa[al]])
                sc = int(opt.mat[nt_aa, aa_aa])
                s0.append(_NT_UPPER[nt[nl]])
                s1.append(tables.AA_I2C[nt_aa])
                s4.append(tables.AA_I2C[nt_aa])
                s2.append("|" if nt_aa == aa_aa else "+" if sc > 0 else " ")
                s3.append(_up(aa[al]))
                nl += 1
                if op == C_V:
                    s0.append(_NT_UPPER[nt[nl]])
                    s1.append(".")
                    s2.append(" ")
                    s3.append(" ")
                    nl += 1
                al += 1
            if intron_len <= max_flank * 2:
                for l in range(intron_len):
                    s0.append(_NT_LOWER[nt[nl + l]])
                    s1.append(" ")
                    s2.append(" ")
                    s3.append(" ")
            else:
                for l in range(max_flank):
                    s0.append(_NT_LOWER[nt[nl + l]])
                    s1.append(" ")
                    s2.append(" ")
                    s3.append(" ")
                mid = "~" + str(intron_len) + "~"
                s0.append(mid)
                s1.append(" " * len(mid))
                s2.append(" " * len(mid))
                s3.append(" " * len(mid))
                for l in range(intron_len - max_flank, intron_len):
                    s0.append(_NT_LOWER[nt[nl + l]])
                    s1.append(" ")
                    s2.append(" ")
                    s3.append(" ")
            nl += intron_len
            if op in (C_U, C_V):
                s0.append(_NT_UPPER[nt[nl]])
                s1.append(".")
                s2.append(" ")
                s3.append(" ")
                nl += 1
                if op == C_U:
                    s0.append(_NT_UPPER[nt[nl]])
                    s1.append(".")
                    s2.append(" ")
                    s3.append(" ")
                    nl += 1
    assert nl == r.ve - r.vs
    if l_nt == r.ve - r.vs + 3 and (not s4 or s4[-1] != "*"):
        nt_aa = _trans_aa(T, int(nt[nl]), int(nt[nl + 1]), int(nt[nl + 2]))
        s0.append(_NT_UPPER[nt[nl]] + _NT_UPPER[nt[nl + 1]] + _NT_UPPER[nt[nl + 2]])
        s1.append(tables.AA_I2C[nt_aa] + "..")
        s4.append(tables.AA_I2C[nt_aa])
        s2.append("   ")
        s3.append("   ")
    out = []
    if opt.flag & F_SHOW_RESIDUE:
        out.append("##ATN\t" + "".join(s0) + "\n##ATA\t" + "".join(s1)
                   + "\n##AAS\t" + "".join(s2) + "\n##AQA\t" + "".join(s3) + "\n")
    if opt.flag & F_SHOW_TRANS:
        out.append("##STA\t" + "".join(s4) + "\n")
    return "".join(out)


def write_output(mi: Index, opt: MapOpt, name: str, seq: np.ndarray,
                 r: Region | None, gid: int, hit_idx: int) -> str:
    """Per-hit output dispatcher (mp_write_output, format.c:453-473)."""
    if r is None:
        if opt.flag & F_SHOW_UNMAP:
            return write_paf(mi, opt, name, seq, None)
        return ""
    if opt.flag & F_GTF:
        out = ""
        if opt.flag & (F_SHOW_RESIDUE | F_SHOW_TRANS):
            out += write_paf(mi, opt, name, seq, r)
            out += write_residue(mi, opt, seq, r)
        return out + write_gtf(mi, opt, name, seq, r, gid)
    out = ""
    if not (opt.flag & F_NO_PAF):
        out += write_paf(mi, opt, name, seq, r)
    if opt.flag & (F_SHOW_RESIDUE | F_SHOW_TRANS):
        out += write_residue(mi, opt, seq, r)
    if opt.flag & F_GFF:
        out += write_gff(mi, opt, name, seq, r, gid, hit_idx)
    return out
