"""The benchmark's workload generator: genome and proteome from a seed.

Derived from the port's ``testgen.make_grch38_workload`` and frozen
here, so that the benchmark's inputs do not change when the port
changes its own generators.  A configuration names its contigs and
their lengths (an assembly's own, as data), the number of genes, the
protein lengths' distribution and the mutation classes; the same seed
gives the same files.
"""

from __future__ import annotations

import numpy as np

from statistics import NormalDist

from .refmap import tables

AA20 = "ARNDCQEGHILKMFPSTWYV"


def _aa2codons():
    T = tables.get_tables(1)
    m: dict[str, list[str]] = {}
    for c in range(64):
        aa = tables.AA_I2C[T.codon[c]]
        m.setdefault(aa, []).append("ACGT"[c >> 4] + "ACGT"[(c >> 2) & 3] + "ACGT"[c & 3])
    return m


_NT = np.frombuffer(b"ACGT", np.uint8)
_AA = np.frombuffer(AA20.encode(), np.uint8)


def _codon_tables():
    """(table, cnt): table[a, k] = the k-th synonymous codon (3 nt codes)
    of AA20 letter a; cnt[a] = number of synonyms."""
    aa2c = _aa2codons()
    nt_i = {c: i for i, c in enumerate("ACGT")}
    table = np.zeros((20, 8, 3), np.uint8)
    cnt = np.zeros(20, np.int64)
    for a, ch in enumerate(AA20):
        for k, cod in enumerate(aa2c[ch]):
            table[a, k] = [nt_i[c] for c in cod]
        cnt[a] = len(aa2c[ch])
    return table, cnt


def _write_fasta_seq(f, ascii_arr: np.ndarray, line_len: int) -> None:
    """Write one sequence wrapped at line_len (vectorized newline insert)."""
    n = len(ascii_arr)
    full = n // line_len * line_len
    if full:
        block = ascii_arr[:full].reshape(-1, line_len)
        out = np.empty((block.shape[0], line_len + 1), np.uint8)
        out[:, :line_len] = block
        out[:, line_len] = 0x0A
        f.write(out.tobytes())
    if n > full:
        f.write(ascii_arr[full:].tobytes() + b"\n")


def protein_lengths(n: int, median: float, sigma: float,
                    min_aa: int) -> np.ndarray:
    """``n`` protein lengths at the quantiles (i + 0.5) / n of a
    log-normal of that median and shape, none under ``min_aa``: the
    same lengths for every seed, which only orders them."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.maximum(np.rint(median * np.exp(sigma * z)),
                      min_aa).astype(np.int64)


def make_workload(path_fa: str, path_faa: str, *, contigs: list,
                  total_genes: int, protein_len: dict, seed: int,
                  scale: float = 1.0, line_len: int = 60,
                  max_exons: int = 10, max_intron: int = 20_000,
                  mut_rate: float = 0.08, rev_frac: float = 0.4,
                  fs_frac: float = 0.05, tandem_frac: float = 0.1,
                  satellites_per_ctg: int = 2,
                  splice_classes: float = 0.1) -> int:
    """Write a genome FASTA and a protein FASTA; returns the protein
    count.

    ``contigs`` is a list of [name, length in bp], each length times
    ``scale``.  About ``total_genes`` genes are planted, spread over the
    contigs by length, each of 1 to ``max_exons`` exons with introns of
    80 to ``max_intron`` bp; their proteins take the lengths of
    ``protein_lengths(**protein_len)`` in an order drawn from the seed,
    and each query is its gene's protein with ``mut_rate`` of its
    residues substituted (one in five also gets a one-residue indel).
    The classes that stress the mapper: ``rev_frac`` of the genes on the
    reverse strand, ``fs_frac`` with a genomic frameshift,
    ``tandem_frac`` copied into tandem arrays, ``satellites_per_ctg``
    stop-free satellite arrays a contig (each with a query carrying its
    peptide), and ``splice_classes`` of the introns non-canonical (GC-AG
    or AT-AC) or with a poly-pyrimidine tail."""
    rng = np.random.default_rng(seed)
    cod_tab, cod_cnt = _codon_tables()
    lens = [int(bp * scale) for _, bp in contigs]
    total = sum(lens)
    # genes by length, largest remainders first: total_genes in all
    share = np.array(lens, np.float64) * total_genes / total
    per_ctg = np.floor(share).astype(np.int64)
    per_ctg[np.argsort(per_ctg - share, kind="stable")
            [:total_genes - int(per_ctg.sum())]] += 1
    per_ctg = per_ctg.tolist()
    plens = rng.permutation(protein_lengths(sum(per_ctg), **protein_len))
    prots = []
    with open(path_fa, "wb") as f:
        for ci, clen in enumerate(lens):
            n_genes = per_ctg[ci]
            first = sum(per_ctg[:ci])
            g = rng.integers(0, 4, clen, dtype=np.uint8)
            cursor = 1000
            for gi in range(n_genes):
                plen = int(plens[first + gi])
                prot = rng.integers(0, 20, plen).astype(np.uint8)
                n_ex = int(rng.integers(1, max_exons + 1))
                cuts = sorted(rng.choice(np.arange(1, plen), n_ex - 1,
                                         replace=False).tolist()) \
                    if n_ex > 1 else []
                bounds = [0] + cuts + [plen]
                need = plen * 3 + n_ex * max_intron + 2000
                if cursor + need >= clen:
                    break
                pos = cursor
                exon_spans = []
                for e in range(n_ex):
                    ex_start = pos
                    codes = prot[bounds[e]:bounds[e + 1]]
                    syn = (rng.random(len(codes))
                           * cod_cnt[codes]).astype(np.int64)
                    g[pos:pos + 3 * len(codes)] = \
                        cod_tab[codes, syn].reshape(-1)
                    pos += 3 * len(codes)
                    exon_spans.append((ex_start, pos))
                    if e < n_ex - 1:
                        ilen = int(rng.integers(80, max_intron))
                        g[pos], g[pos + 1] = 2, 3
                        g[pos + ilen - 2], g[pos + ilen - 1] = 0, 2
                        if rng.random() < splice_classes:
                            if rng.integers(0, 2) == 0:
                                g[pos + 1] = 1                 # GC..AG
                            else:
                                g[pos], g[pos + 1] = 0, 3      # AT..AC
                                g[pos + ilen - 1] = 1
                        if rng.random() < splice_classes:
                            yl = int(rng.integers(5, 26))
                            y0 = max(pos + 4, pos + ilen - 2 - yl)
                            g[y0:pos + ilen - 2] = np.where(
                                rng.random(pos + ilen - 2 - y0) < 0.5,
                                1, 3).astype(np.uint8)
                        pos += ilen
                wide = [sp for sp in exon_spans if sp[1] - sp[0] > 60]
                if rng.random() < fs_frac and wide and pos + 2 < clen:
                    es, ee = wide[int(rng.integers(len(wide)))]
                    off = int(rng.integers(es + 20, ee - 20))
                    k = int(rng.integers(1, 3))
                    if rng.random() < 0.5:
                        g[off:pos - k] = g[off + k:pos].copy()
                        pos -= k
                    else:
                        g[off + k:pos + k] = g[off:pos].copy()
                        g[off:off + k] = rng.integers(0, 4, k,
                                                      dtype=np.uint8)
                        pos += k
                if rng.random() < rev_frac:
                    g[cursor:pos] = (3 - g[cursor:pos])[::-1]
                if rng.random() < tandem_frac:
                    span = g[cursor:pos].copy()
                    k = int(rng.integers(3, 9))
                    for _ in range(k - 1):
                        nxt = pos + int(rng.integers(100, 800))
                        if nxt + len(span) + 2000 >= clen:
                            break
                        g[nxt:nxt + len(span)] = span
                        pos = nxt + len(span)
                cursor = pos + int(rng.integers(500, 3000))
                p = prot.copy()
                mut = rng.integers(0, plen, int(plen * mut_rate))
                p[mut] = rng.integers(0, 20, len(mut)).astype(np.uint8)
                if rng.random() < 0.2:
                    k = int(rng.integers(1, plen - 1))
                    if rng.random() < 0.5:
                        p = np.delete(p, k)
                    else:
                        p = np.insert(p, k, rng.integers(0, 20))
                prots.append((f"prot_c{ci}_{gi}", p))
            for si in range(satellites_per_ctg):
                m = int(rng.integers(5, 30))
                mono_aa = rng.integers(0, 20, m).astype(np.uint8)
                syn = (rng.random(m) * cod_cnt[mono_aa]).astype(np.int64)
                mono = cod_tab[mono_aa, syn].reshape(-1)
                k = int(rng.integers(50, 400))
                arr = np.tile(mono, k)
                if cursor + len(arr) + 2000 >= clen:
                    break
                g[cursor:cursor + len(arr)] = arr
                cursor += len(arr) + int(rng.integers(500, 3000))
                reps = max(2, min(8, 600 // max(1, m)))
                prots.append((f"sat_c{ci}_{si}", np.tile(mono_aa, reps)))
            f.write(f">{contigs[ci][0]}\n".encode())
            _write_fasta_seq(f, _NT[g], line_len)
            del g
    with open(path_faa, "wb") as f:
        for name, p in prots:
            f.write(f">{name}\n".encode() + _AA[p].tobytes() + b"\n")
    return len(prots)
