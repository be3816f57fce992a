"""Deterministic synthetic benchmark/test workloads.

Generates a random genome with implanted multi-exon genes (GT..AG
introns) and a matching mutated protein set.  Used by bench.py and the
fuzz tests; no external data needed (this environment has no network
access to real genomes).
"""

from __future__ import annotations

import numpy as np

from . import tables

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


def orf_strand(rng, n: int, mean_run: float, p_n: float = 0.0002) -> np.ndarray:
    """n nt4 codes of frame-0 sense codons with a stop codon every
    ~mean_run codons and N (code 4) at rate p_n: ORFs of any length for
    the six-frame sketch's tests."""
    T = tables.get_tables(1)
    sense, stops = np.flatnonzero(T.codon < 20), np.flatnonzero(T.codon >= 20)
    cod = rng.choice(sense, n // 3 + 1)
    brk = rng.random(len(cod)) < 1.0 / mean_run
    cod[brk] = rng.choice(stops, int(brk.sum()))
    seq = np.stack([cod >> 4 & 3, cod >> 2 & 3, cod & 3], 1).reshape(-1)[:n]
    seq = seq.astype(np.uint8)
    seq[rng.random(n) < p_n] = 4
    return seq


def make_workload(path_fa: str, path_faa: str, *, genome_len: int = 2_000_000,
                  n_genes: int = 100, seed: int = 42, n_ctg: int = 2,
                  max_exons: int = 8, max_intron: int = 20000,
                  mut_rate: float = 0.05, line_len: int = 60,
                  rev_frac: float = 0.0, fs_frac: float = 0.0,
                  pseudo_frac: float = 0.0, pseudo_mut: float = 0.01,
                  tandem_frac: float = 0.0, tandem_copies: tuple = (3, 9),
                  satellites_per_ctg: int = 0,
                  satellite_monomer_aa: tuple = (5, 30),
                  satellite_copies: tuple = (50, 400),
                  splice_classes: float = 0.0):
    """Write a synthetic genome FASTA + protein FASTA pair.

    rev_frac of the genes are implanted on the reverse strand (the gene
    region is reverse-complemented in place after writing).  fs_frac of
    the genes get a 1-2bp indel inside an exon body (a genomic
    frameshift), exercising the F/G CIGAR ops end-to-end.

    pseudo_frac of the multi-exon genes additionally get a PROCESSED
    PSEUDOGENE: the gene's intronless coding sequence (exons
    concatenated, pseudo_mut per-base substitutions, random strand)
    implanted downstream on the same contig.  This is the workload class
    that exercises the anti-pseudogene machinery — dp_max ranking
    (intron costs excluded from the ranking score, align.c:102-119) and
    the multi-exon primary preference (mp_select_multi_exon,
    hit.c:238-250).  pseudo_mut=0 plants a perfect retrocopy, forcing
    the near-tie the multi-exon preference exists to break.

    tandem_frac of the genes are replicated into a TANDEM GENE ARRAY:
    the gene's whole genomic span (exons + introns) copied
    tandem_copies[0]..[1]-1 times with short spacers.  A query protein
    then seeds every copy, multiplying its per-k-mer occupancy and
    chain candidates — the regime the dynamic per-query max_occ boxplot
    cap (map.c:126-141) and the refine round's max_ava cross-product
    truncation (map.c:53-79) exist for.

    satellites_per_ctg implants that many SATELLITE ARRAYS per contig:
    a random stop-free coding monomer (satellite_monomer_aa aa long)
    repeated satellite_copies[0]..[1]-1 times.  Stop-free means the
    whole array is one giant ORF per strand, so every 6-mer in the
    monomer indexes at array-copy occupancy — driving mean occupancy
    >> the occ caps.  One query protein per satellite carries the
    repeated peptide so lookups actually hit the saturated buckets.

    splice_classes makes that fraction of introns NON-CANONICAL: half
    GC-AG, half AT-AC (the minor-spliceosome classes the splice model
    scores at nasw-sse.c:120-137 via types 1/2, model tables
    nasw-tab.c:124-129), and independently injects a controlled-length
    poly-pyrimidine tail (C/T run ending 3bp before the acceptor, the
    sp[5] per-base window at j = i-4..i-6).  These sites score WORSE
    than GT..AG under every model, so the splice-model class arithmetic
    (-j 0/1/2) demonstrably decides output on such workloads — the
    adversarial coverage tests/test_fuzz_vs_ref.py pins byte-parity on.

    All extra knobs default off and consume NO rng draws when off, so
    preexisting (path, seed) workloads regenerate byte-identically.

    Vectorized over uint8 nt codes end-to-end so whole-genome workloads
    (hundreds of Mb) generate in seconds; the bench's 200Mb x 2000
    workload depends on this."""
    rng = np.random.default_rng(seed)
    cod_tab, cod_cnt = _codon_tables()
    per_ctg = genome_len // n_ctg
    genes_per_ctg = n_genes // n_ctg
    prots = []
    with open(path_fa, "wb") as f:
        for ci in range(n_ctg):
            g = rng.integers(0, 4, per_ctg, dtype=np.uint8)
            cursor = 1000
            for gi in range(genes_per_ctg):
                plen = int(rng.integers(100, 700))
                prot = rng.integers(0, 20, plen).astype(np.uint8)
                n_ex = int(rng.integers(1, max_exons + 1))
                cuts = sorted(rng.choice(np.arange(1, plen), n_ex - 1,
                                         replace=False).tolist()) if n_ex > 1 else []
                bounds = [0] + cuts + [plen]
                need = plen * 3 + n_ex * max_intron + 2000
                if cursor + need >= per_ctg:
                    break
                pos = cursor
                exon_spans = []
                for e in range(n_ex):
                    ex_start = pos
                    codes = prot[bounds[e]:bounds[e + 1]]
                    syn = (rng.random(len(codes)) * cod_cnt[codes]).astype(np.int64)
                    g[pos:pos + 3 * len(codes)] = cod_tab[codes, syn].reshape(-1)
                    pos += 3 * len(codes)
                    exon_spans.append((ex_start, pos))
                    if e < n_ex - 1:
                        ilen = int(rng.integers(80, max_intron))
                        g[pos], g[pos + 1] = 2, 3                  # GT
                        g[pos + ilen - 2], g[pos + ilen - 1] = 0, 2  # AG
                        if splice_classes > 0:
                            if rng.random() < splice_classes:
                                if rng.integers(0, 2) == 0:   # GC..AG
                                    g[pos + 1] = 1
                                else:                         # AT..AC
                                    g[pos], g[pos + 1] = 0, 3
                                    g[pos + ilen - 1] = 1
                            if rng.random() < splice_classes:
                                # poly-Y tail ending 3bp before the AG
                                yl = int(rng.integers(5, 26))
                                y0 = max(pos + 4, pos + ilen - 2 - yl)
                                g[y0:pos + ilen - 2] = np.where(
                                    rng.random(pos + ilen - 2 - y0) < 0.5,
                                    1, 3).astype(np.uint8)
                        pos += ilen
                wide = [sp for sp in exon_spans if sp[1] - sp[0] > 60]
                if fs_frac > 0 and rng.random() < fs_frac and wide \
                        and pos + 2 < per_ctg:
                    # genomic frameshift: 1-2bp indel inside an exon body
                    es, ee = wide[int(rng.integers(len(wide)))]
                    off = int(rng.integers(es + 20, ee - 20))
                    k = int(rng.integers(1, 3))
                    if rng.random() < 0.5:  # deletion
                        g[off:pos - k] = g[off + k:pos].copy()
                        pos -= k
                    else:                   # insertion
                        g[off + k:pos + k] = g[off:pos].copy()
                        g[off:off + k] = rng.integers(0, 4, k, dtype=np.uint8)
                        pos += k
                cds = None
                if pseudo_frac > 0 and n_ex > 1 \
                        and rng.random() < pseudo_frac:
                    # capture the intronless coding sequence before the
                    # strand flip (a retrocopy inserts independently)
                    cds = np.concatenate([g[es:ee] for es, ee in exon_spans])
                if rng.random() < rev_frac:
                    # flip the whole gene locus to the reverse strand
                    g[cursor:pos] = (3 - g[cursor:pos])[::-1]
                if tandem_frac > 0 and rng.random() < tandem_frac:
                    # tandem gene array: the finished locus (post-rev,
                    # post-frameshift) copied k-1 more times downstream
                    span = g[cursor:pos].copy()
                    k = int(rng.integers(tandem_copies[0], tandem_copies[1]))
                    for _ in range(k - 1):
                        nxt = pos + int(rng.integers(100, 800))
                        if nxt + len(span) + 2000 >= per_ctg:
                            break
                        g[nxt:nxt + len(span)] = span
                        pos = nxt + len(span)
                cursor = pos + int(rng.integers(500, 3000))
                if cds is not None and cursor + len(cds) + 3000 < per_ctg:
                    if pseudo_mut > 0:
                        mp = rng.random(len(cds)) < pseudo_mut
                        cds = cds.copy()
                        cds[mp] = rng.integers(0, 4, int(mp.sum()),
                                               dtype=np.uint8)
                    if rng.random() < 0.5:
                        cds = (3 - cds)[::-1]
                    g[cursor:cursor + len(cds)] = cds
                    cursor += len(cds) + int(rng.integers(500, 3000))
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
                # stop-free coding monomer repeated: one giant ORF whose
                # every 6-mer indexes at array-copy occupancy
                m = int(rng.integers(satellite_monomer_aa[0],
                                     satellite_monomer_aa[1]))
                mono_aa = rng.integers(0, 20, m).astype(np.uint8)
                syn = (rng.random(m) * cod_cnt[mono_aa]).astype(np.int64)
                mono = cod_tab[mono_aa, syn].reshape(-1)
                k = int(rng.integers(satellite_copies[0],
                                     satellite_copies[1]))
                arr = np.tile(mono, k)
                if cursor + len(arr) + 2000 >= per_ctg:
                    break
                g[cursor:cursor + len(arr)] = arr
                cursor += len(arr) + int(rng.integers(500, 3000))
                # a query carrying the repeated peptide, so its lookups
                # hit the saturated buckets (boxplot cap + max_ava)
                reps = max(2, min(8, 600 // max(1, m)))
                prots.append((f"sat_c{ci}_{si}", np.tile(mono_aa, reps)))
            f.write(f">ctg{ci}\n".encode())
            _write_fasta_seq(f, _NT[g], line_len)
    with open(path_faa, "wb") as f:
        for name, p in prots:
            f.write(f">{name}\n".encode() + _AA[p].tobytes() + b"\n")
    return len(prots)


# hg38 chromosome lengths in Mb (1..22, X, Y) — the contig-count /
# length-skew shape of the reference paper's defining workload
# (GRCh38 x 21.8-25k proteins, tex/miniprot.tex:470-504)
_HG38_MB = (249, 242, 198, 190, 182, 171, 159, 145, 138, 134, 135, 133,
            114, 107, 102, 90, 83, 80, 59, 64, 47, 51, 156, 57)


def make_grch38_workload(path_fa: str, path_faa: str, *,
                         scale: float = 1.0, total_genes: int = 20_000,
                         seed: int = 38, line_len: int = 60,
                         max_exons: int = 10, max_intron: int = 20_000,
                         mut_rate: float = 0.08, rev_frac: float = 0.4,
                         fs_frac: float = 0.05, tandem_frac: float = 0.1,
                         satellites_per_ctg: int = 2,
                         splice_classes: float = 0.1) -> int:
    """GRCh38-shaped capstone workload: 24 contigs with hg38 length
    proportions (~3.06 Gbp at scale=1), total_genes multi-exon genes
    distributed proportionally to contig length, plus the adversarial
    classes (tandem arrays, satellites, genomic frameshifts,
    non-canonical splice sites, reverse strand).  This is the scale
    record VERDICT r04 demanded: contig count, length skew and memory
    shape of the reference paper's defining run, generated offline (no
    network in this environment).  Returns the protein count."""
    rng = np.random.default_rng(seed)
    cod_tab, cod_cnt = _codon_tables()
    lens = [int(mb * 1_000_000 * scale) for mb in _HG38_MB]
    total = sum(lens)
    prots = []
    with open(path_fa, "wb") as f:
        for ci, clen in enumerate(lens):
            n_genes = max(1, int(round(total_genes * clen / total)))
            g = rng.integers(0, 4, clen, dtype=np.uint8)
            cursor = 1000
            for gi in range(n_genes):
                plen = int(rng.integers(100, 700))
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
            name = f"chr{ci + 1}" if ci < 22 else ("chrX", "chrY")[ci - 22]
            f.write(f">{name}\n".encode())
            _write_fasta_seq(f, _NT[g], line_len)
            del g
    with open(path_faa, "wb") as f:
        for name, p in prots:
            f.write(f">{name}\n".encode() + _AA[p].tobytes() + b"\n")
    return len(prots)


def make_sparse_big_workload(path_fa: str, path_faa: str, *,
                             total_len: int = 2_300_000_000,
                             island_starts: tuple = (1_000_000,
                                                     2_200_000_000),
                             island_len: int = 600_000,
                             genes_per_island: int = 4,
                             max_intron: int = 20_000,
                             seed: int = 7, line_len: int = 60) -> int:
    """One contig LONGER THAN 2^31 bp: 'N' runs with small gene-bearing
    islands of real sequence, at least one past the 2,147,483,647 mark.

    This is the cheap probe of the >2Gbp coordinate regime the
    reference's 32-bit block-binned positions exist for
    (tex/miniprot.tex:172-177, NEWS.md:57).  Ambiguous bases emit no
    k-mers, so indexing and mapping stay fast, while every coordinate
    of the far island — block ids, region vs/ve, extension windows, the
    ctg.len - ve strand conversion at output — exercises int32-overflow
    territory in a numpy/C port.  Byte-vs-reference parity on this
    workload is the acceptance gate (tests/test_fuzz_vs_ref.py).

    The N runs stream to disk in bounded chunks; peak memory is one
    island plus the write buffer, not the 2.3 GB contig."""
    rng = np.random.default_rng(seed)
    cod_tab, cod_cnt = _codon_tables()
    prots = []
    # pre-rendered chunk of N lines for fast bulk writing
    n_chunk_lines = 1 << 16
    n_line = np.full(line_len + 1, ord("N"), np.uint8)
    n_line[line_len] = 0x0A
    n_chunk = np.tile(n_line, n_chunk_lines).tobytes()

    with open(path_fa, "wb") as f:
        f.write(b">big1\n")
        pos = 0  # contig coordinate; kept a multiple of line_len

        def write_n_until(target: int) -> int:
            nonlocal pos
            target = target // line_len * line_len
            while pos < target:
                take = min(target - pos, n_chunk_lines * line_len)
                lines = take // line_len
                f.write(n_chunk[: lines * (line_len + 1)])
                pos += lines * line_len
            return pos

        for isl, start in enumerate(island_starts):
            write_n_until(start)
            g = rng.integers(0, 4, island_len, dtype=np.uint8)
            cursor = 1000
            for gi in range(genes_per_island):
                plen = int(rng.integers(120, 500))
                prot = rng.integers(0, 20, plen).astype(np.uint8)
                n_ex = int(rng.integers(1, 6))
                cuts = sorted(rng.choice(np.arange(1, plen), n_ex - 1,
                                         replace=False).tolist()) \
                    if n_ex > 1 else []
                bounds = [0] + cuts + [plen]
                if cursor + plen * 3 + n_ex * max_intron + 2000 >= island_len:
                    break
                p0 = cursor
                for e in range(n_ex):
                    codes = prot[bounds[e]:bounds[e + 1]]
                    syn = (rng.random(len(codes))
                           * cod_cnt[codes]).astype(np.int64)
                    g[p0:p0 + 3 * len(codes)] = \
                        cod_tab[codes, syn].reshape(-1)
                    p0 += 3 * len(codes)
                    if e < n_ex - 1:
                        ilen = int(rng.integers(80, max_intron))
                        g[p0], g[p0 + 1] = 2, 3                    # GT
                        g[p0 + ilen - 2], g[p0 + ilen - 1] = 0, 2  # AG
                        p0 += ilen
                if rng.random() < 0.5:   # half the genes on the - strand
                    g[cursor:p0] = (3 - g[cursor:p0])[::-1]
                cursor = p0 + int(rng.integers(500, 3000))
                p = prot.copy()
                mut = rng.integers(0, plen, int(plen * 0.05))
                p[mut] = rng.integers(0, 20, len(mut)).astype(np.uint8)
                prots.append((f"prot_i{isl}_{gi}", p))
            _write_fasta_seq(f, _NT[g], line_len)
            pos += island_len
        write_n_until(total_len)
        if total_len > pos:   # sub-line tail
            f.write(b"N" * (total_len - pos) + b"\n")
    with open(path_faa, "wb") as f:
        for name, p in prots:
            f.write(f">{name}\n".encode() + _AA[p].tobytes() + b"\n")
    return len(prots)
