"""The check that decides ``correct``: the port's GFF output against the
reference's, protein by protein.

A sample of proteins drawn from the seed, with the longest among them,
is mapped by the reference (``portbench.refmap``, which builds its own
index from the same FASTA).  Every map of the window is then compared
with it, protein by protein, after the mRNA ids are numbered from 1
within each protein on both sides (the port numbers them across the
whole file).  The number compared is how many (map, protein) pairs
differ; its limit is 0, an exact comparison.
"""

from __future__ import annotations

import re

import numpy as np

_ID = re.compile(r"\b(ID|Parent)=([^;\s]+)")


def read_fasta(path: str) -> list[tuple[str, bytes]]:
    """(name, sequence) of each record of a FASTA file."""
    out, name, seq = [], None, []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, b"".join(seq)))
                name, seq = line[1:].split()[0].decode(), []
            else:
                seq.append(line)
    if name is not None:
        out.append((name, b"".join(seq)))
    return out


def split_blocks(text: str) -> dict[str, str]:
    """{protein: its lines} of a GFF3 output with ``##PAF`` lines: each
    hit starts with its ``##PAF`` line, and a protein's hits are
    consecutive.  Ids are renumbered within each protein."""
    blocks: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        if line.startswith("##PAF\t"):
            cur = line.split("\t", 2)[1]
            blocks.setdefault(cur, []).append(line)
        elif line.startswith("#"):
            continue
        elif cur is not None:
            blocks[cur].append(line)
        else:
            blocks.setdefault("", []).append(line)
    return {k: normalise("\n".join(v)) for k, v in blocks.items()}


def normalise(block: str) -> str:
    """A protein's lines with its mRNA ids numbered from 1 in order of
    first appearance."""
    ids: dict[str, str] = {}

    def sub(m):
        return f"{m.group(1)}=#{ids.setdefault(m.group(2), str(len(ids) + 1))}"
    return _ID.sub(sub, block.rstrip("\n"))


def sample(prots: list[tuple[str, bytes]], traffic: dict, seed: int):
    """The proteins checked: ``check_sample`` drawn from the seed plus
    the ``check_longest`` longest, in file order."""
    n = len(prots)
    rng = np.random.default_rng([seed % (1 << 63), 0x5EED])
    pick = set(rng.choice(n, size=min(int(traffic["check_sample"]), n),
                          replace=False).tolist())
    lens = np.array([len(s) for _, s in prots])
    pick.update(np.argsort(-lens, kind="stable")
                [:int(traffic["check_longest"])].tolist())
    return [prots[i] for i in sorted(pick)]


def reference_blocks(fa: str, prots, config: dict,
                     n_threads: int) -> dict[str, str]:
    """{name: normalised output} of ``prots`` on the reference (or on
    the control, in a process started with PORTBENCH_REF_DP=int8)."""
    from .refmap.index import Index
    from .refmap.run import make_opts, map_gff
    io, mo = make_opts(config["map"])
    mi = Index.build(fa, io, n_threads=n_threads)
    got = map_gff(mi, mo, prots, n_threads=n_threads)
    return {k: normalise(v) for k, v in got.items()}


def count_differing(ref: dict[str, str], maps: list[dict[str, str]]):
    """(pairs that differ, first few of them) of each map against the
    reference, over the reference's proteins."""
    bad = []
    for i, blocks in enumerate(maps):
        for name, want in ref.items():
            if blocks.get(name, "") != want:
                bad.append((i, name))
    return len(bad), bad[:5]


def check_maps(fa: str, faa: str, outputs: list[str], config: dict,
               traffic: dict, seed: int, n_threads: int = 1) -> dict:
    """The verdict on a window's maps (GFF files ``outputs``)."""
    prots = sample(read_fasta(faa), traffic, seed)
    ref = reference_blocks(fa, prots, config, n_threads)
    maps = []
    for path in outputs:
        with open(path) as f:
            maps.append(split_blocks(f.read()))
    n_bad, first = count_differing(ref, maps)
    if first:
        import sys
        for i, name in first:
            sys.stderr.write(f"[portbench] map {i}, protein {name}: the "
                             "port's output differs from the reference's\n")
    return {"correct": n_bad == 0, "failed": n_bad,
            "checked": len(ref),
            "compared": {"differing": {"value": n_bad, "limit": 0}}}
