"""The port's device sketch (kernels/sketch_gpu.py) on the CPU, through
its plain PyTorch version, against the JAX sketch_frames on the JAX CPU
backend and the host sketch_nt4, and the index it builds against the
host build.  Exact: integer hashes and positions."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from miniprot_tpu.kernels import sketch_jax
from miniprot_tpu_torch import tables
from miniprot_tpu_torch.kernels import sketch_gpu
from miniprot_tpu_torch.kernels.sketch_gpu import SKETCH_PARAMS
from miniprot_tpu_torch.sketch import sketch_nt4
from miniprot_tpu_torch.testgen import orf_strand


def _strand(rng, n):
    return rng.choice(np.arange(5, dtype=np.uint8), n,
                      p=[.24, .24, .24, .24, .04])


@pytest.mark.parametrize("n,min_aa_len,kmer,mod_bit,code", [
    (4000, 30, 6, 1, 1), (9001, 20, 5, 2, 1), (5000, 30, 6, 1, 11)])
def test_sketch_frames_matches_jax(n, min_aa_len, kmer, mod_bit, code):
    import jax.numpy as jnp
    seq = _strand(np.random.default_rng(n), n)
    hs, ps, keep = sketch_gpu.sketch_frames(torch.from_numpy(seq),
                                            min_aa_len, kmer, mod_bit, code)
    jh, jp, jk = (np.asarray(x) for x in sketch_jax.sketch_frames(
        jnp.asarray(seq), min_aa_len, kmer, mod_bit, code))
    assert keep.numpy().any()
    assert np.array_equal(keep.numpy(), jk)
    assert np.array_equal(hs.numpy().astype(np.uint32), jh)
    assert np.array_equal(ps.numpy().astype(np.uint32), jp)


@pytest.mark.parametrize("seed", [4, 5])
def test_sketch_nt4_device_matches_host(seed):
    rng = np.random.default_rng(seed)
    for n in (2, 17, int(rng.integers(1000, 60000))):
        seq = _strand(rng, n)
        want = np.sort(sketch_nt4(seq, 30, 6, 1, 8, 77))
        got = np.sort(sketch_gpu.sketch_nt4_device(seq, 30, 6, 1, 8, 77,
                                                   device="cpu"))
        assert np.array_equal(got, want)


def test_index_build_with_cpu_sketch_matches_host(tmp_path):
    """Index.build(sketch_device="cpu") equals the host build array for
    array (the --gpu-sketch path on the plain version)."""
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt
    from miniprot_tpu_torch.testgen import make_workload
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=120_000, n_genes=4, seed=3, n_ctg=3,
                  max_intron=1500, rev_frac=0.5)
    a = Index.build(fa, IdxOpt())
    b = Index.build(fa, IdxOpt(), sketch_device="cpu")
    assert np.array_equal(a.ki, b.ki)
    assert np.array_equal(a.kb, b.kb)
    assert np.array_equal(a.bo, b.bo)


def test_device_sketch_without_device_resolves_to_the_card():
    """sketch_nt4_device runs on the card unless the caller asks for the
    CPU: without an sm_90 card it raises (never a silent CPU run)."""
    from miniprot_tpu_torch import kernels
    seq = _strand(np.random.default_rng(1), 300)
    if kernels.on_gpu_backend():
        sketch_gpu.sketch_nt4_device(seq, 30, 6, 1, 8, 0)
    else:
        with pytest.raises(RuntimeError, match="compute capability"):
            sketch_gpu.sketch_nt4_device(seq, 30, 6, 1, 8, 0)


# --- K6's packed entries (sketch_entries) against the JAX package --------

def _edge_strand(name):
    rng = np.random.default_rng(len(name))
    if name == "all N":
        return np.full(4000, 4, np.uint8)
    # "ORF longer than a tile": a run of 5000 sense codons across K6's
    # 4096-slot tile edge; "-L 2000": one of 2600 codons across it
    a, b = (600, 15600) if name == "ORF longer than a tile" else (10000, 17800)
    seq = orf_strand(rng, b + 900, 10 ** 9, p_n=0)
    seq[:a] = _strand(rng, a)
    seq[b:] = _strand(rng, 900)
    return seq


def _same_as_jax(seq, min_aa_len, kmer, mod_bit, bbit, boff, code=1):
    """sketch_entries and sketch_nt4_device on the CPU equal the JAX
    sketch_nt4_device array for array, in order."""
    want = sketch_jax.sketch_nt4_device(seq, min_aa_len, kmer, mod_bit, bbit,
                                        boff, code)
    got = sketch_gpu.sketch_entries(torch.from_numpy(seq), min_aa_len, kmer,
                                    mod_bit, bbit, boff, code)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().view(np.uint64), want)
    dev = sketch_gpu.sketch_nt4_device(seq, min_aa_len, kmer, mod_bit, bbit,
                                       boff, code, device="cpu")
    assert dev.dtype == np.uint64 and np.array_equal(dev, want)
    return want


@pytest.mark.parametrize("n,min_aa_len,kmer,mod_bit,code", [
    (4000, 30, 6, 1, 1), (9001, 20, 5, 2, 1), (5000, 30, 6, 1, 11)])
def test_sketch_entries_match_jax(n, min_aa_len, kmer, mod_bit, code):
    seq = _strand(np.random.default_rng(n), n)
    assert len(_same_as_jax(seq, min_aa_len, kmer, mod_bit, 8, 77, code))


@pytest.mark.parametrize("n", [0, 2, 3])
def test_sketch_entries_of_short_strands_match_jax(n):
    seq = _strand(np.random.default_rng(n), n)
    assert len(_same_as_jax(seq, 30, 6, 1, 8, 77)) == 0


@pytest.mark.parametrize("name,min_aa_len", [
    ("all N", 30), ("ORF longer than a tile", 30),
    ("ORF longer than a tile", 1400), ("-L 2000", 2000)])
def test_sketch_entries_of_edge_strands_match_jax(name, min_aa_len):
    got = _same_as_jax(_edge_strand(name), min_aa_len, 6, 1, 8, 5)
    assert (len(got) == 0) == (name == "all N")


# --- a torch-ops model of K6's tiling --------------------------------------

def _trailing_true(b):
    """Per row of a (..., w) bool tensor: the True-run ending at its
    last column."""
    return torch.cumprod(b.flip(-1).to(torch.int64), -1).sum(-1)


def _tiled_entries(seq, min_aa_len, kmer, mod_bit, bbit, boff, code=1, *,
                   wbits=32, words=128):
    """K6's algorithm in torch ops, at any tile: tiles of S = words x
    wbits slots per frame with a halo of one word staged on each side;
    per word (a warp's ballot in the kernel) the capped runs ending at
    its top and starting at its bottom, from the last / first word that
    is not all sense or from the carries (the capped runs just before
    and after the tile, walked past the halo up to H = max(kmer,
    min_aa_len)); per slot its capped ending / starting runs from its
    word; per (tile, frame) the count, its exclusive prefix over the
    frame's tiles and each kept window's rank.  Returns (entries in
    sketch_entries' order, counts (3, n_tiles))."""
    n = len(seq)
    S, halo = words * wbits, wbits
    H = max(kmer, min_aa_len)
    mal = max(min_aa_len, 0)
    fr, total = sketch_gpu._frames(n, kmer)
    nt = -(-(n // 3) // S)
    counts = torch.zeros(3, nt, dtype=torch.int64)
    out = torch.full((total,), -1, dtype=torch.int64)
    if n < 3:
        return out, counts
    sense, rc = sketch_gpu.sense_codes(torch.from_numpy(seq), code)
    kmask = (1 << 4 * kmer) - 1
    for p in (0, 1, 2):
        ns, _, off = fr[p]
        s, c = sense[p::3], rc[p::3]
        run_end, run_tot = sketch_gpu._run_lengths(s)
        run_start = torch.where(s, run_tot - run_end + 1, 0)
        pad = torch.zeros(halo + nt * S + halo, dtype=torch.bool)
        pad[halo:halo + ns] = s
        st = pad.unfold(0, S + 2 * halo, S)                 # (nt, S + 2 halo)
        T0 = torch.arange(nt) * S
        L = _trailing_true(st[:, :halo])
        R = _trailing_true(st[:, S + halo:].flip(-1))
        if H > halo:                                        # the walks
            tl, tr = T0 - halo - 1, T0 + S + halo
            wl = torch.where(tl >= 0, run_end[tl.clamp(0, max(ns - 1, 0))]
                             if ns else 0, 0)
            wr = torch.where(tr < ns, run_start[tr.clamp(max=max(ns - 1, 0))]
                             if ns else 0, 0)
            L = torch.where(L == halo, L + wl.clamp(max=H - halo), L)
            R = torch.where(R == halo, R + wr.clamp(max=H - halo), R)
        L, R = L.clamp(max=H), R.clamp(max=H)
        m = st[:, halo:halo + S].reshape(nt, words, wbits)  # tile words
        top = _trailing_true(m)
        bot = _trailing_true(m.flip(-1))
        part = ~m.all(-1)
        k = torch.arange(words)
        jb = torch.cummax(torch.where(part, k, -1), -1).values
        ja = words - 1 - torch.cummax(torch.where(part.flip(-1), k, -1),
                                      -1).values.flip(-1)
        ja = torch.where(ja > words - 1, words, ja)
        E = torch.where(jb >= 0, wbits * (k - jb)
                        + top.gather(1, jb.clamp(min=0)),
                        wbits * (k + 1) + L[:, None]).clamp(max=H)
        Sr = torch.where(ja < words, wbits * (ja - k)
                         + bot.gather(1, ja.clamp(max=words - 1)),
                         wbits * (words - k) + R[:, None]).clamp(max=H)
        eprev = torch.cat([L[:, None], E[:, :-1]], 1)
        snext = torch.cat([Sr[:, 1:], R[:, None]], 1)
        b = torch.arange(wbits)
        hz = torch.cummax(torch.where(~m, b, -1), -1).values
        lz = wbits - 1 - torch.cummax(torch.where(~m.flip(-1), b, -1),
                                      -1).values.flip(-1)
        ending = torch.where(hz >= 0, b - hz, b + 1 + eprev[..., None])
        starting = torch.where(lz < wbits, lz - b,
                               wbits - b + snext[..., None])
        # the run's total, ending + starting - 1, is exact below H; a
        # capped H alone reaches min_aa_len (H >= mal)
        ok = (ending >= kmer) & (ending + starting > mal)
        j = (T0[:, None] + torch.arange(S)).reshape(nt, words, wbits)
        cp = torch.cat([torch.zeros(kmer, dtype=torch.int64), c,
                        torch.zeros(nt * S - ns, dtype=torch.int64)])
        key = torch.zeros_like(j)
        for i in range(kmer):
            key |= cp[j + kmer - i] << 4 * i
        y = sketch_gpu._hash32(key, kmask)
        keep = (ok & ((y & ((1 << mod_bit) - 1)) == 0)).reshape(nt, S)
        counts[p] = keep.sum(1)
        excl = torch.cumsum(counts[p], 0) - counts[p]
        rank = torch.cumsum(keep.to(torch.int64), 1) - 1
        dest = (off + excl[:, None] + rank)[keep]
        out[dest] = sketch_gpu.pack_entries((y >> mod_bit).reshape(nt, S)[keep],
                                            p + 2 + 3 * j.reshape(nt, S)[keep],
                                            bbit, boff)
    return torch.cat([out[f[2]:f[2] + int(counts[p].sum())]
                      for p, f in enumerate(fr)]), counts


def _plain_tile_counts(seq, min_aa_len, kmer, mod_bit, S):
    """Kept windows per (frame, tile) from sketch_frames_plain."""
    n = len(seq)
    nt = -(-(n // 3) // S)
    fr, _ = sketch_gpu._frames(n, kmer)
    _, _, keep = sketch_gpu.sketch_frames_plain(torch.from_numpy(seq),
                                                min_aa_len, kmer, mod_bit)
    counts = torch.zeros(3, nt, dtype=torch.int64)
    for p, (_, nw, off) in enumerate(fr):
        last = torch.nonzero(keep[off:off + nw]).reshape(-1) + kmer - 1
        counts[p] = torch.bincount(last // S, minlength=nt)
    return counts


def _check_tiling(seq, min_aa_len, kmer=6, mod_bit=1, **geom):
    want = sketch_gpu.sketch_entries_plain(torch.from_numpy(seq), min_aa_len,
                                           kmer, mod_bit, 8, 77)
    got, counts = _tiled_entries(seq, min_aa_len, kmer, mod_bit, 8, 77,
                                 **geom)
    assert torch.equal(got, want)
    S = geom.get("words", 128) * geom.get("wbits", 32)
    assert torch.equal(counts, _plain_tile_counts(seq, min_aa_len, kmer,
                                                  mod_bit, S))
    return len(want)


def _n_at_tile_edges(seq, S):
    """N at and beside every tile edge (3 S bases a tile)."""
    seq = seq.copy()
    for e in range(0, len(seq), 3 * S):
        for d in (-4, -1, 0, 2, 3):
            if 0 <= e + d < len(seq):
                seq[e + d] = 4
    return seq


@pytest.mark.parametrize("wbits,words", [(32, 128), (8, 4), (4, 2), (32, 1)])
@pytest.mark.parametrize("kind", ["random", "ORFs", "N at tile edges"])
def test_tiling_model_matches_plain(wbits, words, kind):
    """The kernel's tile logic at its own tile (128 words of 32 slots)
    and at tiles of 32, 8 and 32 slots, so that runs cross many tile
    edges; -L 30 is wider than the 8- and 32-slot tiles' halos."""
    rng = np.random.default_rng(wbits * 100 + words)
    S = wbits * words
    if kind == "random":
        seq = _strand(rng, 3 * S * 5 + 7)
    else:
        seq = orf_strand(rng, max(3 * S * 5, 4000) + 2, 80, p_n=0.0005)
        if kind == "N at tile edges":
            seq = _n_at_tile_edges(seq, S)
    for min_aa_len in (30, 3, 0):
        _check_tiling(seq, min_aa_len, wbits=wbits, words=words)


@pytest.mark.parametrize("min_aa_len,kmer,mod_bit", [
    (2000, 6, 1), (700, 5, 2), (90, 8, 0), (40, 1, 3)])
def test_tiling_model_with_h_wider_than_a_tile(min_aa_len, kmer, mod_bit):
    """H = max(kmer, min_aa_len) past the staged halo and past a whole
    tile (the walks), on strands of long ORFs."""
    rng = np.random.default_rng(min_aa_len)
    seq = orf_strand(rng, 40000, 1.5 * max(min_aa_len, 30), p_n=0)
    for wbits, words in ((32, 128), (8, 4)):
        assert _check_tiling(seq, min_aa_len, kmer, mod_bit, wbits=wbits,
                             words=words)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(n=st.integers(0, 2000), run=st.integers(2, 400),
       edge_n=st.booleans(), min_aa_len=st.integers(-2, 120))
def test_tiling_model_over_lengths(n, run, edge_n, min_aa_len):
    """Hypothesis (derandomized) draws strand lengths, ORF lengths, N at
    tile edges and -L, at 16-slot tiles."""
    seq = orf_strand(np.random.default_rng(n), n, run, p_n=0.0005)
    if edge_n:
        seq = _n_at_tile_edges(seq, 16)
    _check_tiling(seq, min_aa_len, wbits=8, words=2)


def test_sketch_params_mirror_the_kernel_struct():
    """SKETCH_PARAMS lists sketch_orf.cu's SketchParams field for field,
    TILE_SLOTS is its kSlots, and the block holds the tables."""
    import pathlib
    import re
    src = (pathlib.Path(sketch_gpu.__file__).parent / "csrc"
           / "sketch_orf.cu").read_text()
    body = re.search(r"struct SketchParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"uint8_t (\w+)\[(\d+)\];", body)
    assert [(f, int(k)) for f, k in fields] == [
        (f, SKETCH_PARAMS[f].shape[0]) for f in SKETCH_PARAMS.names]
    assert f"constexpr int kSlots = {sketch_gpu.TILE_SLOTS};" in src
    T = tables.get_tables(11)
    p = sketch_gpu.sketch_params(11)
    assert p.dtype == SKETCH_PARAMS and p.shape == (1,)
    assert np.array_equal(p["codon"][0], T.codon)
    assert np.array_equal(p["codon13"][0], T.codon13)
