"""The port's device sketch (kernels/sketch_gpu.py) on the CPU, through
its plain PyTorch version, against the JAX sketch_frames on the JAX CPU
backend and the host sketch_nt4, and the index it builds against the
host build.  Exact: integer hashes and positions."""
import numpy as np
import pytest
import torch

from miniprot_tpu.kernels import sketch_jax
from miniprot_tpu_torch.kernels import sketch_gpu
from miniprot_tpu_torch.sketch import sketch_nt4


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
