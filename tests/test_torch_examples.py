"""examples/api_demo_torch.py, the GPU variant of the API demo, on the
CPU (--cpu: the engine on the kernels' plain versions): the same lines
as examples/api_demo.py, the JAX package's host-engine demo, on a tiny
testgen genome."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _demo(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                        *args], capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_torch_demo_prints_the_jax_demo_lines(tmp_path):
    from miniprot_tpu_torch.testgen import make_workload
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=40_000, n_genes=3, seed=5, n_ctg=2,
                  max_intron=1000, rev_frac=0.5)
    want = _demo("api_demo.py", fa, faa)
    assert want.count("\n") >= 2
    assert _demo("api_demo_torch.py", "--cpu", fa, faa) == want
