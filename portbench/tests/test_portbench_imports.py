"""No module of the benchmark imports JAX or the JAX package; the
reference, the generators and the yardstick import nothing of the port
either.  Top-level names are compared whole: ``miniprot_tpu_torch`` is
the port, ``miniprot_tpu`` the JAX package."""

import ast
import os

from portbench import core

HERE = os.path.join(core.ROOT, "portbench")
NEVER = {"jax", "jaxlib", "flax", "miniprot_tpu"}
# modules that must not import the port: the reference and its inputs
INDEPENDENT = ("refmap/", "workgen.py", "check.py", "work.py",
               "control.py")


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                yield os.path.relpath(path, HERE), path


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    seen = 0
    for rel, path in _modules():
        seen += 1
        bad = set(_top_names(path)) & NEVER
        assert not bad, f"{rel} imports {bad}"
    assert seen > 20


def test_reference_imports_nothing_of_the_port():
    for rel, path in _modules():
        if rel.startswith(INDEPENDENT):
            names = set(_top_names(path))
            assert "miniprot_tpu_torch" not in names, rel
            assert "torch" not in names, rel


def test_importing_the_reference_loads_no_port():
    import subprocess
    import sys
    code = ("import sys; import portbench.check, portbench.control, "
            "portbench.refmap.run, portbench.work; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'miniprot_tpu', "
            "'miniprot_tpu_torch', 'torch')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
