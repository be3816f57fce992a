"""Import hygiene of the PyTorch port: it never imports jax or anything
of miniprot_tpu, and asking for the card without one raises."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "miniprot_tpu_torch"

_PROBE = """
import sys
import miniprot_tpu_torch
from miniprot_tpu_torch import cli, convert, device, pipeline  # noqa
from miniprot_tpu_torch.kernels import nasw_cigar_scan, nasw_ext  # noqa
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "miniprot_tpu"
             or m.startswith("miniprot_tpu."))
print(",".join(bad))
"""


def test_port_imports_leave_jax_and_miniprot_tpu_out():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "", f"imported: {r.stdout.strip()}"


_IMPORT_RE = re.compile(
    r"^\s*(?:from\s+(jax|miniprot_tpu)(?:\.[\w.]*)?\s+import"
    r"|import\s+(jax|miniprot_tpu)(?:\.[\w.]*)?\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_source_has_no_forbidden_import(path):
    src = (ROOT / path).read_text()
    assert not _IMPORT_RE.search(src), path


def test_no_card_here_and_cuda_request_raises():
    import torch

    from miniprot_tpu_torch import kernels
    from miniprot_tpu_torch.device import GpuExtEngine
    from miniprot_tpu_torch.options import MapOpt
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert kernels.on_gpu_backend() is False
    assert kernels.default_device() == torch.device("cuda")
    with pytest.raises(RuntimeError, match="compute capability"):
        kernels.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        GpuExtEngine(MapOpt())                   # the default is the card
    assert GpuExtEngine(MapOpt(), "cpu").device == torch.device("cpu")
