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
from miniprot_tpu_torch import benchmarks, cli, convert, device  # noqa
from miniprot_tpu_torch import pipeline, server  # noqa
from miniprot_tpu_torch.kernels import nasw_cigar_scan, nasw_ext  # noqa
from miniprot_tpu_torch.kernels import nasw_cigar_striped, sketch_gpu  # noqa
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


@pytest.mark.parametrize("cls", [
    "nasw_ext.ExtBatch", "nasw_ext.RawExtBatch",
    "nasw_cigar_scan.ScanCigarBatch", "nasw_cigar_scan.RawScanCigarBatch",
    "nasw_cigar_scan.SmallScanCigarBatch", "nasw_cigar_striped.CigarBatch",
    "nasw_cigar_striped.RawCigarBatch", "nasw_cigar_striped.SmallCigarBatch",
    "nasw_cigar_striped.Dp32Batch"])
def test_batch_without_device_resolves_to_the_card(cls):
    """A batch built without ``device`` runs on the card: it resolves to
    cuda, or raises where there is no sm_90 card (never a silent CPU
    run)."""
    import importlib

    import torch

    from miniprot_tpu_torch import kernels, tables
    mod, name = cls.split(".")
    klass = getattr(importlib.import_module(
        f"miniprot_tpu_torch.kernels.{mod}"), name)
    kw = {"sp": tables.splice_model_scores(1)} if "Raw" in name \
        or "Small" in name else {}
    args = (32, 256, tables.BLOSUM62, (11, 1, 23, 29, 100, 5, 0.5))
    if kernels.on_gpu_backend():
        assert klass(*args, **kw).device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="compute capability"):
            klass(*args, **kw)
    assert klass(*args, device="cpu", **kw).device == torch.device("cpu")
