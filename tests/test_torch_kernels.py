"""The ctypes bindings of the CUDA kernel library against the C entry
points in kernels/csrc (read as text, so this runs without nvcc): every
argument type in order, and the widths each launch switch is built for.
ctypes passes arguments beyond a signature unconverted, so a short
signature corrupts the stream argument instead of failing."""
import ctypes as ct
import pathlib
import re

import pytest

from miniprot_tpu_torch import kernels
from miniprot_tpu_torch.kernels import (nasw_cigar_scan, nasw_cigar_striped,
                                        nasw_ext)

CSRC = pathlib.Path(kernels.__file__).parent / "csrc"
_C_TYPES = {"void*": ct.c_void_p, "int": ct.c_int, "longlong": ct.c_longlong}


def _entry(name):
    """(parameter ctypes, body) of `extern "C" int name(...) {...}`."""
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)\s*\{", text)
        if m:
            body = text[m.end():text.index("\n}\n", m.end())]
            params = []
            for p in m.group(1).split(","):
                p = p.replace("const", "").split()
                ctype = "".join(p[:-1]) + ("*" if p[-1].startswith("*")
                                           else "")
                params.append(_C_TYPES[ctype])
            return params, body
    raise AssertionError(f"no C entry point {name}")


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_signature_matches_c_entry(name):
    params, _ = _entry(name)
    assert kernels._SIGNATURES[name] == params


@pytest.mark.parametrize("name,widths", [
    ("mp_ext_dp", nasw_ext.EXT_WIDTHS),
    ("mp_scan_cigar", nasw_cigar_scan.SCAN_WIDTHS),
    ("mp_striped_cigar", nasw_cigar_striped.STRIPED_WIDTHS)])
def test_launch_switch_builds_the_wrapper_widths(name, widths):
    _, body = _entry(name)
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", body))
    assert cases == tuple(widths)


def test_striped_switch_geometry_is_striped_warps():
    """mp_striped_cigar picks K4's geometry from W alone; STRIPED_WARPS
    (what chip_smoke.py and the card tests report) must name the same
    warps per problem as each case's instantiation."""
    _, body = _entry("mp_striped_cigar")
    cases = {int(w): int(nwp) for w, nwp in
             re.findall(r"case (\d+): MP_B4\(\d+, (\d+)\)", body)}
    assert cases == nasw_cigar_striped.STRIPED_WARPS
