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


def test_dp32_switch_geometry_is_dp32_warps():
    """mp_striped_cigar32 runs B4' on the geometry of the class width
    above W; DP32_WARPS names each class's warps per problem, and each
    instantiation's positions per thread times its threads span the
    class."""
    _, body = _entry("mp_striped_cigar32")
    cases = {int(w): (int(p), int(nwp)) for w, p, nwp in
             re.findall(r"case (\d+): MP_B4P\((\d+), (\d+)\)", body)}
    assert {w: nwp for w, (_, nwp) in cases.items()} == \
        nasw_cigar_striped.DP32_WARPS
    assert all(p * 32 * nwp == w for w, (p, nwp) in cases.items())
    assert [nasw_cigar_striped.dp32_class(W) for W in (4, 32, 36, 300, 512,
                                                       1000, 1024)] == \
        [32, 32, 128, 512, 512, 1024, 1024]


def test_kernel_functions_name_each_counter_and_a_global():
    """KERNEL_FUNCTIONS maps every launch counter to a __global__
    function of the sources (the name a profiler trace gives it)."""
    assert set(kernels.KERNEL_FUNCTIONS) == set(kernels.LAUNCHES)
    src = "".join(p.read_text() for p in CSRC.glob("*.cu"))
    glob = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                          r"\)\s+)?(\w+)", src))
    assert set(kernels.KERNEL_FUNCTIONS.values()) == glob


def test_trace_kernel_times_sums_kernel_events(tmp_path):
    """Kernel events (one per launch) are summed per __global__ function
    whatever their template arguments; events of other categories and
    kernels of other libraries are left out."""
    import json
    events = [
        {"cat": "kernel", "name": "void ext_dp_kernel<4, 1, false>(signed "
         "char const*, int const*)", "dur": 1500.0},
        {"cat": "kernel", "name": "void ext_dp_kernel<1, 4, true>(signed "
         "char const*, int const*)", "dur": 500.0},
        {"cat": "kernel", "name": "track_prep_kernel", "dur": 20.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 5.0},
        {"cat": "kernel", "name": "void at::native::vectorized_elementwise"
         "_kernel<4>(int)", "dur": 7.0},
        {"cat": "cpu_op", "name": "aten::copy_", "dur": 9.0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert kernels.trace_kernel_times(str(path)) == {
        "ext_dp_kernel": (2, 2.0), "track_prep_kernel": (1, 0.02)}
