"""Build the reference's native host runtime on demand.

A frozen copy of the port's host C engine (mpnative.c), built into the
benchmark's own directory of the checkout, ``build/portbench/``, and
rebuilt whenever the source is newer than the shared object.

``PORTBENCH_REF_DP=int8`` selects the control build instead: the same
source compiled with ``-DREF_SAT8``, whose saturating DP arithmetic
clamps at int8's range where the reference clamps at int16's
(the nearest precision below the one the port computes in: the
benchmark's control).  It is a separate library, so a process holds
one or the other.
"""

from __future__ import annotations

import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "mpnative.c")
# <checkout>/build/portbench: portbench/refmap/native -> <checkout>
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_DIR))), "build",
    "portbench")

CFLAGS = ["-O3", "-std=c11", "-ffp-contract=off", "-fPIC", "-shared",
          "-fvisibility=hidden", "-Wall",
          "-Werror=int-conversion", "-Werror=incompatible-pointer-types",
          "-Werror=implicit-function-declaration"]

VARIANTS = {"int16": ("libmpref.so", []),
            "int8": ("libmpref_int8.so", ["-DREF_SAT8"])}


def variant() -> str:
    v = os.environ.get("PORTBENCH_REF_DP", "int16")
    if v not in VARIANTS:
        raise ValueError(f"PORTBENCH_REF_DP={v!r}: not one of "
                         f"{sorted(VARIANTS)}")
    return v


def ensure_built() -> str:
    """Compile the selected variant if stale; return its path."""
    name, extra = VARIANTS[variant()]
    so = os.path.join(BUILD_DIR, name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(SRC)):
        cc = os.environ.get("CC", "cc")
        # compile to a private temp then atomically replace: a process
        # loading it mid-compile must never see a half-written .so
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run([cc, *CFLAGS, *extra, SRC, "-o", tmp, "-lm"],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so
