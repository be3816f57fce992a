"""Build the native host runtime (libmpnative.so) on demand.

The library is rebuilt automatically whenever the source is newer than
the shared object.  FP contraction is disabled so the float32 arithmetic
in chain gap costs matches the reference build (-std=c99 implies
-ffp-contract=off there; we pin it explicitly).
"""

from __future__ import annotations

import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "mpnative.c")
# every build output of the package (this library and the CUDA kernel
# library) lives in one directory outside the source tree
BUILD_DIR = os.environ.get(
    "MINIPROT_TORCH_BUILD",
    os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                 "miniprot_tpu_torch"))
SO = os.path.join(BUILD_DIR, "libmpnative.so")

CFLAGS = ["-O3", "-std=c11", "-ffp-contract=off", "-fPIC", "-shared",
          "-fvisibility=hidden", "-Wall",
          # the silent-capture build must hard-fail on the warning
          # classes that indicate real type bugs
          "-Werror=int-conversion", "-Werror=incompatible-pointer-types",
          "-Werror=implicit-function-declaration"]


def ensure_built() -> str:
    """Compile libmpnative.so if stale.

    MINIPROT_TPU_ASAN=1 builds an AddressSanitizer variant instead (the
    reference's `make asan=1` analog, Makefile:12-15) into a separate
    .so; run python under
        LD_PRELOAD=$(cc -print-file-name=libasan.so) MINIPROT_TPU_ASAN=1
    so the sanitizer runtime loads first (see tools/asan_check.sh).
    """
    asan = os.environ.get("MINIPROT_TPU_ASAN") == "1"
    so = SO.replace(".so", ".asan.so") if asan else SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(SRC)):
        cc = os.environ.get("CC", "cc")
        flags = list(CFLAGS)
        if asan:
            flags = ["-O1", "-g", "-fsanitize=address",
                     "-fno-omit-frame-pointer"] + flags[1:]
        # compile to a private temp then atomically replace: a process
        # dlopen-ing mid-compile must never see a half-written .so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [cc, *flags, SRC, "-o", tmp, "-lm"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so
