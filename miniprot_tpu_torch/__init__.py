"""miniprot_tpu_torch — the PyTorch/CUDA port of miniprot_tpu.

A protein-to-genome aligner with lh3/miniprot's output, whose
alignment DPs run on hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).  The host layer (index, seeding, chaining, refinement,
output) is this package's own copy of miniprot_tpu's host modules and
its native C engine; the device layer is new:

    kernels/nasw_ext.py         extension DP        (CUDA kernel K1)
    kernels/nasw_cigar_scan.py  scan CIGAR DP + walk (K2, K3)
    device.py                   GpuExtEngine: batching + host routing
    daemon.py                   one process owns the card; engines
                                elsewhere ship it their batches
    pipeline.py / cli.py        map_file(device="cuda"|"cpu"|None)
    convert.py                  index / options state from miniprot_tpu

Entry points run on the card unless the caller asks for the CPU, where
every kernel runs as its plain PyTorch version.
"""

__version__ = "0.1.0"
MP_VERSION = "0.18-r281"  # reference parity version (miniprot.h:6)

from .options import IdxOpt, MapOpt  # noqa: F401,E402
