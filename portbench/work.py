"""Work counts of the DP recurrences and the card's peak rates: the
yardstick of ``kernels.dp_roofline``.

Each count belongs to a recurrence, not to a kernel: whatever kernel
computes a recurrence, the same cells need the same operations, so a
rewritten kernel cannot change its own yardstick.  A cell is one
(genome row i, query column j) of a problem; the unpadded cells of a
problem with a genome window of ``nl`` bases and a query of ``al``
residues are ``nl * al``.

The recurrence (miniprot's nasw-sse.c:15-22, the paper's Eq. 5), on
saturating int16 values, with q = go + ge, e = ge, r = io, d(i) the
donor score of row i, a(i) the acceptor's, s(i, j) the substitution
score and f the frameshift penalty:

    I(i,j) = max{H(i,j-1) - q, I(i,j-1)} - e
    D(i,j) = max{H(i-3,j) - q, D(i-3,j)} - e
    A(i,j) = max{H(i-1,j) - r - d(i-1), A(i-1,j)}
    B(i,j) = max{H(i-1,j-1) - r - d(i), B(i-1,j)}
    C(i,j) = max{H(i-1,j-1) - r - d(i+1), C(i-1,j)}
    H(i,j) = max{H(i-3,j-1) + s(i,j), I, D, A - a(i), B - a(i-2),
                 C - a(i-1), H(i-1,j) - f, H(i-2,j) - f,
                 H(i-1,j-1) - f, H(i-2,j-1) - f}

Operations a cell needs at the least, sharing every term that can be
shared (a row's r + d(i) folded once per row, one H - q and one H - f
per cell reused by its neighbours):

    H - q                         1
    I, D: a max and a subtract    2 + 2
    A, B, C: a subtract, a max    2 + 2 + 2
    H: s added                    1
    H: A, B, C less acceptors     3
    H - f                         1
    H: the max of 10 candidates   9
                                 --
    the recurrence               25

    extension (K7 + K1): + 1, the running best score that the x-drop
    and the end choice read                           = 26 a cell
    gap filling with traceback (K7 + K2 + K3, or K4 + K5): + 5, one
    compare a cell for each of I, D, A, B, C (open or extend), + 1 to
    record which of H's candidates won                = 31 a cell

Bytes a problem needs at the least: its genome window (one byte a
base; the splice tracks and the translation are derived from it on the
card), its query (one byte a residue) and its result (an extension's
score and two end positions, 3 x 4 bytes; a gap filling's score, 4
bytes, its CIGAR not counted).  The traceback could stay on chip, so
none of it is counted.

Peaks, for one NVIDIA H100 SXM5 (80 GB HBM3) at its 700 W limit:

    HBM3 bandwidth          3.35e12 B/s (NVIDIA's data sheet)
    int16 DP operations     132 SMs x 64 int32 lanes a clock x 2 int16
                            halves a lane (the s16x2 forms) x 2
                            operations an instruction (the DPX fused
                            forms, such as __viaddmax_s16x2: an add and
                            a max) x 1.98e9 clocks a second (the boost
                            clock) = 6.69e13 op/s
    int32 DP operations     the same without the two halves (the
                            int32 recurrence of Dp32Batch)
                            = 3.35e13 op/s

The op rates are the most the card could give these operations, so a
share against them is never too high.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES, HALVES, FUSED, CLOCK_HZ = 132, 64, 2, 2, 1.98e9
INT16_OPS_PER_S = SMS * INT32_LANES * HALVES * FUSED * CLOCK_HZ
INT32_OPS_PER_S = SMS * INT32_LANES * FUSED * CLOCK_HZ

OPS_PER_CELL = {"ext": 26, "cigar": 31, "cigar32": 31}
OPS_PER_S = {"ext": INT16_OPS_PER_S, "cigar": INT16_OPS_PER_S,
             "cigar32": INT32_OPS_PER_S}
RESULT_BYTES = {"ext": 12, "cigar": 4, "cigar32": 4}


def work(kind: str, nl: np.ndarray, al: np.ndarray) -> tuple[float, float]:
    """(operations, bytes) the problems of one launch need at the
    least: ``nl`` and ``al`` are their genome and query lengths."""
    nl = np.asarray(nl, np.float64)
    al = np.asarray(al, np.float64)
    ops = OPS_PER_CELL[kind] * float(np.sum(nl * al))
    nbytes = float(np.sum(nl + al)) + RESULT_BYTES[kind] * len(nl)
    return ops, nbytes


def least_seconds(launched: dict) -> float:
    """The least time the card needs for every launched problem,
    ``launched`` = {recurrence: [(nl, al), ...] a launch}: the larger of
    the operations' time at their rates and all bytes over the
    bandwidth."""
    op_s = nbytes = 0.0
    for kind, launches in launched.items():
        for nl, al in launches:
            o, b = work(kind, nl, al)
            op_s += o / OPS_PER_S[kind]
            nbytes += b
    return max(op_s, nbytes / HBM_BYTES_PER_S)
