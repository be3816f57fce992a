"""Alphabets, genetic-code tables and scoring matrices.

Reproduces the constant tables of the reference aligner exactly
(reference: nasw-tab.c:6-107, nasw.h:56-59).  All tables are NumPy arrays
so they can be fed straight into JAX gathers on device.

Encodings:
  nt4:   A,C,G,T -> 0..3, anything else -> 4
  aa20:  "ARNDCQEGHILKMFPSTWYV*X" -> 0..21, anything else -> 21 (X)
  aa13:  20-letter -> 13-letter reduced alphabet (SE-B(14) variant);
         codes >= 14 ('*' -> 14, unknown -> 15) terminate k-mers
  codon: 6-bit codon (base-4 big-endian, A=0) -> aa20 code
"""

from __future__ import annotations

import numpy as np

NT_I2C = "ACGTN"
AA_I2C = "ARNDCQEGHILKMFPSTWYV*X"

# 20-letter -> reduced 13-letter alphabet (nasw-tab.c:12)
A2R = np.array([0, 2, 4, 4, 6, 5, 5, 8, 3, 10, 11, 2, 11, 12, 7, 1, 1, 13, 12, 10, 14, 15],
               dtype=np.uint8)

MAX_TRANS_CODE = 33

# NCBI genetic codes, codon order AAA, AAC, AAG, AAT, ACA, ... (base order ACGT)
# (standard public data; layout follows nasw-tab.c:16-55)
_CODON_TABLES = {
    1:  "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    2:  "KNKNTTTT*S*SMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    3:  "KNKNTTTTRSRSMIMIQHQHPPPPRRRRTTTTEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    4:  "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    5:  "KNKNTTTTSSSSMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    6:  "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVQYQYSSSS*CWCLFLF",
    9:  "NNKNTTTTSSSSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    10: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSCCWCLFLF",
    11: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    12: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLSLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    13: "KNKNTTTTGSGSMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    14: "NNKNTTTTSSSSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVYY*YSSSSWCWCLFLF",
    15: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*YQYSSSS*CWCLFLF",
    16: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*YLYSSSS*CWCLFLF",
    21: "NNKNTTTTSSSSMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    22: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*YLY*SSS*CWCLFLF",
    23: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWC*FLF",
    24: "KNKNTTTTSSKSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    25: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSGCWCLFLF",
    26: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLALEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    27: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVQYQYSSSSWCWCLFLF",
    28: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVQYQYSSSSWCWCLFLF",
    29: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVYYYYSSSS*CWCLFLF",
    30: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVEYEYSSSS*CWCLFLF",
    31: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVEYEYSSSSWCWCLFLF",
    32: "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*YWYSSSS*CWCLFLF",
    33: "KNKNTTTTSSKSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVYY*YSSSSWCWCLFLF",
}

# BLOSUM62 extended with '*' and 'X' rows/columns, 22x22 (nasw-tab.c:59-83)
BLOSUM62 = np.array([
    [ 4,-1,-2,-2, 0,-1,-1, 0,-2,-1,-1,-1,-1,-2,-1, 1, 0,-3,-2, 0,-4, 0],
    [-1, 5, 0,-2,-3, 1, 0,-2, 0,-3,-2, 2,-1,-3,-2,-1,-1,-3,-2,-3,-4,-1],
    [-2, 0, 6, 1,-3, 0, 0, 0, 1,-3,-3, 0,-2,-3,-2, 1, 0,-4,-2,-3,-4,-1],
    [-2,-2, 1, 6,-3, 0, 2,-1,-1,-3,-4,-1,-3,-3,-1, 0,-1,-4,-3,-3,-4,-1],
    [ 0,-3,-3,-3, 9,-3,-4,-3,-3,-1,-1,-3,-1,-2,-3,-1,-1,-2,-2,-1,-4,-2],
    [-1, 1, 0, 0,-3, 5, 2,-2, 0,-3,-2, 1, 0,-3,-1, 0,-1,-2,-1,-2,-4,-1],
    [-1, 0, 0, 2,-4, 2, 5,-2, 0,-3,-3, 1,-2,-3,-1, 0,-1,-3,-2,-2,-4,-1],
    [ 0,-2, 0,-1,-3,-2,-2, 6,-2,-4,-4,-2,-3,-3,-2, 0,-2,-2,-3,-3,-4,-1],
    [-2, 0, 1,-1,-3, 0, 0,-2, 8,-3,-3,-1,-2,-1,-2,-1,-2,-2, 2,-3,-4,-1],
    [-1,-3,-3,-3,-1,-3,-3,-4,-3, 4, 2,-3, 1, 0,-3,-2,-1,-3,-1, 3,-4,-1],
    [-1,-2,-3,-4,-1,-2,-3,-4,-3, 2, 4,-2, 2, 0,-3,-2,-1,-2,-1, 1,-4,-1],
    [-1, 2, 0,-1,-3, 1, 1,-2,-1,-3,-2, 5,-1,-3,-1, 0,-1,-3,-2,-2,-4,-1],
    [-1,-1,-2,-3,-1, 0,-2,-3,-2, 1, 2,-1, 5, 0,-2,-1,-1,-1,-1, 1,-4,-1],
    [-2,-3,-3,-3,-2,-3,-3,-3,-1, 0, 0,-3, 0, 6,-4,-2,-2, 1, 3,-1,-4,-1],
    [-1,-2,-2,-1,-3,-1,-1,-2,-2,-3,-3,-1,-2,-4, 7,-1,-1,-4,-3,-2,-4,-2],
    [ 1,-1, 1, 0,-1, 0, 0, 0,-1,-2,-2, 0,-1,-2,-1, 4, 1,-3,-2,-2,-4, 0],
    [ 0,-1, 0,-1,-1,-1,-1,-2,-2,-1,-1,-1,-1,-2,-1, 1, 5,-2,-2, 0,-4, 0],
    [-3,-3,-4,-4,-2,-2,-3,-2,-2,-3,-2,-3,-1, 1,-4,-3,-2,11, 2,-3,-4,-2],
    [-2,-2,-2,-3,-2,-1,-2,-3, 2,-1,-1,-2,-1, 3,-3,-2,-2, 2, 7,-1,-4,-1],
    [ 0,-3,-3,-3,-1,-2,-2,-3,-3, 3, 1,-2, 1,-1,-2,-2, 0,-3,-1, 4,-4,-1],
    [-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4, 1,-4],
    [ 0,-1,-1,-1,-2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-2, 0, 0,-2,-1,-1,-4,-1],
], dtype=np.int8)

AA_STOP = 20   # aa20 code of '*'
AA_X = 21      # aa20 code of 'X'

# Splice models (nasw.h:50-52)
SP_NONE, SP_GENERIC, SP_MAMMAL = 0, 1, 2
SPSC_OFFSET = 64  # nasw.h:54


class Tables:
    """Char-conversion and codon tables for one genetic code.

    Mirrors ns_make_tables() (nasw-tab.c:85-107).
    """

    __slots__ = ("trans_code", "nt4", "aa20", "aa13", "codon", "codon13")

    def __init__(self, trans_code: int = 1):
        if trans_code not in _CODON_TABLES:
            raise ValueError(f"translation table {trans_code} is not defined")
        self.trans_code = trans_code
        nt4 = np.full(256, 4, dtype=np.uint8)
        for i, ch in enumerate(NT_I2C):
            nt4[i] = nt4[ord(ch.upper())] = nt4[ord(ch.lower())] = i
        aa20 = np.full(256, 21, dtype=np.uint8)
        aa13 = np.full(256, 15, dtype=np.uint8)
        for i, ch in enumerate(AA_I2C):
            aa20[i] = aa20[ord(ch.upper())] = aa20[ord(ch.lower())] = i
            aa13[i] = aa13[ord(ch.upper())] = aa13[ord(ch.lower())] = A2R[i]
        tab = _CODON_TABLES[trans_code]
        codon = np.array([aa20[ord(tab[i])] for i in range(64)], dtype=np.uint8)
        codon13 = A2R[codon]
        self.nt4, self.aa20, self.aa13 = nt4, aa20, aa13
        self.codon, self.codon13 = codon, codon13


_cache: dict[int, Tables] = {}
_default_code = 1


def set_default_code(trans_code: int) -> None:
    """Set the process-wide genetic code (the reference's ns_make_tables
    global; re-applied from the index on load, index.c:217)."""
    global _default_code
    Tables(trans_code)  # validate
    _default_code = trans_code


def get_tables(trans_code: int | None = None) -> Tables:
    if trans_code is None:
        trans_code = _default_code
    t = _cache.get(trans_code)
    if t is None:
        t = _cache[trans_code] = Tables(trans_code)
    return t


def set_stop_sc(mat: np.ndarray, pen: int, asize: int = 22) -> None:
    """Set the '*' row/column of a scoring matrix to -pen, keeping mat[*,*].

    Mirrors ns_set_stop_sc (nasw-tab.c:149-156); mat is modified in place.
    """
    m = mat.reshape(asize, asize)
    orig = int(m[AA_STOP, AA_STOP])
    m[AA_STOP, :] = -pen
    m[:, AA_STOP] = -pen
    m[AA_STOP, AA_STOP] = orig


def splice_model_scores(model: int) -> np.ndarray:
    """sp[6] splice penalties: 0:pos3 1:GC-AC 2:AT-AC 3:other 4:pos0 5:poly-Y.

    Mirrors ns_opt_set_sp (nasw-tab.c:124-129).
    """
    if model == SP_MAMMAL:
        return np.array([8, 15, 21, 30, 4, 4], dtype=np.int32)
    if model == SP_GENERIC:
        return np.array([8, 15, 21, 30, 0, 0], dtype=np.int32)
    return np.zeros(6, dtype=np.int32)


def mp_log2_f32(x):
    """The reference's fast float32 log2 approximation (mppriv.h:91-99).

    Only valid for x >= 2.  Bit-exact with the C code (which is compiled
    without FP contraction), for scalar or array inputs.
    """
    x = np.asarray(x, dtype=np.float32)
    zi = x.view(np.uint32)
    log_2 = (((zi >> 23) & 255).astype(np.int32) - 128).astype(np.float32)
    zi = (zi & np.uint32(~(np.uint32(255) << 23))) + (np.uint32(127) << 23)
    zf = zi.view(np.float32)
    f1 = np.float32(-0.34484843) * zf + np.float32(2.02466578)
    log_2 = log_2 + (f1 * zf - np.float32(0.67487759))
    return log_2
