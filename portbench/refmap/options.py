"""Indexing and mapping options with reference-identical defaults.

Mirrors mp_idxopt_t / mp_mapopt_t (miniprot.h:36-77) and their init
functions (options.c:10-90).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import tables


def f32(x) -> float:
    """Round to float32 precision.

    The reference stores these options in C float fields
    (miniprot.h:57-69); e.g. 0.99f rounds UP to ~0.9900000095, so the
    output filter drops a hit with score 891 against best 900 where a
    double 0.99 keeps it.  Keeping them float32-rounded doubles makes
    every promoted-to-double comparison match the C bit for bit."""
    return float(np.float32(x))

# flag bits (miniprot.h:8-17)
F_NO_SPLICE = 0x1
F_NO_ALIGN = 0x2
F_SHOW_UNMAP = 0x4
F_GFF = 0x8
F_NO_PAF = 0x10
F_GTF = 0x20
F_NO_PRE_CHAIN = 0x40
F_SHOW_RESIDUE = 0x80
F_SHOW_TRANS = 0x100
F_NO_CS = 0x200

BITS_PER_AA = 4       # miniprot.h:22
BLOCK_BONUS = 2       # miniprot.h:23
MAX_INTRON_COEF = 3.6  # options.c:8


@dataclass
class IdxOpt:
    """Indexing options (mp_idxopt_init, options.c:10-22)."""
    bbit: int = 8
    min_aa_len: int = 30
    kmer: int = 6
    mod_bit: int = 1
    trans_code: int = 1

    @property
    def n_bucket(self) -> int:
        # mppriv.h:101-104
        return 1 << (self.kmer * BITS_PER_AA - self.mod_bit)


def _default_mat() -> np.ndarray:
    mat = tables.BLOSUM62.copy()
    tables.set_stop_sc(mat, 23)
    return mat


@dataclass
class MapOpt:
    """Mapping options (mp_mapopt_init, options.c:42-90)."""
    flag: int = 0
    mini_batch_size: int = 2_000_000
    max_occ: int = 20000
    max_gap: int = 1000          # max gap on the query protein, in aa
    max_intron: int = 200000
    min_max_intron: int = 10000
    max_max_intron: int = 300000
    bw: int = 200000
    max_ext: int = 10000
    max_ava: int = 1000
    min_chn_cnt: int = 3
    max_chn_max_skip: int = 25
    max_chn_iter: int = 1_000_000
    min_chn_sc: int = 0
    chn_coef_log: float = f32(0.75)
    mask_level: float = f32(0.5)
    mask_len: int = 2**31 - 1
    pri_ratio: float = f32(0.7)
    out_sim: float = f32(0.99)
    out_cov: float = f32(0.1)
    best_n: int = 30
    out_n: int = 1000
    kmer2: int = 5
    go: int = 11
    ge: int = 1
    io: int = 29
    fs: int = 23
    io_end: int = 19
    ie_coef: float = f32(0.5)
    sp_model: int = tables.SP_GENERIC
    sp_null_bonus: int = -7
    sp_max_bonus: int = 14
    sp_scale: float = f32(1.0)
    xdrop: int = 100
    end_bonus: int = 5
    asize: int = 22
    gff_delim: int = -1
    max_intron_flank: int = 200
    gff_prefix: str = "MP"
    mat: np.ndarray = field(default_factory=_default_mat)


    def set_max_intron(self, gsize: int) -> None:
        """Max intron from genome size (options.c:31-40)."""
        x = int(math.sqrt(float(gsize)) * MAX_INTRON_COEF + 1.0)
        x = max(x, self.min_max_intron)
        x = min(x, self.max_max_intron)
        self.bw = self.max_intron = x


    def check(self) -> None:
        if self.sp_model < 0 or self.sp_model > 2:
            raise ValueError("splice model (-j) should be between 0 and 2")
