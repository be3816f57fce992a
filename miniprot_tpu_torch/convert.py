"""Carry state from miniprot_tpu into this package.

In this system the state a run depends on is the genome index and the
scoring options (there are no trained weights).  Both packages keep the
same numpy layout for them, so the conversion is a field-by-field copy
through plain arrays and dicts, with no import of the other package:

    arrays = index_arrays(jax_index)            # or any object with the
    opt_fields = dataclasses.asdict(jax_index.opt)   # same attributes
    mi = index_from_arrays(arrays, opt_fields)
    mo = mapopt_from_fields(dataclasses.asdict(jax_mapopt))

A ``.mpi`` file dumped by either package loads with the other's
``Index.restore`` (the format is the reference's, index.c:189-229).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import tables
from .genome import Contig, NtDB, SpliceScores
from .index import Index
from .options import IdxOpt, MapOpt


def index_arrays(idx) -> dict:
    """The numpy state of an Index-like object (bo, ki, kb, the packed
    sequence, contig names/offsets/lengths, and --spsc tracks if any)."""
    nt = idx.nt
    arrays = {
        "bo": np.asarray(idx.bo), "ki": np.asarray(idx.ki),
        "kb": np.asarray(idx.kb), "nt_seq": np.asarray(nt.seq),
        "nt_l_seq": np.asarray(nt.l_seq, np.int64),
        "ctg_name": np.array([c.name for c in nt.ctg], dtype=str),
        "ctg_off": np.array([c.off for c in nt.ctg], np.int64),
        "ctg_len": np.array([c.len for c in nt.ctg], np.int64),
    }
    if nt.spsc is not None:
        for j, s in enumerate(nt.spsc):
            arrays[f"spsc_{j}"] = np.asarray(s.a, np.uint64)
    return arrays


def index_from_arrays(arrays: dict, opt_fields: dict) -> Index:
    """Build this package's Index from the numpy state of a miniprot_tpu
    Index (see index_arrays) and its IdxOpt fields."""
    opt = IdxOpt(**{f.name: opt_fields[f.name]
                    for f in dataclasses.fields(IdxOpt)
                    if f.name in opt_fields})
    tables.set_default_code(opt.trans_code)
    nt = NtDB()
    nt.seq = np.ascontiguousarray(arrays["nt_seq"], np.uint8)
    nt.l_seq = int(arrays["nt_l_seq"])
    nt.ctg = [Contig(str(name), int(off), int(ln)) for name, off, ln in
              zip(arrays["ctg_name"], arrays["ctg_off"], arrays["ctg_len"])]
    if "spsc_0" in arrays:
        nt.spsc = [SpliceScores(np.asarray(arrays[f"spsc_{j}"], np.uint64))
                   for j in range(2 * len(nt.ctg))]
    idx = Index(opt, nt,
                np.ascontiguousarray(arrays["bo"], np.uint32),
                np.ascontiguousarray(arrays["ki"], np.int64),
                np.ascontiguousarray(arrays["kb"], np.uint32))
    expect = Index._block_offsets(nt, opt.bbit)
    if not np.array_equal(expect, idx.bo):
        raise ValueError("block offsets do not match the contig table")
    return idx


def mapopt_from_fields(d: dict) -> MapOpt:
    """This package's MapOpt from a miniprot_tpu MapOpt's fields
    (dataclasses.asdict of it); unknown keys are an error."""
    names = {f.name for f in dataclasses.fields(MapOpt)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown MapOpt fields: {sorted(extra)}")
    mo = MapOpt()
    for k, v in d.items():
        setattr(mo, k, np.array(v, copy=True) if k == "mat" else v)
    return mo
