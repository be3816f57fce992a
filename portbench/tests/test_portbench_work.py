"""The work counts and peaks on hand-worked shapes."""

import numpy as np
import pytest

from portbench import work


def test_peaks():
    # 132 SMs x 64 lanes x 2 halves x 2 fused ops x 1.98 GHz
    assert work.INT16_OPS_PER_S == pytest.approx(6.690816e13)
    assert work.INT32_OPS_PER_S == pytest.approx(3.345408e13)
    assert work.HBM_BYTES_PER_S == 3.35e12


def test_ext_counts():
    # one problem, 10 genome rows x 4 residues: 40 cells x 26 ops;
    # bytes: 10 + 4 inputs, 12 of result
    assert work.work("ext", [10], [4]) == (1040.0, 26.0)


def test_cigar_counts_are_unpadded():
    # two problems 3 x 2 and 5 x 2: 16 cells x 31 ops; bytes 12 + 2 x 4
    ops, nbytes = work.work("cigar", np.array([3, 5]), np.array([2, 2]))
    assert (ops, nbytes) == (496.0, 20.0)


def test_least_seconds_takes_the_larger_bound():
    # ops-bound: 1000 x 100 cells
    launched = {"ext": [(np.array([1000]), np.array([100]))]}
    assert work.least_seconds(launched) == pytest.approx(
        26 * 1000 * 100 / work.INT16_OPS_PER_S)
    # long windows, one residue each: bytes come close, ops still bound
    # (31 ops at 6.69e13/s take longer than a byte at 3.35e12 B/s)
    launched = {"cigar": [(np.full(1000, 10**6), np.ones(1000))]}
    t_ops = 31 * 1e9 / work.INT16_OPS_PER_S
    t_bytes = (1000 * (10**6 + 1) + 4000) / work.HBM_BYTES_PER_S
    assert work.least_seconds(launched) == pytest.approx(max(t_ops,
                                                             t_bytes))
    # no residues at all: only the bytes remain
    launched = {"ext": [(np.array([10**6]), np.array([0]))]}
    assert work.least_seconds(launched) == pytest.approx(
        (10**6 + 12) / work.HBM_BYTES_PER_S)


def test_int32_recurrence_at_its_own_rate():
    launched = {"cigar32": [(np.array([100]), np.array([50]))]}
    assert work.least_seconds(launched) == pytest.approx(
        31 * 5000 / work.INT32_OPS_PER_S)
