"""The readers of the engine's host share off the pump's thread, on a
synthetic ``ctx``: ``engine.host_join_ms_per_protein`` reads the
profiler's ``engine.host_join`` stage, ``engine.host_offthread_share``
the maps' ``host_offthread`` over their ``n_host``; each reads nothing
from a program without them."""

import pytest

from portbench import core


def _read(name, ctx):
    return core._load(core.ROOT, "metrics", name).read(ctx)


def test_host_join_reads_the_span_per_protein():
    ctx = {"stages": {"engine.host_join": 0.25, "engine.pack": 3.0},
           "proteins": 500}
    assert _read("engine.host_join_ms_per_protein", ctx) == pytest.approx(
        0.5)
    assert _read("engine.host_join_ms_per_protein",
                 {"stages": {"engine.pack": 3.0}, "proteins": 500}) is None


def test_host_offthread_share_over_all_host_dps():
    stats = [{"n_host": 300, "host_offthread": 297},
             {"n_host": 100, "host_offthread": 100}]
    assert _read("engine.host_offthread_share",
                 {"stats": stats}) == pytest.approx(99.25)
    # a program that does not count them, or no host DPs: nothing
    assert _read("engine.host_offthread_share",
                 {"stats": [{"n_host": 300}]}) is None
    assert _read("engine.host_offthread_share",
                 {"stats": [{"n_host": 0, "host_offthread": 0}]}) is None
    assert _read("engine.host_offthread_share", {"stats": []}) is None
