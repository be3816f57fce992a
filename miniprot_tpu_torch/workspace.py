"""Reusable buffer workspace.

First-touch page faults are extremely expensive in virtualized
environments (~50 MB/s observed here), so the hot vectorized pipelines
(sketching, unpacking) draw their large temporaries from a per-process
pool of reused buffers instead of fresh allocations.  The pool mirrors
the reference's per-thread kalloc arenas in spirit (kalloc.c): scratch
lifetimes are per-call, memory is recycled across calls.
"""

from __future__ import annotations

import numpy as np

_pool: dict[tuple, list[np.ndarray]] = {}


def _size_class(n: int) -> int:
    c = 1024
    while c < n:
        c <<= 1
    return c


class Workspace:
    """Hands out reusable 1-D buffers; release all with reset()."""

    def __init__(self) -> None:
        self._out: list[tuple, np.ndarray] = []

    def buf(self, n: int, dtype) -> np.ndarray:
        key = (_size_class(n), np.dtype(dtype).str)
        lst = _pool.setdefault(key, [])
        arr = lst.pop() if lst else np.empty(key[0], dtype)
        self._out.append((key, arr))
        return arr[:n]

    def reset(self) -> None:
        for key, arr in self._out:
            _pool[key].append(arr)
        self._out.clear()

    def __enter__(self) -> "Workspace":
        return self

    def __exit__(self, *exc) -> None:
        self.reset()
