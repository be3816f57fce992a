"""Importable stand-ins for the port's daemon tests (no test functions).

The daemon unpickles batch objects by reference, so a class shipped to
a daemon subprocess must live in a module importable on its side (the
test file itself is not; this module is, with tests/ on PYTHONPATH)."""

import numpy as np
import torch


class FakeBatch:
    """A batch with the engine's stage / launch / collect interface and
    no kernel: launch doubles the values, collect adds one.  tb_bytes()
    claims ``need`` bytes of traceback planes for the daemon's budget."""

    def __init__(self, vals, need=0):
        self.vals = np.asarray(vals, np.int32)
        self.n = len(self.vals)
        self.need = need
        self.device = torch.device("cpu")

    def tb_bytes(self):
        return self.need

    def stage(self):
        return torch.from_numpy(self.vals).to(self.device)

    def launch(self, staged):
        return staged * 2

    def collect(self, host):
        (out,) = host.arrays()
        return [int(v) + 1 for v in out]


class BoomBatch(FakeBatch):
    """launch() raises: the error must surface at collect."""

    def launch(self, staged):
        raise RuntimeError("boom-batch")
