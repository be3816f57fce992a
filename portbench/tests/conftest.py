"""The benchmark harness's own tests: run them with

    python3 -m pytest -q portbench/tests

They run on the CPU at tiny sizes, with the port's plain kernel
versions; a test that needs a card carries the ``gpu`` marker and
decides inside its fixture whether one is there."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card of compute capability >= 9.0")
