"""Fixtures of the benchmark's CPU tests: the 2D configuration cut to
baseN 4, nref 1 (706 dofs), on which the harness runs through the plain
kernels, and a short ladder."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import registry  # noqa: E402

#: the small cell's workload name (the 2D cell's entry, run on the small
#: configuration and mix below)
CELL = "ldc2d_p2p0.re500"


def small_config(base=4, nref=1):
    cfg = copy.deepcopy(registry.config("ldc2d_p2p0"))
    flags = cfg["flags"]
    flags[flags.index("--baseN") + 1] = str(base)
    flags[flags.index("--nref") + 1] = str(nref)
    cfg["problem"]["args"]["baseN"] = base
    cfg["reference"]["cells_per_side"] = base * 2 ** nref
    return cfg


def small_3d_config():
    """The 3D configuration cut to baseN 2, nref 1."""
    cfg = registry.config("ldc3d_p1fb_supg")
    flags = cfg["flags"]
    flags[flags.index("--baseN") + 1] = "2"
    flags[flags.index("--nref") + 1] = "1"
    cfg["problem"]["args"]["baseN"] = 2
    cfg["reference"]["cells_per_side"] = 4
    return cfg


@pytest.fixture(scope="session")
def bench():
    return registry.load_benchmark()


@pytest.fixture
def config():
    return small_config()


@pytest.fixture
def mix():
    m = dict(registry.traffic("ladder_re500"))
    m["rungs"] = [1, 10, 100]
    return m
