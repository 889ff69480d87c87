"""The harness on a CUDA card at the small 2D size: a traced run reads the
device trace (kernels matched to the K1 and KM ranges, shares of the
bound under 100 %), and is correct.  Skips where torch sees no card.

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

import time

import pytest
import torch

from benchmark.harness import cell
from conftest import CELL


@pytest.mark.cuda
def test_traced_run_on_the_card(bench, config, mix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = cell.run(bench, CELL, 12345, 0.0, True, t_start=time.perf_counter(),
                 device="cuda", config=config, mix=mix)
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    m = r["metrics"]
    # the 2D cell's names of the split quantities
    for name in ("k1_roofline.2d", "km_roofline.2d"):
        assert 0 < m[name]["value"] <= 100.0, name
    assert 0 < m["device_idle_pct.2d"]["value"] < 100
    assert m["sweep_wall_s"]["value"] > 0
    assert r["breakdown"]["device_ops"]
