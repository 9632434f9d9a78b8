"""On the card: the harness end to end at a tiny size, traced and not,
with the kernels launched, the trace read and the judge passing.  Skips
here without a card; run on the card with

    python -m pytest -p no:cacheprovider -m gpu benchmark/tests/test_bench_gpu.py
"""

from __future__ import annotations

import time

import pytest

from benchmark import harness

from .conftest import TINY


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    r = harness.run_cell(cell, 2 ** 31 + 3, 1.0, trace, device="cuda",
                         t_start=time.time(), overrides=TINY[cell])
    assert r["correct"] and r["failed"] == 0
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        m = r["metrics"]
        assert 0 < m["factor_roofline"]["value"] <= 105
        assert 0 < m["solve_roofline"]["value"] <= 105
        assert 0 <= m["device_idle_pct"]["value"] < 100
        assert m["factor_calls_per_solve"]["value"] > 0
        assert r["breakdown"]["device_ops"]
