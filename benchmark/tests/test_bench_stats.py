"""The rate and percentile arithmetic runs over every call of the window:
one stalled call has to move problems_per_s and solve_ms_p95."""

from __future__ import annotations

import os
import statistics

import numpy as np
import pytest

from benchmark import harness, stats


def read(name, ctx):
    mod = harness.load_module(
        os.path.join(harness.HERE, "metrics", name + ".py"), "m_" + name)
    return mod.read(ctx)


def window(call_s, batch=16):
    return harness.Context(
        setup_s=12.5, window_s=sum(call_s), call_s=list(call_s),
        solved=batch * len(call_s), attempted=batch * len(call_s),
        iterations=np.full(batch * len(call_s), 9.0),
        host_syncs=[30] * len(call_s), factor_calls=[15] * len(call_s),
        trace=None, spans=[], n_problem=256)


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=101).tolist()
    for p in (0, 5, 50, 95, 100):
        assert stats.percentile(xs, p) == pytest.approx(np.percentile(xs, p))
    assert stats.percentile(xs, 50) == pytest.approx(statistics.median(xs))


def test_one_stalled_call_moves_rate_and_tail():
    calm = [0.05] * 20
    stalled = calm[:-1] + [0.5]
    a, b = window(calm), window(stalled)
    assert read("problems_per_s", a) == pytest.approx(320 / 1.0)
    assert read("problems_per_s", b) < 0.75 * read("problems_per_s", a)
    assert read("solve_ms_p95", b) > 1.4 * read("solve_ms_p95", a)
    assert read("solve_ms_p50", b) == pytest.approx(read("solve_ms_p50", a))


def test_unsolved_instances_do_not_count():
    ctx = window([0.1] * 10)
    ctx.solved -= 40
    assert read("problems_per_s", ctx) == pytest.approx(120.0 / 1.0)


def test_counter_means():
    ctx = window([0.1] * 4)
    assert read("ipm_iterations", ctx) == 9.0
    assert read("host_syncs_per_solve", ctx) == 30
    assert read("factor_calls_per_solve", ctx) == 15
    assert read("setup_s", ctx) == 12.5


def test_readers_without_anything_to_read_return_none():
    ctx = window([0.1] * 4)
    ctx.host_syncs = [None] * 4
    ctx.factor_calls = [0] * 4
    for name in ("host_syncs_per_solve", "factor_calls_per_solve",
                 "factor_roofline", "solve_roofline",
                 "device_idle_pct"):
        assert read(name, ctx) is None


def test_empty_window_is_an_error():
    with pytest.raises(ValueError):
        stats.rate(10, 0.0)
    with pytest.raises(ValueError):
        stats.percentile([], 50)
