"""The judge that decides `correct`: a sound run comes out correct; the
timed path broken underneath, each way a solver cell can break, comes
out not correct; and the control (the plain reference in float32 in the
program's place) fails it while the float64 reference passes.  Runs the
harness end to end on the CPU at a tiny size, past its look for a
card."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, harness

from .conftest import TINY


def run(cell, seed=7, trace=0):
    return harness.run_cell(cell, seed, 0.3, trace, device="cpu",
                            t_start=time.time(), overrides=TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["pres"]["value"] <= r["checks"]["pres"]["limit"]


def _wrap_solve(monkeypatch, change):
    import cvxopt_tpu_torch.coneqp as cq
    orig = cq._coneqp_solve

    def broken(*args, **kwargs):
        return change(orig, args, kwargs)
    monkeypatch.setattr(cq, "_coneqp_solve", broken)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_step_that_leaves_state_unchanged(cell, monkeypatch):
    def frozen(orig, args, kwargs):
        # every IPM step returns the state it was given: no iteration
        # moves the starting point
        return orig(*args, **{**kwargs, "maxiters": 0})
    _wrap_solve(monkeypatch, frozen)
    r = run(cell)
    assert not r["correct"]
    assert r["failed"] == r["attempted"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_answer_altered_where_produced(cell, monkeypatch):
    def altered(orig, args, kwargs):
        raw = dict(orig(*args, **kwargs))
        raw["x"] = raw["x"] + 1e-6
        return raw
    _wrap_solve(monkeypatch, altered)
    r = run(cell)
    assert not r["correct"]
    assert r["checks"]["pres"]["value"] > r["checks"]["pres"]["limit"]


@pytest.mark.parametrize("cell", ["scenario_qp.b1024", "scenario_qp.b16"])
def test_half_the_batch_left_out(cell, monkeypatch):
    import cvxopt_tpu_torch.coneqp as cq
    orig = cq.make_coneqp_cascade

    def make(*args, **kwargs):
        solve = orig(*args, **kwargs)

        def half(P, q, G, h, A, b):
            k = P.shape[0] // 2
            out = dict(solve(P[:k], q[:k], G, h, A, b))
            for key in ("x", "y", "s", "z"):
                mean = out[key].mean(0, keepdim=True)
                out[key] = torch.cat([out[key], mean.expand(
                    P.shape[0] - k, -1)])
            for key in ("status", "iterations"):
                out[key] = torch.cat([out[key], out[key][:P.shape[0] - k]])
            return out
        return half
    monkeypatch.setattr(cq, "make_coneqp_cascade", make)
    r = run(cell)
    assert not r["correct"]


# The control in the program's place, judged as the program is: in the
# scenario cells the cascade's float32 path run to the stated
# tolerances, in the dense cell the plain reference in float32 (at
# n = 1024 here, where float32 cannot meet the limits either).
CONTROL = {
    "dense_qp.single": {"config": {"n": 1024, "m": 1024,
                                   "factor_cols": 64},
                        "traffic": {"pool": 2, "warmup_calls": 0}},
    "scenario_qp.b1024": {**TINY["scenario_qp.b1024"]},
    "scenario_qp.b16": {**TINY["scenario_qp.b16"]},
}


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_fails(cell):
    r, ok = control.readings(cell, 11, 0.3, device="cpu",
                             overrides=CONTROL[cell])
    assert not r["correct"], r["checks"]
    if cell.startswith("scenario"):
        # every float32 answer fails, the ones returned optimal too
        assert ok["optimal"] > 0
        assert min(ok["worst"][k] / r["checks"][k]["limit"]
                   for k in ("pres", "dres")) > 1.0


def test_traced_slice_is_not_counted_as_attempted():
    # a window of one call; the traced slice's calls come after it and
    # count in no end-to-end number
    cell = "scenario_qp.b16"
    r = harness.run_cell(cell, 7, 0.0, 1, device="cpu", t_start=time.time(),
                         overrides=TINY[cell])
    assert r["attempted"] == TINY[cell]["traffic"]["batch"]
