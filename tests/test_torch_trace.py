"""The port's spans (`cvxopt_tpu_torch.trace`) and their reading.

Without a profiler a span is the shared no-op.  Under torch.profiler
(CPU activity) the cascades and `solvers.qp` open their `cvx.*` spans,
one `cvx.*.sync` span per host read, which the cascade's profile counts
too, and return the same bits as without a profiler.  The benchmark's
reduction of a trace (`benchmark/program_spans.py`) puts idle time in a
call down to the innermost `cvx.*` span and leaves every other reading
of `benchmark/tracing.py` as it was.
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program_spans, tracing
from benchmark.tests import test_bench_trace
from cvxopt_tpu_torch import solvers, trace
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.conelp import make_conelp_cascade
from cvxopt_tpu_torch.coneqp import make_coneqp_cascade

TOLS = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)
N, NB = 64, 8


def traced(fn, tmp_path):
    """fn() inside a `bench.call` span under torch.profiler; returns
    (its result, the chrome trace's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.CALL):
            out = fn()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, json.load(f)["traceEvents"]


def spans(events):
    """[(start, end, name)] of the `cvx.*` spans."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("cvx.")]


def box_data(seed):
    """min (1/2 x'Px +) c'x over 0 <= x <= 1, sum x = 1: the scenario
    cell's constraints, a batch of NB at n = N."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((NB, N, N // 4)) / np.sqrt(N)
    P = F @ F.transpose(0, 2, 1) + 0.1 * np.eye(N)
    q = -rng.uniform(0, 0.1, (NB, N))
    G = np.concatenate([-np.eye(N), np.eye(N)])
    h = np.concatenate([np.zeros(N), np.ones(N)])
    return P, q, G, h, np.ones((1, N)), np.ones(1)


def test_span_is_a_noop_without_a_profiler():
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert not trace.recording()
    assert trace.span("cvx.ipm.pass") is trace.span("cvx.kkt.factor")
    with trace.span("cvx.ipm.pass"):
        pass


def test_span_records_under_a_profiler(tmp_path):
    @trace.spanned("cvx.frontend.test")
    def inner():
        assert trace.recording()
        with trace.span("cvx.ipm.test"):
            return 3

    out, events = traced(inner, tmp_path)
    assert out == 3 and not trace.recording()
    (a0, a1, outer), (b0, b1, name) = sorted(spans(events))
    assert (outer, name) == ("cvx.frontend.test", "cvx.ipm.test")
    assert a0 <= b0 and b1 <= a1


@pytest.mark.parametrize("kind", ["coneqp", "conelp"])
def test_cascade_spans_and_syncs(kind, tmp_path):
    P, q, G, h, A, b = box_data(seed=3)
    if kind == "coneqp":
        solve = make_coneqp_cascade(ConeDims(l=2 * N), kktsolver="chol2_inv",
                                    instrument=True, device="cpu", **TOLS)
        args = (P, q, G, h, A, b)
    else:
        solve = make_conelp_cascade(ConeDims(l=2 * N), instrument=True,
                                    device="cpu", **TOLS)
        args = (q, G, h, A, b)
    plain = solve(*args)
    out, events = traced(lambda: solve(*args), tmp_path)
    for k in ("x", "status", "iterations"):
        assert torch.equal(out[k], plain[k]), k
    assert (out["status"] == 0).all()

    found = spans(events)
    names = collections.Counter(name for _, _, name in found)
    assert set(names) >= {
        "cvx.cascade.solve", "cvx.cascade.a", "cvx.cascade.b",
        "cvx.cascade.c", "cvx.ipm.start", "cvx.ipm.pass", "cvx.ipm.sync",
        "cvx.kkt.factor", "cvx.kkt.solve", "cvx.cascade.sync"}
    (r0, r1, _), = [s for s in found if s[2] == "cvx.cascade.solve"]
    assert all(r0 <= a and b <= r1 for a, b, _ in found)
    prof = out["profile"]
    syncs = sum(v for k, v in names.items() if k.endswith(".sync"))
    assert syncs == (prof["a_host_syncs"] + prof["b_host_syncs"]
                     + prof["c_host_syncs"])
    assert prof["c_host_syncs"] == names["cvx.cascade.sync"] == 1
    # phases A and B: a sync per pass and the last check each; coneqp's
    # phase B reads its warm starts' validity once besides
    assert names["cvx.ipm.sync"] == (names["cvx.ipm.pass"] + 2
                                     + (kind == "coneqp"))
    got = program_spans.program_metrics(program_spans.reduce_trace(events))
    assert got["host_syncs_per_call"] == syncs
    assert got["idle_cascade_pct"] > 0.0


def test_qp_front_end_spans(tmp_path):
    P, q, G, h, _, _ = box_data(seed=4)
    opts = dict(TOLS)

    def qp():
        return solvers.qp(P[0], q[0], G, h, options=opts, device="cpu")

    plain = qp()
    out, events = traced(qp, tmp_path)
    assert out["status"] == plain["status"] == "optimal"
    assert out["iterations"] == plain["iterations"]
    assert torch.equal(out["x"], plain["x"])

    found = spans(events)
    names = collections.Counter(name for _, _, name in found)
    assert set(names) == {
        "cvx.frontend.coneqp", "cvx.frontend.sync", "cvx.ipm.start",
        "cvx.ipm.pass", "cvx.ipm.sync", "cvx.kkt.factor", "cvx.kkt.solve"}
    (r0, r1, _), = [s for s in found if s[2] == "cvx.frontend.coneqp"]
    assert all(r0 <= a and b <= r1 for a, b, _ in found)
    # finalize_qp_result reads status, iterations and 8 numbers
    assert names["cvx.frontend.sync"] == 10
    # a pass per step (each ends in its exit test); a sync per pass and
    # the last; a factor per pass and the start point's
    assert names["cvx.ipm.pass"] == out["iterations"]
    assert names["cvx.ipm.sync"] == names["cvx.ipm.pass"] + 1
    assert names["cvx.kkt.factor"] == names["cvx.ipm.pass"] + 1


def ev(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def program_trace():
    """Two calls (0-100, 120-200 us) of nested program spans, a factor
    wrapper span inside `cvx.kkt.factor`; kernels busy 20-30, 60-70 and
    150-160."""
    return [
        ev("bench.call", 0, 100),
        ev("bench.call", 120, 80),
        ev("cvx.cascade.solve", 0, 100),
        ev("cvx.ipm.start", 5, 10),
        ev("cvx.ipm.pass", 20, 60),
        ev("cvx.kkt.factor", 25, 30),
        ev("bench.factor.0", 30, 20),
        ev("cvx.ipm.sync", 85, 5),
        ev("cvx.cascade.solve", 120, 80),
        ev("cvx.ipm.sync", 130, 10),
        ev("cvx.ipm.sync", 210, 5),       # outside the traced calls
        ev("cudaLaunchKernel", 31, 1, cat="cuda_runtime", correlation=1),
        ev("cudaLaunchKernel", 60, 1, cat="cuda_runtime", correlation=2),
        ev("cudaLaunchKernel", 145, 1, cat="cuda_runtime", correlation=3),
        ev("k1", 20, 10, cat="kernel", correlation=1),
        ev("k2", 60, 10, cat="kernel", correlation=2),
        ev("k3", 150, 10, cat="kernel", correlation=3),
    ]


def test_idle_goes_to_the_innermost_program_span():
    events = program_trace()
    old = tracing.reduce_trace(events)
    new = program_spans.reduce_trace(events)
    gaps, old_gaps = dict(new["idle_gaps"]), dict(old["idle_gaps"])
    # idle 0-20: solve 0-5, start 5-15, solve 15-20; 30-60: factor
    # 30-50, kkt.factor 50-55, pass 55-60; 70-150: pass 70-80, solve
    # 80-85, sync 85-90, solve 90-100, between 100-120, solve 120-130,
    # sync 130-140, solve 140-150; 160-200: solve
    assert gaps == pytest.approx({
        "cvx.cascade.solve": 85e-6, "cvx.ipm.start": 10e-6,
        "factor": 20e-6, "cvx.kkt.factor": 5e-6, "cvx.ipm.pass": 15e-6,
        "cvx.ipm.sync": 15e-6, "between_calls": 20e-6})
    for k in ("factor", "between_calls"):
        assert gaps[k] == old_gaps[k]
    split = sum(v for k, v in gaps.items() if k.startswith("cvx."))
    assert split == pytest.approx(old_gaps["call"])
    for k in ("window_s", "busy_s", "device_ops", "span_device_s",
              "ncalls"):
        assert new[k] == old[k], k
    assert new["program"]["cvx.ipm.sync"] == {
        "count": 2, "idle_s": pytest.approx(15e-6)}
    assert new["program"]["cvx.cascade.solve"]["count"] == 2
    got = program_spans.program_metrics(new)
    assert got == pytest.approx({
        "host_syncs_per_call": 1.0,
        "idle_cascade_pct": 100 * 85e-6 / 200e-6,
        "idle_ipm_pct": 100 * 40e-6 / 200e-6,
        "idle_kkt_pct": 100 * 5e-6 / 200e-6})


def test_reduction_without_program_spans_is_the_old_one():
    events = test_bench_trace.trace()
    old = tracing.reduce_trace(events)
    new = program_spans.reduce_trace(events)
    assert new == dict(old, program={})
    assert program_spans.program_metrics(new) == {
        "host_syncs_per_call": None, "idle_cascade_pct": None,
        "idle_ipm_pct": None, "idle_kkt_pct": None}
    assert program_spans.reduce_trace([ev("k", 0, 1, cat="kernel")]) is None
    # a layer with no span reads None, the others their share
    dense = [e for e in program_trace()
             if not e["name"].startswith("cvx.cascade.")]
    got = program_spans.program_metrics(program_spans.reduce_trace(dense))
    assert got["idle_cascade_pct"] is None
    assert got["idle_kkt_pct"] == pytest.approx(100 * 5e-6 / 200e-6)
