"""The reduction of a profiler trace, on a hand-made one, and the spans
around the program's wrappers, which must leave its counters working."""

from __future__ import annotations

import pytest
import torch

from benchmark import tracing


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def trace():
    # two calls (0-100, 120-200 us); a factor span 10-40 launching two
    # kernels on two streams that overlap, a solve span 50-60 launching
    # one; one kernel from outside any kernel span
    return [
        ev("user_annotation", "bench.call", 0, 100),
        ev("user_annotation", "bench.call", 120, 80),
        ev("user_annotation", "bench.factor.0", 10, 30),
        ev("user_annotation", "bench.solve.1", 50, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 130, 1, correlation=4),
        ev("kernel", "assemble", 20, 20, correlation=1),
        ev("kernel", "trail", 30, 20, correlation=2),
        ev("kernel", "solve", 60, 10, correlation=3),
        ev("kernel", "elementwise", 140, 30, correlation=4),
        ev("cpu_op", "aten::mm", 0, 5),
    ]


def test_reduce_trace():
    r = tracing.reduce_trace(trace())
    assert r["window_s"] == pytest.approx(200e-6)
    # device busy 20-50, 60-70, 140-170
    assert r["busy_s"] == pytest.approx(70e-6)
    assert r["span_device_s"][("factor", 0)] == pytest.approx(30e-6)
    assert r["span_device_s"][("solve", 1)] == pytest.approx(10e-6)
    names = dict(r["device_ops"])
    assert names["elementwise"] == pytest.approx(30e-6)
    gaps = dict(r["idle_gaps"])
    # idle 0-20 (host in the call 0-10, in the factor 10-20), 50-60 (in
    # the solve), 70-140 (call 70-100, between calls 100-120, call
    # 120-140), 170-200 (call)
    assert gaps["factor"] == pytest.approx(10e-6)
    assert gaps["solve"] == pytest.approx(10e-6)
    assert gaps["between_calls"] == pytest.approx(20e-6)
    assert gaps["call"] == pytest.approx(90e-6)
    assert sum(gaps.values()) == pytest.approx(200e-6 - 70e-6)


def test_no_calls_no_reading():
    assert tracing.reduce_trace([ev("kernel", "k", 0, 1)]) is None


def test_wrapper_spans_keep_the_program_counters():
    from cvxopt_tpu_torch.ops import fused_chol as fc
    orig = fc.fused_schur_cholesky
    with tracing.KernelSpans() as spans:
        assert fc.fused_schur_cholesky is not orig
        wrapped = fc.fused_schur_cholesky
        wrapped.launches += 3
        assert orig.launches == fc.launch_counts()[
            "fused_schur_cholesky"]
        P = torch.eye(64, dtype=torch.float64).expand(2, 64, 64)
        Gt = torch.ones((64, 8), dtype=torch.float64)
        fc.fused_schur_cholesky_batched(
            P.contiguous(), Gt, torch.ones((2, 8), dtype=torch.float64),
            tb=1, device="cpu")
    assert fc.fused_schur_cholesky is orig
    fc.reset_launch_counts()
    assert spans.calls == [dict(kind="factor", shape=(2, 64, 8, True),
                                esize=8)]
