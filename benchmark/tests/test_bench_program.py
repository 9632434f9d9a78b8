"""The one reduction of a trace with the program's spans, the kinds of
kernel span a problem family declares, the per-call counters the
readers read, and the readers of the program's spans and counters.

`old_reduce_trace` is the reduction the benchmark had before it read
the program's spans, kept here as the fixture that the new one has to
agree with on everything the older metrics read."""

from __future__ import annotations

import bisect
import json
import os
import shutil
import time

import pytest
import torch

from benchmark import harness, tracing

from .conftest import TINY


def ev(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def program_trace():
    """Two calls (0-100, 120-200 us) of nested program spans, a factor
    span inside `cvx.kkt.factor` and a family's `qr` span inside
    `cvx.kkt.solve`; kernels busy 20-30, 60-70, 150-160 and 175-180."""
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
        ev("cvx.kkt.solve", 165, 20),
        ev("bench.qr.1", 170, 10),
        ev("cvx.ipm.sync", 210, 5),       # outside the traced calls
        ev("cudaLaunchKernel", 31, 1, cat="cuda_runtime", correlation=1),
        ev("cudaLaunchKernel", 60, 1, cat="cuda_runtime", correlation=2),
        ev("cudaLaunchKernel", 145, 1, cat="cuda_runtime", correlation=3),
        ev("cudaLaunchKernel", 172, 1, cat="cuda_runtime", correlation=4),
        ev("k1", 20, 10, cat="kernel", correlation=1),
        ev("k2", 60, 10, cat="kernel", correlation=2),
        ev("k3", 150, 10, cat="kernel", correlation=3),
        ev("geqrf", 175, 5, cat="kernel", correlation=4),
        ev("aten::mm", 0, 5, cat="cpu_op"),
    ]


# ---- the reduction before the program's spans were read (the fixture) --

class _OldSpans:
    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i]
        return None


def old_reduce_trace(events):
    dev, launch, calls, kspans = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat in tracing.DEVICE_CATS:
            dev.append((t0, t1, e.get("name", "?"), args.get("correlation")))
        elif cat in tracing.LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = t0
        elif cat == "user_annotation" and e.get("name") == tracing.CALL:
            calls.append((t0, t1))
        elif cat == "user_annotation" and e.get("name", "").startswith(
                ("bench.factor.", "bench.solve.")):
            _, kind, idx = e["name"].split(".")
            kspans.append((t0, t1, kind, int(idx)))
    if not calls:
        return None
    lo, hi = min(c[0] for c in calls), max(c[1] for c in calls)
    busy = tracing._clip(tracing._union([(a, b) for a, b, _, _ in dev]),
                         lo, hi)
    by_name = {}
    for a, b, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    call_idx, kernel_idx = _OldSpans(calls), _OldSpans(kspans)

    def host(t):
        span = kernel_idx.at(t)
        return (span[2] if span else
                "call" if call_idx.at(t) else "between_calls")

    cuts = sorted({t for s in calls + kspans for t in s[:2]})
    gaps = {}
    prev = lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            i, j = bisect.bisect_right(cuts, prev), bisect.bisect_left(cuts, a)
            edges = [prev] + cuts[i:j] + [a]
            for u, v in zip(edges, edges[1:]):
                name = host(0.5 * (u + v))
                gaps[name] = gaps.get(name, 0.0) + (v - u) / 1e6
        prev = max(prev, b)
    per_span = {}
    for a, b, _, corr in dev:
        t = launch.get(corr)
        span = kernel_idx.at(t) if t is not None else None
        if span is not None:
            per_span.setdefault((span[2], span[3]), []).append((a, b))
    span_device_s = {key: tracing._length(tracing._union(iv)) / 1e6
                     for key, iv in per_span.items()}
    return dict(window_s=(hi - lo) / 1e6, busy_s=tracing._length(busy) / 1e6,
                device_ops=[[k[:tracing.NAME_CHARS], v] for k, v in top],
                idle_gaps=sorted(([k, v] for k, v in gaps.items()),
                                 key=lambda kv: -kv[1]),
                span_device_s=span_device_s, ncalls=len(calls))


def test_new_reduction_keeps_what_the_old_one_read():
    # without the family's span, which the old reduction did not know
    events = [e for e in program_trace() if e["name"] != "bench.qr.1"]
    old, new = old_reduce_trace(events), tracing.reduce_trace(events)
    for k in ("window_s", "busy_s", "device_ops", "span_device_s",
              "ncalls"):
        assert new[k] == old[k], k
    old_gaps, split = dict(old["idle_gaps"]), dict(new["idle_split"])
    # the kernel spans' kinds and `between_calls` keep their values
    assert set(old_gaps) == {"factor", "call", "between_calls"}
    for k in set(old_gaps) - {"call"}:
        assert split[k] == old_gaps[k], k
    # the old `call` is split by the program's spans, none of it left
    assert "call" not in split
    assert sum(v for k, v in split.items() if k.startswith("cvx.")) == \
        pytest.approx(old_gaps["call"])
    assert dict(new["idle_gaps"]) == pytest.approx(old_gaps)
    idle = sum(old_gaps.values())
    assert sum(split.values()) == pytest.approx(idle)
    assert idle == pytest.approx(new["window_s"] - new["busy_s"])


def test_idle_and_device_time_go_to_the_innermost_program_span():
    r = tracing.reduce_trace(program_trace())
    split = dict(r["idle_split"])
    # idle 0-20: solve 0-5, start 5-15, solve 15-20; 30-60: factor
    # 30-50, kkt.factor 50-55, pass 55-60; 70-150: pass 70-80, solve
    # 80-85, sync 85-90, solve 90-100, between 100-120, solve 120-130,
    # sync 130-140, solve 140-150; 160-175: solve 160-165, kkt.solve
    # 165-170, qr 170-175; 180-200: kkt.solve 180-185, solve 185-200
    assert split == pytest.approx({
        "cvx.cascade.solve": 65e-6,
        "cvx.ipm.start": 10e-6, "factor": 20e-6, "cvx.kkt.factor": 5e-6,
        "cvx.ipm.pass": 15e-6, "cvx.ipm.sync": 15e-6,
        "between_calls": 20e-6, "cvx.kkt.solve": 10e-6, "qr": 5e-6})
    prog = r["program"]
    assert prog["cvx.ipm.sync"]["count"] == 2
    assert prog["cvx.cascade.solve"]["count"] == 2
    # k1 launched in bench.factor.0 under cvx.kkt.factor, k2 in
    # cvx.ipm.pass, k3 in cvx.cascade.solve, geqrf in bench.qr.1 under
    # cvx.kkt.solve
    assert {k: v["device_s"] for k, v in prog.items()} == pytest.approx({
        "cvx.kkt.factor": 10e-6, "cvx.ipm.pass": 10e-6,
        "cvx.cascade.solve": 10e-6, "cvx.kkt.solve": 5e-6,
        "cvx.ipm.start": 0.0, "cvx.ipm.sync": 0.0})


def test_a_family_declared_kind_is_read():
    r = tracing.reduce_trace(program_trace())
    assert r["span_device_s"] == pytest.approx(
        {("factor", 0): 10e-6, ("qr", 1): 5e-6})
    assert dict(r["idle_gaps"])["qr"] == pytest.approx(5e-6)
    spans = [dict(kind="factor", shape=(1, 64, 8, True), esize=8),
             dict(kind="qr", shape=(4, 16, 8), esize=4)]
    ctx = harness.Context(trace=r, spans=spans)
    assert ctx.kernel_calls("qr") == [(spans[1], pytest.approx(5e-6))]
    assert ctx.kernel_calls("eigh") == []


def test_kernel_spans_wrap_a_declared_function():
    def qr_shape(A, *args, **kwargs):
        return tuple(A.shape)

    orig = torch.linalg.qr
    entry = ("torch.linalg", "qr", "qr", qr_shape)
    with tracing.KernelSpans(tracing.KERNELS + (entry,)) as spans:
        assert torch.linalg.qr is not orig
        q, r = torch.linalg.qr(torch.eye(6, 4), mode="reduced")
    assert torch.linalg.qr is orig
    assert q.shape == (6, 4) and r.shape == (4, 4)
    assert spans.calls == [dict(kind="qr", shape=(6, 4), esize=4)]
    with pytest.raises(ValueError):
        tracing.KernelSpans([("torch.linalg", "qr", "q.r", qr_shape)])


# ---- the readers ---------------------------------------------------------

def read(name, ctx):
    mod = harness.load_module(
        os.path.join(harness.HERE, "metrics", name + ".py"), "m_" + name)
    return mod.read(ctx)


def test_idle_readers():
    r = tracing.reduce_trace(program_trace())
    ctx = harness.Context(trace=r)
    window = 200e-6
    assert read("idle_ipm_pct", ctx) == pytest.approx(
        100 * 40e-6 / window)
    assert read("idle_kkt_pct", ctx) == pytest.approx(
        100 * 15e-6 / window)
    assert read("idle_cascade_pct", ctx) == pytest.approx(
        100 * 65e-6 / window)
    total = sum(read(f"idle_{layer}_pct", ctx)
                for layer in ("ipm", "kkt", "cascade"))
    assert total <= read("device_idle_pct", ctx)
    # a layer that opens no span reads nothing, not 0
    dense = [e for e in program_trace()
             if not e["name"].startswith("cvx.cascade.")]
    assert read("idle_cascade_pct",
                harness.Context(trace=tracing.reduce_trace(dense))) is None
    assert read("idle_ipm_pct", harness.Context(trace=None)) is None


def test_host_syncs_per_call_reader():
    r = tracing.reduce_trace(program_trace())
    # two `cvx.ipm.sync` spans in two calls; the third is outside them
    assert read("host_syncs_per_call", harness.Context(trace=r)) == 1.0
    plain = [e for e in program_trace() if not e["name"].startswith("cvx.")]
    assert read("host_syncs_per_call", harness.Context(
        trace=tracing.reduce_trace(plain))) is None


def test_replay_share_reader():
    def calls(*pairs):
        return [{"ipm_graph.replays": r, "ipm_graph.eager_passes": e,
                 "ipm_graph.captures": 0} for r, e in pairs]

    ctx = harness.Context(trace_counters=calls((13, 0), (14, 0)))
    assert read("replay_share", ctx) == 100.0
    ctx = harness.Context(trace_counters=calls((9, 1), (0, 10)))
    assert read("replay_share", ctx) == pytest.approx(45.0)
    assert read("replay_share", harness.Context(trace_counters=[])) is None


# ---- the per-call counters -------------------------------------------------

def test_per_call_counters_reach_the_context(monkeypatch):
    seen = []

    class Seen(harness.Context):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen.append(self)

    monkeypatch.setattr(harness, "Context", Seen)
    cell = "scenario_qp.b16"
    r = harness.run_cell(cell, 7, 0.0, 1, device="cpu", t_start=time.time(),
                         overrides=TINY[cell])
    assert r["correct"]
    ctx, = seen
    ntrace = TINY[cell]["traffic"]["trace_calls"]
    assert len(ctx.counters) == len(ctx.call_s) == 1
    assert len(ctx.trace_counters) == ntrace
    for c in ctx.counters + ctx.trace_counters:
        # on the CPU no tape engages: every pass is eager
        assert c["ipm_graph.eager_passes"] > 0
        assert c["ipm_graph.replays"] == c["ipm_graph.captures"] == 0
        assert set(c) >= {f"fused_chol.{w}"
                          for w in tracing.FACTOR + tracing.SOLVE}
    # reset before each call: a call's count is its own
    assert ctx.counters[0]["ipm_graph.eager_passes"] == \
        r["metrics"]["host_syncs_per_solve"]["value"] - 2
    assert r["metrics"]["replay_share"]["value"] == 0.0


# ---- a family that brings its own span kind, counter and readers -----------

STUB_FAMILY = '''
import torch

KERNEL_SPANS = [("torch.linalg", "qr", "qr",
                 lambda A, *args, **kwargs: tuple(A.shape))]


def make_pool(cfg, traffic, seed, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((traffic["batch"], cfg["n"], cfg["n"]), generator=g,
                        dtype=torch.float64) for _ in range(traffic["pool"])]


def make_solver(cfg, traffic, device, instrument):
    def call(A):
        Q, R = torch.linalg.qr(A)
        return dict(Q=Q, R=R, A=A)
    return call


def record(out):
    B = out["A"].shape[0]
    return dict(batch=B, ok=torch.ones(B, dtype=torch.bool),
                iters=torch.ones(B), host_syncs=None,
                counters={"stub.qr_calls": 1})


def keep(out, i):
    return (out["Q"][i].clone(), out["R"][i].clone())


def judge(A, i, ans):
    Q, R = ans
    return {"residual": float((Q @ R - A[i]).abs().max())}
'''

STUB_READERS = {
    # the family's counter, per window call
    "qr_calls_per_call": "lambda ctx: sum(c['stub.qr_calls'] for c in "
                         "ctx.counters) / len(ctx.counters)",
    # the family's span kind: the profiled calls' qr records and the idle
    # time the reduction put down to their spans (no device on the CPU)
    "qr_spans": "lambda ctx: len([r for r in ctx.spans if r['kind'] == "
                "'qr']) if dict(ctx.trace['idle_gaps']).get('qr') else None",
}


def stub_root(tmp_path):
    """A checkout holding only new files of one stub cell: the spec, its
    configuration, traffic, problem family and readers."""
    root = tmp_path / "root"
    bench = root / "benchmark"
    for d in ("configs", "traffic", "problems", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "stub.json").write_text(json.dumps(
        {"problem": "stub_qr", "n": 8, "checks": {"residual": 1e-12}}))
    (bench / "traffic" / "one.json").write_text(json.dumps(
        {"batch": 3, "pool": 2, "warmup_calls": 1, "trace_calls": 2}))
    (bench / "problems" / "stub_qr.py").write_text(STUB_FAMILY)
    for name in ("problems_per_s", "setup_s"):
        shutil.copy(os.path.join(harness.HERE, "metrics", name + ".py"),
                    bench / "metrics")
    for name, fn in STUB_READERS.items():
        (bench / "metrics" / f"{name}.py").write_text(f"read = {fn}\n")
    cell = {"name": "stub.one", "config": "stub", "traffic": "one",
            "chips": 1, "why": "a stub"}
    metric = dict(unit="calls", better="lower", source="program_counter",
                  layer="stub", moves="problems_per_s")
    (root / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "stub", "file": "benchmark/configs/stub.json"}],
        "workloads": [cell],
        "end_to_end": [{"name": "problems_per_s", "unit": "problems/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [dict(metric, name=n) for n in STUB_READERS]}))
    return str(root)


def test_a_family_adds_a_span_kind_and_a_counter(tmp_path):
    root = stub_root(tmp_path)
    traced = harness.run_cell("stub.one", 5, 0.05, 1, device="cpu",
                              t_start=time.time(), root=root)
    assert traced["correct"]
    assert traced["metrics"]["qr_calls_per_call"]["value"] == 1.0
    # the profiled calls: the profiler's warm-up call and trace_calls
    assert traced["metrics"]["qr_spans"]["value"] == 3
    assert "qr" in dict(traced["breakdown"]["idle_gaps"])
    assert torch.linalg.qr.__class__ is not tracing._Wrapped
    plain = harness.run_cell("stub.one", 5, 0.05, 0, device="cpu",
                             t_start=time.time(), root=root)
    assert set(plain["metrics"]) == {"problems_per_s", "setup_s"}
