"""The robust least-squares SOCP set (benchmark configuration
`socp_robls_n64`, cell `socp_robls.b1024`) on the CPU, in float64.

The port's cascade and `make_coneqp` on 'q' cones are held to the plain
reference `reference/socp_torch.py` on seeded draws of the benchmark's
problem family, and the reference to the frozen numpy one it was
transcribed from (`benchmark/reference/npref.py`).  The family's judge
flags answers that leave a cone or move x; the cone layer's spans open
on 'q' dims and on no 'l'-only ones; the three readers of the cell read
what they should; the cell runs end to end at a tiny size and its
control fails.

Tolerances on x: the draws hold blocks that are nearly active at the
optimum, where x is pinned only to about sqrt(gap) (measured: x moves
by up to 9.4e-5 between two solves stopped at gap <= 1e-7 and by up to
3.3e-6 at 1e-10, with the objective within 1.1e-7 relative), so x is
compared within 2e-4 at the configuration's tolerances and within 1e-5
at 1e-10.
"""

from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, tracing
from benchmark.reference import npref
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.coneqp import make_coneqp, make_coneqp_cascade
from reference import socp_torch

# small tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

CELL = "socp_robls.b1024"
SPEC = harness.load_spec()
_, CFG, TRAFFIC = harness.cell_parts(SPEC, CELL)
FAMILY = harness.load_module(
    os.path.join(harness.HERE, "problems", CFG["problem"] + ".py"),
    "test_family_" + CFG["problem"])
# (n, blocks, factor columns, batch): a small draw, and the published
# widths at a batch of 2
SIZES = {"small": (16, 10, 4, 4), "published": (64, 100, 16, 2)}
TINY = {"config": {"n": 16, "nq": 10, "factor_cols": 4, "m": 40},
        "traffic": {"batch": 4, "pool": 2, "warmup_calls": 1,
                    "trace_calls": 2}}


def draw(size, seed, pool=1):
    n, nq, cols, B = SIZES[size]
    cfg = {**CFG, "n": n, "nq": nq, "factor_cols": cols}
    return FAMILY.make_pool(cfg, {**TRAFFIC, "batch": B, "pool": pool},
                            seed, "cpu")


def tols(tol):
    return dict(abstol=tol, reltol=0.0 if tol < 1e-7 else tol, feastol=tol)


def reference(d, i, tol, maxiters=50):
    return socp_torch.coneqp_cones(
        d["P"][i], d["q"][i], d["G"][i], d["h"][i], d["judge"]["dims"],
        maxiters=maxiters, **tols(tol))


@pytest.mark.parametrize("solver", ["cascade", "make_coneqp"])
@pytest.mark.parametrize("size, tol, xtol", [
    ("small", 1e-7, 2e-4), ("small", 1e-10, 1e-5),
    ("published", 1e-7, 2e-4), ("published", 1e-10, 1e-5)])
def test_port_matches_the_plain_reference(size, tol, xtol, solver):
    d, = draw(size, seed=2)
    dims = ConeDims(q=(CFG["mq"],) * SIZES[size][1])
    if solver == "cascade":
        solve = make_coneqp_cascade(dims, kktsolver="chol2_inv",
                                    maxiters=50, shared_GhAb=False,
                                    device="cpu", **tols(tol))
    else:
        solve = make_coneqp(dims, maxiters=50, device="cpu", **tols(tol))
    out = solve(d["P"], d["q"], d["G"], d["h"], d["A"], d["b"])
    assert (out["status"] == 0).all()
    for i in range(d["q"].shape[0]):
        ref = reference(d, i, tol)
        assert ref["status"] == "optimal"
        assert float((out["x"][i] - ref["x"]).abs().max()) <= xtol
        assert abs(float(out["pcost"][i]) - ref["pcost"]) <= \
            1e-6 * abs(ref["pcost"])


@pytest.mark.parametrize("size, seed", [("small", 0), ("small", 1),
                                        ("published", 0)])
def test_reference_matches_the_frozen_numpy_reference(size, seed):
    d, = draw(size, seed)
    data = [d[k][0].numpy() for k in ("P", "q", "G", "h")]
    tol = dict(maxiters=60, abstol=1e-9, reltol=0.0, feastol=1e-9)
    a = npref.coneqp_np_cones(*data, d["judge"]["dims"], **tol)
    b = socp_torch.coneqp_cones(*(torch.as_tensor(u) for u in data),
                                d["judge"]["dims"], **tol)
    assert a["status"] == b["status"] == "optimal"
    assert a["iterations"] == b["iterations"]
    for k in ("x", "s", "z"):
        np.testing.assert_allclose(b[k].numpy(), a[k], rtol=0, atol=1e-10)


def test_reference_refuses_s_blocks():
    with pytest.raises(ValueError):
        socp_torch.coneqp_cones(torch.eye(2), torch.ones(2),
                                -torch.eye(4)[:, :2], torch.ones(4),
                                {"l": 0, "q": [], "s": [2]})


def test_benchmark_copy_is_the_reference_verbatim():
    root = harness.ROOT
    assert filecmp.cmp(os.path.join(root, "reference", "socp_torch.py"),
                       os.path.join(root, "benchmark", "reference",
                                    "socp_torch.py"), shallow=False)


def _answer(d, i):
    ref = reference(d, i, 1e-9, maxiters=60)
    return {k: ref[k].clone() for k in ("x", "y", "s", "z")}


@pytest.mark.parametrize("part", ["s", "z"])
def test_judge_flags_a_point_outside_a_cone(part):
    d, = draw("small", seed=5)
    ans = _answer(d, 1)
    good = FAMILY.judge(d, 1, ans)
    assert good["cone"] == 0.0 and good["gap"] <= 1e-8
    assert good["x_ref"] <= CFG["checks"]["x_ref"]
    # lift the tail of block 3 just past its head: ||u1|| > u0
    u = ans[part]
    blk = u[12:16]
    blk[1:] *= (float(blk[0]) + 1e-6) / float(torch.linalg.vector_norm(
        blk[1:]))
    bad = FAMILY.judge(d, 1, ans)
    assert bad["cone"] == pytest.approx(1e-6, rel=1e-3)
    assert bad["cone"] > CFG["checks"]["cone"]


def test_judge_flags_a_moved_x():
    d, = draw("small", seed=5)
    ans = _answer(d, 0)
    ans["x"] = ans["x"] + 1e-3
    nums = FAMILY.judge(d, 0, ans)
    assert nums["x_ref"] > CFG["checks"]["x_ref"]
    assert nums["pres"] > CFG["checks"]["pres"]


def test_pool_is_seeded_convex_and_strictly_feasible():
    big = 2 ** 31 + 12345
    a, b, c = (draw("small", s, pool=2) for s in (big, big, big + 1))
    for x, y, z in zip(a, b, c):
        for k in ("P", "q", "G", "h", "A", "b"):
            assert torch.equal(x[k], y[k]) and x[k].shape == z[k].shape
        assert not torch.equal(x["G"], z["G"])
        assert x["P"].dtype == torch.float64
        assert float(torch.linalg.eigvalsh(x["P"]).min()) > 0.05
        # x = 0 is strictly feasible: each block of h lies inside its cone
        h = x["h"].reshape(x["h"].shape[0], -1, CFG["mq"])
        assert (torch.linalg.vector_norm(h[..., 1:], dim=-1)
                < h[..., 0]).all()
    assert not torch.equal(a[0]["G"], a[1]["G"])


def traced(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.CALL):
            out = fn()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, json.load(f)["traceEvents"]


@pytest.mark.parametrize("cones", ["q", "l"])
def test_cone_spans_open_on_q_dims_only(cones, tmp_path):
    d, = draw("small", seed=3)
    if cones == "q":
        dims = ConeDims(q=(CFG["mq"],) * SIZES["small"][1])
        args = (d["P"], d["q"], d["G"], d["h"], d["A"], d["b"])
    else:
        n = d["q"].shape[-1]
        dims = ConeDims(l=2 * n)
        eye = torch.eye(n, dtype=torch.float64)
        args = (d["P"], d["q"], torch.cat([-eye, eye]),
                torch.cat([torch.zeros(n), torch.ones(n)]).double(),
                torch.ones((1, n), dtype=torch.float64),
                torch.ones(1, dtype=torch.float64))
    solve = make_coneqp_cascade(dims, kktsolver="chol2_inv",
                                shared_GhAb=cones == "l", device="cpu",
                                **tols(1e-7))
    plain = solve(*args)
    out, events = traced(lambda: solve(*args), tmp_path)
    assert (out["status"] == 0).all()
    assert torch.equal(out["x"], plain["x"])
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    cone = {n for n in names if n.startswith("cvx.cone.")}
    if cones == "q":
        assert cone == {"cvx.cone.scaling", "cvx.cone.step"}
        reduced = tracing.reduce_trace(events)
        assert reduced["program"]["cvx.cone.step"]["count"] > \
            reduced["program"]["cvx.ipm.pass"]["count"]
    else:
        assert not cone and "cvx.ipm.pass" in names


def ev(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def cone_trace(with_cone=True):
    """One call (0-100 us): a pass with a scaling span (idle 30-40, its
    kernel 40-50), a step span (its kernel 60-65) and a QR span (kernel
    80-90); idle elsewhere."""
    evs = [ev("bench.call", 0, 100), ev("cvx.cascade.solve", 0, 100),
           ev("cvx.ipm.pass", 10, 85),
           ev("cudaLaunchKernel", 35, 1, cat="cuda_runtime", correlation=1),
           ev("cudaLaunchKernel", 58, 1, cat="cuda_runtime", correlation=2),
           ev("cudaLaunchKernel", 78, 1, cat="cuda_runtime", correlation=3),
           ev("bench.qr.0", 75, 15),
           ev("k_scale", 40, 10, cat="kernel", correlation=1),
           ev("k_step", 60, 5, cat="kernel", correlation=2),
           ev("geqrf", 80, 10, cat="kernel", correlation=3)]
    if with_cone:
        evs += [ev("cvx.cone.scaling", 30, 25), ev("cvx.cone.step", 55, 12)]
    return evs


def read(name, ctx):
    mod = harness.load_module(
        os.path.join(harness.HERE, "metrics", name + ".py"), "t_" + name)
    return mod.read(ctx)


def test_cone_readers():
    ctx = harness.Context(trace=tracing.reduce_trace(cone_trace()))
    # idle under a cone span: 30-40, 50-55 (scaling), 55-60, 65-67 (step)
    assert read("idle_cone_pct", ctx) == pytest.approx(22.0)
    assert read("cone_busy_pct", ctx) == pytest.approx(15.0)
    total = sum(read(f"idle_{layer}_pct", ctx)
                for layer in ("cone", "ipm", "cascade"))
    assert total <= read("device_idle_pct", ctx)
    # a program without the cone layer's spans reads nothing, not 0
    parent = harness.Context(trace=tracing.reduce_trace(cone_trace(False)))
    assert read("idle_cone_pct", parent) is None
    assert read("cone_busy_pct", parent) is None
    assert read("idle_ipm_pct", parent) is not None


def test_qr_roofline_reader():
    mod = harness.load_module(
        os.path.join(harness.HERE, "metrics", "qr_roofline.py"), "t_qr")
    flops, nbytes = mod.qr_work(1024, 464, 64, 4)
    assert flops == pytest.approx(1024 * 2 * 64 ** 2 * (464 - 64 / 3))
    assert nbytes == pytest.approx(1024 * (464 * 64 + 64 * 65 / 2) * 4)
    r = tracing.reduce_trace(cone_trace())
    spans = [dict(kind="qr", shape=(1024, 464, 64), esize=4)]
    got = read("qr_roofline", harness.Context(trace=r, spans=spans))
    least = max(flops / 67e12, nbytes / 3.35e12)
    assert got == pytest.approx(100 * least / 10e-6)
    assert read("qr_roofline", harness.Context(trace=None, spans=[])) is None


# The harness refuses to report from a process that loaded JAX, as this
# one has (tests/conftest.py): the cell runs in a fresh interpreter.
CELL_RUNS = """
import json, sys, time
import torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from benchmark import control, harness
out = {{}}
for trace in (0, 1):
    out[trace] = harness.run_cell({cell!r}, 2 ** 31 + 77, 0.3, trace,
                                  device="cpu", t_start=time.time(),
                                  overrides={tiny!r})
out["control"] = control.readings({cell!r}, 11, 0.3, device="cpu",
                                  overrides={tiny!r})[0]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cell_runs():
    code = CELL_RUNS.format(root=harness.ROOT, cell=CELL, tiny=TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_runs_untraced_on_the_cpu(cell_runs):
    r = cell_runs["0"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"problems_per_s", "setup_s"}
    assert set(r["checks"]) == {"pres", "dres", "gap", "cone", "x_ref"}


def test_cell_runs_traced_on_the_cpu(cell_runs):
    r = cell_runs["1"]
    assert r["correct"] and r["failed"] == 0
    m = r["metrics"]
    assert {"idle_cone_pct", "cone_busy_pct", "idle_ipm_pct",
            "replay_share", "host_syncs_per_call"} <= set(m)
    # the IPM tapes do not take 'q' cones: every pass runs eagerly
    assert m["replay_share"]["value"] == 0.0
    assert "cvx.cone.scaling" in dict(r["breakdown"]["idle_gaps"])


def test_control_fails(cell_runs):
    r = cell_runs["control"]
    assert not r["correct"], r["checks"]


def test_configuration_keeps_the_published_widths():
    entry = next(c for c in SPEC["configs"] if c["name"] == CFG["name"])
    assert entry["reduced"] == ["batch_per_call"] == list(CFG["reduced"])
    assert (CFG["n"], CFG["nq"], CFG["mq"], CFG["factor_cols"]) == \
        (64, 100, 4, 16)
    # the pool holds the whole set, in batches of bench.py's chunk
    assert TRAFFIC["batch"] * TRAFFIC["pool"] == CFG["source_batch"] \
        == 10240
    s = CFG["solver"]
    assert (s["abstol"], s["reltol"], s["feastol"]) == (1e-7,) * 3
