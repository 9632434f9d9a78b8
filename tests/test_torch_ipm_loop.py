"""The IPM loop factors only for steps it takes (`coneqp._coneqp_solve`).

A pass is one step for the running instances followed by the exit test
of the new point, and the start point is tested before the first pass,
so a loop whose longest instance takes k steps factors k times besides
its start point and reads the status k + 1 times.  Phase B of the
cascade builds its cold start point only where a warm start is invalid,
after one read of the warm starts' validity.  On an 'l' problem (the
scenario QPs) and a 'q' problem (the robust least-squares SOCPs at a
small size), on the CPU; this file imports no jax.
"""

import os

import numpy as np
import pytest
import torch

from benchmark import harness
from cvxopt_tpu_torch import ipm_graph
from cvxopt_tpu_torch import kkt
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.coneqp import make_coneqp, make_coneqp_cascade

torch.set_num_threads(1)

TOLS = dict(abstol=1e-7, reltol=1e-7, feastol=1e-7)


def scenario(B=6, n=24, seed=5):
    """bench.py's scenario QPs (G, h, A, b shared), in float64."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((B, n, n // 4)) / np.sqrt(n)
    P = F @ F.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = -rng.uniform(0, 0.1, (B, n))
    G = np.concatenate([-np.eye(n), np.eye(n)])
    h = np.concatenate([np.zeros(n), np.ones(n)])
    return (ConeDims(l=2 * n), True,
            tuple(torch.as_tensor(u, dtype=torch.float64)
                  for u in (P, q, G, h, np.ones((1, n)), np.ones(1))))


def socp(B=8, seed=5):
    """The benchmark's robust least-squares SOCPs at n = 16 with 10
    SOC(4) blocks (G, h per instance)."""
    spec = harness.load_spec()
    _, cfg, traffic = harness.cell_parts(spec, "socp_robls.b1024")
    cfg = {**cfg, "n": 16, "nq": 10, "factor_cols": 4, "m": 40}
    fam = harness.load_module(
        os.path.join(harness.HERE, "problems", "socp_robls.py"),
        "test_ipm_loop_socp_robls")
    d, = fam.make_pool(cfg, {**traffic, "batch": B, "pool": 1}, seed, "cpu")
    return (ConeDims(q=(4,) * 10), False,
            (d["P"], d["q"], d["G"], d["h"], d["A"], d["b"]))


DATA = {"l": scenario, "q": socp}


@pytest.fixture()
def factors(monkeypatch):
    """A list that gets one entry per KKT factor call of the solvers
    made inside the test."""
    calls = []
    real = kkt.get_kktsolver

    def get_kktsolver(*args, **kw):
        factor = real(*args, **kw)

        def counted(*fargs, **fkw):
            calls.append(1)
            return factor(*fargs, **fkw)
        return counted

    monkeypatch.setattr(kkt, "get_kktsolver", get_kktsolver)
    ipm_graph.reset_counts()
    return calls


def cascade(dims, shared):
    return make_coneqp_cascade(dims, kktsolver="chol2_inv",
                               shared_GhAb=shared, device="cpu", **TOLS)


def warm_starts(raw_a):
    iv = {k: raw_a[k].to(torch.float64) for k in ("x", "y", "s", "z")}
    iv["_valid"] = raw_a["status"] == 0
    return iv


@pytest.mark.parametrize("cone", ["l", "q"])
@pytest.mark.parametrize("phase", ["make_coneqp", "a", "b", "c"])
def test_a_factor_per_step_taken(cone, phase, factors):
    """Each loop factors once per step of its longest instance, plus once
    for a cold start point, and reads the status once more than that
    many steps; phase B, whose warm starts are all valid here, reads
    their validity once and builds no cold point."""
    dims, shared, args = DATA[cone]()
    solve = cascade(dims, shared)
    iv = warm_starts(solve.phase_a(*args)) if phase == "b" else None
    del factors[:]
    if phase == "make_coneqp":
        out = make_coneqp(dims, kktsolver="chol2_inv", device="cpu",
                          **TOLS)(*args)
    elif phase == "a":
        out = solve.phase_a(*args)
    elif phase == "b":
        out = solve.phase_b(*args, iv)
    else:
        out = solve.phase_c(*args)
    assert (out["status"] == 0).all()
    steps = int(out["iterations"].max())
    assert steps > 0
    cold = phase != "b"
    assert len(factors) == steps + cold
    assert out["host_syncs"] == steps + 1 + (not cold)
    assert ipm_graph.counts()["cold_skips"] == (not cold)
    assert ipm_graph.counts()["cold_starts"] == 0


@pytest.mark.parametrize("cone", ["l", "q"])
@pytest.mark.parametrize("bad", ["nan", "_valid"])
def test_phase_b_cold_point_only_for_an_invalid_warm_start(cone, bad,
                                                            factors):
    """Every warm start valid: no cold factor.  One made invalid (a
    non-finite x, or phase A's flag false): the cold point is built, that
    instance starts from it as in a cold phase B, and every other
    instance comes out bit for bit as with all warm starts valid."""
    dims, shared, args = DATA[cone]()
    solve = cascade(dims, shared)
    iv = warm_starts(solve.phase_a(*args))
    assert bool(iv["_valid"].all())
    j = 2
    del factors[:]
    ipm_graph.reset_counts()
    good = solve.phase_b(*args, iv)
    assert len(factors) == int(good["iterations"].max())
    assert ipm_graph.counts()["cold_skips"] == 1

    iv_bad = dict(iv)
    if bad == "nan":
        iv_bad["x"] = iv["x"].clone()
        iv_bad["x"][j, 0] = float("nan")
    else:
        iv_bad["_valid"] = iv["_valid"].clone()
        iv_bad["_valid"][j] = False
    del factors[:]
    ipm_graph.reset_counts()
    out = solve.phase_b(*args, iv_bad)
    assert ipm_graph.counts()["cold_starts"] == 1
    assert ipm_graph.counts()["cold_skips"] == 0
    assert len(factors) == 1 + int(out["iterations"].max())
    cold = solve.phase_b(*args, None)
    others = torch.arange(out["status"].shape[0]) != j
    for k in ("x", "y", "s", "z", "status", "iterations"):
        assert torch.equal(out[k][others], good[k][others]), k
        assert torch.equal(out[k][j], cold[k][j]), k


def test_restart_path_keeps_its_iterations():
    """make_coneqp's factor_dtype='rescue' at 1e-11: the f32 phase flags
    instances 0 and 3, which restart from the cold point in float64; the
    iterations of both phases are those of the loop that tested each
    point's exit at the top of the next pass, and each loop reads the
    status once more than its longest instance's steps."""
    n, nb = 16, 4
    rng = np.random.default_rng(0)
    F = rng.standard_normal((nb, n, n // 4)) / np.sqrt(n)
    P = F @ F.transpose(0, 2, 1) + 0.1 * np.eye(n)
    q = -rng.uniform(0, 0.1, (nb, n))
    G = np.concatenate([-np.eye(n), np.eye(n)])
    h = np.concatenate([np.zeros(n), np.ones(n)])
    tol = dict(abstol=1e-11, reltol=1e-11, feastol=1e-11)
    out = make_coneqp(ConeDims(l=2 * n), kktsolver="chol2",
                      factor_dtype="rescue", refinement=1, device="cpu",
                      **tol)(P, q, G, h, np.ones((1, n)), np.ones(1))
    assert out["status"].tolist() == [0, 0, 0, 0]
    assert out["iterations"].tolist() == [16, 8, 9, 14]
    assert out["rescue_iterations"].tolist() == [9, 0, 0, 8]
    phase1 = out["iterations"] - out["rescue_iterations"]
    assert out["host_syncs"] == (int(phase1.max()) + 1
                                 + int(out["rescue_iterations"].max()) + 1)


def read_cold_skip_share(counters):
    mod = harness.load_module(
        os.path.join(harness.HERE, "metrics", "cold_skip_share.py"),
        "t_cold_skip_share")
    return mod.read(harness.Context(trace_counters=counters))


def test_cold_skip_share_reader():
    """Skips over skips and builds of the profiled calls, in %; nothing
    where no call gave a warm start or the program has no such counter."""
    c = lambda starts, skips: {"ipm_graph.cold_starts": starts,  # noqa
                               "ipm_graph.cold_skips": skips}
    assert read_cold_skip_share([c(0, 1)] * 8) == 100.0
    assert read_cold_skip_share([c(1, 0), c(1, 0)]) == 0.0
    assert read_cold_skip_share([c(1, 0), c(0, 1), c(0, 1), c(0, 1)]) \
        == pytest.approx(75.0)
    assert read_cold_skip_share([c(0, 0)] * 4) is None
    assert read_cold_skip_share([]) is None
    # a program without the counters (ipm_graph.counts() lacks them)
    assert read_cold_skip_share([{"ipm_graph.replays": 3}]) is None
