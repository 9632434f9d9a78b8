"""The port's branch-and-bound (cvxopt_tpu_torch/ilp.py, glpk.ilp)
against cvxopt_tpu/ilp.py on the CPU in float64, on the same numpy
problems — twins of the cases of tests/test_ilp.py.

Where two relaxations tie within rounding the two packages may open
nodes in another order, so the twins assert equal statuses and
objectives within 1e-6, x where the optimum is unique, and each JAX
test's own checks (warm starts take fewer IPM iterations than cold;
cover cuts open at most 0.85 x the nodes), not equal node counts."""

import numpy as np
import pytest
import torch

from cvxopt_tpu.ilp import ilp as jilp
from cvxopt_tpu_torch import glpk as tglpk
from cvxopt_tpu_torch.ilp import ilp as tilp

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

C = np.array([-4., -5.])
G = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
H = np.array([3., 3., 0., 0.])
A = np.array([[1.0, 1.0]])
B1 = np.array([1.0])


def _both(c, G, h, *args, stats=None, **kw):
    """The port's (status, x), checked against the JAX package's; with
    `stats`, the port's search statistics land there."""
    if stats is not None:
        kw["options"] = {"_stats": stats}
    out = tilp(c, G, h, *args, device="cpu", **kw)
    if stats is not None:
        kw["options"] = {"_stats": {}}
    ref = jilp(c, G, h, *args, **kw)
    assert out[0] == ref[0]
    if ref[1] is None:
        assert out[1] is None
    else:
        assert abs(float(c @ out[1]) - float(c @ ref[1])) <= 1e-6
    return out


@pytest.mark.parametrize("case", ["one_integer", "all_integer", "binary",
                                  "knapsack"])
def test_ilp_small(case):
    """The reference's glpk.ilp cases (test_glpk.py:35-46) and a 0/1
    knapsack; each optimum is unique."""
    if case == "one_integer":
        st, x = _both(C, G, H, A, B1, I={0})
        assert abs(x[0] - round(x[0])) < 1e-6 and abs(x.sum() - 1) < 1e-6
        expect = [0.0, 1.0]
    elif case == "all_integer":
        st, x = _both(C, G, H, I={0, 1})
        expect = [1.0, 1.0]
    elif case == "binary":
        st, x = _both(C, G, H, B={1})
        assert x[1] in (0.0, 1.0)
        expect = [1.0, 1.0]
    else:
        c = -np.array([10., 13., 7.])
        st, x = _both(c, np.array([[3., 4., 2.]]), np.array([6.0]),
                      B={0, 1, 2})
        expect = [0., 1., 1.]
    assert st == "optimal"
    np.testing.assert_allclose(x, expect, atol=1e-6)


def test_ilp_infeasible_relaxation():
    st, x = _both(C, G, H, A, np.array([-1.0]), B={0, 1})
    assert st == "LP relaxation is primal infeasible" and x is None


def test_ilp_warm_start_fewer_iterations():
    """Warm-started children take fewer IPM iterations than cold ones;
    both searches prove optimality, so the objectives agree."""
    rng = np.random.default_rng(42)
    n = 16
    c = -rng.uniform(1.0, 10.0, n)
    w = rng.uniform(1.0, 8.0, n)
    G = np.vstack([w, np.eye(n), -np.eye(n)])
    h = np.concatenate([[0.35 * w.sum()], np.ones(n), np.zeros(n)])
    stats = {}
    for warm in (False, True):
        s = {}
        st, x = _both(c, G, h, I=range(n), stats=s, warm_start=warm,
                      max_nodes=4000)
        assert st == "optimal"
        stats[warm] = s
    assert stats[True]["ipm_iterations"] < stats[False]["ipm_iterations"]


def test_ilp_glpk_options_plumbing():
    """GLPK parameter names: it_lim caps nodes, tm_lim wall time,
    msg_lev progress output; the glpk namespace's ilp is this one."""
    c = np.array([-1.0, -1.0])
    st, x = _both(c, G, H, I=[0, 1],
                  options={"glpk": {"msg_lev": "GLP_MSG_OFF",
                                    "it_lim": 50}})
    assert st == "optimal"
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-6)
    st2, _ = tglpk.ilp(c, G, H, I=[0, 1], options={"tm_lim": 0},
                       device="cpu")
    assert st2 in ("optimal", "unknown")
    assert tglpk.ilp is tilp


def test_cover_cuts_reduce_nodes():
    """The 60-binary multi-knapsack: the same optimum with and without
    lifted cover cuts, and the cuts prune the search."""
    rng = np.random.default_rng(11)
    n = 60
    c = -rng.uniform(1, 10, n)
    W = rng.uniform(1, 10, (5, n))
    cap = 0.3 * W.sum(axis=1)
    stats = {}
    for cuts in (False, True):
        s = {}
        st, x = _both(c, W, cap, B=list(range(n)), cuts=cuts,
                      max_nodes=4000, node_batch=16, stats=s)
        assert st == "optimal"
        stats[cuts] = (s, float(c @ x))
    assert abs(stats[True][1] - stats[False][1]) < 1e-5
    assert stats[True][0]["cuts"] > 0
    assert stats[True][0]["nodes"] <= 0.85 * stats[False][0]["nodes"]
    assert set(stats[True][0]) == {"nodes", "ipm_iterations", "cuts",
                                   "best_obj"}
