"""The port's modeling DSL (cvxopt_tpu_torch/modeling.py) against
cvxopt_tpu/modeling.py — twins of tests/test_modeling.py,
tests/test_modeling_chap10.py and tests/test_modeling_breadth.py.

Each case builds its problem with one package's `modeling` module and
solves it (the port on the CPU); the case's own checks hold for both,
and the values it returns (statuses, variable values, objectives,
multipliers) agree within 1e-6.  One known difference: the port divides
an expression by a one-element list as by its scalar, where the JAX
package raises TypeError."""

import os

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from cvxopt_tpu import modeling as jmd
from cvxopt_tpu_torch import modeling as tmd

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
DOC_A = np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]])
DOC_B = np.array([3., 3., 0., 0.])


def _val(p):
    return float(np.asarray(p.objective.value()).reshape(-1)[0])


# ---- test_modeling.py ------------------------------------------------

def case1_scalar_lp(md, solve):
    x, y = md.variable(), md.variable()
    c1, c2 = (2 * x + y <= 3), (x + 2 * y <= 3)
    lp1 = md.op(-4 * x - 5 * y, [c1, c2, x >= 0, y >= 0])
    repr(x), str(x), repr(lp1), str(lp1)
    solve(lp1)
    assert lp1.status == "optimal"
    np.testing.assert_allclose(x.value, [1.0], atol=1e-5)
    np.testing.assert_allclose(y.value, [1.0], atol=1e-5)
    np.testing.assert_allclose(c1.multiplier.value, [1.0], atol=1e-4)
    np.testing.assert_allclose(c2.multiplier.value, [2.0], atol=1e-4)
    return dict(status=lp1.status, x=x.value, y=y.value,
                m1=c1.multiplier.value, m2=c2.multiplier.value)


def case2_matrix_lp(md, solve):
    x = md.variable(2)
    p = md.op(md.dot(np.array([-4., -5.]), x), DOC_A @ x <= DOC_B)
    solve(p)
    assert p.status == "optimal" and abs(_val(p) + 9.0) < 1e-4
    return dict(status=p.status, x=x.value, obj=_val(p))


def _pwl(md, solve, m, n, tol):
    rng = np.random.default_rng(100)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    out = {}
    x1 = md.variable(n)
    lp1 = md.op(md.max(abs(A @ x1 - b)))
    solve(lp1)
    assert lp1.status == "optimal"
    assert abs(_val(lp1) - np.abs(A @ x1.value - b).max()) < 1e-6
    x2 = md.variable(n)
    lp2 = md.op(md.sum(abs(A @ x2 - b)))
    solve(lp2)
    assert lp2.status == "optimal"
    r2 = np.abs(A @ x2.value - b).sum()
    assert abs(_val(lp2) - r2) < tol
    x3 = md.variable(n)
    lp3 = md.op(md.sum(md.max(0, abs(A @ x3 - b) - 0.75,
                              2 * abs(A @ x3 - b) - 2.25)))
    solve(lp3)
    assert lp3.status == "optimal"
    u = np.abs(A @ x3.value - b)
    r3 = np.maximum(0, np.maximum(u - 0.75, 2 * u - 2.25)).sum()
    assert abs(_val(lp3) - r3) < tol and r3 <= r2 + 1e-6
    for k, p in (("linf", lp1), ("l1", lp2), ("pen", lp3)):
        out[k] = _val(p)
    return out


def case3_pwl(md, solve):
    return _pwl(md, solve, 100, 20, 1e-5)


def case3_pwl_full_size(md, solve):
    """The reference's stress case at full size (500 x 100)."""
    return _pwl(md, solve, 500, 100, 1e-4)


def pwl_constraint(md, solve):
    rng = np.random.default_rng(1)
    c = rng.standard_normal(5)
    x = md.variable(5)
    p = md.op(md.dot(c, x), [md.max(abs(x)) <= 1])
    solve(p)
    assert p.status == "optimal"
    assert abs(_val(p) + np.abs(c).sum()) < 1e-5
    return dict(status=p.status, x=x.value, obj=_val(p))


def equality_and_value(md, solve):
    x = md.variable(3)
    p = md.op(md.dot(np.array([3., 1., 2.]), x),
              [np.array([[1., 1., 1.]]) @ x == 1.0, x >= 0])
    solve(p)
    assert p.status == "optimal"
    np.testing.assert_allclose(x.value, [0., 1., 0.], atol=1e-6)
    return dict(status=p.status, x=x.value)


def loadfile(md, solve):
    lp = md.op()
    lp.fromfile(os.path.join(DATA, "boeing2.mps"))
    sol = solve(lp)
    assert lp.status == "optimal"
    return dict(status=lp.status, obj=sol["primal objective"])


def tofile_roundtrip(md, solve, tmp_path):
    x = md.variable(2, "x")
    pr = md.op(md.dot(np.array([-4., -5.]), x), DOC_A @ x <= DOC_B)
    path = str(tmp_path / "small.mps")
    pr.tofile(path)
    lp2 = md.op().fromfile(path)
    sol = solve(lp2)
    assert lp2.status == "optimal"
    assert abs(sol["primal objective"] + 9.0) < 1e-4
    with open(path) as f:
        text = f.read()
    return dict(status=lp2.status, obj=sol["primal objective"], text=text)


def min_concave_constraint(md, solve):
    x = md.variable(2)
    p = md.op(md.sum(x), [md.min(x[0], x[1]) >= 1])
    solve(p)
    assert p.status == "optimal"
    np.testing.assert_allclose(x.value, [1.0, 1.0], atol=1e-5)
    return dict(status=p.status, x=x.value)


def inplace_expression_arithmetic(md, solve):
    x = md.variable(2, "x")
    f = 2 * x[0] + x[1]
    f += x[0]
    f -= 3 * x[1]
    f *= 2.0
    p = md.op(f, [x >= 0, x <= 1, x[0] + x[1] >= 0.5])
    solve(p)
    assert p.status == "optimal"
    np.testing.assert_allclose(x.value, [0.0, 1.0], atol=1e-5)
    return dict(status=p.status, x=x.value)


# ---- test_modeling_chap10.py (M, N = 60, 15) ---------------------------

M, N = 60, 15


def _data(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((M, N)), rng.standard_normal(M)


def normappr(md, solve):
    A, b = _data(0)
    objs = []
    for f in (lambda x: md.max(abs(A @ x + b)),
              lambda x: md.sum(abs(A @ x + b)),
              lambda x: md.sum(md.max(0, abs(A @ x + b) - 0.75,
                                      2 * abs(A @ x + b) - 2.25))):
        p = md.op(f(md.variable(N)))
        solve(p)
        assert p.status == "optimal"
        objs.append(_val(p))
    assert objs[2] <= objs[1] + 1e-6
    return dict(objs=np.array(objs))


def l1svc(md, solve):
    A, _ = _data(1)
    x, u = md.variable(N, "x"), md.variable(M, "u")
    solve(md.op(md.sum(abs(x)) + md.sum(u), [A @ x >= 1 - u, u >= 0]))
    x2 = md.variable(N, "x2")
    solve(md.op(md.sum(abs(x2)) + md.sum(md.max(0, 1 - A @ x2))))
    assert np.linalg.norm(x.value - x2.value) < 1e-4
    return dict(x=x.value, x2=x2.value)


def roblp(md, solve):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((M, N))
    b = rng.uniform(0, 1, M)
    c = rng.standard_normal(N)
    x = md.variable(N)
    solve(md.op(md.dot(c, x), A @ x + md.sum(abs(x)) <= b))
    x2, y = md.variable(N), md.variable(N)
    solve(md.op(md.dot(c, x2), [A @ x2 + md.sum(y) <= b, -y <= x2,
                                x2 <= y]))
    assert np.linalg.norm(x.value - x2.value) < 1e-4
    return dict(x=x.value, x2=x2.value)


# ---- test_modeling_breadth.py ----------------------------------------

def division_and_unary_pos(md, solve):
    x = md.variable(2, "x")
    e = (2.0 * x[0] + 4.0 * x[1]) / 2.0
    p = md.op(+e, [x[0] >= 1.0, x[1] >= 2.0])
    solve(p)
    assert p.status == "optimal" and abs(_val(p) - 5.0) < 1e-5
    with pytest.raises(TypeError):
        _ = 1.0 / x        # noqa: F841
    with pytest.raises(TypeError):
        _ = x / x[0]       # noqa: F841
    return dict(status=p.status, obj=_val(p))


def lt_gt_aliases(md, solve):
    x = md.variable(1, "x")
    p = md.op(x, [x > 3.0])
    solve(p)
    assert p.status == "optimal"
    x1 = np.array(x.value)
    np.testing.assert_allclose(x1, [3.0], atol=1e-6)
    solve(md.op(-x, [x < 2.0]))
    np.testing.assert_allclose(x.value, [2.0], atol=1e-6)
    return dict(x1=x1, x2=x.value)


def nested_max_of_max(md, solve):
    x = md.variable(1, "x")
    inner = md.max(x - 1.0, -x - 1.0)
    p = md.op(md.max(inner + 0.5, 2.0 * x - 3.0))
    solve(p)
    assert p.status == "optimal" and abs(_val(p) + 0.5) < 1e-5
    np.testing.assert_allclose(x.value, [0.0], atol=1e-4)
    return dict(obj=_val(p), x=x.value)


def nested_min_of_min_constraint(md, solve):
    x = md.variable(1, "x")
    outer = md.min(md.min(x + 1.0, 3.0 - x), 2.0 * x + 0.5)
    p = md.op(x, [outer >= 0.5])
    solve(p)
    assert p.status == "optimal"
    np.testing.assert_allclose(x.value, [0.0], atol=1e-5)
    return dict(x=x.value)


def _linprog_fit(A, b, norm):
    m, n = A.shape
    if norm == "l1":
        c = np.concatenate([np.zeros(n), np.ones(m)])
        Aub = np.block([[A, -np.eye(m)], [-A, -np.eye(m)]])
        k = n + m
    else:
        c = np.concatenate([np.zeros(n), [1.0]])
        Aub = np.block([[A, -np.ones((m, 1))], [-A, -np.ones((m, 1))]])
        k = n + 1
    ref = linprog(c, A_ub=Aub, b_ub=np.concatenate([b, -b]),
                  bounds=[(None, None)] * k)
    assert ref.status == 0
    return ref.fun


def l1_fit_vs_scipy(md, solve):
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((14, 3)), rng.standard_normal(14)
    x = md.variable(3, "x")
    p = md.op(md.sum(abs(A @ x - b)))
    solve(p)
    assert p.status == "optimal"
    assert abs(_val(p) - _linprog_fit(A, b, "l1")) < 1e-5
    return dict(obj=_val(p))


def linf_fit_vs_scipy(md, solve):
    rng = np.random.default_rng(1)
    A, b = rng.standard_normal((11, 3)), rng.standard_normal(11)
    x = md.variable(3, "x")
    p = md.op(md.max(abs(A @ x - b)))
    solve(p)
    assert p.status == "optimal"
    assert abs(_val(p) - _linprog_fit(A, b, "linf")) < 1e-5
    return dict(obj=_val(p), x=x.value)


def inplace_div_and_mul(md, solve):
    x = md.variable(2, "x")
    e = 4.0 * x[0] + 2.0 * x[1]
    e /= 2.0
    e *= 3.0
    p = md.op(e, [x >= 1.0])
    solve(p)
    assert p.status == "optimal" and abs(_val(p) - 9.0) < 1e-5
    return dict(obj=_val(p), x=x.value)


def scaled_pwl_composition(md, solve):
    x = md.variable(1, "x")
    p = md.op(2.0 * md.max(x, -x) + 0.5 * md.max(x - 1.0, 1.0 - x))
    solve(p)
    assert p.status == "optimal"
    g = np.linspace(-2, 2, 4001)
    best = (2 * np.abs(g) + 0.5 * np.maximum(g - 1, 1 - g)).min()
    assert abs(_val(p) - best) < 1e-4
    return dict(obj=_val(p))


def expression_slicing_in_constraints(md, solve):
    x = md.variable(4, "x")
    A = np.arange(16.0).reshape(4, 4) + np.eye(4) * 10
    e = A @ x
    p = md.op(md.sum(x), [e[:2] >= 1.0, e[2:] >= 2.0, x >= 0.0])
    solve(p)
    assert p.status == "optimal"
    r = A @ x.value
    assert (r[:2] >= 1.0 - 1e-6).all() and (r[2:] >= 2.0 - 1e-6).all()
    return dict(x=x.value, obj=_val(p))


CASES = [case1_scalar_lp, case2_matrix_lp, case3_pwl, case3_pwl_full_size,
         pwl_constraint, equality_and_value, loadfile,
         min_concave_constraint, inplace_expression_arithmetic,
         normappr, l1svc, roblp, division_and_unary_pos, lt_gt_aliases,
         nested_max_of_max, nested_min_of_min_constraint,
         l1_fit_vs_scipy, linf_fit_vs_scipy, inplace_div_and_mul,
         scaled_pwl_composition, expression_slicing_in_constraints]


def _compare(out, ref):
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, str):
            assert out[k] == v, k
        else:
            np.testing.assert_allclose(np.asarray(out[k], dtype=float),
                                       np.asarray(v, dtype=float),
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_case_matches_jax(case):
    out = case(tmd, lambda p: p.solve(device="cpu"))
    ref = case(jmd, lambda p: p.solve())
    _compare(out, ref)


def test_tofile_roundtrip(tmp_path):
    """op.tofile writes the text the JAX package writes, and the file
    solves back to the same objective."""
    out = tofile_roundtrip(tmd, lambda p: p.solve(device="cpu"), tmp_path)
    ref = tofile_roundtrip(jmd, lambda p: p.solve(), tmp_path)
    _compare(out, ref)


def test_exceptions():
    for md in (tmd, jmd):
        with pytest.raises(TypeError):
            md.variable(0)


def test_truediv_by_one_element_list():
    """Known difference: the port divides by [c] or (c,) as by c; the
    JAX package raises TypeError (modeling.py:248-258)."""
    for o in ([2.0], (2.0,), np.array([2.0])):
        x = tmd.variable(2, "x")
        e = (2.0 * x[0] + 4.0 * x[1]) / o
        p = tmd.op(e, [x[0] >= 1.0, x[1] >= 2.0])
        p.solve(device="cpu")
        assert p.status == "optimal" and abs(_val(p) - 5.0) < 1e-6
    with pytest.raises(TypeError):
        (2.0 * jmd.variable(2)[0]) / [2.0]
    with pytest.raises(TypeError):
        tmd.variable(2) / [1.0, 2.0]


def test_solve_through_glpk_matches_ipm():
    """op.solve(solver='glpk') runs the port's simplex: the vertex and
    multipliers of the documented LP, as the IPM gives them."""
    x, y = tmd.variable(), tmd.variable()
    c1 = (2 * x + y <= 3)
    p = tmd.op(-4 * x - 5 * y, [c1, x >= 0, y >= 0, x + 2 * y <= 3])
    sol = p.solve(solver="glpk", device="cpu")
    assert p.status == "optimal" and isinstance(sol["x"], np.ndarray)
    np.testing.assert_allclose(np.r_[x.value, y.value], [1.0, 1.0],
                               atol=1e-9)
    np.testing.assert_allclose(c1.multiplier.value, [1.0], atol=1e-9)
