"""The port's nonlinear solvers (cvxopt_tpu_torch/cvxprog.py) against
cvxopt_tpu/cvxprog.py on the CPU in float64, on the same numpy data:

  - a twin of each case of tests/test_cvxprog.py and
    tests/test_cvxprog_floorplan.py: F written again in torch, equal
    status and iteration counts, x within 1e-6 (absolute);
  - a cpl with an 's' cone (the batched 's' update of the scaling);
  - batched `make_cpl` at B = 3 against `jax.vmap` of the JAX core,
    per instance, with kktsolver 'chol' and 'chol2' and a per-instance
    b, and on the 's'-cone problem;
  - a batch in which one instance runs into maxiters while the others
    finish: each instance equals its own solve at B = 1 (finished
    instances stay frozen)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import cvxprog as jcv
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu_torch import cvxprog as tcv
from cvxopt_tpu_torch import solvers as tsolvers
from cvxopt_tpu_torch.cones import ConeDims as TDims

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

XTOL = 1e-6


def _same(out, ref, xtol=XTOL):
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=xtol, rtol=0)
    for k in ("znl", "zl"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def _acent_data():
    rng = np.random.default_rng(0)
    m, n = 5, 20
    y = rng.standard_normal(m)
    s = rng.uniform(0, 1, n)
    A = rng.standard_normal((m, n))
    r = s - A.T @ y
    A = A + np.outer(y, r) / (y @ y)      # ensures A'y > 0
    return A, A @ rng.uniform(0, 1, n)


def test_acent():
    A, b = _acent_data()
    n = A.shape[1]
    ref = jcv.cp(lambda x: jnp.array([-jnp.sum(jnp.log(x))]), np.ones(n),
                 A=A, b=b)
    out = tcv.cp(lambda x: (-torch.log(x).sum()).reshape(1), np.ones(n),
                 A=A, b=b, device="cpu")
    _same(out, ref)
    assert out["primal objective"] == pytest.approx(
        ref["primal objective"], abs=1e-8)


def _box(n):
    return np.concatenate([np.eye(n), -np.eye(n)]), np.ones(2 * n)


def test_acent2_with_box():
    rng = np.random.default_rng(1)
    m, n = 3, 8
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(0.1, 0.5, n)
    G, h = _box(n)
    ref = jcv.cp(lambda x: jnp.array([-jnp.sum(jnp.log(1.0 - x * x))]),
                 np.zeros(n), G, h, A=A, b=b)
    out = tcv.cp(lambda x: (-torch.log(1.0 - x * x).sum()).reshape(1),
                 np.zeros(n), G, h, A=A, b=b, device="cpu")
    _same(out, ref)


GP_K = [1, 2, 1, 1, 1, 1, 1]
GP_F = np.array([[-1., 1., 1., 0., -1., 1., 0., 0.],
                 [-1., 1., 0., 1., 1., -1., 1., -1.],
                 [-1., 0., 1., 1., 0., 0., -1., 1.]]).T
GP_G = np.log(np.array([1.0, 2 / 100.0, 2 / 100.0, 1 / 1000.0, 0.5,
                        1 / 2.0, 0.5, 1 / 2.0]))


def test_gp_floorplanning():
    ref = jcv.gp(GP_K, GP_F, GP_G)
    out = tsolvers.gp(GP_K, GP_F, GP_G, device="cpu")
    _same(out, ref)
    hwd = np.array([5.0, 10.0, 20.0]) / np.sqrt(3.0)
    np.testing.assert_allclose(np.exp(out["x"].numpy()), hwd, rtol=1e-3)
    # the optimum is flat: (h, w, d) reach 1e-5 only at 1e-11 tolerances
    tight = tsolvers.gp(GP_K, GP_F, GP_G, device="cpu",
                        options=dict(abstol=1e-11, reltol=1e-11,
                                     feastol=1e-11))
    assert tight["status"] == "optimal"
    np.testing.assert_allclose(np.exp(tight["x"].numpy()), hwd, rtol=1e-5)


def test_cpl_linear_objective():
    n = 4
    G, h = -np.eye(n), 2.0 * np.ones(n)
    ref = jcv.cpl(np.ones(n), lambda x: jnp.array([jnp.sum(jnp.exp(x))
                                                    - 10.0]),
                  np.zeros(n), G, h)
    out = tcv.cpl(np.ones(n), lambda x: (torch.exp(x).sum()
                                         - 10.0).reshape(1),
                  np.zeros(n), G, h, device="cpu")
    _same(out, ref)


def test_l2ac():
    rng = np.random.default_rng(2)
    m, n = 4, 10
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def Fj(x):
        r = Aj @ x - bj
        return jnp.array([0.5 * jnp.sum(r * r)
                          - jnp.sum(jnp.log(1.0 - x * x))])

    def Ft(x):
        r = At @ x - bt
        return (0.5 * (r * r).sum()
                - torch.log(1.0 - x * x).sum()).reshape(1)

    _same(tcv.cp(Ft, np.zeros(n), device="cpu"), jcv.cp(Fj, np.zeros(n)))


def _sm_kkt(lib):
    """The Sherman-Morrison kktsolver(x, znl, W) of
    tests/test_cvxprog.py, written against `lib` (jnp or torch)."""
    def Fkkt(x, znl, W):
        ex = lib.exp(x)
        H = znl[0] * ex
        dnli2 = W["dnli"][0] ** 2
        di2 = W["di"] ** 2
        D = H + di2
        u = lib.sqrt(dnli2) * ex
        Dinv = 1.0 / D
        denom = 1.0 + (u * (Dinv * u)).sum()

        def Sinv(v):
            t = Dinv * v
            return t - Dinv * u * ((u * t).sum() / denom)

        def solve(bx, by, bz):
            ux = Sinv(bx + ex * (dnli2 * bz[0]) - di2 * bz[1:])
            Wuz_nl = W["dnli"] * ((ex * ux).sum() - bz[:1])
            Wuz_l = W["di"] * (-ux - bz[1:])
            cat = lib.concatenate if lib is jnp else torch.cat
            return ux, by, cat([Wuz_nl, Wuz_l])

        return solve

    return Fkkt


def _exp_problem(n=6):
    return (np.ones(n), -np.eye(n), 2.0 * np.ones(n),
            lambda x: jnp.array([jnp.sum(jnp.exp(x)) - 10.0]),
            lambda x: (torch.exp(x).sum() - 10.0).reshape(1))


@pytest.mark.parametrize("matrix_free", [False, True])
def test_cpl_custom_kktsolver(matrix_free):
    """The twins of test_cpl_custom_kktsolver and test_cpl_matrix_free:
    each against its JAX run and against the port's dense default."""
    c, G, h, Fj, Ft = _exp_problem()
    n = c.shape[0]
    ref = jcv.cpl(c, Fj, np.zeros(n), G, h, kktsolver=_sm_kkt(jnp),
                  matrix_free=matrix_free)
    out = tcv.cpl(c, Ft, np.zeros(n), G, h, kktsolver=_sm_kkt(torch),
                  matrix_free=matrix_free, device="cpu")
    _same(out, ref)
    dense = tcv.cpl(c, Ft, np.zeros(n), G, h, device="cpu")
    np.testing.assert_allclose(out["x"].numpy(), dense["x"].numpy(),
                               rtol=1e-6, atol=1e-7)
    if matrix_free:
        with pytest.raises(ValueError):
            tcv.cpl(c, Ft, np.zeros(n), G, h, matrix_free=True,
                    device="cpu")


def test_cpl_with_soc_cone():
    n = 5
    rng = np.random.default_rng(8)
    c = rng.standard_normal(n)
    G = np.zeros((n + 1, n))
    G[1:, :] = -np.eye(n)
    h = np.zeros(n + 1)
    h[0] = 1.0
    dims = {"l": 0, "q": [n + 1], "s": []}
    ref = jcv.cpl(c, lambda x: jnp.array([jnp.sum(jnp.exp(x)) - 20.0]),
                  np.zeros(n), G, h, dims)
    out = tcv.cpl(c, lambda x: (torch.exp(x).sum() - 20.0).reshape(1),
                  np.zeros(n), G, h, dims, device="cpu")
    _same(out, ref)
    np.testing.assert_allclose(out["x"].numpy(), -c / np.linalg.norm(c),
                               atol=1e-4)


def _sdp_problem(seed=9):
    """min c'x s.t. sum(exp(x)) <= 10, -2 <= x <= 2 and
    [[1 + x0, x1], [x1, 1 - x0]] PSD (x0^2 + x1^2 <= 1): 'l' and 's'
    cones beside the nonlinear block."""
    n = 3
    c = np.random.default_rng(seed).standard_normal(n)
    Gs = np.array([[-1., 0., 0.], [0., -1., 0.], [0., -1., 0.],
                   [1., 0., 0.]])
    G = np.concatenate([np.eye(n), -np.eye(n), Gs])
    h = np.concatenate([2.0 * np.ones(2 * n), [1., 0., 0., 1.]])
    return c, G, h, {"l": 2 * n, "q": [], "s": [2]}


def test_cpl_with_sdp_cone():
    c, G, h, dims = _sdp_problem()
    n = c.shape[0]
    ref = jcv.cpl(c, lambda x: jnp.array([jnp.sum(jnp.exp(x)) - 10.0]),
                  np.zeros(n), G, h, dims)
    out = tcv.cpl(c, lambda x: (torch.exp(x).sum() - 10.0).reshape(1),
                  np.zeros(n), G, h, dims, device="cpu")
    _same(out, ref)
    x = out["x"].numpy()
    assert x[0] ** 2 + x[1] ** 2 <= 1.0 + 1e-6


def test_floorplan():
    from test_cvxprog_floorplan import build_linear, GAMMA
    Amin = np.full(5, 100.0)
    Aj, At = jnp.asarray(Amin), torch.as_tensor(Amin)

    def Fj(xv):
        hv = xv[17:22]
        return -xv[12:17] + Aj / jnp.where(hv > 0, hv, jnp.nan)

    def Ft(xv):
        hv = xv[17:22]
        return -xv[12:17] + At / torch.where(hv > 0, hv, float("nan"))

    c = np.zeros(22)
    c[0] = c[1] = 1.0
    G, h = build_linear()
    x0 = np.zeros(22)
    x0[17:] = 1.0
    ref = jcv.cpl(c, Fj, x0, G, h)
    out = tcv.cpl(c, Ft, x0, G, h, device="cpu")
    _same(out, ref)
    xv = out["x"].numpy()
    assert np.all(xv[12:17] <= GAMMA * xv[17:22] + 1e-6)
    assert abs(out["primal objective"] - (xv[0] + xv[1])) < 1e-5


def test_front_door_checks():
    c, G, h, _, Ft = _exp_problem(3)
    with pytest.raises(ValueError, match="domain"):
        tcv.cpl(c, lambda x: torch.log(x).sum().reshape(1),
                -np.ones(3), G, h, device="cpu")
    out = tsolvers.cpl(c, Ft, np.zeros(3), G, h, device="cpu")
    assert out["snl"].shape == (1,) and out["sl"].shape == (3,)


# ---- batched make_cpl against jax.vmap -----------------------------------

def _acent2_batch(B, n=8, p=3, seed=11):
    """The acent2 problem of chap9/acent2.py in the epigraph form `cp`
    builds: x = [u; t], F = [-sum log(1 - u^2) - t], shared box and A,
    a per-instance b."""
    rng = np.random.default_rng(seed)
    Au = rng.standard_normal((p, n))
    A = np.concatenate([Au, np.zeros((p, 1))], axis=1)
    b = rng.uniform(-0.5, 0.5, (B, n)) @ Au.T
    Gb, h = _box(n)
    G = np.concatenate([Gb, np.zeros((2 * n, 1))], axis=1)
    c = np.zeros(n + 1)
    c[n] = 1.0
    x0 = np.zeros(n + 1)
    x0[n] = 1.0
    Fj = lambda x: jnp.array([-jnp.sum(jnp.log(1.0 - x[:n] ** 2)) - x[n]])
    Ft = lambda x: (-torch.log(1.0 - x[:n] ** 2).sum() - x[n]).reshape(1)
    return (c, x0, G, h, A, b), {"l": 2 * n}, Fj, Ft


def _sdp_batch(B):
    """B instances of `_sdp_problem` that differ in c."""
    cs = [_sdp_problem(seed=20 + k)[0] for k in range(B)]
    _, G, h, dims = _sdp_problem()
    x0 = np.zeros(3)
    Fj = lambda x: jnp.array([jnp.sum(jnp.exp(x)) - 10.0])
    Ft = lambda x: (torch.exp(x).sum() - 10.0).reshape(1)
    return (np.stack(cs), x0, G, h, np.zeros((0, 3)), np.zeros(0)), dims, \
        Fj, Ft


def _vmap_ref(data, dims, Fj, kw):
    c, x0, G, h, A, b = data
    core = jcv.make_cpl(JDims.from_dict(dims, mnl=1), Fj, **kw)
    axes = tuple(0 if np.ndim(u) == r else None
                 for u, r in zip(data, (2, 2, 3, 2, 3, 2)))
    return jax.vmap(core, in_axes=axes)(*(jnp.asarray(u) for u in data))


@pytest.mark.parametrize("problem,kkt", [("acent2", "chol"),
                                         ("acent2", "chol2"),
                                         ("sdp", "chol")])
def test_make_cpl_batched_matches_vmap(problem, kkt):
    B = 3
    data, dims, Fj, Ft = (_acent2_batch if problem == "acent2"
                          else _sdp_batch)(B)
    ref = _vmap_ref(data, dims, Fj, dict(kktsolver=kkt))
    core = tcv.make_cpl(TDims.from_dict(dims, mnl=1), Ft, kktsolver=kkt,
                        device="cpu")
    out = core(*(torch.as_tensor(u) for u in data))
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    assert (out["status"] == 0).all()
    np.testing.assert_array_equal(out["iterations"].numpy(),
                                  np.asarray(ref["iterations"]))
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=XTOL, rtol=0)
    assert out["host_syncs"] > out["passes"] > 0


def test_make_cpl_freezes_finished_instances():
    """maxiters = 5: the instances that need 6 iterations exit with
    status 3 while the rest finish; every instance equals its JAX run and its
    own solve at B = 1."""
    B = 6
    data, dims, Fj, Ft = _acent2_batch(B, n=16, p=2, seed=1)
    kw = dict(kktsolver="chol2", maxiters=5)
    ref = _vmap_ref(data, dims, Fj, kw)
    core = tcv.make_cpl(TDims.from_dict(dims, mnl=1), Ft, device="cpu",
                        **kw)
    out = core(*(torch.as_tensor(u) for u in data))
    status = out["status"].numpy()
    assert set(status.tolist()) == {0, 3}, status
    np.testing.assert_array_equal(status, np.asarray(ref["status"]))
    np.testing.assert_array_equal(out["iterations"].numpy(),
                                  np.asarray(ref["iterations"]))
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=XTOL, rtol=0)
    c, x0, G, h, A, b = data
    for k in range(B):
        one = core(c, x0, G, h, A, b[k])
        assert int(one["status"]) == status[k]
        assert int(one["iterations"]) == int(out["iterations"][k])
        np.testing.assert_allclose(one["x"].numpy(), out["x"][k].numpy(),
                                   atol=1e-12, rtol=0)
