"""The port's cone-LP solver (cvxopt_tpu_torch/conelp.py) against
cvxopt_tpu/conelp.py on the CPU in float64, on the same numpy problems:

  - the documented problems through the single-problem `conelp`: equal
    status strings and iteration counts, x/y/s/z within 1e-8;
  - `make_conelp` batched on random (l, q, s) cone mixes as
    tests/test_npref_golden.py draws them, against the JAX package at
    1e-7 and the numpy golden reference `_npref.coneqp_np_cones` (P = 0:
    same optimum) on the objective;
  - a batch that mixes optimal, primal and dual infeasible instances;
  - `make_conelp_cascade` on 's' and 'l' cones (B = 4);
  - `make_conelp_ws`, `make_conelp_refresh`, the rescue mode, and the
    primalstart/dualstart warm starts."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import conelp as jc
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu._npref import coneqp_np_cones
from cvxopt_tpu_torch import conelp as tc
from cvxopt_tpu_torch import ipm
from cvxopt_tpu_torch import convert
from cvxopt_tpu_torch.cones import ConeDims as TDims

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

DOC_LP = (np.array([-4., -5.]),
          np.array([[2., 1.], [1., 2.], [-1., 0.], [0., -1.]]),
          np.array([3., 3., 0., 0.]), None)
DOC_CONELP = (
    np.array([-6., -4., -5.]),
    np.array([
        [16., 7., 24., -8., 8., -1., 0., -1., 0., 0., 7., -5., 1., -5.,
         1., -7., 1., -7., -4.],
        [-14., 2., 7., -13., -18., 3., 0., 0., -1., 0., 3., 13., -6.,
         13., 12., -10., -6., -10., -28.],
        [5., 0., -15., 12., -6., 17., 0., 0., 0., -1., 9., 6., -6., 6.,
         -7., -7., -6., -7., -11.]]).T,
    np.array([-3., 5., 12., -2., -14., -13., 10., 0., 0., 0., 68.,
              -30., -19., -30., 99., 23., -19., 23., 10.]),
    {'l': 2, 'q': [4, 4], 's': [3]})
PRIMAL_INF = (np.array([1.0]), np.array([[1.0], [-1.0]]),
              np.array([-1.0, -1.0]), None)
DUAL_INF = (np.array([-1.0]), np.array([[-1.0]]), np.array([0.0]), None)


def _same(out, ref, keys, tol):
    for k in keys:
        if ref[k] is None:
            assert out[k] is None, k
        else:
            np.testing.assert_allclose(np.asarray(out[k]),
                                       np.asarray(ref[k]), atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("case,status", [
    (DOC_LP, "optimal"), (DOC_CONELP, "optimal"),
    (PRIMAL_INF, "primal infeasible"), (DUAL_INF, "dual infeasible")])
def test_documented_problems_match_jax(case, status):
    c, G, h, dims = case
    ref = jc.conelp(c, G, h, dims)
    out = tc.conelp(c, G, h, dims, device="cpu")
    assert out["status"] == ref["status"] == status
    assert out["iterations"] == ref["iterations"]
    _same(out, ref, ("x", "y", "s", "z"), 1e-8)
    _same(out, ref, ("primal objective", "dual objective", "gap",
                     "residual as primal infeasibility certificate",
                     "residual as dual infeasibility certificate"), 1e-8)


def test_documented_answers():
    x = tc.conelp(*DOC_LP, device="cpu")["x"].numpy()
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-5)
    x = tc.conelp(*DOC_CONELP, device="cpu")["x"].numpy()
    np.testing.assert_allclose(x, [-1.220915, 0.096633, 3.577502],
                               atol=1e-4)
    sol = tc.conelp(*PRIMAL_INF, device="cpu")
    assert sol["x"] is None and sol["dual objective"] == 1.0
    assert sol["residual as primal infeasibility certificate"] < 1e-7
    # the certificate: G'z = 0, h'z = -1, z >= 0
    z = sol["z"].numpy()
    assert abs(PRIMAL_INF[2] @ z + 1.0) < 1e-9 and z.min() > 0
    sol = tc.conelp(*DUAL_INF, device="cpu")
    assert sol["y"] is None and sol["primal objective"] == -1.0
    sol = tc.conelp(*DOC_LP, options={"maxiters": 1}, device="cpu")
    assert sol["status"] == "unknown" and sol["iterations"] == 1


def random_cone_lps(cfg, nb, n, p, seed):
    """Strictly feasible, bounded cone LPs: h = G x0 + s0 and
    c = -G'z0 - A'y0 with s0, z0 interior; the 's' rows of G are
    vectorized symmetric matrices."""
    rng = np.random.default_rng(seed)
    dims = JDims(**cfg)
    m = dims.cdim

    def interior():
        v = np.zeros((nb, m))
        v[:, :dims.l] = 1.0 + rng.uniform(0, 0.5, (nb, dims.l))
        off = dims.l
        for mq in dims.q:
            v[:, off] = 2.0
            v[:, off + 1:off + mq] = 0.2 * rng.standard_normal(
                (nb, mq - 1))
            off += mq
        for ms in dims.s:
            E = 0.2 * rng.standard_normal((nb, ms, ms))
            v[:, off:off + ms * ms] = (
                E @ E.transpose(0, 2, 1) + np.eye(ms)).reshape(nb, -1)
            off += ms * ms
        return v

    G = 0.4 * rng.standard_normal((nb, m, n))
    soff = dims.l + sum(dims.q)
    for ms in dims.s:
        blk = G[:, soff:soff + ms * ms].reshape(nb, ms, ms, n)
        G[:, soff:soff + ms * ms] = (
            0.5 * (blk + blk.transpose(0, 2, 1, 3))).reshape(nb, -1, n)
        soff += ms * ms
    A = rng.standard_normal((nb, p, n))
    x0 = 0.1 * rng.standard_normal((nb, n))
    h = np.einsum("bmn,bn->bm", G, x0) + interior()
    b = np.einsum("bpn,bn->bp", A, x0)
    c = -np.einsum("bmn,bm->bn", G, interior()) \
        - np.einsum("bpn,bp->bn", A, rng.standard_normal((nb, p)))
    return c, G, h, A, b


def _jax_batched(core, data, *extra):
    return jax.vmap(core)(*map(jnp.asarray, data + tuple(extra)))


MIXES = [dict(l=3, q=(3, 4), s=()), dict(l=0, q=(5,), s=(3,)),
         dict(l=4, q=(), s=(2, 3)), dict(l=2, q=(3, 3, 3), s=(2,))]


@pytest.mark.parametrize("cfg,p", [(MIXES[0], 0), (MIXES[1], 1),
                                   (MIXES[2], 1), (MIXES[3], 0)])
def test_make_conelp_random_mixes(cfg, p):
    nb, n = 3, 6
    data = random_cone_lps(cfg, nb, n, p, seed=20260821 + p)
    kw = dict(maxiters=60, abstol=1e-7, reltol=1e-7, feastol=1e-7)
    ref = _jax_batched(jc.make_conelp(JDims(**cfg), **kw), data)
    out = tc.make_conelp(TDims(**cfg), device="cpu", **kw)(*data)
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    assert (out["status"].numpy() == 0).all()
    di = out["iterations"].numpy() - np.asarray(ref["iterations"])
    assert np.abs(di).max() <= 1
    for k in ("x", "y", "s", "z"):
        v = np.asarray(ref[k])
        np.testing.assert_allclose(
            out[k].numpy(), v, err_msg=k,
            atol=1e-7 * max(1.0, np.abs(v).max(initial=0.0)))
    # the numpy golden reference (P = 0 coneqp: the same optimum, each
    # side within its 1e-7 gap of it)
    c, G, h, A, b = data
    compared = 0
    for k in range(nb):
        try:
            gold = coneqp_np_cones(
                np.zeros((n, n)), c[k], G[k], h[k],
                {"l": cfg["l"], "q": list(cfg["q"]), "s": list(cfg["s"])},
                A=A[k] if p else None, b=b[k] if p else None,
                abstol=1e-7, reltol=1e-7, feastol=1e-7)
        except np.linalg.LinAlgError:
            continue       # the golden's own factor failed at P = 0
        if gold["status"] != "optimal":
            continue
        compared += 1
        np.testing.assert_allclose(float(out["pcost"][k]),
                                   float(c[k] @ gold["x"]), atol=3e-7)
    assert compared >= 2


def test_batch_mixes_optimal_and_infeasible_instances():
    """One batch, three outcomes; the certificates are scaled per
    instance (h'z = -1, c'x = -1)."""
    dims = dict(l=2)
    c = np.array([[1.0], [-1.0], [1.0]])
    G = np.array([[[1.0], [-1.0]], [[-1.0], [0.0]], [[-1.0], [1.0]]])
    h = np.array([[-1.0, -1.0], [0.0, 1.0], [0.0, 2.0]])
    A, b = np.zeros((3, 0, 1)), np.zeros((3, 0))
    data = (c, G, h, A, b)
    ref = _jax_batched(jc.make_conelp(JDims(**dims)), data)
    out = tc.make_conelp(TDims(**dims), device="cpu")(*data)
    assert out["status"].tolist() == [1, 2, 0]
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    np.testing.assert_array_equal(out["iterations"].numpy(),
                                  np.asarray(ref["iterations"]))
    for k in ("x", "z", "pinfres", "dinfres"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-8, err_msg=k)
    assert abs(float((out["z"][0] * torch.as_tensor(h[0])).sum()) + 1) < 1e-9
    assert abs(float(out["x"][1, 0] * c[1, 0]) + 1) < 1e-9


def mcsdp_batch(nb, m, seed=7):
    """bench.py's mcsdp data: min 1'x s.t. diag(x) + W >= 0 (PSD), with a
    seeded symmetric W per instance; per-instance G/h/A/b."""
    rng = np.random.default_rng(seed)
    G = np.zeros((m * m, m))
    for j in range(m):
        G[j * m + j, j] = -1.0
    W = rng.standard_normal((nb, m, m))
    W = (W + W.transpose(0, 2, 1)) / np.sqrt(m)
    return (np.ones((nb, m)), np.broadcast_to(G, (nb,) + G.shape).copy(),
            W.reshape(nb, -1), np.zeros((nb, 0, m)), np.zeros((nb, 0)))


def scenario_lps(nb, n, seed=0):
    """bench.py make_batch without P: min q'x, 0 <= x <= 1, sum x = 1,
    shared G/h/A/b."""
    rng = np.random.default_rng(seed)
    c = -rng.uniform(0.0, 0.1, (nb, n))
    eye = np.eye(n)
    return (c, np.concatenate([-eye, eye]),
            np.concatenate([np.zeros(n), np.ones(n)]), np.ones((1, n)),
            np.ones(1))


@pytest.mark.parametrize("cone", ["s", "l"])
def test_cascade_matches_jax(cone):
    """Phase A f32, phase B warm-started ('f64_restart' on 's' cones,
    'rescue' otherwise), phase C compacted on the host.

    On 'l' cones x agrees with the JAX cascade to 1e-6 and the
    iteration counts to 1.  On the small SDPs phase A's f32 iteration
    is chaotic (whether an instance reaches 1e-4 or runs into maxiters
    and restarts cold differs between the two f32 implementations), and
    at reltol = 1e-6 the optimizer itself is only determined to ~1e-4
    (either cascade is that far from a 1e-11 solve), so there the
    objectives are compared at 1e-5 and the iterates at 2e-3."""
    if cone == "s":
        cfg, data, shared = dict(s=(6,)), mcsdp_batch(4, 6), False
        kw = dict(maxiters=40, abstol=1e-7, reltol=1e-6, feastol=1e-7)
    else:
        cfg, data, shared = dict(l=12), scenario_lps(4, 6), True
        kw = dict(kktsolver="chol2", maxiters=50, abstol=1e-7,
                  reltol=1e-7, feastol=1e-7)
    j = jc.make_conelp_cascade(JDims(**cfg), shared_GhAb=shared, **kw)(
        *map(jnp.asarray, data))
    solve = tc.make_conelp_cascade(TDims(**cfg), shared_GhAb=shared,
                                   instrument=True, device="cpu", **kw)
    t = solve(*data)
    assert (np.asarray(j["status"]) == 0).all()
    assert (t["status"].numpy() == 0).all()
    assert float(t["pres"].max()) <= 1e-7 and float(t["dres"].max()) <= 1e-7
    assert bool(((t["gap"] <= 1e-7) | (t["relgap"] <= kw["reltol"])).all())
    dx = np.abs(t["x"].numpy() - np.asarray(j["x"])).max()
    if cone == "l":
        assert dx <= 1e-6
        di = t["iterations"].numpy() - np.asarray(j["iterations"])
        assert np.abs(di).max() <= 1
    else:
        assert dx <= 2e-3
        np.testing.assert_allclose(t["pcost"].numpy(),
                                   np.asarray(j["pcost"]), rtol=1e-5)
    prof = t["profile"]
    assert prof["a_iters"] + prof["b_iters"] + prof["c_iters"] == \
        int(t["iterations"].sum())


def test_cascade_phase_c_rescues_flagged_instances():
    """Phase C solves exactly the instances flagged NEEDS_F64, padded to
    a power of two, and scatters them back."""
    cfg, data = dict(l=12), scenario_lps(5, 6, seed=2)
    dev = torch.device("cpu")
    cold = tc.make_conelp(TDims(**cfg), kktsolver="chol2", device="cpu")
    c, G, h, A, b = (torch.as_tensor(u) for u in data)
    full = cold(c, G, h, A, b)
    raw = {k: full[k].clone() for k in ("x", "status", "iterations")}
    raw["x"][[1, 3, 4]] = 0.0
    raw["status"][[1, 3, 4]] = ipm.STATUS_NEEDS_F64
    raw["iterations"][:] = 1
    seen, subs = [], []

    def run(ii):
        seen.append(ii.tolist())
        subs.append(cold(c[ii], G, h, A, b))
        return subs[-1]

    syncs = [0]
    n = ipm.rescue_compacted(raw, ("x", "status"), run, dev, syncs)
    assert n == 3 and seen == [[1, 3, 4, 1]]
    # the status read, then the batch's solve and its iterations read
    assert syncs[0] == 1 + subs[0]["host_syncs"] + 1
    assert raw["status"].tolist() == [0] * 5
    np.testing.assert_allclose(raw["x"].numpy(), full["x"].numpy(),
                               atol=1e-12)
    assert raw["rescue_iterations"].tolist() == [
        0, int(full["iterations"][1]), 0, int(full["iterations"][3]),
        int(full["iterations"][4])]
    assert raw["iterations"].tolist() == [
        1 + v for v in raw["rescue_iterations"].tolist()]


@pytest.mark.parametrize("fd", [None, "rescue", "f64_restart"])
def test_make_conelp_ws_matches_jax(fd):
    """Warm start from a perturbed optimum; the last instance hands in
    NaN and restarts cold where a restart phase exists."""
    cfg = MIXES[3]
    data = random_cone_lps(cfg, 3, 6, 1, seed=5)
    cold = tc.make_conelp(TDims(**cfg), device="cpu")(*data)
    x0 = cold["x"].numpy() + 0.01
    y0, z0 = cold["y"].numpy().copy(), cold["z"].numpy() * 1.1
    if fd is not None:
        x0[2] = np.nan
    kw = dict(factor_dtype=fd, refinement=1)
    ref = _jax_batched(jc.make_conelp_ws(JDims(**cfg), **kw), data,
                       x0, y0, z0)
    out = tc.make_conelp_ws(TDims(**cfg), device="cpu", **kw)(
        *data, x0, y0, z0)
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    assert (out["status"].numpy() == 0).all()
    di = out["iterations"].numpy() - np.asarray(ref["iterations"])
    assert np.abs(di).max() <= (0 if fd != "rescue" else 1)
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)


def test_make_conelp_rescue_mode_matches_jax():
    cfg = dict(l=12)
    c, G, h, A, b = scenario_lps(3, 6, seed=4)
    kw = dict(kktsolver="chol2", factor_dtype="rescue", refinement=1)
    ref = jax.vmap(jc.make_conelp(JDims(**cfg), **kw),
                   in_axes=(0, None, None, None, None))(
        *map(jnp.asarray, (c, G, h, A, b)))
    out = tc.make_conelp(TDims(**cfg), device="cpu", **kw)(c, G, h, A, b)
    assert (out["status"].numpy() == 0).all()
    np.testing.assert_array_equal(out["status"].numpy(),
                                  np.asarray(ref["status"]))
    di = out["iterations"].numpy() - np.asarray(ref["iterations"])
    assert np.abs(di).max() <= 1
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)


@pytest.mark.parametrize("segment", [None, 3])
def test_make_conelp_refresh_matches_jax(segment):
    """Trigger mode (a healthy solve never restarts) and the open-loop
    segment mode; x and status are compared, and the iteration count
    only where no refresh happened."""
    c, G, h, dims = DOC_CONELP
    _, Gt, ht, td, At, bt = ipm._prep_inputs(c, G, h, dims, None, None,
                                            device="cpu")
    args = (c, Gt.numpy(), ht.numpy(), At.numpy(), bt.numpy())
    kw = dict(segment=segment, rounds=6)
    ref = jc.make_conelp_refresh(JDims.from_dict(dims), **kw)(
        *map(jnp.asarray, args))
    out = tc.make_conelp_refresh(td, device="cpu", **kw)(*args)
    assert int(out["status"]) == int(ref["status"]) == 0
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-6)
    assert out["refresh_rounds"] == ref["refresh_rounds"]
    if segment is None:
        assert out["refresh_rounds"] == 0
    # the JAX package's rounds may overrun maxiters (the port caps them),
    # so the counts are compared where JAX stays within it
    if int(ref["iterations"]) <= 100:
        assert out["iterations"] == int(ref["iterations"])


def _mcsdp(m=10, seed=7):
    """One max-cut relaxation, a single 's' cone (tests/test_npref_golden
    .py's instance)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, m))
    w = (w + w.T) / np.sqrt(m)
    G = np.zeros((m * m, m))
    for j in range(m):
        G[j * m + j, j] = -1.0
    return np.ones(m), G, w.reshape(-1), np.zeros((0, m)), np.zeros(0)


@pytest.mark.parametrize("maxiters", [4, 5, 7])
def test_make_conelp_refresh_keeps_within_maxiters(maxiters):
    """A single 's'-cone program whose open-loop segments (3 iterations)
    end inconclusive and refresh: the rounds together run at most
    maxiters iterations, and the exit stays 'unknown'."""
    args = _mcsdp()
    out = tc.make_conelp_refresh(TDims(s=(10,)), segment=3, rounds=6,
                                 maxiters=maxiters, device="cpu")(*args)
    assert out["iterations"] <= maxiters
    assert out["refresh_rounds"] >= 1
    assert int(out["status"]) == ipm.STATUS_UNKNOWN_MAXITERS


def test_conelp_primalstart_dualstart_match_jax():
    c, G, h, dims = DOC_CONELP
    cold = jc.conelp(c, G, h, dims)
    e = np.asarray(jc.cones.cone_identity(JDims.from_dict(dims)))
    ps = {"x": np.asarray(cold["x"]), "s": np.asarray(cold["s"]) + e}
    ds = {"y": np.zeros(0), "z": np.asarray(cold["z"]) + e}
    ref = jc.conelp(c, G, h, dims, primalstart=ps, dualstart=ds)
    out = tc.conelp(c, G, h, dims, primalstart=ps, dualstart=ds,
                    device="cpu")
    assert out["status"] == ref["status"] == "optimal"
    assert out["iterations"] == ref["iterations"]
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               atol=1e-8)
    p2, d2 = convert.startvals_from_numpy({**ps, **ds}, device="cpu")
    assert set(p2) == {"x", "s"} and set(d2) == {"y", "z"}
    assert convert.startvals_from_numpy({"x": ps["x"]},
                                        device="cpu")[1] is None
    with pytest.raises(ValueError, match="not positive"):
        tc.conelp(c, G, h, dims, primalstart={"x": ps["x"], "s": -e},
                  device="cpu")


def test_later_forms_raise_not_implemented():
    """Operator-form G/A and a dict-valued c need a user kktsolver: both
    packages raise ValueError without one."""
    c, G, h, dims = DOC_LP
    cases = [(c, G, dict(A=lambda x, t: x)), (c, lambda x, t: x, {}),
             ({"u": c}, G, {})]
    for cc, GG, kw in cases:
        with pytest.raises(ValueError):
            jc.conelp(cc, GG, h, dims, **kw)
        with pytest.raises(ValueError):
            tc.conelp(cc, GG, h, dims, device="cpu", **kw)
