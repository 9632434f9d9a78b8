"""Every KKT strategy of the port (cvxopt_tpu_torch/kkt.py) against
cvxopt_tpu/kkt.py on the same seeded numpy inputs: each kktsolver name,
factoring in float64 and in float32, on 'l', 'q', 's' and mixed cones,
with and without an equality row, shared and per-instance G.

One W (the JAX package's) is handed to both sides, since an 's' block's
W is fixed only up to the signs of its eigenvectors; Q/R factors differ
in signs between the libraries, so only solves are compared.  On the CPU
`kkt_chol2` runs the plain versions of the fused kernels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cvxopt_tpu import kkt as jk
from cvxopt_tpu import scaling as jsc
from cvxopt_tpu.cones import ConeDims as JDims
from cvxopt_tpu_torch import kkt as tk
from cvxopt_tpu_torch.cones import ConeDims as TDims

# tiny tensors: one thread per test process, so that parallel test
# workers do not oversubscribe the cores
torch.set_num_threads(1)

B, N = 3, 6
NAMES = ["ldl", "ldl2", "qr", "qr_inv", "chol", "chol_inv", "cholqr",
         "cholqr_inv", "chol2", "chol2_inv"]
DIMS = {"l": dict(l=8), "q": dict(q=(4, 3)), "s": dict(s=(3, 2)),
        "lqs": dict(l=2, q=(3,), s=(3,))}


def _interior(rng, d):
    v = np.zeros((B, d.cdim))
    v[:, :d.l] = rng.uniform(0.5, 2, (B, d.l))
    off = d.l
    for m in d.q:
        v[:, off] = 1.0 + rng.uniform(0, 1, B)
        v[:, off + 1:off + m] = \
            rng.standard_normal((B, m - 1)) * 0.3 / np.sqrt(m)
        off += m
    for m in d.s:
        X = rng.standard_normal((B, m, m))
        v[:, off:off + m * m] = \
            (X @ X.transpose(0, 2, 1) + np.eye(m)).reshape(B, -1)
        off += m * m
    return v


def _to_torch(W):
    return {k: ([torch.as_tensor(np.array(u)) for u in v]
                if isinstance(v, list) else torch.as_tensor(np.array(v)))
            for k, v in W.items()}


def _solve_both(name, dims, p, fd, per_instance=False, seed=0):
    jd, td = JDims(**dims), TDims(**dims)
    rng = np.random.default_rng(seed)
    m = jd.cdim
    F = rng.standard_normal((B, N, N))
    P = F @ F.transpose(0, 2, 1) + np.eye(N)
    G = rng.standard_normal((B, m, N) if per_instance else (m, N))
    A = rng.standard_normal((B, p, N) if per_instance else (p, N))
    s, z = _interior(rng, jd), _interior(rng, jd)
    bx, by, bz = (rng.standard_normal((B, k)) for k in (N, p, m))
    with_P = not name.startswith("qr")     # 'qr' takes a zero (1,1) block
    Wj, _ = jax.vmap(lambda a, b: jsc.compute_scaling(a, b, jd))(
        jnp.asarray(s), jnp.asarray(z))

    def one(W, Gk, Ak, Pk, a, b, c):
        f = jk.get_kktsolver(name, Gk, jd, Ak, factor_dtype=fd)
        return (f(W, Pk) if with_P else f(W))(a, b, c)

    ax = 0 if per_instance else None
    ref = jax.vmap(one, in_axes=(0, ax, ax, 0, 0, 0, 0))(
        Wj, *map(jnp.asarray, (G, A, P, bx, by, bz)))
    f = tk.get_kktsolver(name, torch.as_tensor(G), td, torch.as_tensor(A),
                         factor_dtype=fd)
    Wt = _to_torch(Wj)
    solve = f(Wt, torch.as_tensor(P)) if with_P else f(Wt)
    return solve(*map(torch.as_tensor, (bx, by, bz))), ref


def _assert_close(out, ref, tol):
    for u, v in zip(out, ref):
        v = np.asarray(v)
        assert u.dtype == torch.float64 and tuple(u.shape) == v.shape
        scale = max(1.0, float(np.abs(v).max())) if v.size else 1.0
        np.testing.assert_allclose(u.numpy(), v, atol=tol * scale)


# 'ldl' takes no factor_dtype
CASES = [(name, cone, fd, tol, p)
         for name in NAMES for cone in DIMS
         for fd, tol in ((None, 1e-9), ("float32", 1e-4))
         for p in (0, 1) if not (name == "ldl" and fd)]


@pytest.mark.parametrize("name,cone,fd,tol,p", CASES)
def test_strategy_matches_jax(name, cone, fd, tol, p):
    out, ref = _solve_both(name, DIMS[cone], p, fd)
    _assert_close(out, ref, tol)


@pytest.mark.parametrize("name", NAMES)
def test_strategy_per_instance_G_and_A(name):
    out, ref = _solve_both(name, DIMS["lqs"], 1, None, per_instance=True)
    _assert_close(out, ref, 1e-9)


@pytest.mark.parametrize("name", ["ldl", "ldl2"])
def test_kktreg_matches_jax(name):
    jd, td = JDims(l=4), TDims(l=4)
    rng = np.random.default_rng(2)
    G, A = rng.standard_normal((4, N)), rng.standard_normal((1, N))
    s, z = _interior(rng, jd), _interior(rng, jd)
    bx, by, bz = (rng.standard_normal((B, k)) for k in (N, 1, 4))
    Wj, _ = jax.vmap(lambda a, b: jsc.compute_scaling(a, b, jd))(
        jnp.asarray(s), jnp.asarray(z))
    ref = jax.vmap(lambda W, a, b, c: jk.get_kktsolver(
        name, jnp.asarray(G), jd, jnp.asarray(A), kktreg=1e-6)(W)(a, b, c))(
        Wj, *map(jnp.asarray, (bx, by, bz)))
    f = tk.get_kktsolver(name, torch.as_tensor(G), td, torch.as_tensor(A),
                         kktreg=1e-6)
    out = f(_to_torch(Wj))(*map(torch.as_tensor, (bx, by, bz)))
    _assert_close(out, ref, 1e-9)


def test_adaptive_factor_solves_the_kkt_system():
    """factor_dtype='adaptive': the float32 factor where its probe
    contracts, the eigh-based working-precision factor where it does not
    (an ill-conditioned instance); both instances solve the KKT system
    that the float64 'chol2' solves, within refinement's reach."""
    td = TDims(l=8)
    rng = np.random.default_rng(3)
    G, A = rng.standard_normal((8, N)), rng.standard_normal((1, N))
    P = torch.eye(N, dtype=torch.float64).expand(2, N, N)
    s = np.ones((2, 8))
    z = np.ones((2, 8))
    s[1], z[1] = np.logspace(-7, 0, 8), np.logspace(0, -7, 8)
    from cvxopt_tpu_torch.scaling import compute_scaling
    W, _ = compute_scaling(torch.as_tensor(s), torch.as_tensor(z), td)
    rhs = [torch.as_tensor(rng.standard_normal((2, k))) for k in (N, 1, 8)]
    Gt, At = torch.as_tensor(G), torch.as_tensor(A)
    ref = tk.get_kktsolver("chol2", Gt, td, At)(W, P)(*rhs)
    out = tk.get_kktsolver("chol2", Gt, td, At,
                           factor_dtype="adaptive")(W, P)(*rhs)
    for u, v, tol in zip(out, ref, (1e-4, 1e-4, 1e-4)):
        scale = max(1.0, float(v.abs().max()))
        assert float((u - v).abs().max()) <= tol * scale
    # the ill-conditioned instance took the accurate branch
    assert float((out[0][1] - ref[0][1]).abs().max()) <= 1e-8 * max(
        1.0, float(ref[0][1].abs().max()))


def _probe_instance(seed, td, n):
    """G, W and H of one 'l'-cone instance with s, z spread over up to
    8 decades, and the adaptive probe's residual both ways: against the
    float32 Gram matrix and against the true S = Gs'Gs + H."""
    from cvxopt_tpu_torch.scaling import compute_scaling
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(seed)
    G = torch.as_tensor(rng.standard_normal((td.l, n)))
    k = rng.uniform(0, 8)
    s = torch.as_tensor(np.logspace(-k, 0, td.l)[None])
    z = torch.as_tensor(np.logspace(0, -k, td.l)[None])
    H = (torch.eye(n, dtype=f64) * 10 ** rng.uniform(-6, 0)).expand(1, n, n)
    W, _ = compute_scaling(s, z, td)
    Gs32 = tk._scaled_G(G, W, td, f32, 1)
    rows = tk._kernel_factor(H.to(f32), Gs32.transpose(-1, -2),
                             torch.ones(Gs32.shape[:-1], dtype=f32), n,
                             True, False)
    r0 = torch.full((1, n, 1), 1.0 / n ** 0.5, dtype=f64)
    t = tk._colvec(r0.to(f32), rows).to(f64)
    S32 = (Gs32.transpose(-1, -2) @ Gs32 + H.to(f32)).to(f64)
    Gs = tk._scaled_G(G, W, td, f64, 1)
    St = Gs.transpose(-1, -2) @ (Gs @ t) + H @ t
    res = [float(torch.linalg.vector_norm(v - r0)) for v in (S32 @ t, St)]
    return G, W, H, res


def test_adaptive_probe_takes_its_residual_against_the_true_s(monkeypatch):
    """An instance whose probe residual passes the 1e-6 threshold against
    the float32 Gram matrix but not against the true S: the probe must
    send it to the working-precision factor, whose solve then equals the
    float64 'chol2' solve."""
    td, n = TDims(l=8), N
    # seeds found by scanning this generator; the first whose residuals
    # straddle the threshold on this machine's float32 arithmetic is used
    for seed in (515, 710, 824, 65, 71, 249, 303, 406, 480, 549):
        G, W, H, (res32, res) = _probe_instance(seed, td, n)
        if res32 <= 1e-6 < res:
            break
    else:
        pytest.fail("no instance straddles the probe threshold")
    calls = []
    real = tk.eigh_accurate
    monkeypatch.setattr(tk, "eigh_accurate",
                        lambda S: calls.append(S.shape) or real(S))
    rng = np.random.default_rng(seed + 1)
    A = torch.as_tensor(rng.standard_normal((1, n)))
    rhs = [torch.as_tensor(rng.standard_normal((1, k))) for k in (n, 1, 8)]
    ref = tk.get_kktsolver("chol2", G, td, A)(W, H)(*rhs)
    out = tk.get_kktsolver("chol2", G, td, A,
                           factor_dtype="adaptive")(W, H)(*rhs)
    assert calls, "the probe kept the float32 factor"
    for u, v in zip(out, ref):
        assert float((u - v).abs().max()) <= 1e-10 * max(
            1.0, float(v.abs().max()))


def test_singular_systems_give_nonfinite_not_exceptions():
    """A zero column of G with P = 0: every strategy returns NaN or inf
    for that instance instead of raising, and solves its neighbour."""
    n, m = 4, 4
    G = -np.eye(m, n)
    G[:, -1] = 0.0
    td = TDims(l=m)
    P = torch.zeros((2, n, n), dtype=torch.float64)
    P[1] = torch.eye(n, dtype=torch.float64)
    s = torch.ones((2, m), dtype=torch.float64)
    from cvxopt_tpu_torch.scaling import compute_scaling
    W, _ = compute_scaling(s, s, td)
    A = torch.zeros((0, n), dtype=torch.float64)
    rhs = (torch.ones((2, n), dtype=torch.float64),
           torch.zeros((2, 0), dtype=torch.float64),
           torch.ones((2, m), dtype=torch.float64))
    for name in ("ldl", "ldl2", "chol", "chol_inv", "chol2", "cholqr"):
        ux, _, _ = tk.get_kktsolver(name, torch.as_tensor(G), td, A)(
            W, P)(*rhs)
        assert not torch.isfinite(ux[0]).all(), name
        assert torch.isfinite(ux[1]).all(), name


def test_psqrt_factor_and_wrap_P():
    rng = np.random.default_rng(6)
    F = rng.standard_normal((B, N, 3))
    P = torch.as_tensor(F @ F.transpose(0, 2, 1))      # PSD, rank 3
    Rt = tk.psqrt_factor(P).Rt
    np.testing.assert_allclose((Rt.transpose(1, 2) @ Rt).numpy(),
                               P.numpy(), atol=1e-12)
    R32 = tk.psqrt_factor(P, dtype=torch.float32).Rt
    assert R32.dtype == torch.float32 and torch.isfinite(R32).all()
    np.testing.assert_allclose(
        (R32.transpose(1, 2) @ R32).double().numpy(), P.numpy(), atol=1e-4)
    ref = jk.psqrt_factor(jnp.asarray(P.numpy()), dtype=jnp.float32).Rt
    np.testing.assert_allclose(
        (R32.transpose(1, 2) @ R32).numpy(),
        np.asarray(jnp.swapaxes(ref, -1, -2) @ ref), atol=1e-5)
    # an indefinite P gives NaN, per instance
    P2 = P.clone()
    P2[0] = -torch.eye(N, dtype=torch.float64)
    R = tk.psqrt_factor(P2, dtype=torch.float32).Rt
    assert torch.isnan(R[0]).all() and torch.isfinite(R[1:]).all()
    assert isinstance(tk.wrap_P("cholqr_inv", P), tk.PFactor)
    assert tk.wrap_P("chol", P) is P
    assert tk.wrap_P("cholqr", P, "float32").Rt.dtype == torch.float32


def test_get_kktsolver_accepts_the_jax_names():
    td = TDims(l=2)
    G = torch.eye(2, dtype=torch.float64)
    A = torch.zeros((0, 2), dtype=torch.float64)
    for name in NAMES:
        assert callable(tk.get_kktsolver(name, G, td, A))
    for name in ("nonsense", "ldl_inv"):
        with pytest.raises(ValueError):
            tk.get_kktsolver(name, G, td, A)
    with pytest.raises(ValueError, match="zero"):
        tk.get_kktsolver("qr", G, td, A)(
            {"d": torch.ones(1, 2), "di": torch.ones(1, 2), "beta": [],
             "v": [], "r": [], "rti": []}, torch.eye(2))
