"""Pre-packaged structure-exploiting KKT solvers, twin of
`cvxopt_tpu/kkt_structured.py`:

  woodbury_solver(d, U, c)  (diag(d) + c U U')^{-1} applied through the
                            k x k Sherman-Morrison-Woodbury system;
  kkt_l1(P)                 kktsolver for the l1-approximation LP
                            min ||P u - q||_1 with G = [P,-I;-P,-I]
                            (l1.py:47-97): an n x n Cholesky of 4 P'DP;
  l1(P, q)                  the whole solve: operator-form G, kkt_l1 and
                            least-squares warm starts (l1.py:100-116);
  kkt_l1regls(A)            kktsolver for min ||A u - y||_2^2 + ||u||_1
                            (l1regls.py:41-76): (2A'A + D) u = r by
                            Woodbury through an m x m system;
  l1regls(A, y)             the whole solve (operator P/G + kkt_l1regls).

The factories return closures over one unbatched problem, the contract
of `conelp`/`coneqp`'s callable kktsolvers.  Like every entry point of
the port, each function takes ``device=`` (default ``"cuda"``, which
raises without a card) and puts its array arguments there in float64.  Their small dense
factorizations are `torch.linalg.cholesky` and `solve_triangular`, as
the JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.linops import LinearOperator

__all__ = ["woodbury_solver", "l1_operator", "kkt_l1", "l1",
           "kkt_l1regls", "l1regls"]


def _f64(a, dev):
    return torch.as_tensor(a, dtype=torch.float64, device=dev)


def _cho_solve(L, r):
    """(L L')^{-1} r for a vector or a matrix of columns r."""
    v = r.unsqueeze(-1) if r.dim() == 1 else r
    w = torch.linalg.solve_triangular(L, v, upper=False)
    x = torch.linalg.solve_triangular(L.T, w, upper=True)
    return x.squeeze(-1) if r.dim() == 1 else x


def woodbury_solver(d, U, c=1.0, device="cuda"):
    """Return ``solve(r) = (diag(d) + c * U @ U.T)^{-1} r``.

    With k = U.shape[1] right factors the apply costs one k x k
    Cholesky at build time and two (n, k) products per solve.  `r` may
    be a vector (n,) or a matrix of columns (n, nrhs), a tensor or
    anything `torch.as_tensor` takes."""
    dev = resolve_device(device)
    d = _f64(d, dev)
    U = _f64(U, dev)
    k = U.shape[1]
    Ud = U / d[:, None]                       # D^{-1} U
    S = torch.eye(k, dtype=U.dtype, device=U.device) + c * (U.T @ Ud)
    L = torch.linalg.cholesky(S)

    def solve(r):
        r = torch.as_tensor(r, dtype=d.dtype, device=d.device)
        rd = r / (d[:, None] if r.dim() == 2 else d)
        return rd - c * (Ud @ _cho_solve(L, Ud.T @ r))

    return solve


# ---------------------------------------------------------------------------
# l1 approximation:  minimize ||P u - q||_1
# ---------------------------------------------------------------------------

def l1_operator(P, device="cuda"):
    """The LP data for min ||P u - q||_1 in operator form: variable
    x = [u; v] in R^{n+m}, G = [P, -I; -P, -I] (l1.py:21-42)."""
    P = _f64(P, resolve_device(device))
    m, n = P.shape

    def mv(x):
        t = P @ x[:n]
        return torch.cat([t - x[n:], -t - x[n:]])

    def rmv(z):
        return torch.cat([P.T @ (z[:m] - z[m:]), -(z[:m] + z[m:])])

    return LinearOperator(mv=mv, rmv=rmv, shape=(2 * m, n + m))


def kkt_l1(P, device="cuda"):
    """kktsolver factory for the l1-approximation LP (l1.py:47-97).

    Solves [0 G'; G -W'W][x; z] = [bx; bz] with G = [P,-I;-P,-I] via
    an n x n Cholesky of 4 P' D P, where D is the harmonic mean of the
    two diagonal scaling blocks.  Returns (ux, uy, W uz)."""
    P = _f64(P, resolve_device(device))
    m, n = P.shape

    def Fkkt(W):
        di = W["di"]
        d1 = di[:m] ** 2
        d2 = di[m:] ** 2
        D = d1 * d2 / (d1 + d2)
        L = torch.linalg.cholesky(4.0 * (P.T * D) @ P)

        def solve(bx, by, bz):
            r = bx[:n] + P.T @ ((d1 - d2) / (d1 + d2) * bx[n:]
                                + 2.0 * D * (bz[:m] - bz[m:]))
            xu = _cho_solve(L, r)
            u = P @ xu
            xv = (bx[n:] - d1 * bz[:m] - d2 * bz[m:]
                  + (d1 - d2) * u) / (d1 + d2)
            z1 = di[:m] * (u - xv - bz[:m])
            z2 = di[m:] * (-u - xv - bz[m:])
            return torch.cat([xu, xv]), by, torch.cat([z1, z2])

        return solve

    return Fkkt


def l1(P, q, device="cuda", **kwargs):
    """Solve ``minimize ||P u - q||_1`` (examples/doc/chap8/l1.py) and
    return the conelp solution dict; ``sol['u']`` holds the minimizer.

    Uses the operator-form G, the structure-exploiting kkt_l1 solver,
    and least-squares warm starts (l1.py:100-116)."""
    from cvxopt_tpu_torch import solvers

    dev = resolve_device(device)
    P = _f64(P, dev)
    q = _f64(q, dev)
    m, n = P.shape
    c = torch.cat([P.new_zeros(n), P.new_ones(m)])
    h = torch.cat([q, -q])
    G = l1_operator(P, device=dev)

    uls = torch.linalg.lstsq(P, q.unsqueeze(-1)).solution.squeeze(-1)
    rls = P @ uls - q
    x0 = torch.cat([uls, 1.1 * rls.abs()])
    s0 = h - G.mv(x0)
    rmax = rls.abs().max()
    w = torch.where(rmax > 1e-10,
                    0.9 / torch.clamp(rmax, min=1e-300) * rls,
                    torch.zeros_like(rls))
    z0 = torch.cat([0.5 * (1 + w), 0.5 * (1 - w)])

    sol = solvers.conelp(
        c, G, h, dims={"l": 2 * m, "q": [], "s": []}, kktsolver=kkt_l1(P, device=dev),
        primalstart={"x": x0, "s": s0}, dualstart={"z": z0}, device=dev,
        **kwargs)
    sol["u"] = sol["x"][:n]
    return sol


# ---------------------------------------------------------------------------
# l1-regularized least squares:  minimize ||A u - y||_2^2 + ||u||_1
# ---------------------------------------------------------------------------

def kkt_l1regls(A, device="cuda"):
    """kktsolver factory for the l1-regularized least-squares QP
    (l1regls.py:41-76): variable x = [u; v] in R^{2n},
    P = [2A'A, 0; 0, 0], G = [I,-I;-I,-I].  Eliminates zl and v, then
    solves (2A'A + D) u = r by Woodbury through the m x m system
    I + 2 A D^{-1} A', the fast path when m << n."""
    A = _f64(A, resolve_device(device))
    m, n = A.shape

    def Fkkt(W):
        di = W["di"]
        d1 = di[:n] ** 2
        d2 = di[n:] ** 2
        D = 4.0 * d1 * d2 / (d1 + d2)
        ds = (d2 - d1) / (d1 + d2)
        Asc = A / torch.sqrt(D)[None, :]
        S = torch.eye(m, dtype=A.dtype, device=A.device) \
            + 2.0 * (Asc @ Asc.T)
        L = torch.linalg.cholesky(S)

        def solve(bx, by, bz):
            xn = bx[:n] - ds * bx[n:] \
                + d1 * (1.0 + ds) * bz[:n] - d2 * (1.0 - ds) * bz[n:]
            rhs = xn / D
            v = _cho_solve(L, A @ rhs)
            x1 = rhs - (A.T @ v) * (2.0 / D)
            x2 = (bx[n:] - d1 * bz[:n] - d2 * bz[n:]) / (d1 + d2) \
                - ds * x1
            z1 = di[:n] * (x1 - x2 - bz[:n])
            z2 = di[n:] * (-x1 - x2 - bz[n:])
            return torch.cat([x1, x2]), by, torch.cat([z1, z2])

        return solve

    return Fkkt


def l1regls(A, y, device="cuda", **kwargs):
    """Solve ``minimize ||A u - y||_2^2 + ||u||_1``
    (examples/doc/chap8/l1regls.py) and return the coneqp solution dict;
    ``sol['u']`` holds the minimizer."""
    from cvxopt_tpu_torch import solvers

    dev = resolve_device(device)
    A = _f64(A, dev)
    y = _f64(y, dev)
    m, n = A.shape
    q = torch.cat([-2.0 * A.T @ y, A.new_ones(n)])

    def Pmv(u):
        return torch.cat([2.0 * A.T @ (A @ u[:n]), A.new_zeros(n)])

    def Gmv(u):
        return torch.cat([u[:n] - u[n:], -u[:n] - u[n:]])

    def Grmv(z):
        return torch.cat([z[:n] - z[n:], -(z[:n] + z[n:])])

    P = LinearOperator(mv=Pmv, rmv=Pmv, shape=(2 * n, 2 * n))
    G = LinearOperator(mv=Gmv, rmv=Grmv, shape=(2 * n, 2 * n))
    h = A.new_zeros(2 * n)

    sol = solvers.coneqp(P, q, G, h, dims={"l": 2 * n},
                         kktsolver=kkt_l1regls(A, device=dev),
                         device=dev, **kwargs)
    sol["u"] = sol["x"][:n]
    return sol
