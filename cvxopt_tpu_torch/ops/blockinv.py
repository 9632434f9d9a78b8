"""Block-recursive SPD inverse and blocked Cholesky factorizations.

Twin of `cvxopt_tpu/ops/blockinv.py`.  `spd_inverse` computes S^{-1} by
recursive 2x2 block inversion

    S = [[A, B'], [B, C]]
    S^{-1} = [[Ai + Y' Ci Y,  -Y' Ci],      Ai = inv(A) (recurse)
              [-Ci Y,          Ci    ]]      Y  = B Ai
                                             Ci = inv(C - Y B')  (recurse)

so that all work above the (<= base) base case is batched matmuls; its
backward error is O(eps * kappa(S)), the class of forming Linv' Linv.
The explicit-inverse KKT strategies ('chol_inv') use it.

Non-PD input gives NaN, never an exception: every Cholesky goes through
`torch.linalg.cholesky_ex` (`scaling._chol_nan`), S is PD iff every
block pivot of the recursive Schur-complement chain is PD, and a NaN
pivot propagates through the assembling matmuls.  The solvers read NaN
as a singular KKT system.
"""

from __future__ import annotations

import torch

from cvxopt_tpu_torch.scaling import _chol_nan

BASE = 32


def _t(X):
    return X.transpose(-1, -2)


def _eye_like(S):
    n = S.shape[-1]
    return torch.eye(n, dtype=S.dtype, device=S.device).expand(S.shape)


def spd_inverse(S, base: int = BASE):
    """Inverse of a (batched) symmetric positive-definite matrix
    S (..., n, n); NaN on non-PD input."""
    n = S.shape[-1]
    if n <= base:
        L = _chol_nan(S)
        Li = torch.linalg.solve_triangular(L, _eye_like(S), upper=False)
        return _t(Li) @ Li
    k = n // 2
    A = S[..., :k, :k]
    Bt = S[..., :k, k:]                      # = B'
    C = S[..., k:, k:]
    Ai = spd_inverse(A, base)
    Y = _t(Bt) @ Ai                          # B Ai      (n-k, k)
    Sc = C - Y @ Bt                          # Schur complement
    Ci = spd_inverse(Sc, base)
    X12 = -_t(Y) @ Ci                        # (k, n-k)
    X11 = Ai - X12 @ Y
    top = torch.cat([X11, X12], dim=-1)
    bot = torch.cat([_t(X12), Ci], dim=-1)
    X = torch.cat([top, bot], dim=-2)
    # one symmetrization pass cleans the rounding asymmetry of X11
    return 0.5 * (X + _t(X))


def tri_inverse_lower(L, base: int = 128):
    """Inverse of a (batched) lower-triangular matrix by 2x2 block
    recursion:

        inv([[L11, 0], [L21, L22]]) =
            [[inv(L11), 0], [-inv(L22) L21 inv(L11), inv(L22)]]
    """
    n = L.shape[-1]
    if n <= base:
        return torch.linalg.solve_triangular(L, _eye_like(L), upper=False)
    k = n // 2
    L11i = tri_inverse_lower(L[..., :k, :k], base)
    L22i = tri_inverse_lower(L[..., k:, k:], base)
    X21 = -L22i @ (L[..., k:, :k] @ L11i)
    z = L.new_zeros(L.shape[:-2] + (k, n - k))
    top = torch.cat([L11i, z], dim=-1)
    bot = torch.cat([X21, L22i], dim=-1)
    return torch.cat([top, bot], dim=-2)


def panel_cholesky(S, panel: int = 512):
    """Right-looking block-panel Cholesky for large single instances.

    Per panel k: Lkk = chol(S[k,k]); L[k+1:,k] = S[k+1:,k] inv(Lkk)';
    S[k+1:,k+1:] -= L[k+1:,k] L[k+1:,k]'.  n must be a multiple of
    `panel`.  NaN on non-PD input."""
    n = S.shape[-1]
    if n % panel:
        raise ValueError("panel_cholesky requires panel | n")
    L = torch.zeros_like(S)
    A = S.clone()
    for k0 in range(0, n, panel):
        k1 = k0 + panel
        Lkk = _chol_nan(A[..., k0:k1, k0:k1])
        L[..., k0:k1, k0:k1] = Lkk
        if k1 < n:
            Lki = tri_inverse_lower(Lkk)
            L21 = A[..., k1:, k0:k1] @ _t(Lki)
            L[..., k1:, k0:k1] = L21
            A[..., k1:, k1:] -= L21 @ _t(L21)
    return L


def blocked_cholesky(S, block: int = 2560):
    """Recursive 2x2-blocked Cholesky for large single instances:

        S = [[A, B'], [B, C]]
        L = [[LA, 0], [B LA^{-T}, chol(C - (B LA^{-T})(B LA^{-T})')]]

    NaN on non-PD input.  Batched over leading axes."""
    n = S.shape[-1]
    if n <= block:
        return _chol_nan(S)
    k = n // 2
    A = S[..., :k, :k]
    B = S[..., k:, :k]
    C = S[..., k:, k:]
    LA = blocked_cholesky(A, block)
    # X = B LA^{-T}  via  LA X' = B'
    X = _t(torch.linalg.solve_triangular(LA, _t(B), upper=False))
    LC = blocked_cholesky(C - X @ _t(X), block)
    z = S.new_zeros(S.shape[:-2] + (k, n - k))
    top = torch.cat([LA, z], dim=-1)
    bot = torch.cat([X, LC], dim=-1)
    return torch.cat([top, bot], dim=-2)
