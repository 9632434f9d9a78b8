"""Sparse KKT path: fixed-pattern banded assembly and banded Cholesky,
twin of `cvxopt_tpu/ops/sparse_kkt.py`.

The reference's big-LP workhorse is kkt_chol2 with a CHOLMOD sparse
Cholesky and fixed-pattern re-assembly (``syrk(..., partial=True)``).
The JAX package, and this port, build the banded equivalent:

  1. ORDERING (host, once): reverse Cuthill-McKee on the pattern of
     S = P + G'G reduces it to a band of width kd.
  2. FIXED-PATTERN ASSEMBLY (device, every IPM iteration): the scatter
     index of every Gram-pair product G[k,i] G[k,j] into band storage
     is computed once from the pattern; each factor is then one
     multiply and one `index_add_` of static shape.
  3. FACTOR/SOLVE (device): banded Cholesky, one row per step
     (`banded.pbtrf`/`pbtrs`, method 'scan') or by dense (cb, cb)
     panels (`banded.pbtrf_blocked`/`pbtrs_blocked`, method 'blocked').

`kkt_chol2_banded` packages this as a callable kktsolver for 'l'-cone
problems of the port's `conelp`/`coneqp`; `lp_sparse`/`qp_sparse` solve
a large sparse LP/QP end to end with an operator-form G (ELL matvecs),
never densifying G.  Method 'auto' picks 'blocked' when the solve runs
on the card and 'scan' on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.kkt_structured import _cho_solve
from cvxopt_tpu_torch.ops import banded


# ---------------------------------------------------------------------------
# ELL sparse storage (row-padded) - device matvecs
# ---------------------------------------------------------------------------

@dataclass
class SparseELL:
    """Row-padded (ELLPACK) sparse matrix: per row up to r column
    indices and values; padding uses column 0 with value 0."""
    vals: torch.Tensor         # (m, r)
    cols: torch.Tensor         # (m, r) int64
    shape: tuple

    @staticmethod
    def from_scipy(A, device="cuda", dtype=torch.float64) -> "SparseELL":
        A = sp.csr_matrix(A)
        m, n = A.shape
        cnt = np.diff(A.indptr)
        r = max(int(cnt.max()), 1) if A.nnz else 1
        vals = np.zeros((m, r))
        cols = np.zeros((m, r), np.int64)
        rows = np.repeat(np.arange(m), cnt)
        slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], cnt)
        vals[rows, slot] = A.data
        cols[rows, slot] = A.indices
        dev = resolve_device(device)
        return SparseELL(torch.as_tensor(vals, dtype=dtype, device=dev),
                         torch.as_tensor(cols, device=dev), (m, n))

    def matvec(self, x):
        """G @ x: gathers only."""
        return (self.vals * x[self.cols]).sum(dim=1)

    def rmatvec(self, y):
        """G' @ y: one scatter-add."""
        contrib = self.vals * y[:, None]
        out = contrib.new_zeros((self.shape[1],))
        return out.index_add_(0, self.cols.reshape(-1), contrib.reshape(-1))

    def todense(self):
        m, n = self.shape
        D = self.vals.new_zeros((m * n,))
        rows = torch.arange(m, device=self.cols.device)[:, None]
        return D.index_add_(0, (rows * n + self.cols).reshape(-1),
                            self.vals.reshape(-1)).reshape(m, n)


# ---------------------------------------------------------------------------
# Setup: ordering and static scatter plan
# ---------------------------------------------------------------------------

def rcm_order(pattern) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a symmetric pattern (the
    bandwidth-minimizing analogue of cvxopt.amd.order)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    S = sp.csr_matrix(pattern)
    S = ((S + S.T) != 0).astype(np.int8)
    return np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True),
                      dtype=np.int64)


def band_width_of(pattern, perm) -> int:
    S = sp.coo_matrix(pattern)
    pos = np.argsort(perm)
    return int(np.abs(pos[S.row] - pos[S.col]).max()) if S.nnz else 0


@dataclass
class BandPlan:
    """Static plan for assembling the band of S = P + G' diag(w) G
    under a fill-reducing permutation (indices computed once, values
    re-scattered every iteration)."""
    perm: np.ndarray            # new -> old column order
    kd: int                     # bandwidth of the permuted S
    n: int
    G: SparseELL                # original column indexing (matvecs)
    scatter_idx: torch.Tensor   # (m*r*r,) flat band index; (kd+1)*n drops
    pairs_i: torch.Tensor       # unused (values come from G), as in JAX
    Pband: Optional[torch.Tensor] = None   # static band of P (permuted)
    dtype: object = torch.float64


def _pattern(G_sp):
    G_sp = sp.csr_matrix(G_sp)
    return sp.csr_matrix((np.ones_like(G_sp.data), G_sp.indices,
                          G_sp.indptr), shape=G_sp.shape)


def _pair_index(ell_cols, valid, pos):
    """Per Gram pair (k, a, b) of the ELL rows: the permuted positions
    (pi, pj) of columns cols[k, a], cols[k, b], and whether the pair is
    kept (both entries real, pi >= pj so each pair lands once)."""
    r = ell_cols.shape[1]
    p_i = pos[ell_cols]
    pi = np.broadcast_to(p_i[:, :, None], p_i.shape + (r,))
    pj = np.broadcast_to(p_i[:, None, :], p_i.shape[:1] + (r, r))
    keep = valid[:, :, None] & valid[:, None, :] & (pi >= pj)
    return pi, pj, keep


def make_band_plan(G_sp, P_sp=None, dtype=torch.float64,
                   extra_pattern=None, device="cuda") -> BandPlan:
    """Host-side symbolic setup.  G_sp: (m, n) scipy sparse; P_sp:
    optional (n, n) scipy sparse symmetric.  The plan's tensors live on
    `device`."""
    dev = resolve_device(device)
    G_sp = sp.csr_matrix(G_sp)
    m, n = G_sp.shape
    Gpat = _pattern(G_sp)
    Spat = Gpat.T @ Gpat
    if P_sp is not None:
        Spat = Spat + sp.csr_matrix(P_sp)
    if extra_pattern is not None:
        Spat = Spat + sp.csr_matrix(extra_pattern)
    perm = rcm_order(Spat != 0)
    kd = band_width_of(Spat != 0, perm)
    pos = np.argsort(perm)                  # old column -> band position

    ell = SparseELL.from_scipy(G_sp, device=dev, dtype=dtype)
    cols = ell.cols.cpu().numpy()
    valid = ell.vals.cpu().numpy() != 0
    pi, pj, keep = _pair_index(cols, valid, pos)
    flat = np.where(keep, (pi - pj) * n + pj, (kd + 1) * n)
    plan = BandPlan(
        perm=perm, kd=kd, n=n, G=ell,
        scatter_idx=torch.as_tensor(flat.reshape(-1), device=dev),
        pairs_i=torch.zeros((), device=dev), dtype=dtype)
    if P_sp is not None:
        Pd = sp.csr_matrix(P_sp).toarray()[np.ix_(perm, perm)]
        plan.Pband = torch.as_tensor(
            np.stack([np.pad(np.diagonal(Pd, -j), (0, j))
                      for j in range(kd + 1)]), dtype=dtype, device=dev)
    return plan


def assemble_band(plan: BandPlan, wrow):
    """Device-side numeric assembly: the band of P + G' diag(wrow) G
    under the plan's permutation.  wrow: (m,).  Pairs outside the band
    land in one extra slot that is dropped."""
    v = plan.G.vals.to(wrow.dtype)
    contrib = wrow[:, None, None] * v[:, :, None] * v[:, None, :]
    size = (plan.kd + 1) * plan.n
    band = contrib.new_zeros((size + 1,)).index_add_(
        0, plan.scatter_idx, contrib.reshape(-1))
    band = band[:size].reshape(plan.kd + 1, plan.n)
    if plan.Pband is not None:
        band = band + plan.Pband.to(band.dtype)
    return band


# ---------------------------------------------------------------------------
# The sparse kkt_chol2 (callable kktsolver of conelp/coneqp)
# ---------------------------------------------------------------------------

def _dense(x, dtype, dev):
    """Dense `dtype` tensor on dev from a tensor, array data or a scipy
    sparse matrix; None stays None."""
    if x is None or torch.is_tensor(x):
        return x if x is None else x.to(device=dev, dtype=dtype)
    if sp.issparse(x):
        x = x.toarray()
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def kkt_chol2_banded(G_sp, dims, A=None, P_sp=None,
                     dtype=torch.float64, method="auto",
                     factor_dtype=None, cb=None, device="cuda"):
    """Callable kktsolver exploiting the sparsity of G (and optionally P)
    for 'l'-cone problems: factor cost O(n kd^2) instead of O(n^3).

        kkt = kkt_chol2_banded(G_scipy, dims, A=A_dense[, P_sp=...])
        solvers.conelp(c, G, h, kktsolver=kkt)   (or coneqp)

    The callable follows the reference kktsolver contract (W) ->
    solve(bx, by, bz) -> (ux, uy, W uz); for coneqp pass P as P_sp.

    ``method``: 'scan' factors one row per step (`banded.pbtrf`),
    'blocked' by dense panels (`banded.pbtrf_blocked`), 'auto' picks
    'blocked' on the card and 'scan' on the CPU.  ``factor_dtype``
    (e.g. torch.float32) factors a Jacobi-equilibrated band in reduced
    precision.  The plan and the solves live on `device`."""
    if getattr(dims, "q", ()) or getattr(dims, "s", ()):
        raise ValueError("kkt_chol2_banded supports 'l' cones only "
                         "(like the reference's sparse kkt_chol2)")
    dev = resolve_device(device)
    plan = make_band_plan(G_sp, P_sp=P_sp, dtype=dtype, device=dev)
    n = plan.n
    kd = plan.kd
    perm = torch.as_tensor(plan.perm, device=dev)
    inv = torch.as_tensor(np.argsort(plan.perm), device=dev)
    G = plan.G
    if method == "auto":
        method = "blocked" if dev.type == "cuda" else "scan"
    if cb is None:
        cb = max(128, -(-kd // 8) * 8)
    if A is not None and getattr(A, "shape", (0,))[0]:
        A = _dense(A, dtype, dev)
        p = A.shape[0]
        Aperm = A[:, perm]
    else:
        p = 0
    # band[j, i] holds S[i+j, i]; equilibration scales it by deq[i+j]
    # deq[i]
    ipj = torch.clamp(torch.arange(n, device=dev)[None, :]
                      + torch.arange(kd + 1, device=dev)[:, None], max=n - 1)

    def kktsolver(W):
        di = W["di"]
        band = assemble_band(plan, (di * di).to(dtype))
        if factor_dtype is not None:
            deq = torch.rsqrt(torch.clamp(band[0], min=1e-300))
            bandF = (band * deq[ipj] * deq[None, :]).to(factor_dtype)
        else:
            deq = None
            bandF = band
        if method == "blocked":
            fac = banded.pbtrf_blocked(bandF, cb=cb)
            solve_band = lambda v: banded.pbtrs_blocked(fac, v)  # noqa: E731
        else:
            LB = banded.pbtrf(bandF)
            solve_band = lambda v: banded.pbtrs(LB, v)           # noqa: E731

        def scale(v, d):
            return d * v if v.dim() == 1 else d[:, None] * v

        def Sinv(v):                         # v in ORIGINAL indexing
            vp = v[perm]
            if deq is not None:
                vp = scale(vp, deq).to(bandF.dtype)
            t = solve_band(vp)
            if deq is not None:
                t = scale(t.to(band.dtype), deq)
            return t[inv]

        if p:
            rhs = Aperm.T                    # (n, p), permuted
            if deq is not None:
                rhs = scale(rhs, deq).to(bandF.dtype)
            SiAT = solve_band(rhs)
            if deq is not None:
                SiAT = scale(SiAT.to(band.dtype), deq)
            Lk = torch.linalg.cholesky(Aperm @ SiAT)

        def solve(bx, by, bz):
            zs = di * (di * bz)              # W^{-1} W^{-T} bz ('l')
            t = Sinv(bx + G.rmatvec(zs.to(G.vals.dtype)))
            if p:
                uy = _cho_solve(Lk, A @ t - by)
                ux = t - Sinv(A.T @ uy)
            else:
                uy = by
                ux = t
            return ux, uy, di * (G.matvec(ux) - bz)

        return solve

    kktsolver.plan = plan                    # introspection and tests
    return kktsolver


# ---------------------------------------------------------------------------
# Sparse front ends: large LPs/QPs without ever densifying G
# ---------------------------------------------------------------------------

def _as_ops(G_sp, dtype, device="cuda"):
    from cvxopt_tpu_torch.linops import LinearOperator
    ell = SparseELL.from_scipy(G_sp, device=device, dtype=dtype)
    return LinearOperator(mv=ell.matvec, rmv=ell.rmatvec, shape=ell.shape)


def _pick_sparse_kkt(G_sp, dims, A, P_sp, dtype, method="auto",
                     device="cuda"):
    """Pattern-routed sparse kktsolver: banded when RCM can band the
    Gram pattern (O(n kd^2)), tile-map blocksparse otherwise (arrow and
    grid-fill patterns), as spsolve.symbolic routes.  `method` goes to
    the banded factor."""
    Spat = _pattern(G_sp).T @ _pattern(G_sp)
    if P_sp is not None:
        Spat = Spat + sp.csr_matrix(P_sp)
    n = Spat.shape[0]
    kd = band_width_of(Spat != 0, rcm_order(Spat != 0))
    if (kd + 1) * 4 < n:
        return kkt_chol2_banded(G_sp, dims, A=A, P_sp=P_sp, dtype=dtype,
                                method=method, device=device)
    from cvxopt_tpu_torch.ops.blocksparse import kkt_chol2_blocksparse
    return kkt_chol2_blocksparse(G_sp, dims, A=A, P_sp=P_sp, dtype=dtype,
                                 device=device)


def lp_sparse(c, G_sp, h, A=None, b=None, options=None, method="auto",
              device="cuda"):
    """Solve a large sparse 'l'-cone LP end to end without densifying G:
    operator-form G (ELL matvecs) and the pattern-routed fixed-pattern
    kktsolver (banded or tile-map) in the port's `conelp`, in float64
    on `device`."""
    from cvxopt_tpu_torch import solvers
    from cvxopt_tpu_torch.cones import ConeDims
    dev = resolve_device(device)
    dtype = torch.float64
    G_sp = sp.csr_matrix(G_sp)
    dims = ConeDims(l=G_sp.shape[0])
    kkt = _pick_sparse_kkt(G_sp, dims, A, None, dtype, method=method,
                           device=dev)
    return solvers.conelp(_dense(c, dtype, dev), _as_ops(G_sp, dtype, dev),
                          _dense(h, dtype, dev), dims=dims,
                          A=_dense(A, dtype, dev), b=_dense(b, dtype, dev),
                          kktsolver=kkt, options=options, device=dev)


def qp_sparse(P_sp, q, G_sp, h, A=None, b=None, options=None,
              device="cuda"):
    """Sparse-QP analogue of lp_sparse (coneqp with the pattern-routed
    kktsolver; P enters the symbolic pattern)."""
    from cvxopt_tpu_torch import solvers
    from cvxopt_tpu_torch.cones import ConeDims
    dev = resolve_device(device)
    dtype = torch.float64
    G_sp = sp.csr_matrix(G_sp)
    P_sp = sp.csr_matrix(P_sp)
    dims = ConeDims(l=G_sp.shape[0])
    kkt = _pick_sparse_kkt(G_sp, dims, A, P_sp, dtype, device=dev)
    return solvers.coneqp(_as_ops(P_sp, dtype, dev), _dense(q, dtype, dev),
                          _as_ops(G_sp, dtype, dev), _dense(h, dtype, dev),
                          dims=dims, A=_dense(A, dtype, dev),
                          b=_dense(b, dtype, dev), kktsolver=kkt,
                          options=options, device=dev)
