"""Cone algebra over R^l_+ x SOC(q_0..) x PSD(s_0..) in PyTorch.

Twin of `cvxopt_tpu/cones.py`.  A cone vector is a flat tensor of
length ``dims.cdim`` laid out as ``[nonlinear (mnl) | 'l' | 'q' blocks |
's' blocks (m*m full symmetric, row-major)]``; equal-size blocks are
grouped into runs and handled as stacked batches.  Every function
operates on the last axis and takes any number of leading batch axes.

The blocks of a cone vector are contiguous and in run order, so the
functions build their result by concatenating per-block parts instead
of writing into a copy.  The 's' eigenvalue problems (`max_step`,
`max_step_eig`) go through `ops/jacobi.py` (float64 eigvalsh/eigh of
the symmetrized block).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np
import torch

from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.ops.jacobi import eigh_accurate, eigvalsh_accurate

Tensor = torch.Tensor


@dataclass(frozen=True)
class ConeDims:
    """Static description of a symmetric cone product (the reference's
    ``dims = {'l': ..., 'q': [...], 's': [...]}`` plus the nonlinear
    block count ``mnl``).  Hashable."""

    l: int = 0
    q: Tuple[int, ...] = ()
    s: Tuple[int, ...] = ()
    mnl: int = 0

    def __post_init__(self):
        object.__setattr__(self, "q", tuple(int(m) for m in self.q))
        object.__setattr__(self, "s", tuple(int(m) for m in self.s))
        if self.l < 0 or self.mnl < 0:
            raise ValueError("dims.l and dims.mnl must be nonnegative")
        if any(m < 1 for m in self.q):
            raise ValueError("dims.q entries must be positive")
        if any(m < 0 for m in self.s):
            raise ValueError("dims.s entries must be nonnegative")

    @cached_property
    def lnl(self) -> int:
        """Length of the elementwise (nonlinear + 'l') region."""
        return self.mnl + self.l

    @cached_property
    def qdim(self) -> int:
        return sum(self.q)

    @cached_property
    def sdim_full(self) -> int:
        return sum(m * m for m in self.s)

    @cached_property
    def sdim_packed(self) -> int:
        return sum(m * (m + 1) // 2 for m in self.s)

    @cached_property
    def sdim_diag(self) -> int:
        return sum(self.s)

    @cached_property
    def cdim(self) -> int:
        """Unpacked flat length."""
        return self.lnl + self.qdim + self.sdim_full

    @cached_property
    def cdim_packed(self) -> int:
        return self.lnl + self.qdim + self.sdim_packed

    @cached_property
    def cdim_diag(self) -> int:
        """Length of a 'diagonal storage' vector (e.g. lambda)."""
        return self.lnl + self.qdim + self.sdim_diag

    @cached_property
    def offq(self) -> int:
        return self.lnl

    @cached_property
    def offs(self) -> int:
        return self.lnl + self.qdim

    @cached_property
    def q_runs(self) -> Tuple[Tuple[int, int, int], ...]:
        """Runs of consecutive equal-size 'q' blocks: (offset, count, m)."""
        runs = []
        off = self.offq
        for m, grp in itertools.groupby(self.q):
            cnt = len(list(grp))
            runs.append((off, cnt, m))
            off += cnt * m
        return tuple(runs)

    @cached_property
    def s_runs(self) -> Tuple[Tuple[int, int, int, int], ...]:
        """Runs of equal-size 's' blocks: (mat_offset, diag_offset,
        count, m) into full (cdim) and diagonal (cdim_diag) storage."""
        runs = []
        moff = self.offs
        doff = self.lnl + self.qdim
        for m, grp in itertools.groupby(self.s):
            cnt = len(list(grp))
            runs.append((moff, doff, cnt, m))
            moff += cnt * m * m
            doff += cnt * m
        return tuple(runs)

    def as_dict(self):
        return {"l": self.l, "q": list(self.q), "s": list(self.s)}

    @staticmethod
    def from_dict(d, mnl: int = 0) -> "ConeDims":
        return ConeDims(l=int(d.get("l", 0)), q=tuple(d.get("q", ())),
                        s=tuple(d.get("s", ())), mnl=mnl)


# ---------------------------------------------------------------------------
# views and assembly


def qview(x: Tensor, run) -> Tensor:
    off, cnt, m = run
    return x[..., off:off + cnt * m].reshape(x.shape[:-1] + (cnt, m))


def sview(x: Tensor, run) -> Tensor:
    off, _, cnt, m = run
    return x[..., off:off + cnt * m * m].reshape(x.shape[:-1] + (cnt, m, m))


def sdiagview(lmbda: Tensor, run) -> Tensor:
    _, doff, cnt, m = run
    return lmbda[..., doff:doff + cnt * m].reshape(
        lmbda.shape[:-1] + (cnt, m))


def _flat(v: Tensor, nblock: int) -> Tensor:
    """Flatten the trailing `nblock` block axes into one."""
    return v.reshape(v.shape[:v.dim() - nblock] + (-1,))


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _bcast(parts):
    """Broadcast per-block parts to a common leading shape."""
    lead = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return [p.expand(lead + p.shape[-1:]) for p in parts]


# ---------------------------------------------------------------------------
# inner products and norms


def sdot(x: Tensor, y: Tensor, dims: ConeDims) -> Tensor:
    """Cone-space inner product (a plain dot: 's' storage is full)."""
    return (x * y).sum(-1)


def snrm2(x: Tensor, dims: ConeDims) -> Tensor:
    return torch.sqrt(torch.clamp(sdot(x, x, dims), min=0.0))


def jdot(x: Tensor, y: Tensor) -> Tensor:
    """Hyperbolic inner product x' J y, J = diag(1, -I), last axis."""
    return x[..., 0] * y[..., 0] - (x[..., 1:] * y[..., 1:]).sum(-1)


def jnrm2(x: Tensor) -> Tensor:
    """sqrt(x' J x), computed as sqrt(x0-|x1|)*sqrt(x0+|x1|)."""
    a = torch.linalg.vector_norm(x[..., 1:], dim=-1)
    return torch.sqrt(torch.clamp(x[..., 0] - a, min=0.0)) * \
        torch.sqrt(torch.clamp(x[..., 0] + a, min=0.0))


# ---------------------------------------------------------------------------
# Jordan products


def sprod(x: Tensor, y: Tensor, dims: ConeDims) -> Tensor:
    """Jordan product y o x: 'l' elementwise, 'q' arrow product,
    's' 0.5*(YX + XY)."""
    parts = []
    nl = dims.lnl
    if nl:
        parts.append(x[..., :nl] * y[..., :nl])
    for run in dims.q_runs:
        xk, yk = qview(x, run), qview(y, run)
        d0 = (xk * yk).sum(-1, keepdim=True)
        rest = yk[..., :1] * xk[..., 1:] + xk[..., :1] * yk[..., 1:]
        parts.append(_flat(torch.cat([d0, rest], dim=-1), 2))
    for run in dims.s_runs:
        X, Y = sview(x, run), sview(y, run)
        parts.append(_flat(0.5 * (Y @ X + X @ Y), 3))
    return _cat(_bcast(parts)) if parts else x * y


def sprod_diag(x: Tensor, lmbda: Tensor, dims: ConeDims) -> Tensor:
    """Jordan product lmbda o x with lmbda in diagonal storage."""
    parts = []
    nl = dims.lnl
    if nl:
        parts.append(x[..., :nl] * lmbda[..., :nl])
    for run in dims.q_runs:
        xk = qview(x, run)
        lk = qview(lmbda, run)
        d0 = (xk * lk).sum(-1, keepdim=True)
        rest = lk[..., :1] * xk[..., 1:] + xk[..., :1] * lk[..., 1:]
        parts.append(_flat(torch.cat([d0, rest], dim=-1), 2))
    for run in dims.s_runs:
        X = sview(x, run)
        lk = sdiagview(lmbda, run)
        gam = 0.5 * (lk[..., :, None] + lk[..., None, :])
        parts.append(_flat(X * gam, 3))
    return _cat(_bcast(parts)) if parts else x * lmbda


def sinv(x: Tensor, lmbda: Tensor, dims: ConeDims) -> Tensor:
    """Inverse Jordan product lmbda o\\ x (lmbda in diagonal storage)."""
    parts = []
    nl = dims.lnl
    if nl:
        parts.append(x[..., :nl] / lmbda[..., :nl])
    for run in dims.q_runs:
        xk = qview(x, run)
        lk = qview(lmbda, run)
        aa = jdot(lk, lk)[..., None]
        l0 = lk[..., :1]
        cc = xk[..., :1]
        dd = (lk[..., 1:] * xk[..., 1:]).sum(-1, keepdim=True)
        new0 = cc * l0 - dd
        new1 = (aa / l0) * xk[..., 1:] + (dd / l0 - cc) * lk[..., 1:]
        parts.append(_flat(torch.cat([new0, new1], dim=-1) / aa, 2))
    for run in dims.s_runs:
        X = sview(x, run)
        lk = sdiagview(lmbda, run)
        gam = 0.5 * (lk[..., :, None] + lk[..., None, :])
        parts.append(_flat(X / gam, 3))
    return _cat(_bcast(parts)) if parts else x / lmbda


def ssqr(lmbda: Tensor, dims: ConeDims) -> Tensor:
    """lmbda o lmbda in diagonal storage."""
    out = lmbda * lmbda
    if not dims.q_runs:
        return out
    parts = [out[..., :dims.lnl]]
    for run in dims.q_runs:
        lk = qview(lmbda, run)
        d0 = (lk * lk).sum(-1, keepdim=True)
        rest = 2.0 * lk[..., :1] * lk[..., 1:]
        parts.append(_flat(torch.cat([d0, rest], dim=-1), 2))
    parts.append(out[..., dims.offs:])
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# identity / diag embeddings


def cone_identity(dims: ConeDims, dtype=torch.float64,
                  device="cuda") -> Tensor:
    """Identity element e: ones on 'l', (1,0,..) per 'q' block,
    identity matrices for 's'."""
    e = np.zeros(dims.cdim)
    e[:dims.lnl] = 1.0
    for off, cnt, m in dims.q_runs:
        e[off:off + cnt * m:m] = 1.0
    for off, _, cnt, m in dims.s_runs:
        blk = np.zeros((cnt, m, m))
        idx = np.arange(m)
        blk[:, idx, idx] = 1.0
        e[off:off + cnt * m * m] = blk.reshape(-1)
    return torch.tensor(e, dtype=dtype, device=resolve_device(device))


def push_interior(u: Tensor, t: Tensor, e: Tensor,
                  dims: ConeDims) -> Tensor:
    """A cold start point's push into the cone's interior
    (coneprog.py:2044-2149): u + (1 + t) e where t = max_step(u) says
    that u is not strictly interior (t >= -1e-8 max(1, snrm2(u))), else
    u.  `e` is the cone's identity; t carries u's leading axes."""
    nrm = snrm2(u, dims)
    return torch.where((t >= -1e-8 * torch.clamp(nrm, min=1.0))[..., None],
                       u + (1.0 + t)[..., None] * e, u)


def diag_embed(lmbda: Tensor, dims: ConeDims) -> Tensor:
    """Diagonal storage (cdim_diag) -> full storage (cdim)."""
    nq = dims.lnl + dims.qdim
    parts = [lmbda[..., :nq]]
    for run in dims.s_runs:
        lk = sdiagview(lmbda, run)
        parts.append(_flat(torch.diag_embed(lk), 3))
    return _cat(parts)


def diag_part(x: Tensor, dims: ConeDims) -> Tensor:
    """Full storage (cdim) -> diagonal storage (cdim_diag)."""
    nq = dims.lnl + dims.qdim
    parts = [x[..., :nq]]
    for run in dims.s_runs:
        d = torch.diagonal(sview(x, run), dim1=-2, dim2=-1)
        parts.append(_flat(d, 2))
    return _cat(parts)


def _replace_s(x: Tensor, dims: ConeDims, fn) -> Tensor:
    if not dims.s_runs:
        return x
    parts = [x[..., :dims.offs]]
    for run in dims.s_runs:
        parts.append(_flat(fn(sview(x, run)), 3))
    return torch.cat(parts, dim=-1)


def symmetrize(x: Tensor, dims: ConeDims) -> Tensor:
    """X := (X + X')/2 on every 's' block."""
    return _replace_s(x, dims,
                      lambda X: 0.5 * (X + X.transpose(-1, -2)))


def symmetrize_lower(x: Tensor, dims: ConeDims) -> Tensor:
    """Symmetrize 's' blocks from the reference's column-major 'L'
    storage (the row-major upper triangle is the meaningful part)."""
    return _replace_s(
        x, dims,
        lambda X: torch.triu(X) + torch.triu(X, 1).transpose(-1, -2))


# ---------------------------------------------------------------------------
# packed storage


def pack(x: Tensor, dims: ConeDims) -> Tensor:
    """Full (cdim) -> packed (cdim_packed), off-diagonal 's' entries
    scaled by sqrt(2) (an isometry)."""
    nq = dims.lnl + dims.qdim
    parts = [x[..., :nq]]
    for run in dims.s_runs:
        m = run[3]
        rows, cols = np.tril_indices(m)
        v = sview(x, run)[..., rows, cols]
        w = torch.tensor(np.where(rows == cols, 1.0, np.sqrt(2.0)),
                         dtype=x.dtype, device=x.device)
        parts.append(_flat(v * w, 2))
    return _cat(parts)


def unpack(y: Tensor, dims: ConeDims) -> Tensor:
    """Packed (cdim_packed) -> full symmetric (cdim) storage."""
    nq = dims.lnl + dims.qdim
    parts = [y[..., :nq]]
    p = nq
    for run in dims.s_runs:
        _, _, cnt, m = run
        npk = m * (m + 1) // 2
        v = y[..., p:p + cnt * npk].reshape(y.shape[:-1] + (cnt, npk))
        p += cnt * npk
        rows, cols = np.tril_indices(m)
        w = torch.tensor(np.where(rows == cols, 1.0, 1.0 / np.sqrt(2.0)),
                         dtype=y.dtype, device=y.device)
        X = torch.zeros(v.shape[:-1] + (m, m), dtype=y.dtype,
                        device=y.device)
        X[..., rows, cols] = v * w
        X = X + torch.tril(X, -1).transpose(-1, -2)
        parts.append(_flat(X, 3))
    return _cat(parts)


def pack_matrix_cols(M: Tensor, dims: ConeDims) -> Tensor:
    """`pack` on every column of a (cdim, n) matrix."""
    return pack(M.transpose(-1, -2), dims).transpose(-1, -2)


# ---------------------------------------------------------------------------
# max_step


def _lq_steps(x: Tensor, dims: ConeDims):
    ts = []
    nl = dims.lnl
    if nl:
        ts.append(-torch.amin(x[..., :nl], dim=-1))
    for run in dims.q_runs:
        xk = qview(x, run)
        t = torch.linalg.vector_norm(xk[..., 1:], dim=-1) - xk[..., 0]
        ts.append(torch.amax(t, dim=-1))
    return ts


def _max_of(ts, x: Tensor) -> Tensor:
    if not ts:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.amax(torch.stack(ts, dim=-1), dim=-1)


def max_step(x: Tensor, dims: ConeDims) -> Tensor:
    """min { t | x + t*e >= 0 }: 'l' -min(x), 'q' |x1| - x0,
    's' -lambda_min."""
    ts = _lq_steps(x, dims)
    for run in dims.s_runs:
        w = eigvalsh_accurate(sview(x, run))
        ts.append(torch.amax(-w[..., 0], dim=-1))
    return _max_of(ts, x)


def max_step_eig(x: Tensor, dims: ConeDims):
    """max_step that also returns the 's' eigendecomposition:
    (t, sig, Qx) with sig the 's' eigenvalues in diagonal storage and
    Qx = x with each 's' block replaced by its eigenvector matrix."""
    ts = _lq_steps(x, dims)
    sig_parts, vparts = [], []
    for run in dims.s_runs:
        w, V = eigh_accurate(sview(x, run))
        ts.append(torch.amax(-w[..., 0], dim=-1))
        sig_parts.append(_flat(w, 2))
        vparts.append(_flat(V, 3))
    sig = (torch.cat(sig_parts, dim=-1) if sig_parts
           else x.new_zeros(x.shape[:-1] + (0,)))
    out = torch.cat([x[..., :dims.offs]] + vparts, dim=-1) \
        if vparts else x
    return _max_of(ts, x), sig, out
