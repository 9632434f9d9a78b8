"""KKT factor-solve strategies for the port's cone-QP solver.

Twin of `cvxopt_tpu/kkt.py`, limited to what the batched cone-QP path
needs: the normal-equations Cholesky `kkt_chol2` ('chol2' and its
explicit-inverse form 'chol2_inv'), `get_kktsolver`, `robust_name`,
`wrap_P` and `resolve_factor_dtype`.  Each strategy is a factory

    factor = kkt_chol2(G, dims, A)
    solve  = factor(W [, H, Df])          # once per IPM iteration
    ux, uy, Wuz = solve(bx, by, bz)       # several times per iteration

on batched tensors: W's entries, bx, by, bz carry a leading batch axis;
G and A are shared (m, n) / (p, n) or per-instance (B, m, n) / (B, p, n).

For cones with only an 'l' part (no Df), the factor of
S = H + G' diag(di^2) G runs in the fused CUDA kernels of
`ops/fused_chol.py`, called with Gt = G' and dinv2 = di^2: the scaled
per-instance G is never formed (at B = 1024, n = 256, m = 512 it would
be 512 MB of f32).  A shared G goes to the batched kernel pair, a
per-instance G to the unbatched pair.  The kernels need n to be a
multiple of 64, so this layer pads P with an identity block, Gt with
zero rows and the right-hand sides with zeros, and slices the results
back.  'q'/'s' cones keep a plain torch factor until their slice.

Singularity is reported through NaNs, which the solver loops turn into
a status code.
"""

from __future__ import annotations

from typing import Optional

import torch

from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.scaling import (
    scale, scale_rows, scale_w2inv, _difull, _chol_nan,
)
from cvxopt_tpu_torch.ops.matvec import mv, mvt
from cvxopt_tpu_torch.ops import fused_chol as fc

DEFAULT_SOLVERS = ("ldl", "ldl2", "qr", "chol", "chol2")

# strategies of the JAX package that later slices port (ROADMAP.md,
# Queue 1 item 6)
_LATER = ("ldl", "ldl2", "qr", "qr_inv", "chol", "chol_inv", "cholqr",
          "cholqr_inv")

_DTYPE_NAMES = {"float32": torch.float32, "float64": torch.float64}


def _stack_gg(G, Df):
    """GG = [Df; G]."""
    if Df is None:
        return G
    if G.dim() < Df.dim():
        G = G.expand(Df.shape[:-2] + G.shape)
    return torch.cat([Df, G], dim=-2)


def _as_dtype(fd):
    if fd is None or isinstance(fd, torch.dtype):
        return fd
    if fd not in _DTYPE_NAMES:
        raise ValueError(f"unsupported factor_dtype {fd!r}")
    return _DTYPE_NAMES[fd]


def _pad_to(n):
    return -(-n // fc.BP) * fc.BP


def _colvec(v, fn):
    """Apply a rows -> rows map to a vector (B, n) or to the columns of
    a matrix (B, n, k), as S^{-1} v is written in the JAX package."""
    if v.dim() == 2:
        return fn(v.unsqueeze(1)).squeeze(1)
    return fn(v.transpose(-1, -2)).transpose(-1, -2)


def _kernel_factor(Hf, Gt, dinv2, n, equilibrate, explicit_inverse):
    """Factor S = H + Gt diag(dinv2) Gt' in the fused kernels; returns
    a rows -> rows map r -> S^{-1} r (explicit_inverse=False) or the
    matrix S^{-1} (True)."""
    dev = dinv2.device
    dt = dinv2.dtype
    Bsz = dinv2.shape[0]
    npd = _pad_to(n)
    shared = Gt.dim() == 2
    if npd != n:
        Pp = torch.zeros((Bsz, npd, npd), dtype=dt, device=dev)
        Pp[:, :n, :n] = Hf
        idx = torch.arange(n, npd, device=dev)
        Pp[:, idx, idx] = 1.0
        Gp = torch.zeros(Gt.shape[:-2] + (npd, Gt.shape[-1]), dtype=dt,
                         device=dev)
        Gp[..., :n, :] = Gt
        Hf, Gt = Pp, Gp
    else:
        Hf = Hf.expand(Bsz, n, n).contiguous()
        Gt = Gt.contiguous()
    if shared:
        out = fc.fused_schur_cholesky_batched(
            Hf, Gt, dinv2, tb=1, equilibrate=equilibrate, device=dev)
    else:
        out = fc.fused_schur_cholesky(
            Hf, Gt, dinv2, equilibrate=equilibrate, device=dev)
    L, Dinv = out[0], out[1]
    deq = out[2][:, :n] if equilibrate else None

    def solve_rows(R):
        if shared:
            return fc.fused_cholesky_solve_batched(L, Dinv, R, tb=1,
                                                   device=dev)
        return fc.fused_cholesky_solve(L, Dinv, R, device=dev)

    if explicit_inverse:
        eye = torch.eye(npd, dtype=dt, device=dev).expand(Bsz, npd, npd)
        Sinv = solve_rows(eye)
        if npd != n:
            Sinv = Sinv[:, :n, :n].contiguous()
        if deq is not None:
            Sinv = deq[:, :, None] * Sinv * deq[:, None, :]
        return Sinv

    def Sinv_rows(R):
        if deq is not None:
            R = R * deq[:, None, :]
        if npd != n:
            R = torch.cat([R, R.new_zeros(R.shape[:-1] + (npd - n,))],
                          dim=-1)
        X = solve_rows(R.contiguous())[..., :n]
        return X * deq[:, None, :] if deq is not None else X

    return Sinv_rows


def kkt_chol2(G, dims: ConeDims, A, mnl: int = 0,
              explicit_inverse: bool = False, factor_dtype=None):
    """Normal-equations Cholesky: S = H + GG'W^{-1}W^{-T}GG factored
    directly, equalities through the Schur complement K = A S^{-1} A'.

    ``explicit_inverse=True`` ('chol2_inv') forms S^{-1} once per factor
    (the kernel solve with n identity right-hand sides) and applies it
    with matmuls.  ``factor_dtype`` factors in that dtype after Jacobi
    equilibration S_e = D S D, D = diag(S)^{-1/2} (done inside the
    kernel), while the solver's iterative refinement recovers accuracy.
    """
    if factor_dtype == "adaptive":
        raise NotImplementedError(
            "factor_dtype='adaptive' is not ported yet (ROADMAP.md "
            "Queue 1 item 6, the adaptive factor)")
    fdt_opt = _as_dtype(factor_dtype)
    lonly = not dims.q_runs and not dims.s_runs

    def factor(W, H=None, Df=None):
        GG = _stack_gg(G, Df)
        io_dtype = GG.dtype
        fdt = fdt_opt or io_dtype
        n = GG.shape[-1]
        di = _difull(W)
        Bsz = di.shape[0]
        dev = di.device
        Af = A.to(fdt)
        if H is None:
            Hf = torch.zeros((n, n), dtype=fdt, device=dev)
        else:
            Hf = H.to(fdt)
        if lonly and Df is None:
            dif = di.to(fdt)
            dinv2 = (dif * dif).expand(Bsz, dif.shape[-1]).contiguous()
            Gt = GG.to(fdt).transpose(-1, -2)
            out = _kernel_factor(Hf, Gt, dinv2, n, fdt_opt is not None,
                                 explicit_inverse)
        else:
            # 'q'/'s' cones: plain torch factor until their slice
            Wf = {k: ([u.to(fdt) for u in v] if isinstance(v, list)
                      else v.to(fdt)) for k, v in W.items()}
            GGb = GG.to(fdt)
            if GGb.dim() == 2:
                GGb = GGb.expand((Bsz,) + GGb.shape)
            Gs = scale_rows(GGb, Wf, dims, trans="T", inverse="I")
            S = Gs.transpose(-1, -2) @ Gs + Hf
            deq = None
            if fdt_opt is not None:
                deq = torch.rsqrt(torch.clamp(
                    torch.diagonal(S, dim1=-2, dim2=-1), min=1e-30))
                S = S * deq[:, :, None] * deq[:, None, :]
            Ls = _chol_nan(S)
            if explicit_inverse:
                out = torch.cholesky_inverse(Ls)
                if deq is not None:
                    out = deq[:, :, None] * out * deq[:, None, :]
            else:
                def out(R, Ls=Ls, deq=deq):
                    if deq is not None:
                        R = R * deq[:, None, :]
                    X = torch.cholesky_solve(R.transpose(-1, -2), Ls)
                    X = X.transpose(-1, -2)
                    return X * deq[:, None, :] if deq is not None else X

        if explicit_inverse:
            Sinv_mat = out

            def Sinv(v):
                if v.dim() == 2:
                    return (Sinv_mat @ v.unsqueeze(-1)).squeeze(-1)
                return Sinv_mat @ v
        else:
            def Sinv(v):
                return _colvec(v, out)

        p = A.shape[-2]
        if p:
            At = Af.transpose(-1, -2)
            if At.dim() == 2:
                At = At.expand(Bsz, n, p)
            SiAT = Sinv(At)                              # (B, n, p)
            K = Af @ SiAT
            Lk = _chol_nan(K)

        def solve(bx, by, bz):
            # r = bx + GG' W^{-1} W^{-T} bz through the UNSCALED GG
            zs = scale_w2inv(bz, W, dims)
            r = (bx + mvt(GG, zs)).to(fdt)
            t = Sinv(r)
            if p:
                rhs = mv(Af, t) - by.to(fdt)
                w = torch.linalg.solve_triangular(
                    Lk, rhs.unsqueeze(-1), upper=False)
                uy = torch.linalg.solve_triangular(
                    Lk.transpose(-1, -2), w, upper=True).squeeze(-1)
                ux = t - (SiAT @ uy.unsqueeze(-1)).squeeze(-1)
            else:
                uy = by.to(fdt)
                ux = t
            ux = ux.to(io_dtype)
            uy = uy.to(io_dtype)
            Wuz = scale(mv(GG, ux) - bz, W, dims, trans="T", inverse="I")
            return ux, uy, Wuz

        return solve

    return factor


def robust_name(name: str) -> str:
    """The non-explicit-inverse variant of a kktsolver name (the f64
    rescue phases always factor with the triangular-solve variants)."""
    return {"chol2_inv": "chol2", "chol_inv": "chol",
            "qr_inv": "qr", "cholqr_inv": "cholqr"}.get(name, name)


def wrap_P(name, P, factor_dtype=None):
    """The JAX package hoists a square-root factor of P out of the
    iteration for the 'cholqr' strategies; those are not ported yet."""
    if isinstance(name, str) and "cholqr" in name:
        raise NotImplementedError(
            "kktsolver 'cholqr' is not ported yet (ROADMAP.md Queue 1 "
            "item 6)")
    return P


def resolve_factor_dtype(factor_dtype):
    """Resolve `options['factor_dtype']`.

    'auto' resolves to None (factor in the working dtype): f64 linear
    algebra is native on CUDA (and on the CPU), so the JAX package's
    TPU-only mixed-precision default does not apply.  'none'/False
    disable; anything else ('float32', 'rescue') passes through."""
    if factor_dtype in ("none", False, "auto"):
        return None
    return factor_dtype


def get_kktsolver(name: str, G, dims: ConeDims, A, mnl: int = 0,
                  kktreg: Optional[float] = None, factor_dtype=None):
    """Map kktsolver names to strategies ('chol2', 'chol2_inv')."""
    if name == "chol2":
        return kkt_chol2(G, dims, A, mnl=mnl, factor_dtype=factor_dtype)
    if name == "chol2_inv":
        return kkt_chol2(G, dims, A, mnl=mnl, explicit_inverse=True,
                         factor_dtype=factor_dtype)
    if name in _LATER:
        raise NotImplementedError(
            f"kktsolver '{name}' is not ported yet (ROADMAP.md Queue 1 "
            "item 6)")
    raise ValueError(f"'{name}' is not a valid value for kktsolver")
