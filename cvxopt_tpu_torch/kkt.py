"""KKT factor-solve strategies for the port's conic IPM solvers.

Twin of `cvxopt_tpu/kkt.py`.  Each strategy is a factory

    factor = kkt_xxx(G, dims, A, mnl=0, ...)
    solve  = factor(W [, H, Df])          # once per IPM iteration
    ux, uy, Wuz = solve(bx, by, bz)       # several times per iteration

solving the 3x3 system

    [ H    A'   GG'   ] [ ux ]   [ bx ]
    [ A    0    0     ] [ uy ] = [ by ]        GG = [Df; G]
    [ GG   0   -W'W   ] [ uz ]   [ bz ]

and returning (ux, uy, W*uz), on batched tensors: W's entries, bx, by,
bz carry a leading batch axis; G and A are shared (m, n) / (p, n) or
per-instance (B, m, n) / (B, p, n).

Strategies ('*_inv' names are the explicit-inverse variants):
  kkt_lu     'ldl': LU of the full 3x3 system with packed 's' rows;
  kkt_ldl2   'ldl2': LU of the condensed 2x2 system of order n+p;
  kkt_chol   'chol': QR of A' eliminates the equalities, then a dense
             Cholesky of Q2'(H + GG'W^{-1}W^{-T}GG)Q2; coneqp's default
             on 'q'/'s' cones;
  kkt_chol2  'chol2': Cholesky of S = H + GG'W^{-1}W^{-T}GG and a Schur
             complement for A; the default on 'l' cones;
  kkt_cholqr 'cholqr': QR of [W^{-T}GG; Rp] Q2 with Rp'Rp = H, so that
             kappa(R) = sqrt(kappa(S)): the strategy whose float32 factor
             reaches 1e-7 on 'q'/'s' cones;
  kkt_qr     'qr': two QR factorizations for a zero (1,1) block;
             conelp's default on 'q'/'s' cones.

`kkt_chol2` factors and solves in the fused CUDA kernels of
`ops/fused_chol.py` on every cone.  With only an 'l' part (no Df) it
hands them Gt = G' and dinv2 = di^2: the scaled per-instance G is never
formed (at B = 1024, n = 256, m = 512 it would be 512 MB of f32), and a
shared G goes to the batched kernel pair.  With 'q'/'s' blocks it forms
the scaled Gs = W^{-T} GG per instance and hands the unbatched pair
Gt = Gs', dinv2 = 1.  The kernels need n to be a multiple of 64, so this
layer pads P with an identity block, Gt with zero rows and the
right-hand sides with zeros, and slices the results back.  Given CPU
tensors the kernel wrappers compute their plain PyTorch versions.

Singularity is reported through NaNs (or infinities), which the solver
loops turn into a status code; no strategy raises on a singular system.
"""

from __future__ import annotations

from typing import Optional

import torch

from cvxopt_tpu_torch.cones import ConeDims, pack, unpack, pack_matrix_cols
from cvxopt_tpu_torch.scaling import (
    scale, scale_rows, scale_w2inv, _difull, _chol_nan,
)
from cvxopt_tpu_torch.ops.matvec import mv, mvt
from cvxopt_tpu_torch.ops import fused_chol as fc
from cvxopt_tpu_torch.ops.blockinv import spd_inverse
from cvxopt_tpu_torch.ops.jacobi import eigh_accurate

DEFAULT_SOLVERS = ("ldl", "ldl2", "qr", "chol", "chol2")

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


def _factor_dtype(factor_dtype):
    """torch dtype of a strategy's factor_dtype option; 'adaptive' (which
    lives in kkt_chol2 only) means float32 elsewhere."""
    if factor_dtype == "adaptive":
        return torch.float32
    return _as_dtype(factor_dtype)


def _cast_W(W, dt):
    return {k: ([u.to(dt) for u in v] if isinstance(v, list) else v.to(dt))
            for k, v in W.items()}


def _bexp(M, Bsz):
    """A shared (m, n) matrix as a (B, m, n) view."""
    return M if M.dim() == 3 else M.expand((Bsz,) + M.shape)


def _scaled_G(GG, W, dims, fdt, Bsz):
    """Gs = W^{-T} GG per instance, (B, cdim, n), cast to `fdt` BEFORE
    scaling so that the batched scaled matrix only ever exists in the
    factor's dtype."""
    return scale_rows(_bexp(GG.to(fdt), Bsz), _cast_W(W, fdt), dims,
                      trans="T", inverse="I")


def _tri(T, v, upper):
    """T^{-1} v for triangular T (..., k, k) and vectors v (B, k)."""
    return torch.linalg.solve_triangular(
        T, v.unsqueeze(-1), upper=upper).squeeze(-1)


def _eye_inverse_upper(R):
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    return torch.linalg.solve_triangular(R, eye.expand(R.shape), upper=True)


def _qr_At(A, explicit_inverse):
    """A' = Q [R1; 0]: (Q1, Q2, R1, R1inv) with Q1 (..., n, p) spanning
    range(A'), Q2 (..., n, n-p) its complement.  p = 0 takes Q2 = I
    without calling the library on an empty matrix."""
    p, n = A.shape[-2:]
    kw = dict(dtype=A.dtype, device=A.device)
    if not p:
        return (torch.zeros((n, 0), **kw), torch.eye(n, **kw),
                torch.zeros((0, 0), **kw), None)
    Q, RA = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    R1 = RA[..., :p, :]
    return (Q[..., :p], Q[..., p:], R1,
            _eye_inverse_upper(R1) if explicit_inverse else None)


def _equalities(A, explicit_inverse, fdt):
    """The equality block of the QR-based strategies in dtype `fdt`:
    Q1, Q2 and the maps v -> R1'^{-1} v, v -> R1^{-1} v."""
    Q1, Q2, R1, R1inv = _qr_At(A, explicit_inverse)
    Q1f, Q2f = Q1.to(fdt), Q2.to(fdt)
    if explicit_inverse and R1inv is not None:
        R1i = R1inv.to(fdt)
        return Q1f, Q2f, (lambda v: mvt(R1i, v)), (lambda v: mv(R1i, v))
    R1f = R1.to(fdt)
    return (Q1f, Q2f,
            lambda v: _tri(R1f.transpose(-1, -2), v, upper=False),
            lambda v: _tri(R1f, v, upper=True))


def _lu_nan(K):
    """LU factors of K; a singular K gives infinities or NaN in the
    solves instead of an exception."""
    lu, piv, _ = torch.linalg.lu_factor_ex(K)
    return lu, piv


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

    ``factor_dtype='adaptive'`` factors in equilibrated float32 every
    iteration and verifies the factor with one probe solve whose
    residual is taken in the working dtype; instances whose float32
    factor contracts too weakly for iterative refinement get a
    working-precision factor through `eigh_accurate` instead.  Meant for
    single problems: one weak instance makes the whole batch pay for
    the second factorization."""
    if factor_dtype == "adaptive":
        return _kkt_chol2_adaptive(G, dims, A)
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
        else:
            # 'q'/'s' cones: S = H + Gs'Gs with the scaled Gs
            Gs = _scaled_G(GG, W, dims, fdt, Bsz)
            Gt = Gs.transpose(-1, -2)
            dinv2 = torch.ones((Bsz, Gs.shape[-2]), dtype=fdt, device=dev)
        out = _kernel_factor(Hf, Gt, dinv2, n, fdt_opt is not None,
                             explicit_inverse)

        if explicit_inverse:
            Sinv_mat = out

            def Sinv(v):
                if v.dim() == 2:
                    return (Sinv_mat @ v.unsqueeze(-1)).squeeze(-1)
                return Sinv_mat @ v
        else:
            def Sinv(v):
                return _colvec(v, out)

        return _chol2_solver(GG, W, dims, Af, Sinv, fdt, io_dtype, Bsz)

    return factor


def _chol2_solver(GG, W, dims, Af, Sinv, fdt, io_dtype, Bsz):
    """kkt_chol2's solve closure, given v -> S^{-1} v on vectors (B, n)
    and matrices (B, n, k)."""
    p, n = Af.shape[-2:]
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
            uy = _tri(Lk.transpose(-1, -2), _tri(Lk, rhs, upper=False),
                      upper=True)
            ux = t - (SiAT @ uy.unsqueeze(-1)).squeeze(-1)
        else:
            uy = by.to(fdt)
            ux = t
        ux = ux.to(io_dtype)
        uy = uy.to(io_dtype)
        Wuz = scale(mv(GG, ux) - bz, W, dims, trans="T", inverse="I")
        return ux, uy, Wuz

    return solve


def _kkt_chol2_adaptive(G, dims: ConeDims, A):
    """kkt_chol2 with factor_dtype='adaptive' (see there)."""
    f32 = torch.float32

    def factor(W, H=None, Df=None):
        GG = _stack_gg(G, Df)
        io_dtype = GG.dtype
        n = GG.shape[-1]
        Bsz = _difull(W).shape[0]
        dev = GG.device
        Gs32 = _scaled_G(GG, W, dims, f32, Bsz)
        # the equilibrated float32 factor, in the fused kernels as every
        # other kkt_chol2 factor
        H32 = torch.zeros((n, n), dtype=f32, device=dev) if H is None \
            else H.to(f32)
        rows32 = _kernel_factor(
            H32, Gs32.transpose(-1, -2),
            torch.ones(Gs32.shape[:-1], dtype=f32, device=dev), n, True,
            False)

        def solve32(V):                              # V (B, n, k)
            return _colvec(V.to(f32), rows32).to(io_dtype)

        # probe: one f32 solve, its residual against the true S in the
        # working dtype, as Gs'(Gs t) + H t (two mat-vecs; S itself is
        # not formed)
        Gs = _scaled_G(GG, W, dims, io_dtype, Bsz)
        r0 = torch.full((Bsz, n, 1), 1.0 / float(n) ** 0.5,
                        dtype=io_dtype, device=dev)
        t = solve32(r0)
        St = Gs.transpose(-1, -2) @ (Gs @ t)
        if H is not None:
            St = St + H @ t
        relres = torch.linalg.vector_norm((St - r0).squeeze(-1), dim=-1)
        # NaN-safe: a non-PD (in f32) S must take the accurate branch
        need64 = ~(relres <= 1e-6)

        if bool(need64.any()):
            S64 = Gs.transpose(-1, -2) @ Gs
            if H is not None:
                S64 = S64 + H
            w, V64 = eigh_accurate(S64)
            winv = torch.where(w > 0, 1.0 / torch.where(
                w > 0, w, torch.ones_like(w)),
                torch.full_like(w, float("nan")))

            def app64(U):
                return V64 @ (winv[:, :, None]
                              * (V64.transpose(-1, -2) @ U))

            def Sinv_mat(U):
                X = app64(U)
                for _ in range(3):           # internal refinement
                    X = X + app64(U - S64 @ X)
                return torch.where(need64[:, None, None], X, solve32(U))
        else:
            Sinv_mat = solve32

        def Sinv(v):
            if v.dim() == 2:
                return Sinv_mat(v.unsqueeze(-1)).squeeze(-1)
            return Sinv_mat(v)

        return _chol2_solver(GG, W, dims, A, Sinv, io_dtype, io_dtype, Bsz)

    return factor


def kkt_lu(G, dims: ConeDims, A, mnl: int = 0,
           kktreg: Optional[float] = None):
    """Dense factorization of the full 3x3 KKT system with packed cone
    rows ('ldl'): LU with partial pivoting in place of Bunch-Kaufman
    LDL.  With static regularization ``kktreg`` (+reg on the (1,1)
    block's diagonal, -reg on the (2,2)/(3,3) blocks) the system is
    quasidefinite and the factorization is stable."""
    p, n = A.shape[-2:]
    pdim = dims.cdim_packed
    ldK = n + p + pdim

    def factor(W, H=None, Df=None):
        GG = _stack_gg(G, Df)
        Bsz = _difull(W).shape[0]
        Gp = pack_matrix_cols(
            _scaled_G(GG, W, dims, GG.dtype, Bsz), dims)     # (B, pdim, n)
        K = torch.zeros((Bsz, ldK, ldK), dtype=GG.dtype, device=GG.device)
        if H is not None:
            K[:, :n, :n] = H
        K[:, n:n + p, :n] = A
        K[:, :n, n:n + p] = A.transpose(-1, -2)
        K[:, n + p:, :n] = Gp
        K[:, :n, n + p:] = Gp.transpose(-1, -2)
        diag = torch.arange(n + p, ldK, device=GG.device)
        K[:, diag, diag] = -1.0
        if kktreg is not None:
            d1 = torch.arange(n, device=GG.device)
            K[:, d1, d1] += kktreg
            d2 = torch.arange(n, ldK, device=GG.device)
            K[:, d2, d2] -= kktreg
        lu, piv = _lu_nan(K)

        def solve(bx, by, bz):
            zs = scale(bz, W, dims, trans="T", inverse="I")
            u = torch.cat([bx, by, pack(zs, dims)], dim=-1)
            u = torch.linalg.lu_solve(lu, piv, u.unsqueeze(-1)).squeeze(-1)
            return u[:, :n], u[:, n:n + p], unpack(u[:, n + p:], dims)

        return solve

    return factor


def kkt_ldl2(G, dims: ConeDims, A, mnl: int = 0,
             kktreg: Optional[float] = None, factor_dtype=None):
    """Condensed 2x2 factorization ('ldl2'): eliminate uz to get

        [ H + GG' W^{-1} W^{-T} GG   A' ] [ ux ]   [ bx + GG'W^{-1}W^{-T}bz ]
        [ A                          0  ] [ uy ] = [ by                     ]

    of order n+p, factored by LU with partial pivoting.  Unlike
    kkt_chol2 this needs only a nonsingular saddle system, not a
    positive definite S.  Supports ``kktreg`` as kkt_lu does."""
    p, n = A.shape[-2:]
    fdt_opt = _factor_dtype(factor_dtype)

    def factor(W, H=None, Df=None):
        GG = _stack_gg(G, Df)
        io_dtype = GG.dtype
        fdt = fdt_opt or io_dtype
        Bsz = _difull(W).shape[0]
        Gs = _scaled_G(GG, W, dims, fdt, Bsz)
        S = Gs.transpose(-1, -2) @ Gs
        if H is not None:
            S = S + H.to(fdt)
        K = torch.zeros((Bsz, n + p, n + p), dtype=fdt, device=GG.device)
        K[:, :n, :n] = S
        K[:, n:, :n] = A.to(fdt)
        K[:, :n, n:] = A.to(fdt).transpose(-1, -2)
        if kktreg is not None:
            d1 = torch.arange(n, device=GG.device)
            K[:, d1, d1] += kktreg
            d2 = torch.arange(n, n + p, device=GG.device)
            K[:, d2, d2] -= kktreg
        lu, piv = _lu_nan(K)

        def solve(bx, by, bz):
            zs = scale_w2inv(bz, W, dims)
            r = (bx + mvt(GG, zs)).to(fdt)
            u = torch.cat([r, by.to(fdt)], dim=-1)
            u = torch.linalg.lu_solve(lu, piv, u.unsqueeze(-1)).squeeze(-1)
            ux = u[:, :n].to(io_dtype)
            uy = u[:, n:].to(io_dtype)
            Wuz = scale(mv(GG, ux) - bz, W, dims, trans="T", inverse="I")
            return ux, uy, Wuz

        return solve

    return factor


def _reduced_solver(GG, W, dims, eq, Smv, Kinv, fdt, io_dtype, p):
    """The solve closure shared by kkt_chol and kkt_cholqr: equalities
    eliminated through A' = Q1 R1, the reduced system Q2'SQ2 v2 = rhs2
    solved by `Kinv`, S applied by `Smv`."""
    Q1f, Q2f, solve_R1T, solve_R1 = eq

    def solve(bx, by, bz):
        # r = bx + GG' W^{-1} W^{-T} bz through the UNSCALED GG
        zs = scale_w2inv(bz, W, dims)
        r = (bx + mvt(GG, zs)).to(fdt)
        byf = by.to(fdt)
        if p:
            x1 = mv(Q1f, solve_R1T(byf))     # from A ux = by: R1' v1 = by
            rhs2 = mvt(Q2f, r - Smv(x1))
        else:
            rhs2 = mvt(Q2f, r)
        ux = mv(Q2f, Kinv(rhs2))
        if p:
            ux = ux + x1
            uy = solve_R1(mvt(Q1f, r - Smv(ux)))
        else:
            uy = byf
        ux = ux.to(io_dtype)
        uy = uy.to(io_dtype)
        # W uz = W^{-T} (GG ux - bz)
        Wuz = scale(mv(GG, ux) - bz, W, dims, trans="T", inverse="I")
        return ux, uy, Wuz

    return solve


def kkt_chol(G, dims: ConeDims, A, mnl: int = 0,
             explicit_inverse: bool = False, factor_dtype=None):
    """QR of A' to eliminate the equality constraints, then a dense
    Cholesky of K = Q2'(H + GG'W^{-1}W^{-T}GG)Q2 ('chol'); coneqp's
    default on 'q'/'s' cones.

    ``explicit_inverse=True`` ('chol_inv') forms K^{-1} by
    `blockinv.spd_inverse` (and R1^{-1}, fixed across iterations) so
    that every solve is matmuls.  ``factor_dtype`` factors in that
    dtype after Jacobi equilibration of K."""
    p = A.shape[-2]
    fdt_opt = _factor_dtype(factor_dtype)
    io_dtype = G.dtype
    fdt = fdt_opt or io_dtype
    eq = _equalities(A, explicit_inverse, fdt)       # once per problem
    Q2f = eq[1]

    def factor(W, H=None, Df=None):
        GG = _stack_gg(G, Df)
        Bsz = _difull(W).shape[0]
        Gs = _scaled_G(GG, W, dims, fdt, Bsz)
        S = Gs.transpose(-1, -2) @ Gs
        if H is not None:
            S = S + H.to(fdt)
        K = Q2f.transpose(-1, -2) @ S @ Q2f              # (B, n-p, n-p)
        deq = None
        if fdt_opt is not None:
            deq = torch.rsqrt(torch.clamp(
                torch.diagonal(K, dim1=-2, dim2=-1), min=1e-30))
            K = K * deq[:, :, None] * deq[:, None, :]

        if explicit_inverse:
            Kinv_mat = spd_inverse(K)
            if deq is not None:
                Kinv_mat = deq[:, :, None] * Kinv_mat * deq[:, None, :]

            def Kinv(v):
                return mv(Kinv_mat, v)
        else:
            L = _chol_nan(K)

            def Kinv(v):
                if deq is not None:
                    v = deq * v
                w = _tri(L.transpose(-1, -2), _tri(L, v, upper=False),
                         upper=True)
                return deq * w if deq is not None else w

        return _reduced_solver(GG, W, dims, eq, lambda v: mv(S, v), Kinv,
                               fdt, io_dtype, p)

    return factor


class PFactor:
    """A precomputed square-root factor of the (1,1) block: Rt'Rt = P.

    `kkt_cholqr` recomputes this factor on every call when handed a raw
    matrix; solver loops hoist it out of the iteration by passing
    ``psqrt_factor(P)`` instead (see `wrap_P`)."""

    def __init__(self, Rt):
        self.Rt = Rt


def psqrt_factor(P, dtype=None) -> "PFactor":
    """PSD square-root factor Rt with Rt'Rt = P, for P (..., n, n).

    Default (dtype=None): through `eigh_accurate`, with negative
    eigenvalues from roundoff clamped to zero; full working precision.

    ``dtype`` set (the reduced-precision cholqr path): through a
    Cholesky of P + jitter in that dtype.  The factor only ever enters
    the reduced-precision QR stack, so a preconditioner-grade Rt is
    enough; the refinement measures residuals against the true P.  The
    jitter is relative (3e-7 of the largest diagonal entry, 1e-3 for
    the instances whose first Cholesky fails), so inputs that are PSD
    up to roundoff are safe; an indefinite P still gives NaN."""
    if dtype is not None:
        Pf = P.to(dtype)
        eye = torch.eye(P.shape[-1], dtype=dtype, device=P.device)
        dmax = torch.amax(torch.abs(
            torch.diagonal(Pf, dim1=-2, dim2=-1)), dim=-1)

        def try_(eps):
            shift = (eps * dmax + 1e-25)[..., None, None] * eye
            return _chol_nan(Pf + shift).transpose(-1, -2)

        R1, R2 = try_(3e-7), try_(1e-3)
        bad = ~torch.isfinite(R1.sum((-2, -1), keepdim=True))
        return PFactor(torch.where(bad, R2, R1))
    w, U = eigh_accurate(P)
    Rt = torch.sqrt(torch.clamp(w, min=0.0))[..., :, None] \
        * U.transpose(-1, -2)
    return PFactor(Rt)


def kkt_cholqr(G, dims: ConeDims, A, mnl: int = 0,
               explicit_inverse: bool = False, factor_dtype=None):
    """Condition-halving QR strategy for coneqp ('cholqr'): factor the
    condensed SPD matrix S = H + GG'W^{-1}W^{-T}GG without forming it.

    With Rp'Rp = H (computed once, see `PFactor`) and the stacked
    M = [W^{-T}GG; Rp], S = M'M exactly; a QR factorization of M Q2
    (Q2 from the once-per-problem QR of A') gives R with
    R'R = Q2'SQ2 and kappa(R) = sqrt(kappa(S)).  Near convergence the
    NT-scaled Gram matrix has kappa(S) ~ 1/mu^2, beyond 1/eps_f32 at
    1e-7 tolerances and not repairable by diagonal equilibration when
    'q'/'s' blocks make the ill-conditioning anisotropic within a
    block; kappa(R) ~ 1/mu stays within float32 range, so a
    reduced-precision factor plus working-precision iterative
    refinement reaches 1e-7 on SOC/SDP problems where a float32
    Cholesky of S diverges.

    ``explicit_inverse=True`` ('cholqr_inv') forms R^{-1} once per
    factor so that the solves are matmuls; its application error
    ~eps*sqrt(kappa(S)) stays refinement-recoverable in float32."""
    p = A.shape[-2]
    fdt_opt = _as_dtype(factor_dtype)
    io_dtype = G.dtype
    fdt = fdt_opt or io_dtype
    eq = _equalities(A, explicit_inverse, fdt)       # once per problem
    Q2f = eq[1]

    def factor(W, H=None, Df=None):
        GG = _stack_gg(G, Df)
        Bsz = _difull(W).shape[0]
        M = _scaled_G(GG, W, dims, fdt, Bsz)
        if H is not None:
            Rp = H.Rt if isinstance(H, PFactor) \
                else psqrt_factor(H, dtype=fdt_opt).Rt
            M = torch.cat([M, _bexp(Rp.to(fdt), Bsz)], dim=-2)
        M2 = M @ Q2f                                     # (B, cdim+n, n-p)
        # column equilibration: ||M2[:,j]||^2 = (Q2'SQ2)_jj
        deq = torch.rsqrt(torch.clamp((M2 * M2).sum(-2), min=1e-30))
        R = torch.linalg.qr(M2 * deq[:, None, :], mode="r")[1]

        if explicit_inverse:
            Rinv = _eye_inverse_upper(R)

            def Kinv(v):
                return deq * mv(Rinv, mvt(Rinv, deq * v))
        else:
            def Kinv(v):
                w = _tri(R.transpose(-1, -2), deq * v, upper=False)
                return deq * _tri(R, w, upper=True)

        return _reduced_solver(GG, W, dims, eq,
                               lambda v: mvt(M, mv(M, v)), Kinv,
                               fdt, io_dtype, p)

    return factor


def kkt_qr(G, dims: ConeDims, A, mnl: int = 0,
           explicit_inverse: bool = False, factor_dtype=None):
    """Zero-(1,1)-block KKT solve by two QR factorizations ('qr');
    conelp's default on 'q'/'s' cones: the QR of A' eliminates the
    equalities, then a QR of W^{-T}G Q2 (packed rows) solves the reduced
    system without forming normal equations.

    ``explicit_inverse=True`` ('qr_inv') forms R3^{-1} (and R1^{-1})
    once per factor so that the solves are matmuls.  ``factor_dtype``
    runs the QR and the solves in that dtype."""
    p = A.shape[-2]
    fdt_opt = _factor_dtype(factor_dtype)
    io_dtype = G.dtype
    fdt = fdt_opt or io_dtype
    Q1f, Q2f, solve_R1T, solve_R1 = _equalities(A, explicit_inverse, fdt)

    def factor(W, H=None, Df=None):
        if H is not None:
            raise ValueError("kkt_qr requires a zero (1,1) block "
                             "(conelp only)")
        GG = _stack_gg(G, Df)
        Bsz = _difull(W).shape[0]
        Gs = pack_matrix_cols(_scaled_G(GG, W, dims, fdt, Bsz), dims)
        Gs1 = Gs @ Q1f                                   # (B, pdim, p)
        Q3, R3 = torch.linalg.qr(Gs @ Q2f, mode="reduced")

        if explicit_inverse:
            R3inv = _eye_inverse_upper(R3)

            def solve_R3T(v):
                return mvt(R3inv, v)

            def solve_R3(v):
                return mv(R3inv, v)
        else:
            def solve_R3T(v):
                return _tri(R3.transpose(-1, -2), v, upper=False)

            def solve_R3(v):
                return _tri(R3, v, upper=True)

        def solve(bx, by, bz):
            bzp = pack(scale(bz, W, dims, trans="T", inverse="I"),
                       dims).to(fdt)
            bxf = bx.to(fdt)
            if p:
                v1 = solve_R1T(by.to(fdt))
                w = bzp - mv(Gs1, v1)
            else:
                w = bzp
            u = mvt(Q3, w) + solve_R3T(mvt(Q2f, bxf))
            Wz = mv(Q3, u) - w
            ux = mv(Q2f, solve_R3(u))
            if p:
                uy = solve_R1(mvt(Q1f, bxf) - mvt(Gs1, Wz))
                ux = ux + mv(Q1f, v1)
            else:
                uy = by.to(fdt)
            return (ux.to(io_dtype), uy.to(io_dtype),
                    unpack(Wz.to(io_dtype), dims))

        return solve

    return factor


def robust_name(name: str) -> str:
    """The non-explicit-inverse variant of a kktsolver name (the f64
    rescue phases always factor with the triangular-solve variants)."""
    return {"chol2_inv": "chol2", "chol_inv": "chol",
            "qr_inv": "qr", "cholqr_inv": "cholqr"}.get(name, name)


def wrap_P(name, P, factor_dtype=None):
    """Hoist `psqrt_factor` out of the solver iteration for the cholqr
    strategies: the (1,1) block is constant across coneqp iterations,
    so it runs once per problem.  When the factor itself is
    reduced-precision, the square root is too."""
    if isinstance(name, str) and "cholqr" in name and P is not None \
            and torch.is_tensor(P):
        return psqrt_factor(P, dtype=_as_dtype(factor_dtype))
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
    """Map kktsolver names to strategies: 'ldl' is the full-3x3 `kkt_lu`,
    'ldl2' the condensed `kkt_ldl2`; 'qr', 'chol', 'chol2', 'cholqr' and
    their '_inv' forms map to their namesakes."""
    inv = dict(explicit_inverse=True) if name.endswith("_inv") else {}
    base = name[:-4] if inv else name
    if name == "ldl":
        return kkt_lu(G, dims, A, mnl=mnl, kktreg=kktreg)
    if name == "ldl2":
        return kkt_ldl2(G, dims, A, mnl=mnl, kktreg=kktreg,
                        factor_dtype=factor_dtype)
    strategies = {"qr": kkt_qr, "chol": kkt_chol, "cholqr": kkt_cholqr,
                  "chol2": kkt_chol2}
    if base in strategies:
        return strategies[base](G, dims, A, mnl=mnl,
                                factor_dtype=factor_dtype, **inv)
    raise ValueError(f"'{name}' is not a valid value for kktsolver")
