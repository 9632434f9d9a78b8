"""Distributed block-arrow KKT solvers: model parallelism for one large
problem.

Twin of `cvxopt_tpu/parallel/schur.py`.  Target structure: scenario-
coupled QPs

    minimize   sum_k [ 1/2 x_k' P_k x_k + q_k' x_k
                       + x_k' Pc_k x_0 ]  +  1/2 x_0' P0 x_0 + q0' x_0
    subject to G_k x_k + E_k x_0 + s_k = h_k,   s_k >= 0   (k = 1..K)

with K local blocks x_k (dimension nk) coupled through shared variables
x_0 (dimension n0).  The condensed KKT matrix S = P + G' W^{-2} G is
block-arrow:

    [ D_1          U_1 ]      D_k = P_k + G_k' Wk^{-2} G_k
    [      ...     ... ]      U_k = Pc_k + G_k' Wk^{-2} E_k
    [          D_K U_K ]      S00 = P0 + sum_k E_k' Wk^{-2} E_k
    [ U_1' ... U_K' S00]

Each rank of the mesh factors its scenarios' D_k; the Schur complement
S0 = S00 - sum_k U_k' D_k^{-1} U_k and the coupling right-hand side are
all-reduced over the mesh, x_0 is solved replicated, and the scenario
blocks of the solution are all-gathered.  Every rank holds the whole
problem (JAX's replicated inputs) and slices its scenarios.

The local factors D_k = P_k + Gt diag(dinv2) Gt' are exactly the form of
the port's fused kernels (`kkt._kernel_factor`, `ops/fused_chol.py`):
the arrow solver hands them Gt = G_k' with dinv2 = 1/d^2, the block
solver Gt = Gs_k' with dinv2 = 1 (Gs_k = W_k^{-T} G_k).  The kernels
give D_k^{-1} whole, not a triangular half, so where the JAX package
forms F_k = L_k^{-1} U_k and sums F_k'F_k the port forms
X_k = D_k^{-1} U_k and sums U_k' X_k: the same matrices in another
rounding.  Given CPU tensors the wrappers compute their plain PyTorch
versions.  The reduced n0 x n0 factor stays on torch.linalg.cholesky,
as JAX leaves it to XLA.

Exposed as conelp/coneqp-compatible custom kktsolvers: the whole IPM runs
unchanged and replicated on every rank; only the KKT factor and solve
are distributed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch import kkt as _kkt
from cvxopt_tpu_torch import scaling as _nt
from cvxopt_tpu_torch.scaling import _chol_nan
from cvxopt_tpu_torch.parallel import collectives as coll
from cvxopt_tpu_torch.parallel.mesh import Mesh, check_axis

Tensor = torch.Tensor


# ---- shared helpers -----------------------------------------------------

def _cho(L, M):
    """(L L')^{-1} M for M (..., n) or (..., n, k)."""
    vec = M.dim() == L.dim() - 1
    X = torch.cholesky_solve(M.unsqueeze(-1) if vec else M, L)
    return X.squeeze(-1) if vec else X


def _local_factor(Pk, Gt, dinv2):
    """Factor D_k = P_k + Gt_k diag(dinv2_k) Gt_k' for the K' local
    scenarios in the fused kernels; returns v -> D^{-1} v on vectors
    (K', nk) and on matrices of columns (K', nk, r)."""
    nk = Pk.shape[-1]
    rows = _kkt._kernel_factor(Pk, Gt, dinv2, nk, False, False)
    return lambda v: _kkt._colvec(v, rows)


def _scenarios(mesh, axis, K):
    """This rank's scenario rows (all of them without a mesh)."""
    if mesh is None:
        return slice(None)
    check_axis(mesh, axis)
    return mesh.local_rows(K)


def _sum_over(x, mesh):
    return x if mesh is None else coll.psum(x, mesh)


def _gather(x, mesh):
    return x if mesh is None else coll.all_gather(x, mesh, tiled=True)


def _flat_P(qp):
    K, nk, n0 = qp.K, qp.nk, qp.n0
    Pm = qp.P0.new_zeros((K * nk + n0, K * nk + n0))
    for k in range(K):
        r = slice(k * nk, (k + 1) * nk)
        Pm[r, r] = qp.Pk[k]
        Pm[r, K * nk:] = qp.Pc[k]
        Pm[K * nk:, r] = qp.Pc[k].T
    Pm[K * nk:, K * nk:] = qp.P0
    return Pm


def _to(a, dtype, dev):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


@dataclass(frozen=True)
class ArrowQP:
    """Data for a scenario-coupled QP, stacked over the scenario axis K
    (the axis sharded over the mesh)."""
    Pk: Tensor     # (K, nk, nk)
    Pc: Tensor     # (K, nk, n0)  coupling blocks of P
    P0: Tensor     # (n0, n0)
    qk: Tensor     # (K, nk)
    q0: Tensor     # (n0,)
    Gk: Tensor     # (K, mk, nk)
    Ek: Tensor     # (K, mk, n0)
    hk: Tensor     # (K, mk)

    @property
    def K(self):
        return self.Pk.shape[0]

    @property
    def nk(self):
        return self.Pk.shape[1]

    @property
    def n0(self):
        return self.P0.shape[0]

    @property
    def mk(self):
        return self.Gk.shape[1]

    # ---- the dense conelp/coneqp form, on the data's device ----------

    def flat_P(self):
        return _flat_P(self)

    def flat_q(self):
        return torch.cat([self.qk.reshape(-1), self.q0])

    def flat_G(self):
        K, nk, mk = self.K, self.nk, self.mk
        Gm = self.Gk.new_zeros((K * mk, K * nk + self.n0))
        for k in range(K):
            Gm[k * mk:(k + 1) * mk, k * nk:(k + 1) * nk] = self.Gk[k]
            Gm[k * mk:(k + 1) * mk, K * nk:] = self.Ek[k]
        return Gm

    def flat_h(self):
        return self.hk.reshape(-1)


def make_arrow_kktsolver(qp: ArrowQP, mesh: Optional[Mesh] = None,
                         axis: str = "batch"):
    """A coneqp-compatible custom kktsolver for an ArrowQP.

    Returns `kktsolver(W) -> solve(bx, by, bz) -> (ux, uy, W uz)` for the
    nonnegative orthant (dims = {'l': K*mk}).  With `mesh`, each rank
    factors its scenarios and the Schur complement and coupling
    right-hand side are all-reduced over the mesh."""
    K, nk, n0, mk = qp.K, qp.nk, qp.n0, qp.mk
    sl = _scenarios(mesh, axis, K)
    Pk, Pc, Gk, Ek = qp.Pk[sl], qp.Pc[sl], qp.Gk[sl], qp.Ek[sl]
    Gt = Gk.transpose(-1, -2)

    def kktsolver(W):
        d = W["d"].reshape(K, mk)[sl]
        Dk = 1.0 / (d * d)                            # W_k^{-2}
        Dinv = _local_factor(Pk, Gt, Dk.contiguous())
        Uk = Pc + torch.einsum("kmi,km,kmj->kij", Gk, Dk, Ek)
        XU = Dinv(Uk)                                 # D_k^{-1} U_k
        S_loc = Uk.transpose(-1, -2) @ XU
        E_loc = torch.einsum("kmi,km,kmj->kij", Ek, Dk, Ek)
        S0 = qp.P0 + _sum_over(torch.sum(E_loc - S_loc, dim=0), mesh)
        L0 = _chol_nan(S0)

        def solve(bx, by, bz):
            bxk = bx[:K * nk].reshape(K, nk)[sl]
            bx0 = bx[K * nk:]
            bzk = bz.reshape(K, mk)[sl]
            Dz = Dk * bzk
            rk = bxk + torch.einsum("kmi,km->ki", Gk, Dz)
            xh = Dinv(rk)                             # D_k^{-1} r_k
            r0_loc = torch.einsum("kmi,km->i", Ek, Dz) - \
                torch.einsum("kij,ki->j", Uk, xh)
            x0 = _cho(L0, bx0 + _sum_over(r0_loc, mesh))
            xk = xh - XU @ x0
            # W uz = W^{-T}(G ux - bz)
            Gx = torch.einsum("kmi,ki->km", Gk, xk) + Ek @ x0
            Wuz = _gather((Gx - bzk) / d, mesh)
            ux = torch.cat([_gather(xk, mesh).reshape(-1), x0])
            return ux, by, Wuz.reshape(-1)

        return solve

    return kktsolver


def random_arrow_qp(K, nk, n0, mk, seed=0, dtype=torch.float64,
                    device="cuda"):
    """A random well-conditioned ArrowQP instance (numpy's
    default_rng(seed) stream, the JAX function's draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Fk = rng.standard_normal((K, nk, nk)) / np.sqrt(nk)
    Pk = Fk @ Fk.transpose(0, 2, 1) + np.eye(nk)[None]
    Pc = 0.1 * rng.standard_normal((K, nk, n0))
    F0 = rng.standard_normal((n0, n0)) / np.sqrt(n0)
    # make the full P comfortably PD despite coupling
    P0 = F0 @ F0.T + (1.0 + 0.5 * K) * np.eye(n0)
    qk = rng.standard_normal((K, nk))
    q0 = rng.standard_normal(n0)
    Gk = np.broadcast_to(-np.eye(mk, nk), (K, mk, nk)).copy()
    Ek = 0.1 * rng.standard_normal((K, mk, n0))
    hk = rng.uniform(0.5, 1.5, (K, mk))
    c = lambda a: _to(a, dtype, dev)
    return ArrowQP(Pk=c(Pk), Pc=c(Pc), P0=c(P0), qk=c(qk), q0=c(q0),
                   Gk=c(Gk), Ek=c(Ek), hk=c(hk))


# =====================================================================
# Generalized block-partitioned KKT: local equality constraints and
# arbitrary local cone blocks ('l'/'q'/'s'), with optional shared
# equalities on the coupling variables (the arrow solver above is the
# orthant-only special case).  The per-scenario saddle
# [[D_k, A_k'], [A_k, 0]] is eliminated locally; the reduced system on
# the coupling variables is assembled over the mesh.
# =====================================================================


def global_dims(dims_local: ConeDims, K: int) -> ConeDims:
    """ConeDims for K stacked scenarios, RUN-MAJOR: all 'l' rows first,
    then for each local q-run its K*cnt blocks contiguously, then the
    s-runs likewise, so that per-scenario slices are reshapes."""
    q = []
    for (_, cnt, m) in dims_local.q_runs:
        q.extend([m] * (K * cnt))
    s = []
    for (_, _, cnt, m) in dims_local.s_runs:
        s.extend([m] * (K * cnt))
    return ConeDims(l=K * dims_local.l, q=tuple(q), s=tuple(s))


def _run_widths(dims_local: ConeDims):
    """Per-scenario widths of the local runs, in cone order."""
    return ([dims_local.l] + [cnt * m for (_, cnt, m) in dims_local.q_runs]
            + [cnt * m * m for (_, _, cnt, m) in dims_local.s_runs])


def split_cone_vec(v, dims_local: ConeDims, K: int):
    """(..., cdim_global) run-major global cone vector -> (..., K,
    cdim_local) scenario-major local layout."""
    lead = v.shape[:-1]
    parts, off = [], 0
    for w in _run_widths(dims_local):
        parts.append(v[..., off:off + K * w].reshape(lead + (K, w)))
        off += K * w
    return torch.cat(parts, dim=-1)


def merge_cone_vec(vk, dims_local: ConeDims, K: int):
    """(..., K, cdim_local) -> run-major (..., cdim_global), the inverse
    of split_cone_vec."""
    lead = vk.shape[:-2]
    parts, off = [], 0
    for w in _run_widths(dims_local):
        parts.append(vk[..., :, off:off + w].reshape(lead + (K * w,)))
        off += w
    return torch.cat(parts, dim=-1)


def split_w(W, dims_local: ConeDims, K: int):
    """Global run-major scaling dict -> per-scenario dict with a leading
    K axis on every leaf."""
    Wk = {"d": W["d"].reshape(K, dims_local.l),
          "di": W["di"].reshape(K, dims_local.l),
          "beta": [], "v": [], "r": [], "rti": []}
    for i, (_, cnt, m) in enumerate(dims_local.q_runs):
        Wk["beta"].append(W["beta"][i].reshape(K, cnt))
        Wk["v"].append(W["v"][i].reshape(K, cnt, m))
    for i, (_, _, cnt, m) in enumerate(dims_local.s_runs):
        Wk["r"].append(W["r"][i].reshape(K, cnt, m, m))
        Wk["rti"].append(W["rti"][i].reshape(K, cnt, m, m))
    return Wk


def _rows_of_w(Wk, sl):
    return {k: ([u[sl] for u in v] if isinstance(v, list) else v[sl])
            for k, v in Wk.items()}


@dataclass(frozen=True)
class BlockQP:
    """Scenario-coupled QP with local cone AND equality constraints:

        minimize    sum_k [ 1/2 x_k'P_k x_k + q_k'x_k + x_k'Pc_k x_0 ]
                    + 1/2 x_0'P0 x_0 + q0'x_0
        subject to  G_k x_k + E_k x_0 + s_k = h_k,  s_k in local cone
                    A_k x_k + C_k x_0 = b_k                  (k = 1..K)
                    A0 x_0 = b0

    Local cone rows are in LOCAL l/q/s order (dims_local); the flattened
    problem uses the run-major global ordering of `global_dims`."""
    Pk: Tensor     # (K, nk, nk)
    Pc: Tensor     # (K, nk, n0)
    P0: Tensor     # (n0, n0)
    qk: Tensor     # (K, nk)
    q0: Tensor     # (n0,)
    Gk: Tensor     # (K, mk, nk)   local cone rows
    Ek: Tensor     # (K, mk, n0)
    hk: Tensor     # (K, mk)
    Ak: Tensor     # (K, pk, nk)   local equalities (pk may be 0)
    Ck: Tensor     # (K, pk, n0)
    bk: Tensor     # (K, pk)
    A0: Tensor     # (p0, n0)      shared equalities (p0 may be 0)
    b0: Tensor     # (p0,)
    dims_local: ConeDims = ConeDims(l=0)

    @property
    def K(self):
        return self.Pk.shape[0]

    @property
    def nk(self):
        return self.Pk.shape[1]

    @property
    def n0(self):
        return self.P0.shape[0]

    @property
    def mk(self):
        return self.Gk.shape[1]

    @property
    def pk(self):
        return self.Ak.shape[1]

    @property
    def p0(self):
        return self.A0.shape[0]

    # ---- dense flattening (the cross-check oracle) -------------------

    def flat_P(self):
        return _flat_P(self)

    def flat_q(self):
        return torch.cat([self.qk.reshape(-1), self.q0])

    def flat_G(self):
        K, nk, mk = self.K, self.nk, self.mk
        Gm = self.Gk.new_zeros((K, mk, K * nk + self.n0))
        for k in range(K):
            Gm[k, :, k * nk:(k + 1) * nk] = self.Gk[k]
            Gm[k, :, K * nk:] = self.Ek[k]
        # (n, K, mk) -> (n, cdim_global): the rows in run-major order
        return merge_cone_vec(Gm.permute(2, 0, 1), self.dims_local,
                              K).T.contiguous()

    def flat_h(self):
        return merge_cone_vec(self.hk, self.dims_local, self.K)

    def flat_A(self):
        K, nk, pk = self.K, self.nk, self.pk
        Am = self.Ak.new_zeros((K * pk + self.p0, K * nk + self.n0))
        for k in range(K):
            Am[k * pk:(k + 1) * pk, k * nk:(k + 1) * nk] = self.Ak[k]
            Am[k * pk:(k + 1) * pk, K * nk:] = self.Ck[k]
        Am[K * pk:, K * nk:] = self.A0
        return Am

    def flat_b(self):
        return torch.cat([self.bk.reshape(-1), self.b0])

    @property
    def dims(self) -> ConeDims:
        return global_dims(self.dims_local, self.K)


def make_block_kktsolver(qp: BlockQP, mesh: Optional[Mesh] = None,
                         axis: str = "batch"):
    """conelp/coneqp-compatible custom kktsolver for a BlockQP.

    Per scenario k the condensed blocks are

        D_k = P_k + Gs_k'Gs_k          Gs_k = W_k^{-T} G_k
        U_k = Pc_k + Gs_k'Es_k         Es_k = W_k^{-T} E_k

    and the local saddle [[D_k, A_k'], [A_k, 0]] is eliminated with the
    kernels' factor of D_k plus a Cholesky of M_k = A_k D_k^{-1} A_k'.
    The reduced (n0 + p0) system on the coupling variables is assembled
    over the mesh (an all-reduce) and solved replicated.  With `mesh`,
    the scenario axis K must divide by the mesh size."""
    K, nk, n0 = qp.K, qp.nk, qp.n0
    pk, p0 = qp.pk, qp.p0
    dl = qp.dims_local
    sl = _scenarios(mesh, axis, K)
    Pk, Pc, Gk, Ek = qp.Pk[sl], qp.Pc[sl], qp.Gk[sl], qp.Ek[sl]
    Ak, Ck = qp.Ak[sl], qp.Ck[sl]
    T = lambda M: M.transpose(-1, -2)

    def scale_rows(M, Wk):
        return _nt.scale_rows(M, Wk, dl, trans="T", inverse="I")

    def local_factor(Wk):
        Gs, Es = scale_rows(Gk, Wk), scale_rows(Ek, Wk)
        ones = Gs.new_ones(Gs.shape[:-1])
        Dinv = _local_factor(Pk, T(Gs), ones)
        U = Pc + T(Gs) @ Es
        XU = Dinv(U)
        F = dict(Gs=Gs, Es=Es, Dinv=Dinv, U=U)
        if pk:
            DiAT = Dinv(T(Ak))                         # (K', nk, pk)
            Lm = _chol_nan(Ak @ DiAT)
            # the saddle's x-part is affine in x0: [XU; YU]
            YU = _cho(Lm, Ak @ XU - Ck)
            XU = XU - DiAT @ YU
            S_loc = T(U) @ XU + T(Ck) @ YU             # V' K^{-1} V
            F.update(DiAT=DiAT, Lm=Lm)
        else:
            YU = U.new_zeros(U.shape[:1] + (0, n0))
            S_loc = T(U) @ XU
        F.update(XU=XU, YU=YU, S_loc=S_loc, E_loc=T(Es) @ Es)
        return F

    def local_saddle_apply(F, u, v):
        """The factored local saddle's inverse on (K', nk), (K', pk)."""
        t = F["Dinv"](u)
        if not pk:
            return t, u.new_zeros(u.shape[:1] + (0,))
        y = _cho(F["Lm"], (Ak @ t.unsqueeze(-1)).squeeze(-1) - v)
        return t - (F["DiAT"] @ y.unsqueeze(-1)).squeeze(-1), y

    def reduced_factor(S_sum, E_sum):
        L0 = _chol_nan(qp.P0 + E_sum - S_sum)         # (n0, n0)
        if not p0:
            return L0, None, None
        # saddle [[S0, A0'], [A0, 0]]: S0 chol + Schur on A0
        SiA0T = _cho(L0, qp.A0.T)
        return L0, SiA0T, _chol_nan(qp.A0 @ SiA0T)

    def reduced_solve(fac, r0, v0):
        L0, SiA0T, Lm0 = fac
        t = _cho(L0, r0)
        if not p0:
            return t, r0.new_zeros((0,))
        y0 = _cho(Lm0, qp.A0 @ t - v0)
        return t - SiA0T @ y0, y0

    def kktsolver(W):
        Wk = _rows_of_w(split_w(W, dl, K), sl)
        F = local_factor(Wk)
        fac0 = reduced_factor(_sum_over(F["S_loc"].sum(0), mesh),
                              _sum_over(F["E_loc"].sum(0), mesh))

        def solve(bx, by, bz):
            bxk = bx[:K * nk].reshape(K, nk)[sl]
            bx0 = bx[K * nk:]
            byk = by[:K * pk].reshape(K, pk)[sl]
            by0 = by[K * pk:]
            bzk = split_cone_vec(bz, dl, K)[sl]
            zs = _nt.scale(bzk, Wk, dl, trans="T", inverse="I")
            rk = bxk + (T(F["Gs"]) @ zs.unsqueeze(-1)).squeeze(-1)
            xh, yh = local_saddle_apply(F, rk, byk)
            r0_loc = torch.einsum("kmj,km->j", F["Es"], zs) - \
                torch.einsum("kij,ki->j", F["U"], xh)
            if pk:
                r0_loc = r0_loc - torch.einsum("kpj,kp->j", Ck, yh)
            x0, y0 = reduced_solve(fac0, bx0 + _sum_over(r0_loc, mesh),
                                   by0)
            xk = xh - F["XU"] @ x0
            yk = yh - F["YU"] @ x0
            Gx = (Gk @ xk.unsqueeze(-1)).squeeze(-1) + Ek @ x0
            Wuz_k = _nt.scale(Gx - bzk, Wk, dl, trans="T", inverse="I")
            ux = torch.cat([_gather(xk, mesh).reshape(-1), x0])
            uy = torch.cat([_gather(yk, mesh).reshape(-1), y0])
            Wuz = merge_cone_vec(_gather(Wuz_k, mesh), dl, K)
            return ux, uy, Wuz

        return solve

    return kktsolver


def random_block_qp(K, nk, n0, l=None, q=(), pk=2, p0=0, seed=0,
                    dtype=torch.float64, device="cuda"):
    """A random feasible BlockQP with local l+q cones and local
    equalities (well-conditioned; numpy's default_rng(seed) stream, the
    JAX function's draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    l = nk if l is None else l
    dl = ConeDims(l=l, q=tuple(q))
    mk = dl.cdim
    Fk = rng.standard_normal((K, nk, nk)) / np.sqrt(nk)
    Pk = Fk @ Fk.transpose(0, 2, 1) + np.eye(nk)[None]
    Pc = 0.1 * rng.standard_normal((K, nk, n0))
    F0 = rng.standard_normal((n0, n0)) / np.sqrt(n0)
    P0 = F0 @ F0.T + (1.0 + 0.5 * K) * np.eye(n0)
    qk = 0.1 * rng.standard_normal((K, nk))
    q0 = 0.1 * rng.standard_normal(n0)
    # cone rows: l rows random, q rows random with feasible h
    Gk = 0.3 * rng.standard_normal((K, mk, nk))
    Ek = 0.1 * rng.standard_normal((K, mk, n0))
    # h = G*0 + E*0 + s0 with s0 strictly interior
    s0 = np.zeros((K, mk))
    s0[:, :l] = rng.uniform(0.5, 1.5, (K, l))
    off = l
    for m in dl.q:
        s0[:, off] = 2.0
        s0[:, off + 1:off + m] = 0.2 * rng.standard_normal((K, m - 1))
        off += m
    Ak = rng.standard_normal((K, pk, nk)) if pk else np.zeros((K, 0, nk))
    Ck = 0.1 * rng.standard_normal((K, pk, n0)) if pk else \
        np.zeros((K, 0, n0))
    bk = np.zeros((K, pk))                    # x = 0 is feasible
    A0 = rng.standard_normal((p0, n0)) if p0 else np.zeros((0, n0))
    b0 = np.zeros(p0)
    c = lambda a: _to(a, dtype, dev)
    return BlockQP(Pk=c(Pk), Pc=c(Pc), P0=c(P0), qk=c(qk), q0=c(q0),
                   Gk=c(Gk), Ek=c(Ek), hk=c(s0), Ak=c(Ak), Ck=c(Ck),
                   bk=c(bk), A0=c(A0), b0=c(b0), dims_local=dl)
