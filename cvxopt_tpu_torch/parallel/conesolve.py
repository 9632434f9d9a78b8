"""Distributed cone-sharded coneqp: ONE cone QP whose cone blocks are
sharded across the ranks of a mesh, solved by a Mehrotra
predictor-corrector loop that calls the cone-aware collectives
(`parallel.collectives`) at every global reduction.

Twin of `cvxopt_tpu/parallel/conesolve.py`.  Layout: x, P, q (and the
optional equalities A, b) are replicated; G's rows, h, s, z are sharded
so that each rank holds whole cone blocks (`local_dims` describes one
shard; all shards are congruent).  The NT scaling, the Jordan algebra
and the per-block eigen work are local; the loop needs
  * psdot   - duality gap, ds'dz, dual objective correction,
  * psnrm2  - primal residual norm,
  * pmax    - global step length from per-shard max_step,
  * psum    - KKT normal equations S = P + sum_k Gs_k' Gs_k and the
              right-hand side sum_k G_k' zs_k,
one or two scalars and one (n, n) all-reduce an iteration.

The JAX `lax.while_loop` is a Python loop.  Every rank runs it: a branch
is taken on values that are all-reduced or replicated, and the status
that ends the loop is itself reduced (`pmin`), so that all ranks leave
it in the same pass.  S is summed across ranks before its factor, so the
fused kernels (which assemble S from one Gt) cannot form it: it is
factored by torch.linalg.cholesky, as JAX uses jnp.linalg.cholesky.
"""

from __future__ import annotations

import torch

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch._device import tensors
from cvxopt_tpu_torch import scaling as nt
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.ops.matvec import mv, mvt
from cvxopt_tpu_torch.scaling import _chol_nan
from cvxopt_tpu_torch.parallel import collectives as coll
from cvxopt_tpu_torch.parallel.mesh import check_axis
from cvxopt_tpu_torch.parallel.schur import _cho
from cvxopt_tpu_torch.ipm import (
    STATUS_RUNNING, STATUS_OPTIMAL, STATUS_UNKNOWN_MAXITERS, STEP, EXPON,
)


def make_coneqp_sharded(local_dims: ConeDims, mesh, axis: str = "cone",
                        maxiters: int = 50, abstol: float = 1e-7,
                        reltol: float = 1e-6, feastol: float = 1e-7,
                        refinement: int = 1):
    """Build the sharded solver: f(P, q, G, h[, A, b]) -> result dict.

    G (m, n) and h (m,) are the global arrays, m = mesh size *
    local_dims.cdim rows laid out shard by shard; rank r takes rows
    [r * cdim, (r + 1) * cdim).  P (n, n), q (n,) and the optional
    equality pair A (p, n), b (p,) are replicated.  Every rank of the
    mesh calls f with the same arguments and gets the same result: x, y
    and the scalars replicated, s and z all-gathered (m,)."""
    check_axis(mesh, axis)
    ldims = local_dims
    cdim_diag_g = ldims.cdim_diag * mesh.size
    psum = lambda v: coll.psum(v, mesh)
    psdot = lambda u, v: coll.psdot(u, v, ldims, mesh)

    def run(P, q, G_loc, h_loc, A, b):
        p = A.shape[0]
        dtype, dev = q.dtype, q.device
        e = cones.cone_identity(ldims, dtype=dtype, device=dev)

        resx0 = torch.clamp(torch.linalg.vector_norm(q), min=1.0)
        resy0 = torch.clamp(torch.linalg.vector_norm(b), min=1.0)
        resz0 = torch.clamp(coll.psnrm2(h_loc, ldims, mesh), min=1.0)

        def kkt_factor(W):
            Gsl = nt.scale_rows(G_loc, W, ldims, trans="T", inverse="I")
            L = _chol_nan(P + psum(Gsl.T @ Gsl))
            if p:
                # replicated saddle elimination for A x = b: S^{-1}A'
                # and the (p, p) Schur complement A S^{-1} A'
                SinvAt = _cho(L, A.T)
                Lp = _chol_nan(A @ SinvAt)

            def solve(bx, by, bz_loc):
                zs = nt.scale_w2inv(bz_loc, W, ldims)
                ux = _cho(L, bx + psum(mvt(G_loc, zs)))
                if p:
                    uy = _cho(Lp, mv(A, ux) - by)
                    ux = ux - SinvAt @ uy
                else:
                    uy = by
                Wuz = nt.scale(mv(G_loc, ux) - bz_loc, W, ldims,
                               trans="T", inverse="I")
                return ux, uy, Wuz

            return solve

        def start(v):
            """v + (1 + t) e where t = max_step(v) says v is not
            strictly interior (coneprog.py:2044-2149)."""
            nrm = coll.psnrm2(v, ldims, mesh)
            t = coll.pmax_step(v, ldims, mesh)
            return torch.where(t >= -1e-8 * torch.clamp(nrm, min=1.0),
                               v + (1.0 + t) * e, v)

        # ---- cold start ---------------------------------------------
        f0 = kkt_factor(nt.identity_scaling(ldims, dtype=dtype,
                                            device=dev))
        x, y, zc = f0(-q, b, h_loc)
        s, z = start(-zc), start(zc)
        W, lmbda = nt.compute_scaling(s, z, ldims)
        gap = psdot(s, z)

        def iteration(x, y, W, lmbda, gap, rx, ry, rz):
            lmbdasq = cones.ssqr(lmbda, ldims)
            f3 = kkt_factor(W)

            def f4_no_ir(bx, by, bz, bs):
                us = cones.sinv(bs, lmbda, ldims)
                uz = bz - nt.scale(us, W, ldims, trans="T")
                ux, uy, uz2 = f3(bx, by, uz)
                return ux, uy, uz2, us - uz2

            def resid4(ux, uy, uz, us, vx, vy, vz, vs):
                wz3 = nt.scale(uz, W, ldims, inverse="I")
                vx = vx - mv(P, ux) - mvt(A, uy) - psum(mvt(G_loc, wz3))
                vy = vy - mv(A, ux)
                vz = vz - mv(G_loc, ux) - nt.scale(us, W, ldims,
                                                   trans="T")
                vs = vs - cones.sprod_diag(us + uz, lmbda, ldims)
                return vx, vy, vz, vs

            def f4(bx, by, bz, bs):
                u = f4_no_ir(bx, by, bz, bs)
                for _ in range(refinement):
                    du = f4_no_ir(*resid4(*u, bx, by, bz, bs))
                    u = tuple(a + d for a, d in zip(u, du))
                return u

            def step_to(t, frac):
                return torch.where(t == 0.0, torch.ones_like(t),
                                   torch.clamp(frac / t, max=1.0))

            mu = gap / cdim_diag_g
            lmbdasq_full = cones.diag_embed(lmbdasq, ldims)

            # predictor
            dx, dy, dz, ds = f4(-rx, -ry, -rz, -lmbdasq_full)
            dsdz = psdot(ds, dz)
            ws3 = cones.sprod(ds, dz, ldims)
            t = torch.clamp(torch.maximum(
                coll.pmax_step(nt.scale2(lmbda, ds, ldims), ldims, mesh),
                coll.pmax_step(nt.scale2(lmbda, dz, ldims), ldims, mesh)),
                min=0.0)
            step = step_to(t, 1.0)
            sigma = torch.clamp(1.0 - step + dsdz / gap * step ** 2,
                                min=0.0, max=1.0) ** EXPON

            # corrector
            ds_in = -lmbdasq_full + sigma * mu * e - ws3
            dx, dy, dz, ds = f4(-rx, -ry, -rz, ds_in)
            ts, sigs, ds_q = cones.max_step_eig(
                nt.scale2(lmbda, ds, ldims), ldims)
            tz, sigz, dz_q = cones.max_step_eig(
                nt.scale2(lmbda, dz, ldims), ldims)
            t = torch.clamp(torch.maximum(coll.pmax(ts, mesh),
                                          coll.pmax(tz, mesh)), min=0.0)
            step = step_to(t, STEP)

            x = x + step * dx
            y = y + step * dy
            ds2, dz2 = nt.update_args(lmbda, (ds_q, dz_q), (sigs, sigz),
                                      step, e, ldims)
            W2, lmbda2 = nt.update_scaling(W, lmbda, ds2, dz2, ldims)
            s2, z2 = nt.unscale(lmbda2, W2, ldims)
            gap2 = psum(torch.sum(lmbda2 * lmbda2))
            return x, y, s2, z2, W2, lmbda2, gap2

        it = 0
        while True:
            # residuals (coneprog.py:2167-2234)
            Px = mv(P, x)
            rx = Px + q + mvt(A, y) + psum(mvt(G_loc, z))
            ry = mv(A, x) - b
            rz = s + mv(G_loc, x) - h_loc
            pcost = 0.5 * torch.dot(x, Px) + torch.dot(q, x)
            dcost = pcost + torch.dot(y, ry) + psdot(z, rz) - gap
            inf = torch.full_like(gap, float("inf"))
            relgap = torch.where(
                pcost < 0.0, gap / -pcost,
                torch.where(dcost > 0.0, gap / dcost, inf))
            pres = torch.maximum(coll.psnrm2(rz, ldims, mesh) / resz0,
                                 torch.linalg.vector_norm(ry) / resy0)
            dres = torch.linalg.vector_norm(rx) / resx0
            done = (pres <= feastol) & (dres <= feastol) & \
                ((gap <= abstol) | (relgap <= reltol))
            status = STATUS_OPTIMAL if bool(done) else (
                STATUS_UNKNOWN_MAXITERS if it >= maxiters
                else STATUS_RUNNING)
            # all ranks leave the loop in the same pass
            status = int(coll.pmin(torch.tensor(status, device=dev), mesh))
            if status != STATUS_RUNNING:
                break
            x, y, s, z, W, lmbda, gap = iteration(x, y, W, lmbda, gap,
                                                  rx, ry, rz)
            it += 1
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        return dict(x=x, y=y, s=s, z=z, gap=gap, iterations=i32(it),
                    status=i32(status), pcost=pcost, dcost=dcost,
                    relgap=relgap, pres=pres, dres=dres)

    def solve(P, q, G, h, A=None, b=None):
        P, q, G, h, A, b = tensors(P, q, G, h, A, b, device=mesh.device)
        if A is None:
            A = q.new_zeros((0, q.shape[0]))
            b = q.new_zeros((0,))
        m = G.shape[0]
        if m != mesh.size * ldims.cdim:
            raise ValueError(f"G has {m} rows; the mesh's {mesh.size} "
                             f"shards take {mesh.size * ldims.cdim}")
        rows = mesh.local_rows(m)
        out = run(P, q, G[rows], h[rows], A, b)
        out["s"] = coll.all_gather(out["s"], mesh, tiled=True)
        out["z"] = coll.all_gather(out["z"], mesh, tiled=True)
        return out

    return solve
