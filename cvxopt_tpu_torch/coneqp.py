"""coneqp — batched cone quadratic program solver in PyTorch.

Twin of `cvxopt_tpu/coneqp.py`: an infeasible-start Mehrotra
predictor-corrector primal-dual IPM with Nesterov-Todd scaling for

    minimize    (1/2) x'Px + q'x
    subject to  G x + s = h,  A x = b,  s >= 0 (wrt the cone)

The JAX package writes the solve for one instance and vmaps it; here
the batch is a leading axis of every tensor and the `lax.while_loop`
is a Python loop over the per-instance status.  As under vmap, every
pass computes the body for the whole batch, and instances that were
not running keep their old values through ``torch.where`` (never a
multiplication by the mask: a NaN factor in a finished instance must
not leak into it).  Each pass costs one host sync (``running.any()``).

Status codes: 0 optimal, 3 unknown (maxiters), 4 unknown (singular).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch import scaling as nt
from cvxopt_tpu_torch import kkt as kktmod
from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.ops.matvec import mv, vdot
from cvxopt_tpu_torch.conelp import (
    STATUS_RUNNING, STATUS_OPTIMAL, STATUS_UNKNOWN_MAXITERS,
    STATUS_UNKNOWN_SINGULAR, STATUS_NEEDS_F64, STATUS_STRINGS,
    STEP, EXPON, RESCUE_STALL_ITERS, RESCUE_RELRES, _prep_inputs,
    _run_loop, _restart_state, _tensors, _unbatch, rescue_compacted,
    _lp_maps, _start_values,
)
from cvxopt_tpu_torch._tree import (
    _col, _where, _tnorm_parts, _is_operator, _per_instance_factor,
    _operator_maps,
)


def _coneqp_solve(dims: ConeDims, *, factor_W, Pf, Gf, GTf, Af, ATf,
                  q, h, b, n, p, dtype, maxiters, abstol, reltol,
                  feastol, refinement, correction, show_progress,
                  initvals=None, factor_W64=None, refine_pred=True,
                  relres_trigger=True, detect_rescue=False,
                  debug=False):
    """The coneqp algorithm on a batch (q: (B, n); h, b: shared or
    batched) with all linear maps as closures on batched vectors."""
    Bsz = q.shape[0]
    dev = q.device
    h = h.expand(Bsz, h.shape[-1])
    b = b.expand(Bsz, b.shape[-1])
    e = cones.cone_identity(dims, dtype=dtype, device=dev)
    e_lq = e[:dims.lnl + dims.qdim]

    resx0 = torch.clamp(torch.linalg.vector_norm(q, dim=-1), min=1.0)
    resy0 = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=1.0)
    resz0 = torch.clamp(cones.snrm2(h, dims), min=1.0)

    # ---- initial point (coneprog.py:2044-2149) -----------------------
    cold = None
    if initvals is None or factor_W64 is not None or detect_rescue:
        f0 = factor_W(nt.identity_scaling(dims, dtype=dtype, device=dev,
                                          batch=(Bsz,)))
        xc, yc, zc = f0(-q, b, h)
        sc = -zc
        nrms = cones.snrm2(sc, dims)
        ts = cones.max_step(sc, dims)
        sc = torch.where(_col(ts >= -1e-8 * torch.clamp(nrms, min=1.0)),
                         sc + _col(1.0 + ts) * e, sc)
        nrmz = cones.snrm2(zc, dims)
        tz = cones.max_step(zc, dims)
        zc = torch.where(_col(tz >= -1e-8 * torch.clamp(nrmz, min=1.0)),
                         zc + _col(1.0 + tz) * e, zc)
        cold = (xc, yc, sc, zc)
    if initvals is None:
        x, y, s, z = cold
    else:
        def iv(k, default):
            v = initvals.get(k)
            v = default if v is None else v
            return v.to(dtype).expand(Bsz, default.shape[-1])
        x = iv("x", q.new_zeros((Bsz, n)))
        y = iv("y", q.new_zeros((Bsz, p)))
        s = iv("s", e.expand(Bsz, e.shape[0]))
        z = iv("z", e.expand(Bsz, e.shape[0]))
        if cold is not None:
            # per-instance warm-start validation: non-finite or
            # non-interior warm starts restart from the cold point
            tsz_w = cones.max_step(torch.stack([s, z]), dims)
            valid = (torch.isfinite(x.sum(-1)) & torch.isfinite(y.sum(-1))
                     & (tsz_w[0] < 0) & (tsz_w[1] < 0))
            if "_valid" in initvals:
                valid = valid & initvals["_valid"]
            x, y, s, z = (_where(valid, u, c)
                          for u, c in zip((x, y, s, z), cold))

    def _mkstate(x_, y_, s_, z_):
        W_, lmbda_ = nt.compute_scaling(s_, z_, dims)
        kw = dict(dtype=dtype, device=dev)
        ikw = dict(dtype=torch.int32, device=dev)
        nan = torch.full((Bsz,), float("nan"), **kw)
        return dict(
            x=x_, y=y_, s=s_, z=z_, W=W_, lmbda=lmbda_,
            gap=cones.sdot(s_, z_, dims),
            iters=torch.zeros((Bsz,), **ikw),
            status=torch.full((Bsz,), STATUS_RUNNING, **ikw),
            pcost=nan, dcost=nan, relgap=nan, pres=nan, dres=nan,
            best_m=torch.full((Bsz,), float("inf"), **kw),
            stall=torch.zeros((Bsz,), **ikw),
            max_it=torch.full((Bsz,), maxiters, **ikw),
        )

    state = _mkstate(x, y, s, z)
    state0 = state if cold is None or initvals is None \
        else _mkstate(*cold)

    def _iteration(fW, x, y, s, z, W, lmbda, gap, rx, ry, rz):
        lmbdasq = cones.ssqr(lmbda, dims)
        f3 = fW(W)

        def f4_no_ir(bx, by_, bz, bs):
            us = cones.sinv(bs, lmbda, dims)
            uz = bz - nt.scale(us, W, dims, trans="T")
            ux, uy, uz = f3(bx, by_, uz)
            us = us - uz
            return ux, uy, uz, us

        def resid4(ux, uy, uz, us, vx, vy, vz, vs):
            wz3 = nt.scale(uz, W, dims, inverse="I")
            vx = vx - Pf(ux) - ATf(uy) - GTf(wz3)
            vy = vy - Af(ux)
            vz = vz - Gf(ux) - nt.scale(us, W, dims, trans="T")
            vs = vs - cones.sprod_diag(us + uz, lmbda, dims)
            return vx, vy, vz, vs

        def f4(bx, by_, bz, bs, nref=refinement):
            u = f4_no_ir(bx, by_, bz, bs)
            relres = torch.zeros_like(gap)
            for _ in range(nref):
                v = resid4(*u, bx, by_, bz, bs)
                # contraction of one solve round: the mixed-precision
                # failure detector (conelp.RESCUE_RELRES)
                relres = _tnorm_parts(v) / torch.clamp(
                    _tnorm_parts((bx, by_, bz, bs)), min=1e-30)
                du = f4_no_ir(*v)
                u = tuple(a + d for a, d in zip(u, du))
            return u, relres

        mu = gap / dims.cdim_diag
        lmbdasq_full = cones.diag_embed(lmbdasq, dims)

        # ---- predictor ----------------------------------------------
        ds_in = -lmbdasq_full
        (dx, dy, dz, ds), rr1 = f4(-rx, -ry, -rz, ds_in,
                                   nref=refinement if refine_pred else 0)
        dsdz = cones.sdot(ds, dz, dims)
        ws3 = cones.sprod(ds, dz, dims)
        ds_sc = nt.scale2(lmbda, ds, dims)
        dz_sc = nt.scale2(lmbda, dz, dims)
        tsz = cones.max_step(torch.stack([ds_sc, dz_sc]), dims)
        t = torch.clamp(torch.maximum(tsz[0], tsz[1]), min=0.0)
        step = torch.where(t == 0.0, 1.0, torch.clamp(1.0 / t, max=1.0))
        sigma = torch.clamp(1.0 - step + dsdz / gap * step ** 2,
                            min=0.0, max=1.0) ** EXPON

        # ---- corrector ----------------------------------------------
        ds_in = -lmbdasq_full + _col(sigma * mu) * e
        if correction:
            ds_in = ds_in - ws3
        (dx, dy, dz, ds), rr2 = f4(-rx, -ry, -rz, ds_in)
        ds_sc = nt.scale2(lmbda, ds, dims)
        dz_sc = nt.scale2(lmbda, dz, dims)
        tsz, sig2, dq2 = cones.max_step_eig(
            torch.stack([ds_sc, dz_sc]), dims)
        sigs, sigz = sig2[0], sig2[1]
        ds_q, dz_q = dq2[0], dq2[1]
        t = torch.clamp(torch.maximum(tsz[0], tsz[1]), min=0.0)
        step = torch.where(t == 0.0, 1.0, torch.clamp(STEP / t, max=1.0))

        # ---- update -------------------------------------------------
        x = x + _col(step) * dx
        y = y + _col(step) * dy

        nlq = dims.lnl + dims.qdim
        ds2 = torch.cat([e_lq + _col(step) * ds_q[:, :nlq],
                         ds_q[:, nlq:]], dim=-1)
        dz2 = torch.cat([e_lq + _col(step) * dz_q[:, :nlq],
                         dz_q[:, nlq:]], dim=-1)
        ds2 = nt.scale2(lmbda, ds2, dims, inverse="I")
        dz2 = nt.scale2(lmbda, dz2, dims, inverse="I")

        if dims.s:
            lam_s = lmbda[:, nlq:]
            sig_s = (1.0 + _col(step) * sigs) / lam_s
            sig_z = (1.0 + _col(step) * sigz) / lam_s
            ps, pz = [ds2[:, :dims.offs]], [dz2[:, :dims.offs]]
            for run in dims.s_runs:
                _, doff, cnt, m = run
                i0 = doff - nlq
                cs = torch.sqrt(sig_s[:, i0:i0 + cnt * m]).reshape(
                    Bsz, cnt, m)
                cz = torch.sqrt(sig_z[:, i0:i0 + cnt * m]).reshape(
                    Bsz, cnt, m)
                ps.append((cones.sview(ds2, run)
                           * cs[..., None, :]).reshape(Bsz, -1))
                pz.append((cones.sview(dz2, run)
                           * cz[..., None, :]).reshape(Bsz, -1))
            ds2 = torch.cat(ps, dim=-1)
            dz2 = torch.cat(pz, dim=-1)

        W2, lmbda2 = nt.update_scaling(W, lmbda, ds2, dz2, dims)

        lam_full = cones.diag_embed(lmbda2, dims)
        s2 = nt.scale(lam_full, W2, dims, trans="T")
        z2 = nt.scale(lam_full, W2, dims, inverse="I")
        gap2 = vdot(lmbda2, lmbda2)
        return x, y, s2, z2, W2, lmbda2, gap2, torch.maximum(rr1, rr2)

    def _body(st, fW, rescue):
        x, y, s, z = st["x"], st["y"], st["s"], st["z"]
        W, lmbda, gap = st["W"], st["lmbda"], st["gap"]
        iters = st["iters"]

        # ---- residuals (coneprog.py:2169-2204) -----------------------
        Px = Pf(x)
        rx = Px + q + ATf(y) + GTf(z)
        f0_ = 0.5 * vdot(x, Px) + vdot(x, q)
        resx = torch.linalg.vector_norm(rx, dim=-1)
        ry = Af(x) - b
        resy = torch.linalg.vector_norm(ry, dim=-1)
        rz = s + Gf(x) - h
        resz = cones.snrm2(rz, dims)

        pcost = f0_
        dcost = f0_ + vdot(y, ry) + cones.sdot(z, rz, dims) - gap
        relgap = torch.where(
            pcost < 0.0, gap / -pcost,
            torch.where(dcost > 0.0, gap / dcost,
                        torch.full_like(gap, float("inf"))))
        pres = torch.maximum(resy / resy0, resz / resz0)
        dres = resx / resx0

        if show_progress:
            for k in range(Bsz):
                print(f"{int(iters[k]):2d}: {float(pcost[k]): 8.4e} "
                      f"{float(dcost[k]): 8.4e} {float(gap[k]): 4.0e} "
                      f"{float(pres[k]):7.0e} {float(dres[k]):7.0e}")

        optimal = ((pres <= feastol) & (dres <= feastol)
                   & ((gap <= abstol) | (relgap <= reltol)))
        maxed = iters >= st["max_it"]

        m = torch.maximum(torch.maximum(pres, dres) / feastol,
                          torch.minimum(gap / abstol, relgap / reltol))
        improved = m < 0.995 * st["best_m"]
        stall2 = torch.where(improved, 0, st["stall"] + 1)
        best2 = torch.minimum(st["best_m"], m)
        if rescue:
            collapse = (gap <= abstol) & (m > 10.0)
            regressed = m > 100.0 * st["best_m"]
            stalled = ((stall2 >= RESCUE_STALL_ITERS) | collapse
                       | regressed)
        else:
            stalled = torch.zeros_like(optimal)

        new_status = torch.full_like(st["status"], STATUS_RUNNING)
        new_status = torch.where(stalled, STATUS_NEEDS_F64, new_status)
        new_status = torch.where(maxed, STATUS_UNKNOWN_MAXITERS, new_status)
        new_status = torch.where(optimal, STATUS_OPTIMAL, new_status)
        exiting = new_status != STATUS_RUNNING

        upd = _iteration(fW, x, y, s, z, W, lmbda, gap, rx, ry, rz)
        x2, y2, s2, z2, W2, lmbda2, gap2, relres = upd

        if debug:
            print("debug: KKT relres after refinement = "
                  + " ".join(f"{float(r):9.2e}" for r in relres))
        ok = torch.isfinite(gap2) & torch.isfinite(lmbda2.sum(-1))
        fail = ~ok
        if rescue:
            # diverging refinement far from convergence, or a singular
            # f32 factor (NaN step): discard the step, hand the instance
            # to the f64 restart phase.  relres_trigger is off for the
            # condition-halved 'cholqr' on q/s cones, whose normwise
            # residual expansion is expected and benign
            if relres_trigger:
                fail = fail | ((relres > RESCUE_RELRES) & (m > 100.0))
            fail_status = STATUS_NEEDS_F64
        else:
            fail_status = STATUS_UNKNOWN_SINGULAR
        new_status = torch.where(
            exiting, new_status,
            torch.where(fail, fail_status, STATUS_RUNNING)
            .to(new_status.dtype))
        keep = exiting | fail

        out = dict(st)
        out.update(pcost=pcost, dcost=dcost, relgap=relgap,
                   pres=pres, dres=dres, best_m=best2,
                   stall=stall2.to(torch.int32))
        out["status"] = new_status
        out["iters"] = iters + (~keep).to(torch.int32)
        for k, new in (("x", x2), ("y", y2), ("s", s2), ("z", z2),
                       ("W", W2), ("lmbda", lmbda2), ("gap", gap2)):
            out[k] = _where(keep, st[k], new)
        return out

    syncs = [0]
    if factor_W64 is None:
        final = _run_loop(state,
                          lambda st: _body(st, factor_W, detect_rescue),
                          syncs)
        rescue_iters = torch.zeros_like(final["iters"])
    else:
        # phase 1: mixed-precision factor with failure detection;
        # phase 2: full-precision factor for the instances phase 1
        # could not finish, restarted from the initial point
        st1 = _run_loop(state, lambda st: _body(st, factor_W, True), syncs)
        st2 = _restart_state(st1, state0, ("x", "y", "s", "z", "W",
                                           "lmbda", "gap"), maxiters)
        final = _run_loop(st2, lambda st: _body(st, factor_W64, False),
                          syncs)
        rescue_iters = final["iters"] - st1["iters"]
    ts = cones.max_step(final["s"], dims)
    tz = cones.max_step(final["z"], dims)
    return dict(
        x=final["x"], y=final["y"], s=final["s"], z=final["z"],
        status=final["status"], iterations=final["iters"],
        gap=final["gap"], relgap=final["relgap"],
        pcost=final["pcost"], dcost=final["dcost"],
        pres=final["pres"], dres=final["dres"],
        primal_slack=-ts, dual_slack=-tz,
        rescue_iterations=rescue_iters,
        host_syncs=syncs[0],
    )


def _resolve_qp_opts(dims, kktsolver, refinement):
    if refinement is None:
        refinement = 1 if (dims.q or dims.s) else 0
    if kktsolver == "default" or kktsolver is None:
        # reference: 'chol' if q/s else 'chol2' (coneprog.py:1805-1809)
        kktsolver = "chol" if (dims.q or dims.s) else "chol2"
    return kktsolver, refinement


def _maps(P, G, A):
    """Batched linear-map closures for dense P (B, n, n), G, A."""
    return dict(Pf=lambda x: mv(P, x), **_lp_maps(G, A))


def make_coneqp(dims: ConeDims, kktsolver: str = "default",
                maxiters: int = 100, abstol: float = 1e-7,
                reltol: float = 1e-6, feastol: float = 1e-7,
                refinement: Optional[int] = None,
                kktreg: Optional[float] = None,
                correction: bool = True,
                factor_dtype: Optional[str] = None,
                show_progress: bool = False,
                debug: bool = False,
                device="cuda"):
    """Build the batched coneqp core: f(P, q, G, h, A, b) -> result
    dict of tensors.  q is (B, n) (or (n,) for one problem, whose
    results then drop the batch axis); P is (B, n, n) or shared; G, h,
    A, b are shared or carry the batch axis.  The working dtype is q's.
    Runs on `device` ("cuda" unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    kktsolver, refinement = _resolve_qp_opts(dims, kktsolver,
                                             refinement)

    def core(P, q, G, h, A, b, initvals=None):
        q, = _tensors(dev, q)
        P, G, h, A, b = _tensors(dev, P, G, h, A, b, dtype=q.dtype)
        single = q.dim() == 1
        if single:
            q = q.unsqueeze(0)
        Bsz, n = q.shape
        if P.dim() == 2:
            P = P.expand(Bsz, n, n)
        fd = factor_dtype
        factor_W64 = None
        fname = kktsolver
        if fd == "rescue":
            rname = kktmod.robust_name(kktsolver)
            f64 = kktmod.get_kktsolver(rname, G, dims, A, kktreg=kktreg,
                                       factor_dtype=None)
            P64 = kktmod.wrap_P(rname, P)
            factor_W64 = lambda W: f64(W, P64)
            fd = "float32"
            if (dims.q or dims.s) and kktsolver in (
                    "chol", "chol2", "chol_inv", "chol2_inv"):
                # q/s cones: an f32 Cholesky of the formed normal
                # equations cannot reach 1e-7 (kappa(S) ~ 1/mu^2); the
                # condition-halving QR factor can
                fname = "cholqr_inv" if kktsolver.endswith("_inv") \
                    else "cholqr"
        factor = kktmod.get_kktsolver(fname, G, dims, A, kktreg=kktreg,
                                      factor_dtype=fd)
        Pw = kktmod.wrap_P(fname, P, factor_dtype=(
            fd if fd == "float32" else None))
        raw = _coneqp_solve(
            dims, factor_W=lambda W: factor(W, Pw),
            factor_W64=factor_W64, **_maps(P, G, A),
            q=q, h=h, b=b, n=n, p=A.shape[-2], dtype=q.dtype,
            maxiters=maxiters, abstol=abstol, reltol=reltol,
            feastol=feastol, refinement=refinement,
            correction=correction, show_progress=show_progress,
            debug=debug, initvals=initvals,
            relres_trigger=not ((dims.q or dims.s) and "cholqr" in fname))
        return _unbatch(raw) if single else raw

    return core


def make_coneqp_cascade(dims: ConeDims, kktsolver: str = "default",
                        maxiters: int = 100, abstol: float = 1e-7,
                        reltol: float = 1e-6, feastol: float = 1e-7,
                        refinement: Optional[int] = None,
                        kktreg: Optional[float] = None,
                        correction: bool = True,
                        phase1_tol: float = 1e-4,
                        shared_GhAb: bool = True,
                        instrument: bool = False,
                        device="cuda"):
    """Progressive-precision batched coneqp: solve(P, q, G, h, A, b)
    with a leading batch axis on P and q (and on G/h/A/b too unless
    ``shared_GhAb``), inputs in float64.

      A. pure-f32 solve to `phase1_tol`;
      B. warm-started f64-residual / f32-factor solve (equilibrated
         factor plus iterative refinement) to the target tolerances; on
         'q'/'s' cones, where the ill-conditioning of the scaled Gram
         matrix is not diagonal, the f32 factor is 'cholqr_inv' with two
         refinement rounds;
      C. f64-factor cold restart for the instances phase B flagged,
         compacted on the host into a power-of-two padded batch.

    Total `iterations` counts all phases.  With ``instrument`` the
    result holds per-phase wall seconds and iteration sums under
    ``profile``.  The phases are also reachable as ``solve.phase_a``,
    ``solve.phase_b`` and ``solve.phase_c``."""
    dev = resolve_device(device)
    kktsolver, refinement = _resolve_qp_opts(dims, kktsolver,
                                             refinement)
    mixed_ok = not (dims.q or dims.s)
    refinement_b = max(1, refinement) if mixed_ok else max(2, refinement)
    bname = kktsolver if mixed_ok else "cholqr_inv"
    f32 = torch.float32

    def common(P, q, G, h, A, b):
        return dict(**_maps(P, G, A), q=q, h=h, b=b, n=q.shape[-1],
                    p=A.shape[-2], dtype=q.dtype, maxiters=maxiters,
                    correction=correction, show_progress=False)

    def phase_a(P, q, G, h, A, b):
        P1, q1, G1, h1, A1, b1 = (u.to(f32) for u in (P, q, G, h, A, b))
        factor_a = kktmod.get_kktsolver(kktsolver, G1, dims, A1,
                                        kktreg=kktreg)
        raw = _coneqp_solve(
            dims, factor_W=lambda W: factor_a(W, P1),
            **common(P1, q1, G1, h1, A1, b1),
            abstol=max(phase1_tol, abstol),
            reltol=max(phase1_tol, reltol),
            feastol=max(phase1_tol, feastol), refinement=0)
        keys = ("x", "y", "s", "z", "iterations", "status", "host_syncs")
        return {k: raw[k] for k in keys}

    def phase_b(P, q, G, h, A, b, iv):
        factor_b = kktmod.get_kktsolver(bname, G, dims, A, kktreg=kktreg,
                                        factor_dtype="float32")
        Pb = kktmod.wrap_P(bname, P, factor_dtype="float32")
        return _coneqp_solve(
            dims, factor_W=lambda W: factor_b(W, Pb), detect_rescue=True,
            **common(P, q, G, h, A, b),
            abstol=abstol, reltol=reltol, feastol=feastol,
            refinement=refinement_b, initvals=iv, refine_pred=False,
            relres_trigger=mixed_ok)

    def phase_c(P, q, G, h, A, b):
        rname = kktmod.robust_name(kktsolver)
        f64fac = kktmod.get_kktsolver(rname, G, dims, A, kktreg=kktreg,
                                      factor_dtype=None)
        P64 = kktmod.wrap_P(rname, P)
        return _coneqp_solve(
            dims, factor_W=lambda W: f64fac(W, P64),
            **common(P, q, G, h, A, b),
            abstol=abstol, reltol=reltol, feastol=feastol,
            refinement=max(1, refinement))

    out_keys = ("x", "y", "s", "z", "status", "gap", "relgap",
                "pcost", "dcost", "pres", "dres", "primal_slack",
                "dual_slack")

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def solve(P, q, G, h, A, b):
        P, q, G, h, A, b = _tensors(dev, P, q, G, h, A, b)
        prof = {}
        t0 = time.perf_counter()
        raw_a = phase_a(P, q, G, h, A, b)
        if instrument:
            _sync()
            prof["a_iters"] = int(raw_a["iterations"].sum())
            prof["a_s"] = time.perf_counter() - t0
            prof["a_host_syncs"] = raw_a["host_syncs"]
        iv = {k: raw_a[k].to(P.dtype) for k in ("x", "y", "s", "z")}
        iv["_valid"] = raw_a["status"] == STATUS_OPTIMAL
        t0 = time.perf_counter()
        raw = dict(phase_b(P, q, G, h, A, b, iv))
        if instrument:
            _sync()
            prof["b_iters"] = int(raw["iterations"].sum())
            prof["b_s"] = time.perf_counter() - t0
            prof["b_host_syncs"] = raw["host_syncs"]
        raw["iterations"] = raw["iterations"] + raw_a["iterations"]
        raw["phase1_iterations"] = raw_a["iterations"]

        # ---- phase C: host-compacted f64 rescue ----------------------
        t0 = time.perf_counter()

        def run_c(ii):
            if shared_GhAb:
                return phase_c(P[ii], q[ii], G, h, A, b)
            return phase_c(P[ii], q[ii], G[ii], h[ii], A[ii], b[ii])

        nflag = rescue_compacted(raw, out_keys, run_c, dev)
        if instrument:
            _sync()
            prof["c_iters"] = int(raw["rescue_iterations"].sum())
            prof["c_s"] = time.perf_counter() - t0
            prof["c_instances"] = nflag
            raw["profile"] = prof
        return raw

    solve.phase_a = phase_a
    solve.phase_b = phase_b
    solve.phase_c = phase_c
    return solve


def coneqp(P, q, G=None, h=None, dims=None, A=None, b=None,
           initvals=None, kktsolver=None, options=None, device="cuda",
           **kwargs):
    """Solve one cone QP in float64; returns the reference-format
    result dict (no certificate entries).

    With a callable ``kktsolver(W) -> solve(bx, by, bz)`` (returning
    ux, uy and W uz for one unbatched problem), P, G and A may also be
    `LinearOperator`s or callables ``G(x, trans)`` ('N' or 'T'; P is
    applied with 'N').  Operator forms without a kktsolver raise
    ValueError."""
    from cvxopt_tpu_torch.solvers import options as global_options
    dev = resolve_device(device)
    opts = dict(global_options)
    if options:
        opts.update(options)
    dtype = torch.float64
    custom_kkt = callable(kktsolver)
    P_op = _is_operator(P)
    if P_op and not custom_kkt:
        raise ValueError("use of operator-form P requires a "
                         "user-provided kktsolver")
    q = torch.as_tensor(q, dtype=dtype, device=dev).reshape(-1)
    n = q.shape[0]
    if not P_op:
        P = torch.as_tensor(P, dtype=dtype, device=dev).reshape(n, n)
        P = 0.5 * (P + P.T)
    if G is None and h is None:
        G = torch.zeros((0, n), dtype=dtype, device=dev)
        h = torch.zeros((0,), dtype=dtype, device=dev)
        if dims is None:
            dims = ConeDims(l=0)
    _, G, h, dims, A, b = _prep_inputs(q, G, h, dims, A, b, dtype=dtype,
                                       device=dev, allow_ops=custom_kkt)
    refinement = opts.get("refinement", None)
    factor_dtype = kktmod.resolve_factor_dtype(
        opts.get("factor_dtype", "auto"))
    if factor_dtype is not None and refinement is None:
        refinement = 1   # mixed precision needs one f64 IR round
    iv = _start_values(initvals, ("x", "y", "s", "z"), dims, dtype, dev)
    tols = dict(maxiters=int(opts.get("maxiters", 100)),
                abstol=float(opts.get("abstol", 1e-7)),
                reltol=float(opts.get("reltol", 1e-6)),
                feastol=float(opts.get("feastol", 1e-7)),
                correction=bool(opts.get("use_correction", True)),
                show_progress=bool(opts.get("show_progress", False)))

    if not custom_kkt:
        fn = make_coneqp(
            dims, kktsolver=kktsolver or "default", refinement=refinement,
            kktreg=opts.get("kktreg", None), factor_dtype=factor_dtype,
            debug=bool(opts.get("debug", False)), device=dev, **tols)
        raw = fn(P, q, G, h, A, b, initvals=iv)
        return finalize_qp_result(raw)

    # ---- advanced path: a user kktsolver and operator-form P/G/A ----
    maps = _maps(P, G, A)
    if P_op:
        maps["Pf"] = _operator_maps(P)[0]
    _, refinement = _resolve_qp_opts(dims, "default", refinement)
    raw = _coneqp_solve(
        dims, factor_W=_per_instance_factor(kktsolver), **maps,
        q=q.unsqueeze(0), h=h, b=b.unsqueeze(0), n=n, p=b.shape[0],
        dtype=dtype, refinement=refinement, initvals=iv, **tols)
    return finalize_qp_result(_unbatch(raw))


def finalize_qp_result(raw):
    """Reference result-dict format for coneqp (coneprog.py:2229-2234)."""
    status = int(raw["status"])

    def fin(v):
        v = float(v)
        return None if (v != v or abs(v) == float("inf")) else v

    return {
        "status": STATUS_STRINGS.get(status, "unknown"),
        "x": raw["x"], "y": raw["y"], "s": raw["s"], "z": raw["z"],
        "gap": fin(raw["gap"]),
        "relative gap": fin(raw["relgap"]),
        "primal objective": fin(raw["pcost"]),
        "dual objective": fin(raw["dcost"]),
        "primal infeasibility": fin(raw["pres"]),
        "dual infeasibility": fin(raw["dres"]),
        "primal slack": fin(raw["primal_slack"]),
        "dual slack": fin(raw["dual_slack"]),
        "iterations": int(raw["iterations"]),
    }
