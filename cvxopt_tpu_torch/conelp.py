"""conelp — batched cone LP solver in PyTorch, via the homogeneous
self-dual embedding.

Twin of `cvxopt_tpu/conelp.py`: a Mehrotra predictor-corrector
primal-dual interior-point method on the homogeneous self-dual embedding
with (tau, kappa), Nesterov-Todd scaling, optional iterative refinement
of the 6-variable Newton system, and self-dual certificates of primal
and dual infeasibility, for

    minimize    c'x
    subject to  G x + s = h,  A x = b,  s >= 0 (wrt the cone)

The JAX package writes the solve for one instance and vmaps it; here the
batch is a leading axis of every tensor, tau, kappa, dg and lg are (B,)
tensors, and the `lax.while_loop` is a Python loop over the per-instance
status: every pass computes the body for the whole batch, and instances
that were not running keep their old values through ``torch.where``
(never a multiplication by the mask: a NaN factor in a finished instance
must not leak into it).  Each pass costs one host sync.

The front door `conelp` also takes the reference's advanced forms:
G and A as `LinearOperator`s or callables ``G(x, trans)``, a callable
``kktsolver(W) -> solve(bx, by, bz)``, and (with operator-form A) a
dict-valued c, so that x lives in a vector space of named blocks.  All
arithmetic on x and y goes through the tree helpers of `_tree`.  User
callables see one unbatched problem, as the JAX package's users write
them; the solve runs at B = 1 and `_tree._per_instance` puts the batch
axis back on what they return.

Status codes: 0 optimal, 1 primal infeasible, 2 dual infeasible,
3 unknown (maxiters), 4 unknown (singular KKT).
"""

from __future__ import annotations

from typing import Optional

import torch

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch import scaling as nt
from cvxopt_tpu_torch import kkt as kktmod
from cvxopt_tpu_torch import ipm
from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.ops.matvec import mv, vdot
from cvxopt_tpu_torch.trace import span, spanned
from cvxopt_tpu_torch.ipm import (
    STATUS_RUNNING, STATUS_OPTIMAL, STATUS_PRIMAL_INFEASIBLE,
    STATUS_DUAL_INFEASIBLE, STATUS_UNKNOWN_MAXITERS,
    STATUS_UNKNOWN_SINGULAR, STATUS_NEEDS_F64, STATUS_STALLED,
    STATUS_STRINGS, STEP, EXPON, RESCUE_STALL_ITERS, RESCUE_RELRES,
    _run_loop, _restart_state, _tensors, _lp_maps, _unbatch, _prep_inputs,
    _start_values,
)
from cvxopt_tpu_torch._tree import (
    _col, _tmap, _leaves, _where, _tdot, _tnorm, _tzeros, _tneg, _tscale,
    _taxpy, _tadd, _tsub, _tnorm_parts, _is_operator, _per_instance_factor,
)


def _conelp_solve(dims: ConeDims, *, factor, Gf, GTf, Af, ATf, c, h, b,
                  n, p, dtype, maxiters, abstol, reltol, feastol,
                  refinement, show_progress, primalstart=None,
                  dualstart=None, factor64=None, relres_trigger=True,
                  detect_rescue=False, stall_exit=None, debug=False):
    """The conelp algorithm on a batch (c: (B, n) or a tree of batched
    tensors; h, b: shared or batched) with all linear maps as closures
    on batched vectors."""
    c0 = _leaves(c)[0]
    Bsz = c0.shape[0]
    dev = c0.device
    h = h.expand(Bsz, h.shape[-1])
    b = b.expand(Bsz, b.shape[-1])
    e = cones.cone_identity(dims, dtype=dtype, device=dev)
    kw = dict(dtype=dtype, device=dev)
    ikw = dict(dtype=torch.int32, device=dev)

    resx0 = torch.clamp(_tnorm(c), min=1.0)
    resy0 = torch.clamp(_tnorm(b), min=1.0)
    resz0 = torch.clamp(cones.snrm2(h, dims), min=1.0)

    # ---- initial points (coneprog.py:662-845) ------------------------
    with span("cvx.ipm.start"):
        # the cold point is also computed when a restart phase exists:
        # restarts must be cold (restarting from a warm start re-enters
        # the warm-start pathology)
        cold = None
        warm = primalstart is not None and dualstart is not None
        if not warm or factor64 is not None or detect_rescue:
            f0 = factor(nt.identity_scaling(dims, dtype=dtype, device=dev,
                                            batch=(Bsz,)))
            # solve [0 A' G'; A 0 0; G 0 -I][x;dy;-s] = [0;b;h]
            xc, _, ms = f0(_tzeros(c), b, h)
            # solve [...][dx;y;z] = [-c;0;0]
            _, yc, zc = f0(_tneg(c), _tzeros(b), torch.zeros_like(h))
            sc, zc = (cones.push_interior(u, cones.max_step(u, dims), e, dims)
                      for u in (-ms, zc))
            cold = (xc, yc, sc, zc)

        def start(d, k):
            return _tmap(
                lambda u: u.to(dtype).expand((Bsz,) + u.shape[1:]), d[k])

        if primalstart is None:
            x, s = cold[0], cold[2]
        else:
            x = start(primalstart, "x")
            s = start(primalstart, "s")
        if dualstart is None:
            y, z = cold[1], cold[3]
        else:
            y = start(dualstart, "y") if dualstart.get("y") is not None \
                else _tzeros(b)
            z = start(dualstart, "z")

        if warm and cold is not None:
            # per-instance warm-start validation: a non-finite or
            # non-interior handoff would NaN compute_scaling
            tsz_w = cones.max_step(torch.stack([s, z]), dims)
            valid = (torch.isfinite(_tdot(x, x))
                     & torch.isfinite(_tdot(y, y))
                     & (tsz_w[0] < 0) & (tsz_w[1] < 0))
            x, y, s, z = (_where(valid, u, cl)
                          for u, cl in zip((x, y, s, z), cold))

        def _mkstate(x_, y_, s_, z_):
            W_, lmbda_ = nt.compute_scaling(s_, z_, dims)
            one = torch.ones((Bsz,), **kw)
            nan = torch.full((Bsz,), float("nan"), **kw)
            return dict(
                x=x_, y=y_, s=s_, z=z_, tau=one, kappa=one, W=W_,
                lmbda=lmbda_, dg=one, lg=one,
                gap=cones.sdot(s_, z_, dims),
                iters=torch.zeros((Bsz,), **ikw),
                status=torch.full((Bsz,), STATUS_RUNNING, **ikw),
                pcost=nan, dcost=nan, relgap=nan, pres=nan, dres=nan,
                pinfres=nan, dinfres=nan, cx=nan, by=nan, hz=nan,
                best_m=torch.full((Bsz,), float("inf"), **kw),
                stall=torch.zeros((Bsz,), **ikw),
                max_it=torch.full((Bsz,), maxiters, **ikw),
            )

        state = _mkstate(x, y, s, z)
        # restart phases must restore the COLD point, not the warm one
        state0 = _mkstate(*cold) if (warm and cold is not None) else state

    def _iteration(fW, x, y, s, z, W, lmbda, dg, lg, rx, ry, rz, rt):
        dgi = 1.0 / dg
        lmbdasq = cones.ssqr(lmbda, dims)
        lgsq = lg * lg

        f3 = fW(W)

        # (x1, y1, z1) = dgi * K^{-1} (-c, b, h)  (coneprog.py:1071)
        x1, y1, z1 = f3(_tneg(c), b, h)
        x1, y1, z1 = _tscale(dgi, x1), _tscale(dgi, y1), _col(dgi) * z1
        th = nt.scale(h, W, dims, trans="T", inverse="I")
        z1z1 = cones.sdot(z1, z1, dims)

        def f6_no_ir(bx, by_, bz, btau, bs, bkappa):
            # (coneprog.py:1130-1196)
            us = -cones.sinv(bs, lmbda, dims)
            uz = -(bz + nt.scale(us, W, dims, trans="T"))
            ux, uy, uz = f3(bx, _tneg(by_), uz)
            ukappa = -bkappa / lg
            utau = btau + ukappa / dgi
            utau = dgi * (utau + _tdot(c, ux) + _tdot(b, uy)
                          + cones.sdot(th, uz, dims)) / (1.0 + z1z1)
            ux = _taxpy(utau, x1, ux)
            uy = _taxpy(utau, y1, uy)
            uz = uz + _col(utau) * z1
            us = us - uz
            ukappa = ukappa - utau
            return ux, uy, uz, utau, us, ukappa

        def resid6(ux, uy, uz, utau, us, ukappa,
                   vx, vy, vz, vtau, vs, vkappa):
            # residual of the 6-var system (coneprog.py:599-631)
            wz3 = nt.scale(uz, W, dims, inverse="I")
            ut = utau / dg
            vx = _tsub(_tsub(_tsub(vx, ATf(uy)), GTf(wz3)), _tscale(ut, c))
            vy = _tsub(_tadd(vy, Af(ux)), _tscale(ut, b))
            vz = vz + Gf(ux) - _col(ut) * h + nt.scale(us, W, dims,
                                                       trans="T")
            vtau = vtau + dg * ukappa + _tdot(c, ux) + _tdot(b, uy) \
                + cones.sdot(h, wz3, dims)
            vs = vs + cones.sprod_diag(us + uz, lmbda, dims)
            vkappa = vkappa + lg * (utau + ukappa)
            return vx, vy, vz, vtau, vs, vkappa

        def f6(*rhs):
            u = f6_no_ir(*rhs)
            relres = torch.zeros_like(lg)
            for _ in range(refinement):
                v = resid6(*u, *rhs)
                # contraction of one solve round: the mixed-precision
                # failure detector (RESCUE_RELRES)
                relres = _tnorm_parts(v) / torch.clamp(
                    _tnorm_parts(rhs), min=1e-30)
                du = f6_no_ir(*v)
                u = tuple(_tadd(a, d) for a, d in zip(u, du))
            return u, relres

        mu = (vdot(lmbda, lmbda) + lgsq) / (1 + dims.cdim_diag)
        lmbdasq_full = cones.diag_embed(lmbdasq, dims)

        def step_bound(ds, dz, dtau, dkappa, with_eig):
            ds_sc = nt.scale2(lmbda, ds, dims)
            dz_sc = nt.scale2(lmbda, dz, dims)
            # one stacked call covers both cone vectors
            pair = torch.stack([ds_sc, dz_sc])
            if with_eig:
                tsz, sig2, dq2 = cones.max_step_eig(pair, dims)
            else:
                tsz, sig2, dq2 = cones.max_step(pair, dims), None, None
            t = torch.maximum(torch.maximum(tsz[0], tsz[1]),
                              torch.maximum(-dtau / lg, -dkappa / lg))
            return torch.clamp(t, min=0.0), sig2, dq2

        # ---- predictor (coneprog.py:1250-1333) -----------------------
        (dx, dy, dz, dtau, ds, dkappa), rr1 = f6(rx, ry, rz, rt,
                                                 lmbdasq_full, lgsq)
        ws3 = cones.sprod(ds, dz, dims)
        wkappa3 = dtau * dkappa
        t, _, _ = step_bound(ds, dz, dtau, dkappa, False)
        step = torch.where(t == 0.0, 1.0, torch.clamp(1.0 / t, max=1.0))
        sigma = (1.0 - step) ** EXPON

        # ---- corrector -----------------------------------------------
        ds_in = lmbdasq_full + ws3 - _col(sigma * mu) * e
        dk_in = lgsq + wkappa3 - sigma * mu
        om = 1.0 - sigma
        (dx, dy, dz, dtau, ds, dkappa), rr2 = f6(
            _tscale(om, rx), _tscale(om, ry), _col(om) * rz, om * rt,
            ds_in, dk_in)
        t, sig2, dq2 = step_bound(ds, dz, dtau, dkappa, True)
        tt = -dtau / lg
        tk = -dkappa / lg
        step = torch.where(t == 0.0, 1.0, torch.clamp(STEP / t, max=1.0))

        # ---- update (coneprog.py:1336-1436) --------------------------
        x = _taxpy(step, dx, x)
        y = _taxpy(step, dy, y)

        ds2, dz2 = nt.update_args(lmbda, dq2, sig2, step, e, dims)
        W2, lmbda2 = nt.update_scaling(W, lmbda, ds2, dz2, dims)

        dg2 = dg * torch.sqrt(1.0 - step * tk) / torch.sqrt(1.0 - step * tt)
        dgi2 = 1.0 / dg2
        lg2 = lg * torch.sqrt(1.0 - step * tt) * torch.sqrt(1.0 - step * tk)

        s2, z2 = nt.unscale(lmbda2, W2, dims)
        kappa2 = lg2 / dgi2
        tau2 = lg2 * dgi2
        gap2 = (torch.linalg.vector_norm(lmbda2, dim=-1) / tau2) ** 2
        return dict(x=x, y=y, s=s2, z=z2, tau=tau2, kappa=kappa2, W=W2,
                    lmbda=lmbda2, dg=dg2, lg=lg2, gap=gap2), \
            torch.maximum(rr1, rr2)

    def _body(st, fW, rescue):
        x, y, s, z = st["x"], st["y"], st["s"], st["z"]
        tau, kappa, gap = st["tau"], st["kappa"], st["gap"]
        iters = st["iters"]

        # ---- residuals (coneprog.py:861-915) -------------------------
        hrx = _tneg(_tadd(ATf(y), GTf(z)))
        hresx = _tnorm(hrx)
        rx = _tsub(hrx, _tscale(tau, c))
        resx = _tnorm(rx) / tau
        hry = Af(x)
        hresy = _tnorm(hry)
        ry = _tsub(hry, _tscale(tau, b))
        resy = _tnorm(ry) / tau
        hrz = Gf(x) + s
        hresz = cones.snrm2(hrz, dims)
        rz = hrz - _col(tau) * h
        resz = cones.snrm2(rz, dims) / tau
        cx = _tdot(c, x)
        by = _tdot(b, y)
        hz = cones.sdot(h, z, dims)
        rt = kappa + cx + by + hz

        pcost = cx / tau
        dcost = -(by + hz) / tau
        inf = torch.full_like(gap, float("inf"))
        relgap = torch.where(
            pcost < 0.0, gap / -pcost,
            torch.where(dcost > 0.0, gap / dcost, inf))
        pres = torch.maximum(resy / resy0, resz / resz0)
        dres = resx / resx0
        pinfres = torch.where(hz + by < 0.0,
                              hresx / resx0 / (-hz - by), inf)
        dinfres = torch.where(
            cx < 0.0,
            torch.maximum(hresy / resy0, hresz / resz0) / (-cx), inf)

        if show_progress:
            for k in range(Bsz):
                print(f"{int(iters[k]):2d}: {float(pcost[k]): 8.4e} "
                      f"{float(dcost[k]): 8.4e} {float(gap[k]): 4.0e} "
                      f"{float(pres[k]):7.0e} {float(dres[k]):7.0e} "
                      f"{float(kappa[k] / tau[k]):7.0e}")

        # ---- exit tests (coneprog.py:925-1023) -----------------------
        optimal = ((pres <= feastol) & (dres <= feastol)
                   & ((gap <= abstol) | (relgap <= reltol)))
        maxed = iters >= st["max_it"]
        pinf = pinfres <= feastol
        dinf = dinfres <= feastol

        # per-instance failure detectors (mixed-precision phase only);
        # certificates count as progress too
        m = torch.maximum(torch.maximum(pres, dres) / feastol,
                          torch.minimum(gap / abstol, relgap / reltol))
        m = torch.minimum(m, torch.minimum(pinfres, dinfres) / feastol)
        improved = m < 0.995 * st["best_m"]
        stall2 = torch.where(improved, 0, st["stall"] + 1).to(torch.int32)
        best2 = torch.minimum(st["best_m"], m)
        collapse = (gap <= abstol) & (m > 10.0)
        if rescue:
            regressed = m > 100.0 * st["best_m"]
            stalled = ((stall2 >= RESCUE_STALL_ITERS) | collapse
                       | regressed)
            stall_status = STATUS_NEEDS_F64
        elif stall_exit is not None:
            # trigger-driven refresh (make_conelp_refresh): hand the
            # current iterate back to the host loop when the measured
            # convergence stalls
            stalled = (stall2 >= stall_exit) | collapse
            stall_status = STATUS_STALLED
        else:
            stalled = torch.zeros_like(optimal)
            stall_status = STATUS_NEEDS_F64

        new_status = torch.full_like(st["status"], STATUS_RUNNING)
        for cond, code in ((stalled, stall_status),
                           (dinf, STATUS_DUAL_INFEASIBLE),
                           (pinf, STATUS_PRIMAL_INFEASIBLE),
                           (maxed, STATUS_UNKNOWN_MAXITERS),
                           (optimal, STATUS_OPTIMAL)):
            new_status = torch.where(cond, code, new_status)
        exiting = new_status != STATUS_RUNNING

        # one IPM step (computed for every instance; discarded for the
        # exiting ones)
        new, relres = _iteration(fW, x, y, s, z, st["W"], st["lmbda"],
                                 st["dg"], st["lg"], rx, ry, rz, rt)
        if debug:
            print("debug: KKT relres after refinement = "
                  + " ".join(f"{float(r):9.2e}" for r in relres))
        ok = (torch.isfinite(new["gap"]) & torch.isfinite(new["tau"])
              & torch.isfinite(new["lmbda"].sum(-1)))
        fail = ~ok
        if rescue:
            # diverging refinement far from convergence, or a singular
            # f32 factor: discard the step, hand to the f64 restart.
            # relres_trigger is off for condition-halved factors
            # ('qr'/'cholqr' on q/s cones) where normwise residual
            # expansion is expected and benign.
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
        out.update(pcost=pcost, dcost=dcost, relgap=relgap, pres=pres,
                   dres=dres, pinfres=pinfres, dinfres=dinfres, cx=cx,
                   by=by, hz=hz, best_m=best2, stall=stall2)
        out["status"] = new_status.to(torch.int32)
        out["iters"] = iters + (~keep).to(torch.int32)
        for k, v in new.items():
            out[k] = _where(keep, st[k], v)
        return out

    syncs = [0]
    if factor64 is None:
        # with detect_rescue, flagged instances EXIT with NEEDS_F64 for
        # the caller's host-side compaction
        final = _run_loop(state, lambda st: _body(st, factor, detect_rescue),
                          syncs)
    else:
        # two-phase mixed-precision rescue: the instances phase 1 could
        # not finish RESTART from the initial point with a fresh
        # iteration budget, so their result is the full-precision
        # solver's
        st1 = _run_loop(state, lambda st: _body(st, factor, True), syncs)
        st2 = _restart_state(
            st1, state0, ("x", "y", "s", "z", "tau", "kappa", "W",
                          "lmbda", "dg", "lg", "gap"), maxiters)
        final = _run_loop(st2, lambda st: _body(st, factor64, False), syncs)

    # ---- finalization (coneprog.py:925-1023 per-branch scalings) -----
    status = final["status"]
    tau, cx, by, hz = final["tau"], final["cx"], final["by"], final["hz"]
    xs = torch.where(status == STATUS_DUAL_INFEASIBLE, -1.0 / cx, 1.0 / tau)
    ys = torch.where(status == STATUS_PRIMAL_INFEASIBLE,
                     1.0 / (-hz - by), 1.0 / tau)
    s_out = final["s"] * _col(xs)
    z_out = final["z"] * _col(ys)
    return dict(
        x=_tscale(xs, final["x"]), y=_tscale(ys, final["y"]), s=s_out,
        z=z_out,
        status=status, iterations=final["iters"],
        gap=final["gap"], relgap=final["relgap"],
        pcost=final["pcost"], dcost=final["dcost"],
        pres=final["pres"], dres=final["dres"],
        pinfres=final["pinfres"], dinfres=final["dinfres"],
        primal_slack=-cones.max_step(s_out, dims),
        dual_slack=-cones.max_step(z_out, dims),
        host_syncs=syncs[0],
    )


def _resolve_opts(dims, kktsolver, refinement):
    if refinement is None:
        refinement = 1 if (dims.q or dims.s) else 0
    if kktsolver == "default" or kktsolver is None:
        # reference conelp default: 'qr' if q/s else 'chol2'
        # (coneprog.py:458-462)
        kktsolver = "qr" if (dims.q or dims.s) else "chol2"
    return kktsolver, refinement


def _relres_trigger(dims, kktsolver) -> bool:
    """Whether the mixed-precision rescue may use the refinement
    normwise-residual trigger: condition-halved strategies ('qr',
    'cholqr') on q/s cones have benignly large normwise residuals, so
    only the outcome triggers (stall/collapse/NaN) apply there."""
    return not ((dims.q or dims.s) and isinstance(kktsolver, str)
                and kktsolver.startswith(("qr", "cholqr")))


def _factors(kktsolver, G, dims, A, kktreg, factor_dtype):
    """(factor, factor64) for a `factor_dtype` mode: 'rescue' is an f32
    factor with an f64 restart phase, 'f64_restart' the f64 factor of
    the robust strategy in both phases."""
    if factor_dtype in ("rescue", "f64_restart"):
        factor64 = kktmod.get_kktsolver(
            kktmod.robust_name(kktsolver), G, dims, A, kktreg=kktreg,
            factor_dtype=None)
        if factor_dtype == "f64_restart":
            return factor64, factor64
        return kktmod.get_kktsolver(kktsolver, G, dims, A, kktreg=kktreg,
                                    factor_dtype="float32"), factor64
    return kktmod.get_kktsolver(kktsolver, G, dims, A, kktreg=kktreg,
                                factor_dtype=factor_dtype), None


def make_conelp(dims: ConeDims, kktsolver: str = "default",
                maxiters: int = 100, abstol: float = 1e-7,
                reltol: float = 1e-6, feastol: float = 1e-7,
                refinement: Optional[int] = None,
                kktreg: Optional[float] = None,
                factor_dtype: Optional[str] = None,
                show_progress: bool = False,
                stall_exit: Optional[int] = None,
                debug: bool = False, device="cuda"):
    """Build the batched conelp core: f(c, G, h, A, b) -> result dict of
    tensors.  c is (B, n) (or (n,) for one problem, whose results then
    drop the batch axis); G, h, A, b are shared or carry the batch axis.
    The working dtype is c's.  Runs on `device` ("cuda" unless the
    caller asks for the CPU).

    ``stall_exit``: exit with the internal STATUS_STALLED after that
    many consecutive non-improving iterations (the refresh trigger,
    make_conelp_refresh).  The core also takes ``primalstart`` /
    ``dualstart`` dicts of batched tensors ('x', 's' / 'y', 'z')."""
    dev = resolve_device(device)
    kktsolver, refinement = _resolve_opts(dims, kktsolver, refinement)

    def core(c, G, h, A, b, primalstart=None, dualstart=None):
        c, = _tensors(dev, c)
        G, h, A, b = _tensors(dev, G, h, A, b, dtype=c.dtype)
        single = c.dim() == 1
        if single:
            c = c.unsqueeze(0)
        factor, factor64 = _factors(kktsolver, G, dims, A, kktreg,
                                    factor_dtype)
        raw = _conelp_solve(
            dims, factor=factor, factor64=factor64, **_lp_maps(G, A),
            c=c, h=h, b=b, n=c.shape[-1], p=A.shape[-2], dtype=c.dtype,
            maxiters=maxiters, abstol=abstol, reltol=reltol,
            feastol=feastol, refinement=refinement,
            show_progress=show_progress, stall_exit=stall_exit,
            debug=debug, primalstart=primalstart, dualstart=dualstart,
            relres_trigger=_relres_trigger(dims, kktsolver))
        return _unbatch(raw) if single else raw

    return core


def _make_ws(dims, kktsolver, maxiters, abstol, reltol, feastol,
             refinement, kktreg, factor_dtype, stall_exit, detect, dev):
    """The warm-started core behind make_conelp_ws (two-phase rescue
    inside the solve) and make_conelp_ws_detect (detection only)."""
    kktsolver, refinement = _resolve_opts(dims, kktsolver, refinement)

    def core(c, G, h, A, b, x0, y0, z0):
        c, = _tensors(dev, c)
        G, h, A, b, x0, y0, z0 = _tensors(dev, G, h, A, b, x0, y0, z0,
                                          dtype=c.dtype)
        single = c.dim() == 1
        if single:
            c, x0, y0, z0 = (u.unsqueeze(0) for u in (c, x0, y0, z0))
        factor, factor64 = _factors(kktsolver, G, dims, A, kktreg,
                                    factor_dtype)
        if detect:
            factor64 = None
        e = cones.cone_identity(dims, dtype=c.dtype, device=dev)
        # Mehrotra-style starting-point shift: repair cone violations
        # with 1.5x margin, then back both points off the boundary by
        # half the average complementarity; warm points straight off a
        # parent's optimal face are badly off-center for the HSD solver
        s0 = h - mv(G, x0)
        ts = cones.max_step(s0, dims)          # = max cone violation
        tz = cones.max_step(z0, dims)
        ds = torch.clamp(1.5 * ts, min=0.0)
        dz = torch.clamp(1.5 * tz, min=0.0)
        s1 = s0 + _col(ds) * e
        z1 = z0 + _col(dz) * e
        mu = cones.sdot(s1, z1, dims)
        ds = ds + 0.5 * mu / torch.clamp(cones.sdot(z1, e, dims), min=1e-12)
        dz = dz + 0.5 * mu / torch.clamp(cones.sdot(s1, e, dims), min=1e-12)
        raw = _conelp_solve(
            dims, factor=factor, factor64=factor64, detect_rescue=detect,
            **_lp_maps(G, A), c=c, h=h, b=b, n=c.shape[-1],
            p=A.shape[-2], dtype=c.dtype, maxiters=maxiters,
            abstol=abstol, reltol=reltol, feastol=feastol,
            refinement=refinement, show_progress=False,
            stall_exit=stall_exit,
            primalstart={"x": x0, "s": s0 + _col(ds) * e},
            dualstart={"y": y0, "z": z0 + _col(dz) * e},
            relres_trigger=_relres_trigger(dims, kktsolver))
        return _unbatch(raw) if single else raw

    return core


def make_conelp_ws(dims: ConeDims, kktsolver: str = "default",
                   maxiters: int = 100, abstol: float = 1e-7,
                   reltol: float = 1e-6, feastol: float = 1e-7,
                   refinement: Optional[int] = None,
                   kktreg: Optional[float] = None,
                   factor_dtype: Optional[str] = None,
                   stall_exit: Optional[int] = None, device="cuda"):
    """Warm-started batched conelp core:
    f(c, G, h, A, b, x0, y0, z0) -> result dict.

    The starts are the reference's primalstart/dualstart semantics
    (coneprog.py:107-118) with an interior shift applied: s0 = h - G x0
    and z0 are pushed into the cone, so a parent node's iterates can
    seed a child relaxation directly.  ``factor_dtype``: None, 'float32',
    'rescue' (f32 factor, per-instance f64 cold restart) or
    'f64_restart' (f64 factors with the failure detectors and a cold
    restart)."""
    return _make_ws(dims, kktsolver, maxiters, abstol, reltol, feastol,
                    refinement, kktreg, factor_dtype, stall_exit, False,
                    resolve_device(device))


def make_conelp_ws_detect(dims: ConeDims, kktsolver: str = "default",
                          maxiters: int = 100, abstol: float = 1e-7,
                          reltol: float = 1e-6, feastol: float = 1e-7,
                          refinement: Optional[int] = None,
                          kktreg: Optional[float] = None,
                          factor_dtype: Optional[str] = None,
                          device="cuda"):
    """`make_conelp_ws` in detection-only mode: the factor runs at the
    requested precision ('rescue' -> f32, 'f64_restart'/None -> f64 of
    the robust strategy) with the per-instance failure detectors active,
    and flagged instances exit with the NEEDS_F64 status code for
    host-side compaction (the cascade's phase C)."""
    if factor_dtype is None:
        factor_dtype = "f64_restart"
    return _make_ws(dims, kktsolver, maxiters, abstol, reltol, feastol,
                    refinement, kktreg, factor_dtype, None, True,
                    resolve_device(device))


def make_conelp_cascade(dims: ConeDims, kktsolver: str = "default",
                        maxiters: int = 100, abstol: float = 1e-7,
                        reltol: float = 1e-6, feastol: float = 1e-7,
                        refinement: Optional[int] = None,
                        kktreg: Optional[float] = None,
                        phase1_tol: float = 1e-4,
                        shared_GhAb: bool = True,
                        instrument: bool = False, device="cuda"):
    """Progressive-precision batched conelp (the cone-LP analogue of
    coneqp.make_coneqp_cascade): solve(c, G, h, A, b) with a leading
    batch axis on c (and on G/h/A/b unless ``shared_GhAb``), inputs in
    float64.

      A. pure-f32 solve to `phase1_tol`;
      B. the HSD solver re-entered in f64 through the Mehrotra-shifted
         warm start of `make_conelp_ws_detect`, with f32 factors
         ('rescue' mode) on 'l'/'q' cones and f64 factors
         ('f64_restart') on 's' cones, where f32 factors collapse the
         HSD gap while feasibility drifts; detection only;
      C. cold f64 solve of the instances phase B flagged, compacted on
         the host into a power-of-two padded batch.

    Instances phase A could not finish, or flagged infeasible at 1e-4,
    restart cold in phase B.  The phases run in `ipm.cascade`, as for
    coneqp.make_coneqp_cascade: total `iterations` counts all phases,
    ``instrument`` adds the ``profile`` (whose tape counters read 0:
    conelp replays no IPM tape), and the phases are also reachable as
    ``solve.phase_a`` (which casts its arguments to float32),
    ``solve.phase_b`` and ``solve.phase_c``."""
    dev = resolve_device(device)
    kktsolver, refinement = _resolve_opts(dims, kktsolver, refinement)
    tols = dict(maxiters=maxiters, abstol=abstol, reltol=reltol,
                feastol=feastol, kktreg=kktreg, device=dev)

    core_a = make_conelp(
        dims, kktsolver=kktsolver, maxiters=maxiters,
        abstol=max(phase1_tol, abstol), reltol=max(phase1_tol, reltol),
        feastol=max(phase1_tol, feastol), refinement=0, kktreg=kktreg,
        device=dev)
    phase_b = make_conelp_ws_detect(
        dims, kktsolver=kktsolver, refinement=max(1, refinement),
        factor_dtype="f64_restart" if dims.s else "rescue", **tols)
    phase_c = make_conelp(
        dims, kktsolver=kktmod.robust_name(kktsolver),
        refinement=max(1, refinement), **tols)

    def phase_a(c, G, h, A, b):
        return core_a(*(u.to(torch.float32) for u in (c, G, h, A, b)))

    def handoff(raw_a, args):
        # instances phase A could not finish hand over garbage
        # iterates: poison them with NaN so that the warm-start validity
        # check sends them straight to the cold start
        dt = args[0].dtype
        ok_a = raw_a["status"] == STATUS_OPTIMAL
        nanv = torch.full((), float("nan"), dtype=dt, device=dev)
        return tuple(torch.where(ok_a[:, None], raw_a[k].to(dt), nanv)
                     for k in ("x", "y", "z"))

    out_keys = ("x", "y", "s", "z", "status", "gap", "relgap",
                "pcost", "dcost", "pres", "dres", "pinfres",
                "dinfres", "primal_slack", "dual_slack")
    return ipm.cascade(phase_a, phase_b, phase_c, handoff, out_keys,
                       1 if shared_GhAb else 5, instrument, dev)


@spanned("cvx.frontend.conelp")
def conelp(c, G, h, dims=None, A=None, b=None, primalstart=None,
           dualstart=None, kktsolver=None, options=None, device="cuda",
           **kwargs):
    """Solve one cone LP in float64; returns the reference-format result
    dict (coneprog.py:125-283).  `primalstart` ('x', 's') / `dualstart`
    ('y', 'z') warm starts as in the reference.

    With a callable ``kktsolver(W) -> solve(bx, by, bz)`` (returning
    ux, uy and W uz for one unbatched problem), G and A may also be
    `LinearOperator`s or callables ``G(x, trans)`` with trans 'N' or
    'T', and c a dict of blocks (then A must be operator-form or
    absent); x comes back in c's form.  Operator forms without a
    kktsolver raise ValueError."""
    from cvxopt_tpu_torch.solvers import options as global_options
    dev = resolve_device(device)
    opts = dict(global_options)
    if options:
        opts.update(options)
    dtype = torch.float64
    custom_kkt = callable(kktsolver)
    c, G, h, dims, A, b = _prep_inputs(c, G, h, dims, A, b, dtype=dtype,
                                       device=dev, allow_ops=custom_kkt)
    refinement = opts.get("refinement", None)
    factor_dtype = kktmod.resolve_factor_dtype(
        opts.get("factor_dtype", "auto"))
    if factor_dtype is not None and refinement is None:
        refinement = 1   # mixed precision needs one f64 IR round
    tree = isinstance(c, dict)
    ps = _start_values(primalstart, ("x", "s"), dims, dtype, dev, tree)
    ds = _start_values(dualstart, ("y", "z"), dims, dtype, dev)
    tols = dict(maxiters=int(opts.get("maxiters", 100)),
                abstol=float(opts.get("abstol", 1e-7)),
                reltol=float(opts.get("reltol", 1e-6)),
                feastol=float(opts.get("feastol", 1e-7)),
                show_progress=bool(opts.get("show_progress", False)))

    if not custom_kkt:
        fn = make_conelp(
            dims, kktsolver=kktsolver or "default", refinement=refinement,
            kktreg=opts.get("kktreg", None), factor_dtype=factor_dtype,
            debug=bool(opts.get("debug", False)), device=dev, **tols)
        raw = fn(c, G, h, A, b, primalstart=ps, dualstart=ds)
        return finalize_result(raw, dims)

    # ---- advanced path: a user kktsolver, operators, dict-valued x ----
    A_op = _is_operator(A)
    if tree and not A_op and A.shape[0]:
        # a matrix A is only meaningful for a dict x when it is empty
        # (coneprog.py:477-479)
        raise ValueError("pytree-valued c requires operator-form A")
    cb = _tmap(lambda u: u.unsqueeze(0), c)
    maps = _lp_maps(G, A)
    if tree and not A_op:
        maps["Af"] = lambda x: b.new_zeros((1, 0))
        maps["ATf"] = lambda y: _tzeros(cb)
    _, refinement = _resolve_opts(dims, "default", refinement)
    raw = _conelp_solve(
        dims, factor=_per_instance_factor(kktsolver), **maps, c=cb,
        h=h, b=b.unsqueeze(0), n=None, p=b.shape[0], dtype=dtype,
        refinement=refinement, primalstart=ps, dualstart=ds, **tols)
    return finalize_result(_unbatch(raw), dims)


def finalize_result(raw, dims: ConeDims):
    """Convert one instance's raw output into the reference result-dict
    format (coneprog.py:125-283): same keys, None where the reference
    returns None.  Each read of a device value is a `cvx.frontend.sync`
    span."""
    with span("cvx.frontend.sync"):
        status = int(raw["status"])
    sstr = STATUS_STRINGS.get(status, "unknown")

    def opt(v, none_statuses):
        return None if status in none_statuses else v

    def fin(v):
        with span("cvx.frontend.sync"):
            v = float(v)
        return None if (v != v or abs(v) == float("inf")) else v

    with span("cvx.frontend.sync"):
        iterations = int(raw["iterations"])

    pinf, dinf = STATUS_PRIMAL_INFEASIBLE, STATUS_DUAL_INFEASIBLE
    return {
        "status": sstr,
        "x": opt(raw["x"], (pinf,)),
        "s": opt(raw["s"], (pinf,)),
        "y": opt(raw["y"], (dinf,)),
        "z": opt(raw["z"], (dinf,)),
        "gap": opt(fin(raw["gap"]), (pinf, dinf)),
        "relative gap": opt(fin(raw["relgap"]), (pinf, dinf)),
        "primal objective": (-1.0 if status == dinf else
                             opt(fin(raw["pcost"]), (pinf,))),
        "dual objective": (1.0 if status == pinf else
                           opt(fin(raw["dcost"]), (dinf,))),
        "primal infeasibility": opt(fin(raw["pres"]), (pinf, dinf)),
        "dual infeasibility": opt(fin(raw["dres"]), (pinf, dinf)),
        "primal slack": opt(fin(raw["primal_slack"]), (pinf,)),
        "dual slack": opt(fin(raw["dual_slack"]), (dinf,)),
        "residual as primal infeasibility certificate":
            fin(raw["pinfres"]) if status == pinf else None,
        "residual as dual infeasibility certificate":
            fin(raw["dinfres"]) if status == dinf else None,
        "iterations": iterations,
    }


def make_conelp_refresh(dims: ConeDims, kktsolver: str = "default",
                        maxiters: int = 100, abstol: float = 1e-7,
                        reltol: float = 1e-6, feastol: float = 1e-7,
                        refinement: Optional[int] = None,
                        kktreg: Optional[float] = None,
                        factor_dtype: Optional[str] = None,
                        stall_exit: int = 4,
                        segment: Optional[int] = None,
                        rounds: int = 3, device="cuda"):
    """conelp with scaling refresh, for single cone programs:
    solve(c, G, h, A, b) with c (n,).

    The core runs until it converges, certifies infeasibility, or the
    per-iteration convergence measure stops improving for `stall_exit`
    consecutive iterations; only then does the host restart the warm
    core from the current iterate, which recomputes the NT scaling
    fresh and re-centers through the Mehrotra shift.  A healthy solve
    never restarts.  With ``segment`` set, the core instead runs
    open-loop segments of that many iterations and any inconclusive
    exit refreshes.  Returns the raw result dict plus cumulative
    `iterations` (at most `maxiters`) and `refresh_rounds`."""
    se = None if segment is not None else stall_exit
    seg_iters = min(segment, maxiters) if segment is not None else maxiters
    kw = dict(kktsolver=kktsolver, abstol=abstol, reltol=reltol,
              feastol=feastol, refinement=refinement, kktreg=kktreg,
              factor_dtype=factor_dtype, stall_exit=se, device=device)
    cold = make_conelp(dims, maxiters=seg_iters, **kw)
    conclusive = (STATUS_OPTIMAL, STATUS_PRIMAL_INFEASIBLE,
                  STATUS_DUAL_INFEASIBLE)

    def wants_refresh(status):
        # trigger mode: a STALLED exit refreshes, and so does a SINGULAR
        # one (a fresh scaling repairs a factorization broken by the
        # carried one); MAXITERS stays terminal
        if segment is None:
            return status in (STATUS_STALLED, STATUS_UNKNOWN_SINGULAR)
        return status not in conclusive

    def solve(c, G, h, A, b):
        out = cold(c, G, h, A, b)
        total = int(out["iterations"])
        r = 0
        while (wants_refresh(int(out["status"])) and r < rounds
               and total < maxiters):
            # each round's warm core gets what is left of maxiters, so
            # the cumulative count never exceeds it
            ws = make_conelp_ws(dims, maxiters=min(seg_iters,
                                                   maxiters - total), **kw)
            out = ws(c, G, h, A, b, out["x"], out["y"], out["z"])
            total += int(out["iterations"])
            r += 1
        out = dict(out)
        if int(out["status"]) == STATUS_STALLED:
            # exhausted rounds while stalled: report the reference's
            # inconclusive status, keeping the best iterate
            out["status"] = torch.full_like(out["status"],
                                            STATUS_UNKNOWN_MAXITERS)
        out["iterations"] = total
        out["refresh_rounds"] = r
        return out

    return solve
