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

import time
from typing import Optional

import numpy as np
import torch

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch import scaling as nt
from cvxopt_tpu_torch import kkt as kktmod
from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.ops.matvec import mv, vdot
from cvxopt_tpu_torch._tree import (
    _col, _tmap, _leaves, _where, _tdot, _tnorm, _tzeros, _tneg, _tscale,
    _taxpy, _tadd, _tsub, _tnorm_parts, _take, _is_operator,
    _per_instance_factor, _operator_maps,
)

STATUS_RUNNING = -1
STATUS_OPTIMAL = 0
STATUS_PRIMAL_INFEASIBLE = 1
STATUS_DUAL_INFEASIBLE = 2
STATUS_UNKNOWN_MAXITERS = 3
STATUS_UNKNOWN_SINGULAR = 4
# internal only: instance handed from the mixed-precision phase to the
# full-precision rescue phase (never escapes the solver)
STATUS_NEEDS_F64 = 5
# internal only: the stall detector fired with `stall_exit` set; the
# host refresh loop (make_conelp_refresh) restarts from this iterate
# with a freshly computed scaling
STATUS_STALLED = 6

# mixed-precision rescue triggers (per instance, outcome-based):
# RESCUE_STALL_ITERS non-improving iterations, a >100x regression of the
# convergence measure, a gap collapse with residuals >10x feastol, or a
# refinement round that expands the residual (relres > RESCUE_RELRES).
RESCUE_STALL_ITERS = 4
RESCUE_RELRES = 1.0

STATUS_STRINGS = {
    STATUS_OPTIMAL: "optimal",
    STATUS_PRIMAL_INFEASIBLE: "primal infeasible",
    STATUS_DUAL_INFEASIBLE: "dual infeasible",
    STATUS_UNKNOWN_MAXITERS: "unknown",
    STATUS_UNKNOWN_SINGULAR: "unknown",
    STATUS_STALLED: "unknown",
}

# step and centering exponent (coneprog.py:423-424)
STEP = 0.99
EXPON = 3


def _run_loop(st, body, syncs):
    """Iterate `body` while any instance is running; instances that are
    not keep their state."""
    while True:
        running = st["status"] == STATUS_RUNNING
        syncs[0] += 1
        if not bool(running.any()):        # the one host sync per pass
            return st
        new = body(st)
        st = {k: _where(running, new[k], st[k]) for k in st}


def _restart_state(st1, state0, keys, maxiters):
    """Second-phase state of the two-phase rescue: the instances phase 1
    flagged restart from `state0` with a fresh iteration budget."""
    it1 = st1["iters"]
    was64 = st1["status"] == STATUS_NEEDS_F64
    st2 = dict(st1)
    for k in keys:
        st2[k] = _where(was64, state0[k], st1[k])
    st2["status"] = torch.where(
        was64, STATUS_RUNNING, st1["status"]).to(torch.int32)
    st2["stall"] = torch.zeros_like(st1["stall"])
    st2["best_m"] = torch.full_like(st1["best_m"], float("inf"))
    st2["max_it"] = torch.where(was64, it1 + maxiters,
                                st1["max_it"]).to(torch.int32)
    return st2


def rescue_compacted(raw, out_keys, run_batch, dev):
    """Phase C of the cascades: gather the instances whose status is
    NEEDS_F64 into batches padded to a power of two (the first straggler
    repeated in the padding lanes), solve each with ``run_batch(index
    tensor)`` and scatter `out_keys` back into `raw`.  Sets
    ``raw['rescue_iterations']``, adds it to ``raw['iterations']`` and
    returns the number of flagged instances."""
    status = raw["status"].cpu().numpy()
    (flagged,) = np.nonzero(status == STATUS_NEEDS_F64)
    raw["rescue_iterations"] = torch.zeros_like(raw["iterations"])
    if not flagged.size:
        return 0
    nb = status.shape[0]
    R = min(1 << max(int(np.ceil(np.log2(flagged.size))), 0), nb)
    resc = np.zeros((nb,), np.int32)
    for k0 in range(0, flagged.size, R):
        part = flagged[k0:k0 + R]
        idx = np.full((R,), part[0], dtype=np.int64)
        idx[:part.size] = part
        sub = run_batch(torch.as_tensor(idx, device=dev))
        dst_np, src_np = np.unique(idx, return_index=True)
        src = torch.as_tensor(src_np, device=dev)
        dst = torch.as_tensor(dst_np, device=dev)
        for k in out_keys:
            raw[k] = raw[k].clone()
            raw[k][dst] = sub[k][src]
        resc[dst_np] = sub["iterations"].cpu().numpy()[src_np]
    raw["rescue_iterations"] = torch.as_tensor(resc, device=dev)
    raw["iterations"] = raw["iterations"] + raw["rescue_iterations"]
    return int(flagged.size)


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
    e_lq = e[:dims.lnl + dims.qdim]
    kw = dict(dtype=dtype, device=dev)
    ikw = dict(dtype=torch.int32, device=dev)

    resx0 = torch.clamp(_tnorm(c), min=1.0)
    resy0 = torch.clamp(_tnorm(b), min=1.0)
    resz0 = torch.clamp(cones.snrm2(h, dims), min=1.0)

    # ---- initial points (coneprog.py:662-845) ------------------------
    # the cold point is also computed when a restart phase exists:
    # restarts must be cold (restarting from a warm start re-enters the
    # warm-start pathology)
    cold = None
    warm = primalstart is not None and dualstart is not None
    if not warm or factor64 is not None or detect_rescue:
        f0 = factor(nt.identity_scaling(dims, dtype=dtype, device=dev,
                                        batch=(Bsz,)))
        # solve [0 A' G'; A 0 0; G 0 -I][x;dy;-s] = [0;b;h]
        xc, _, ms = f0(_tzeros(c), b, h)
        sc = -ms
        nrms = cones.snrm2(sc, dims)
        ts = cones.max_step(sc, dims)
        sc = torch.where(_col(ts >= -1e-8 * torch.clamp(nrms, min=1.0)),
                         sc + _col(1.0 + ts) * e, sc)
        # solve [...][dx;y;z] = [-c;0;0]
        _, yc, zc = f0(_tneg(c), _tzeros(b), torch.zeros_like(h))
        nrmz = cones.snrm2(zc, dims)
        tz = cones.max_step(zc, dims)
        zc = torch.where(_col(tz >= -1e-8 * torch.clamp(nrmz, min=1.0)),
                         zc + _col(1.0 + tz) * e, zc)
        cold = (xc, yc, sc, zc)

    def start(d, k):
        return _tmap(lambda u: u.to(dtype).expand((Bsz,) + u.shape[1:]),
                     d[k])

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
        valid = (torch.isfinite(_tdot(x, x)) & torch.isfinite(_tdot(y, y))
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
        sigs, sigz = sig2[0], sig2[1]
        ds_q, dz_q = dq2[0], dq2[1]
        tt = -dtau / lg
        tk = -dkappa / lg
        step = torch.where(t == 0.0, 1.0, torch.clamp(STEP / t, max=1.0))

        # ---- update (coneprog.py:1336-1436) --------------------------
        x = _taxpy(step, dx, x)
        y = _taxpy(step, dy, y)

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

        dg2 = dg * torch.sqrt(1.0 - step * tk) / torch.sqrt(1.0 - step * tt)
        dgi2 = 1.0 / dg2
        lg2 = lg * torch.sqrt(1.0 - step * tt) * torch.sqrt(1.0 - step * tk)

        # unscale s, z from lambda (coneprog.py:1413-1433)
        lam_full = cones.diag_embed(lmbda2, dims)
        s2 = nt.scale(lam_full, W2, dims, trans="T")
        z2 = nt.scale(lam_full, W2, dims, inverse="I")

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


def _tensors(dev, *arrays, dtype=None):
    return tuple(torch.as_tensor(a, device=dev, dtype=dtype)
                 for a in arrays)


def _lp_maps(G, A):
    """Batched linear-map closures for G, A (dense or operator-form)."""
    Gf, GTf = _operator_maps(G)
    Af, ATf = _operator_maps(A)
    return dict(Gf=Gf, GTf=GTf, Af=Af, ATf=ATf)


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


def _unbatch(raw):
    """One instance's results: tensors and trees of tensors lose the
    batch axis, anything else (counters) stays."""
    return {k: (_take(v, 0) if torch.is_tensor(_leaves(v)[0]) else v)
            for k, v in raw.items()}


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
    restart cold in phase B.  Total `iterations` counts all phases.
    With ``instrument`` the result holds per-phase wall seconds and
    iteration sums under ``profile``."""
    dev = resolve_device(device)
    kktsolver, refinement = _resolve_opts(dims, kktsolver, refinement)
    f32 = torch.float32
    tols = dict(maxiters=maxiters, abstol=abstol, reltol=reltol,
                feastol=feastol, kktreg=kktreg, device=dev)

    phase_a = make_conelp(
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

    out_keys = ("x", "y", "s", "z", "status", "gap", "relgap",
                "pcost", "dcost", "pres", "dres", "pinfres",
                "dinfres", "primal_slack", "dual_slack")

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def solve(c, G, h, A, b):
        c, G, h, A, b = _tensors(dev, c, G, h, A, b)
        dt = c.dtype
        prof = {}
        t0 = time.perf_counter()
        raw_a = phase_a(*(u.to(f32) for u in (c, G, h, A, b)))
        if instrument:
            _sync()
            prof["a_iters"] = int(raw_a["iterations"].sum())
            prof["a_s"] = time.perf_counter() - t0
            prof["a_host_syncs"] = raw_a["host_syncs"]
        # instances phase A could not finish hand over garbage
        # iterates: poison them with NaN so that the warm-start validity
        # check sends them straight to the cold start
        ok_a = raw_a["status"] == STATUS_OPTIMAL
        nanv = torch.full((), float("nan"), dtype=dt, device=dev)
        x0, y0, z0 = (torch.where(ok_a[:, None], raw_a[k].to(dt), nanv)
                      for k in ("x", "y", "z"))
        t0 = time.perf_counter()
        raw = dict(phase_b(c, G, h, A, b, x0, y0, z0))
        if instrument:
            _sync()
            prof["b_iters"] = int(raw["iterations"].sum())
            prof["b_s"] = time.perf_counter() - t0
            prof["b_host_syncs"] = raw["host_syncs"]
        raw["iterations"] = raw["iterations"] + raw_a["iterations"]
        raw["phase1_iterations"] = raw_a["iterations"]

        t0 = time.perf_counter()

        def run_c(ii):
            if shared_GhAb:
                return phase_c(c[ii], G, h, A, b)
            return phase_c(c[ii], G[ii], h[ii], A[ii], b[ii])

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


def _prep_inputs(c, G, h, dims, A, b, dtype=torch.float64, device="cuda",
                 allow_ops=False):
    """Single-problem inputs as tensors: c (n,), G (cdim, n), h (cdim,),
    A (p, n), b (p,), with 's' rows symmetrized from their column-major
    lower triangles.  With ``allow_ops`` (a user kktsolver is given), G
    and A may be operators and c a dict of blocks; they pass through
    (c's leaves as tensors).  Without, either raises ValueError, as in
    the JAX package."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    if isinstance(c, dict):
        if not allow_ops:
            raise ValueError("pytree-valued c requires operator-form "
                             "G/A and a custom kktsolver")
        c = _tmap(lambda u: torch.as_tensor(u, **kw), c)
        n = sum(u.numel() for u in _leaves(c))
    else:
        c = torch.as_tensor(c, **kw).reshape(-1)
        n = c.shape[0]
    G_op, A_op = _is_operator(G), _is_operator(A)
    if (G_op or A_op) and not allow_ops:
        raise ValueError("use of operator-form G/A requires a "
                         "user-provided kktsolver")
    h = torch.as_tensor(h, **kw).reshape(-1)
    if dims is None:
        dims = ConeDims(l=h.shape[0])
    elif isinstance(dims, dict):
        dims = ConeDims.from_dict(dims)
    if h.shape[0] != dims.cdim:
        raise TypeError(f"'h' must have length {dims.cdim}")
    if not G_op:
        G = torch.as_tensor(G, **kw).reshape(-1, n)
        if G.shape[0] != dims.cdim:
            raise TypeError(f"'G' must have {dims.cdim} rows")
        G = cones.symmetrize_lower(G.transpose(0, 1), dims).transpose(0, 1)
    if A is None:
        A = torch.zeros((0, n), **kw)
        A_op = False
    elif not A_op:
        A = torch.as_tensor(A, **kw).reshape(-1, n)
    if b is None:
        b = torch.zeros((0 if A_op else A.shape[0],), **kw)
    else:
        b = torch.as_tensor(b, **kw).reshape(-1)
    h = cones.symmetrize_lower(h, dims)
    return c, G, h, dims, A, b


def _start_values(d, keys, dims, dtype, dev, tree=False):
    """A warm-start dict as batched (B = 1) tensors; 's' and 'z' are
    symmetrized and must lie in the interior of the cone.  With `tree`,
    'x' is a dict of blocks like c."""
    if d is None:
        return None
    out = {}
    for k in keys:
        if k not in d:
            continue
        if tree and k == "x":
            out[k] = _tmap(lambda u: torch.as_tensor(
                u, dtype=dtype, device=dev).unsqueeze(0), d[k])
            continue
        v = torch.as_tensor(d[k], dtype=dtype, device=dev).reshape(1, -1)
        if k in ("s", "z"):
            v = cones.symmetrize_lower(v, dims)
            if float(cones.max_step(v, dims)[0]) >= 0:
                raise ValueError(f"initial {k} is not positive")
        out[k] = v
    return out


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
    returns None."""
    status = int(raw["status"])
    sstr = STATUS_STRINGS.get(status, "unknown")

    def opt(v, none_statuses):
        return None if status in none_statuses else v

    def fin(v):
        v = float(v)
        return None if (v != v or abs(v) == float("inf")) else v

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
        "iterations": int(raw["iterations"]),
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
