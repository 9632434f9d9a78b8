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

import contextlib
from typing import Optional

import torch

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch import scaling as nt
from cvxopt_tpu_torch import kkt as kktmod
from cvxopt_tpu_torch import ipm
from cvxopt_tpu_torch import ipm_graph
from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.ops.matvec import mv, vdot
from cvxopt_tpu_torch.trace import span, spanned
from cvxopt_tpu_torch.ipm import (
    STATUS_RUNNING, STATUS_OPTIMAL, STATUS_UNKNOWN_MAXITERS,
    STATUS_UNKNOWN_SINGULAR, STATUS_NEEDS_F64, STATUS_STRINGS,
    STEP, EXPON, RESCUE_STALL_ITERS, RESCUE_RELRES, _prep_inputs,
    _run_loop, _running, _restart_state, _tensors, _unbatch, _lp_maps,
    _start_values,
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
                  debug=False, tape=None):
    """The coneqp algorithm on a batch (q: (B, n); h, b: shared or
    batched) with all linear maps as closures on batched vectors.  With
    an `ipm_graph.Tape` (single-phase only) the passes replay it: the
    inputs the maps, the factor and q, h, b read are the tape's pinned
    ones, and the values computed here that a pass reads are pinned.

    A pass steps the running instances and then tests the new point's
    exit, and the start tests the initial point, so the one status read
    before each pass already sees every instance that is done: the loop
    factors only for steps it takes."""
    Bsz = q.shape[0]
    dev = q.device
    conic = bool(dims.q or dims.s)

    def cone_span(what):
        # the cone layer's spans open on 'q'/'s' dims only, so that an
        # 'l'-only trace keeps its span set
        return span("cvx.cone." + what) if conic else contextlib.nullcontext()

    h = h.expand(Bsz, h.shape[-1])
    b = b.expand(Bsz, b.shape[-1])
    e = ipm_graph.pin(tape, "e", cones.cone_identity(dims, dtype=dtype,
                                                     device=dev))

    resx0, resy0, resz0 = (ipm_graph.pin(tape, k, torch.clamp(r, min=1.0))
                           for k, r in (
        ("resx0", torch.linalg.vector_norm(q, dim=-1)),
        ("resy0", torch.linalg.vector_norm(b, dim=-1)),
        ("resz0", cones.snrm2(h, dims))))

    def _measure(pres, dres, gap, relgap):
        """The convergence measure of a point (1 at the tolerances)."""
        return torch.maximum(torch.maximum(pres, dres) / feastol,
                             torch.minimum(gap / abstol, relgap / reltol))

    def _evaluate(st, rescue):
        """st with the residuals, costs and exit status of its point
        (coneprog.py:2169-2204): RUNNING, or the code it exits with."""
        x, y, s, z, gap = st["x"], st["y"], st["s"], st["z"], st["gap"]
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

        optimal = ((pres <= feastol) & (dres <= feastol)
                   & ((gap <= abstol) | (relgap <= reltol)))
        maxed = st["iters"] >= st["max_it"]

        m = _measure(pres, dres, gap, relgap)
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

        status = torch.full_like(st["status"], STATUS_RUNNING)
        status = torch.where(stalled, STATUS_NEEDS_F64, status)
        status = torch.where(maxed, STATUS_UNKNOWN_MAXITERS, status)
        status = torch.where(optimal, STATUS_OPTIMAL, status)
        return dict(st, rx=rx, ry=ry, rz=rz, pcost=pcost, dcost=dcost,
                    relgap=relgap, pres=pres, dres=dres, best_m=best2,
                    stall=stall2.to(torch.int32), status=status)

    def _progress(st):
        for k in range(Bsz):
            print(f"{int(st['iters'][k]):2d}: {float(st['pcost'][k]): 8.4e} "
                  f"{float(st['dcost'][k]): 8.4e} {float(st['gap'][k]): 4.0e} "
                  f"{float(st['pres'][k]):7.0e} {float(st['dres'][k]):7.0e}")

    syncs = [0]

    # ---- initial point (coneprog.py:2044-2149) -----------------------
    with span("cvx.ipm.start"):
        warm = valid = None
        need_cold = (initvals is None or factor_W64 is not None
                     or detect_rescue)
        if initvals is not None:
            def iv(k, default):
                v = initvals.get(k)
                v = default if v is None else v
                return v.to(dtype).expand(Bsz, default.shape[-1])
            warm = (iv("x", q.new_zeros((Bsz, n))),
                    iv("y", q.new_zeros((Bsz, p))),
                    iv("s", e.expand(Bsz, e.shape[0])),
                    iv("z", e.expand(Bsz, e.shape[0])))
        if warm is not None and need_cold:
            # per-instance warm-start validation: non-finite or
            # non-interior warm starts restart from the cold point
            x, y, s, z = warm
            with cone_span("step"):
                tsz_w = cones.max_step(torch.stack([s, z]), dims)
            valid = (torch.isfinite(x.sum(-1)) & torch.isfinite(y.sum(-1))
                     & (tsz_w[0] < 0) & (tsz_w[1] < 0))
            if "_valid" in initvals:
                valid = valid & initvals["_valid"]
            if factor_W64 is None:
                # without a restart phase the cold point serves only the
                # invalid warm starts: build it only if there is one
                syncs[0] += 1
                with span("cvx.ipm.sync"):
                    need_cold = not bool(valid.all())
            ipm_graph.COUNTS["cold_starts" if need_cold
                             else "cold_skips"] += 1
        cold = None
        if need_cold:
            f0 = factor_W(nt.identity_scaling(dims, dtype=dtype,
                                              device=dev, batch=(Bsz,)))
            xc, yc, zc = f0(-q, b, h)
            sc = -zc
            with cone_span("step"):
                ts = cones.max_step(sc, dims)
            with cone_span("step"):
                tz = cones.max_step(zc, dims)
            cold = (xc, yc, cones.push_interior(sc, ts, e, dims),
                    cones.push_interior(zc, tz, e, dims))
        if warm is None:
            x, y, s, z = cold
        elif cold is None:
            x, y, s, z = warm
        else:
            x, y, s, z = (_where(valid, u, c) for u, c in zip(warm, cold))

        def _mkstate(x_, y_, s_, z_):
            with cone_span("scaling"):
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
        # the first status read sees the instances the start point ends
        state = _evaluate(state, detect_rescue or factor_W64 is not None)
        if show_progress:
            _progress(state)

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
                # failure detector (ipm.RESCUE_RELRES)
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
        with cone_span("step"):
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
        with cone_span("step"):
            tsz, sig2, dq2 = cones.max_step_eig(
                torch.stack([ds_sc, dz_sc]), dims)
        t = torch.clamp(torch.maximum(tsz[0], tsz[1]), min=0.0)
        step = torch.where(t == 0.0, 1.0, torch.clamp(STEP / t, max=1.0))

        # ---- update -------------------------------------------------
        x = x + _col(step) * dx
        y = y + _col(step) * dy

        ds2, dz2 = nt.update_args(lmbda, dq2, sig2, step, e, dims)
        with cone_span("scaling"):
            W2, lmbda2 = nt.update_scaling(W, lmbda, ds2, dz2, dims)

        s2, z2 = nt.unscale(lmbda2, W2, dims)
        gap2 = vdot(lmbda2, lmbda2)
        return x, y, s2, z2, W2, lmbda2, gap2, torch.maximum(rr1, rr2)

    def _body(st, fW, rescue):
        """One step from st's point, then the exit test of the new one."""
        upd = _iteration(fW, st["x"], st["y"], st["s"], st["z"], st["W"],
                         st["lmbda"], st["gap"], st["rx"], st["ry"],
                         st["rz"])
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
                m = _measure(st["pres"], st["dres"], st["gap"],
                             st["relgap"])
                fail = fail | ((relres > RESCUE_RELRES) & (m > 100.0))
            fail_status = STATUS_NEEDS_F64
        else:
            fail_status = STATUS_UNKNOWN_SINGULAR

        new = _evaluate(dict(st, x=x2, y=y2, s=s2, z=z2, W=W2,
                             lmbda=lmbda2, gap=gap2,
                             iters=st["iters"] + 1), rescue)
        # a failed step is discarded: the instance keeps its point and
        # its evaluation, and exits with the failure's status
        out = {k: _where(fail, st[k], new[k]) for k in st}
        out["status"] = torch.where(fail, fail_status, new["status"]).to(
            torch.int32)
        if show_progress and bool((_running(st) & ~fail).any()):
            _progress(out)
        return out

    if factor_W64 is None:
        final = _run_loop(state,
                          lambda st: _body(st, factor_W, detect_rescue),
                          syncs, tape)
        rescue_iters = torch.zeros_like(final["iters"])
    else:
        # phase 1: mixed-precision factor with failure detection;
        # phase 2: full-precision factor for the instances phase 1
        # could not finish, restarted from the initial point
        st1 = _run_loop(state, lambda st: _body(st, factor_W, True), syncs)
        st2 = _restart_state(st1, state0, ("x", "y", "s", "z", "W",
                                           "lmbda", "gap"), maxiters)
        # the restarted instances enter the loop with their point's status
        restarted = _running(st2)
        st2 = _where(restarted, _evaluate(st2, False), st2)
        final = _run_loop(st2, lambda st: _body(st, factor_W64, False),
                          syncs)
        rescue_iters = final["iters"] - st1["iters"]
    with cone_span("step"):
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
    Runs on `device` ("cuda" unless the caller asks for the CPU).  From
    its second call at one set of shapes, a solve on the card replays its
    IPM passes from CUDA graphs (`ipm_graph`) where the kktsolver is
    `kkt.capturable`, ``factor_dtype`` is not 'rescue' and nothing is
    printed."""
    dev = resolve_device(device)
    kktsolver, refinement = _resolve_qp_opts(dims, kktsolver,
                                             refinement)
    tapes = ipm_graph.Tapes(dev)
    taped = (factor_dtype != "rescue" and not (show_progress or debug)
             and kktmod.capturable(kktsolver, dims, factor_dtype))

    def core(P, q, G, h, A, b, initvals=None):
        q, = _tensors(dev, q)
        P, G, h, A, b = _tensors(dev, P, G, h, A, b, dtype=q.dtype)
        tape = tapes.get("qp", (P, q, G, h, A, b), taped)
        P, q, G, h, A, b = (ipm_graph.pin(tape, k, u) for k, u in
                            zip("PqGhAb", (P, q, G, h, A, b)))
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
        factor = ipm_graph.once(tape, "factor", lambda: kktmod.get_kktsolver(
            fname, G, dims, A, kktreg=kktreg, factor_dtype=fd))
        Pw = kktmod.wrap_P(fname, P, factor_dtype=(
            fd if fd == "float32" else None))
        raw = _coneqp_solve(
            dims, factor_W=lambda W: factor(W, Pw),
            factor_W64=factor_W64,
            **ipm_graph.once(tape, "maps", lambda: _maps(P, G, A)),
            q=q, h=h, b=b, n=n, p=A.shape[-2], dtype=q.dtype,
            maxiters=maxiters, abstol=abstol, reltol=reltol,
            feastol=feastol, refinement=refinement,
            correction=correction, show_progress=show_progress,
            debug=debug, initvals=initvals, tape=tape,
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

    The phases run in `ipm.cascade`: total `iterations` counts all phases,
    ``instrument`` adds the ``profile``, and the phases are also
    reachable as ``solve.phase_a``, ``solve.phase_b`` and
    ``solve.phase_c``.  Phase A hands phase B its iterates as
    ``initvals``, marked invalid (``_valid``) where it did not finish.

    On the card each phase replays its IPM passes from CUDA graphs from
    its second call at one set of shapes on, where its kktsolver is
    `kkt.capturable`: a phase then copies its inputs into buffers of its
    tape and builds its kktsolver and maps over them once."""
    dev = resolve_device(device)
    kktsolver, refinement = _resolve_qp_opts(dims, kktsolver,
                                             refinement)
    mixed_ok = not (dims.q or dims.s)
    refinement_b = max(1, refinement) if mixed_ok else max(2, refinement)
    bname = kktsolver if mixed_ok else "cholqr_inv"
    rname = kktmod.robust_name(kktsolver)
    f32 = torch.float32
    tapes = ipm_graph.Tapes(dev)

    def setup(phase, name, fdt, ins, dtype=None):
        """A phase's P (cast to `dtype`), kktsolver and keyword arguments
        of `_coneqp_solve`, over its tape's pinned inputs where one
        engages."""
        tape = tapes.get(phase, ins, kktmod.capturable(name, dims, fdt))
        P, q, G, h, A, b = (ipm_graph.pin(tape, k, u, dtype)
                            for k, u in zip("PqGhAb", ins))
        factor = ipm_graph.once(tape, "factor", lambda: kktmod.get_kktsolver(
            name, G, dims, A, kktreg=kktreg, factor_dtype=fdt))
        kw = ipm_graph.once(tape, "kw", lambda: dict(
            **_maps(P, G, A), q=q, h=h, b=b, n=q.shape[-1], p=A.shape[-2],
            dtype=q.dtype, maxiters=maxiters, correction=correction,
            show_progress=False, tape=tape))
        return P, factor, kw

    def phase_a(P, q, G, h, A, b):
        P1, factor_a, kw = setup("a", kktsolver, None, (P, q, G, h, A, b),
                                 f32)
        raw = _coneqp_solve(
            dims, factor_W=lambda W: factor_a(W, P1), **kw,
            abstol=max(phase1_tol, abstol),
            reltol=max(phase1_tol, reltol),
            feastol=max(phase1_tol, feastol), refinement=0)
        keys = ("x", "y", "s", "z", "iterations", "status", "host_syncs")
        return {k: raw[k] for k in keys}

    def phase_b(P, q, G, h, A, b, iv):
        P, factor_b, kw = setup("b", bname, "float32", (P, q, G, h, A, b))
        Pb = kktmod.wrap_P(bname, P, factor_dtype="float32")
        return _coneqp_solve(
            dims, factor_W=lambda W: factor_b(W, Pb), detect_rescue=True,
            **kw, abstol=abstol, reltol=reltol, feastol=feastol,
            refinement=refinement_b, initvals=iv, refine_pred=False,
            relres_trigger=mixed_ok)

    def phase_c(P, q, G, h, A, b):
        P, f64fac, kw = setup("c", rname, None, (P, q, G, h, A, b))
        P64 = kktmod.wrap_P(rname, P)
        return _coneqp_solve(
            dims, factor_W=lambda W: f64fac(W, P64), **kw,
            abstol=abstol, reltol=reltol, feastol=feastol,
            refinement=max(1, refinement))

    def handoff(raw_a, args):
        iv = {k: raw_a[k].to(args[0].dtype) for k in ("x", "y", "s", "z")}
        iv["_valid"] = raw_a["status"] == STATUS_OPTIMAL
        return (iv,)

    out_keys = ("x", "y", "s", "z", "status", "gap", "relgap",
                "pcost", "dcost", "pres", "dres", "primal_slack",
                "dual_slack")
    return ipm.cascade(phase_a, phase_b, phase_c, handoff, out_keys,
                       2 if shared_GhAb else 6, instrument, dev)


@spanned("cvx.frontend.coneqp")
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
    """Reference result-dict format for coneqp (coneprog.py:2229-2234).
    Each read of a device value is a `cvx.frontend.sync` span."""
    with span("cvx.frontend.sync"):
        status = int(raw["status"])

    def fin(v):
        with span("cvx.frontend.sync"):
            v = float(v)
        return None if (v != v or abs(v) == float("inf")) else v

    with span("cvx.frontend.sync"):
        iterations = int(raw["iterations"])

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
        "iterations": iterations,
    }
