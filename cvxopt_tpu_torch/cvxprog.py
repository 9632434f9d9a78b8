"""Nonlinear convex solvers cpl, cp and gp in PyTorch.

Twin of `cvxopt_tpu/cvxprog.py`:

  cpl: minimize c'x  s.t.  f(x) <= 0, G x <= h (cone), A x = b
       with f: R^n -> R^mnl convex and twice differentiable;
  cp:  minimize f0(x) s.t. fk(x) <= 0, ... by its epigraph form in cpl;
  gp:  a geometric program in convex (log) form, one log-sum-exp per
       posynomial.

The user supplies f as a torch function of ONE instance, x (n,) ->
(mnl,), that is functional (no in-place ops, no ``.item()``, no data-
dependent Python control flow) and returns NaN outside its domain (as
``torch.log`` of a negative number does).  The gradient Df and the
Hessian H(x, z) = sum_k z_k nabla^2 f_k(x) come from ``torch.func``
(`jacfwd`, `hessian`; `jvp`, `vjp` and jvp-of-grad in the matrix-free
mode), each vmapped over the batch.

`make_cpl` is batched like `coneqp.make_coneqp`: every tensor carries a
leading batch axis (G, h, A, b may be shared), and the JAX package's
five `lax.while_loop`s become batched loops.  The main loop runs while
any instance is running, and instances that are not keep their state
through ``torch.where``.  The predictor line search, the domain
backtracking and the two backtracking searches of the corrector run
with a per-instance ``done`` mask: an instance keeps its first accepted
step, instances that are not live (finished, or exiting this pass)
start done, and every instance is capped at MAX_LS_ITERS trials.  Each
trip of a search and each pass of the main loop tests its mask on the
host: one host sync each, counted in the result's ``host_syncs``.

Status codes: 0 optimal, 3 unknown (maxiters), 4 unknown (singular).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch import scaling as nt
from cvxopt_tpu_torch import kkt as kktmod
from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.ops.matvec import mv, mvt, vdot
from cvxopt_tpu_torch.conelp import (
    STATUS_RUNNING, STATUS_OPTIMAL, STATUS_UNKNOWN_MAXITERS,
    STATUS_UNKNOWN_SINGULAR, STATUS_STRINGS, _run_loop, _unbatch,
)
from cvxopt_tpu_torch._tree import _col, _where, _per_instance_factor

# constants (cvxprog.py:384-388)
STEP = 0.99
BETA = 0.5
ALPHA = 0.01
EXPON = 3
MAX_RELAXED_ITERS = 8
MAX_LS_ITERS = 40


def _derivatives(f, matrix_free):
    """Batched maps of f of one instance: (fB, DfB, HB) and, in the
    matrix-free mode, (Df_mv, Df_rmv, H_mv) instead of DfB and HB."""
    tf = torch.func
    fB = tf.vmap(f)

    def lagr(znl):
        return lambda u: (znl * f(u)).sum()

    if matrix_free:
        Df_mv = tf.vmap(lambda x, u: tf.jvp(f, (x,), (u,))[1])
        Df_rmv = tf.vmap(lambda x, v: tf.vjp(f, x)[1](v)[0])
        H_mv = tf.vmap(lambda x, znl, u: tf.jvp(
            tf.grad(lagr(znl)), (x,), (u,))[1])
        return fB, None, None, (Df_mv, Df_rmv, H_mv)
    DfB = tf.vmap(tf.jacfwd(f))
    HB = tf.vmap(lambda x, znl: tf.hessian(lagr(znl))(x))
    return fB, DfB, HB, None


def _backtrack(step, done, accept, syncs):
    """Per-instance backtracking: each instance that is not done tries
    its step, keeps it when `accept(step)` holds there and halves it
    otherwise, for at most MAX_LS_ITERS trials.  One host sync per
    trip."""
    for _ in range(MAX_LS_ITERS):
        syncs[0] += 1
        if bool(done.all()):
            break
        acc = accept(step)
        act = ~done
        step = torch.where(act & ~acc, step * BETA, step)
        done = done | (act & acc)
    return step


def make_cpl(dims: ConeDims, f: Callable, kktsolver="default",
             maxiters: int = 100, abstol: float = 1e-7,
             reltol: float = 1e-6, feastol: float = 1e-7,
             refinement: int = 1, kktreg: Optional[float] = None,
             max_relaxed: int = MAX_RELAXED_ITERS,
             show_progress: bool = False, matrix_free: bool = False,
             factor_dtype: Optional[str] = None, device="cuda"):
    """Build the batched cpl core: g(c, x0, G, h, A, b) -> result dict
    of tensors.

    c and x0 are (B, n) or (n,); G (m, n) or (B, m, n); h (m,) or
    (B, m); A (p, n) or (B, p, n); b (p,) or (B, p).  The batch size is
    the largest leading axis given; when no argument has one, the
    results drop the batch axis.  `dims.mnl` must equal the output
    length of `f`, a functional torch map of one instance (n,) ->
    (mnl,) that is NaN outside its domain.  The working dtype is c's.
    Runs on `device` ("cuda" unless the caller asks for the CPU).

    ``kktsolver`` names a strategy of `kkt.get_kktsolver` ('default' is
    'chol') or is a callable ``kktsolver(x, znl, W) -> solve(bx, by,
    bz)`` of one unbatched instance (cvxprog.py:518-537), which then
    evaluates f, Df and H itself.  A callable runs once per instance in
    a Python loop, at every factor and every solve: right for the one
    problem of the `cpl`/`cp` front doors, but at B = 1024 it costs
    about 1024 Python calls each time; a large batch wants a named
    strategy.  ``matrix_free=True`` never forms Df
    or H: every Df u, Df' v and H u is a jvp, vjp or Hessian-vector
    product of `f`; it requires a callable kktsolver.  The result holds
    the passes of the main loop (``passes``) and all host syncs
    (``host_syncs``)."""
    assert dims.mnl > 0, "cpl requires a nonlinear block (dims.mnl > 0)"
    dev = resolve_device(device)
    custom_kkt = callable(kktsolver)
    if matrix_free and not custom_kkt:
        raise ValueError(
            "matrix_free=True (operator-form Df/H) requires a custom "
            "kktsolver callable, as in the reference")
    if kktsolver == "default":
        kktsolver = "chol"
    fB, DfB, HB, mf_maps = _derivatives(f, matrix_free)
    if matrix_free:
        Df_mv, Df_rmv, H_mv = mf_maps
    mnl = dims.mnl
    nlq = dims.lnl + dims.qdim

    def core(c, x0, G, h, A, b):
        c = torch.as_tensor(c, device=dev)
        dtype = c.dtype
        x0, G, h, A, b = (torch.as_tensor(u, dtype=dtype, device=dev)
                          for u in (x0, G, h, A, b))
        lead = [u.shape[0] for u, r in ((c, 2), (x0, 2), (h, 2), (b, 2),
                                        (G, 3), (A, 3)) if u.dim() == r]
        single = not lead
        Bsz = max(lead, default=1)
        n = c.shape[-1]
        p = A.shape[-2]
        c, x0, h, b = (u.expand(Bsz, u.shape[-1]) for u in (c, x0, h, b))
        kw = dict(dtype=dtype, device=dev)
        e = cones.cone_identity(dims, dtype=dtype, device=dev)
        e_lq = e[:nlq]

        if custom_kkt:
            factor3 = _per_instance_factor(kktsolver)
        else:
            factor = kktmod.get_kktsolver(kktsolver, G, dims, A, mnl=mnl,
                                          kktreg=kktreg,
                                          factor_dtype=factor_dtype)

        def norm(v):
            return torch.linalg.vector_norm(v, dim=-1)

        def dftz_at(x, znl):
            if matrix_free:
                return Df_rmv(x, znl)
            return mvt(DfB(x), znl)

        # initial points (cvxprog.py:556-570): s = z = e
        x = x0
        y = torch.zeros((Bsz, p), **kw)
        s = e.expand(Bsz, dims.cdim)
        z = s
        W = nt.identity_scaling(dims, dtype=dtype, device=dev,
                                batch=(Bsz,))
        lmbda = cones.diag_part(e, dims).expand(Bsz, dims.cdim_diag)

        # scale factors fixed at iteration 0 (cvxprog.py:711-719)
        rx_init = c + mvt(A, y) + dftz_at(x0, z[:, :mnl]) \
            + mvt(G, z[:, mnl:])
        resx_init = norm(rx_init)
        resznl_init = norm(s[:, :mnl] + fB(x0))
        rzl_init = s[:, mnl:] + mv(G, x) - h
        pres_init = torch.sqrt(norm(mv(A, x) - b) ** 2 + resznl_init ** 2
                               + cones.sdot(rzl_init, rzl_init, dims))
        gap0 = cones.sdot(s, z, dims)
        pres0 = torch.clamp(pres_init, min=1.0)
        dres0 = torch.clamp(resx_init, min=1.0)
        theta1 = 1.0 / gap0
        theta2 = 1.0 / torch.clamp(resx_init, min=1.0)
        theta3 = 1.0 / torch.clamp(resznl_init, min=1.0)

        zero = torch.zeros((Bsz,), **kw)
        nan = torch.full((Bsz,), float("nan"), **kw)
        ikw = dict(dtype=torch.int32, device=dev)
        # placeholder saved line-search state (never read before the
        # first save; see the relaxed machinery in _iteration)
        zc = torch.zeros((Bsz, dims.cdim), **kw)
        zsd = torch.zeros((Bsz, dims.sdim_diag), **kw)
        saved0 = dict(
            phi=zero, dphi=zero, gap=zero, sigma=zero, dsdz=zero,
            step=torch.ones((Bsz,), **kw),
            x=x, y=y, s=s, z=z, W=W, lmbda=lmbda,
            dx=torch.zeros((Bsz, n), **kw), dy=y, ds2u=zc, dz2u=zc,
            dsq=zc, dzq=zc, sigs=zsd, sigz=zsd)
        state = dict(
            x=x, y=y, s=s, z=z, W=W, lmbda=lmbda,
            iters=torch.zeros((Bsz,), **ikw),
            status=torch.full((Bsz,), STATUS_RUNNING, **ikw),
            gap=gap0, pcost=nan, dcost=nan, relgap=nan, pres=nan,
            dres=nan, relaxed=torch.zeros((Bsz,), **ikw), saved=saved0)
        ls_syncs = [0]

        def body(st):
            x, y, s, z = st["x"], st["y"], st["s"], st["z"]
            W, lmbda = st["W"], st["lmbda"]
            iters = st["iters"]
            relaxed_in, saved_in = st["relaxed"], st["saved"]
            znl = z[:, :mnl]

            fx = fB(x)
            if matrix_free:
                Df, H = None, None
                dftz = Df_rmv(x, znl)
            else:
                Df = DfB(x)
                H = HB(x, znl)
                dftz = mvt(Df, znl)

            gap = cones.sdot(s, z, dims)

            # residuals (cvxprog.py:670-691)
            rx = c + mvt(A, y) + dftz + mvt(G, z[:, mnl:])
            resx = norm(rx)
            ry = mv(A, x) - b
            resy = norm(ry)
            rznl = s[:, :mnl] + fx
            resznl = norm(rznl)
            rzl = s[:, mnl:] + mv(G, x) - h
            reszl = torch.sqrt(cones.sdot(rzl, rzl, dims))

            pcost = vdot(c, x)
            dcost = pcost + vdot(y, ry) + vdot(znl, rznl) \
                + cones.sdot(z[:, mnl:], rzl, dims) - gap
            relgap = torch.where(
                pcost < 0.0, gap / -pcost,
                torch.where(dcost > 0.0, gap / dcost,
                            torch.full_like(gap, float("inf"))))
            pres = torch.sqrt(resy ** 2 + resznl ** 2 + reszl ** 2) / pres0
            dres = resx / dres0
            phi = theta1 * gap + theta2 * resx + theta3 * resznl

            if show_progress:
                for k in range(Bsz):
                    print(f"{int(iters[k]):2d}: {float(pcost[k]): 8.4e} "
                          f"{float(dcost[k]): 8.4e} {float(gap[k]): 4.0e} "
                          f"{float(pres[k]):7.0e} {float(dres[k]):7.0e}")

            optimal = ((pres <= feastol) & (dres <= feastol)
                       & ((gap <= abstol) | (relgap <= reltol)))
            maxed = iters >= maxiters
            new_status = torch.full_like(st["status"], STATUS_RUNNING)
            new_status = torch.where(maxed, STATUS_UNKNOWN_MAXITERS,
                                     new_status)
            new_status = torch.where(optimal, STATUS_OPTIMAL, new_status)
            exiting = new_status != STATUS_RUNNING
            live = (st["status"] == STATUS_RUNNING) & ~exiting

            x2, y2, s2, z2, W2, lmbda2, r_new, saved_new = _iteration(
                x, y, s, z, W, lmbda, gap, phi, rx, ry, rznl, rzl, resx,
                resznl, Df, H, relaxed_in, saved_in, live)

            gap2 = cones.sdot(s2, z2, dims)
            ok = (torch.isfinite(gap2) & torch.isfinite(lmbda2.sum(-1))
                  & torch.isfinite(x2.sum(-1)))
            # singular-KKT recovery during a relaxed series: restore
            # the saved state and retry with a standard line search
            # (cvxprog.py:785-820)
            if max_relaxed > 0:
                can_restore = ((~ok) & (relaxed_in > 0)
                               & (relaxed_in < max_relaxed) & ~exiting)
            else:
                can_restore = torch.zeros_like(ok)
            new_status = torch.where(
                exiting, new_status,
                torch.where(ok | can_restore, STATUS_RUNNING,
                            STATUS_UNKNOWN_SINGULAR).to(new_status.dtype))
            keep = exiting | (~ok)

            out = dict(st)
            out.update(gap=gap, pcost=pcost, dcost=dcost, relgap=relgap,
                       pres=pres, dres=dres, status=new_status)
            out["iters"] = iters + (~(keep | can_restore)).to(torch.int32)
            # the step's merge first, then the saved state over it
            for k, new in (("x", x2), ("y", y2), ("s", s2), ("z", z2),
                           ("W", W2), ("lmbda", lmbda2)):
                out[k] = _where(can_restore, saved_in[k],
                                _where(keep, st[k], new))
            out["relaxed"] = torch.where(
                exiting, relaxed_in,
                torch.where(can_restore, torch.full_like(relaxed_in, -1),
                            torch.where(ok, r_new, relaxed_in)))
            out["saved"] = _where(keep | can_restore, saved_in, saved_new)
            return out

        def _iteration(x, y, s, z, W, lmbda, gap, phi, rx, ry, rznl, rzl,
                       resx, resznl, Df, H, relaxed, saved, live):
            lmbdasq = cones.ssqr(lmbda, dims)
            znl = z[:, :mnl]
            if matrix_free:
                def Hmul(u):
                    return H_mv(x, znl, u)

                def DfT(v):
                    return Df_rmv(x, v)

                def Dfm(u):
                    return Df_mv(x, u)
            else:
                def Hmul(u):
                    return mv(H, u)

                def DfT(v):
                    return mvt(Df, v)

                def Dfm(u):
                    return mv(Df, u)
            if custom_kkt:
                f3 = factor3(x, znl, W)
            else:
                f3 = factor(W, H, Df)

            def f4_no_ir(bx, by_, bz, bs):
                # (cvxprog.py:858-883)
                us = cones.sinv(bs, lmbda, dims)
                uz = bz - nt.scale(us, W, dims, trans="T")
                ux, uy, uz = f3(bx, by_, uz)
                return ux, uy, uz, us - uz

            def resid4(ux, uy, uz, us, vx, vy, vz, vs):
                # (cvxprog.py:889-923)
                wz3 = nt.scale(uz, W, dims, inverse="I")
                vx = vx - Hmul(ux) - mvt(A, uy) - DfT(wz3[:, :mnl]) \
                    - mvt(G, wz3[:, mnl:])
                vy = vy - mv(A, ux)
                GGux = torch.cat([Dfm(ux), mv(G, ux)], dim=-1)
                vz = vz - GGux - nt.scale(us, W, dims, trans="T")
                vs = vs - cones.sprod_diag(us + uz, lmbda, dims)
                return vx, vy, vz, vs

            def f4(*rhs):
                u = f4_no_ir(*rhs)
                for _ in range(refinement):
                    du = f4_no_ir(*resid4(*u, *rhs))
                    u = tuple(a + d for a, d in zip(u, du))
                return u

            mu = gap / dims.cdim_diag
            lmbdasq_full = cones.diag_embed(lmbdasq, dims)
            rz_full = torch.cat([rznl, rzl], dim=-1)
            if max_relaxed > 0:
                relaxed_ok = (relaxed >= 0) & (relaxed < max_relaxed)
            else:
                relaxed_ok = torch.zeros_like(live)

            def compute_direction(sigma):
                ds_in = -lmbdasq_full + _col(sigma * mu) * e
                dx, dy, dz, ds = f4(-rx, -ry, -rz_full, ds_in)
                # unscaled steps for the line search (cvxprog.py:1031)
                pair = torch.stack([nt.scale2(lmbda, ds, dims),
                                    nt.scale2(lmbda, dz, dims)])
                tsz, sig2, dq2 = cones.max_step_eig(pair, dims)
                t = torch.clamp(torch.maximum(tsz[0], tsz[1]), min=0.0)
                return dict(
                    dx=dx, dy=dy, ds2u=nt.scale(ds, W, dims, trans="T"),
                    dz2u=nt.scale(dz, W, dims, inverse="I"),
                    dsq=dq2[0], dzq=dq2[1], sigs=sig2[0], sigz=sig2[1],
                    dsdz=cones.sdot(ds, dz, dims),
                    step0=torch.where(t == 0.0, 1.0,
                                      torch.clamp(STEP / t, max=1.0)))

            def eval_phi(ctx, step):
                st_ = _col(step)
                newx = ctx["x"] + st_ * ctx["dx"]
                newy = ctx["y"] + st_ * ctx["dy"]
                newz = ctx["z"] + st_ * ctx["dz2u"]
                news = ctx["s"] + st_ * ctx["ds2u"]
                newrx = c + mvt(A, newy) + dftz_at(newx, newz[:, :mnl]) \
                    + mvt(G, newz[:, mnl:])
                newresznl = norm(news[:, :mnl] + fB(newx))
                newgap = (1.0 - (1.0 - ctx["sigma"]) * step) \
                    * ctx["gap"] + step ** 2 * ctx["dsdz"]
                newphi = theta1 * newgap + theta2 * norm(newrx) \
                    + theta3 * newresznl
                return newgap, newphi

            # ---- predictor (i=0, cvxprog.py:966-1181) ----------------
            D0 = compute_direction(zero)
            ctx0 = dict(x=x, y=y, s=s, z=z, sigma=zero, gap=gap,
                        dsdz=D0["dsdz"], dx=D0["dx"], dy=D0["dy"],
                        ds2u=D0["ds2u"], dz2u=D0["dz2u"])

            def p_accept(step):
                newgap, newphi = eval_phi(ctx0, step)
                gap_cond = newgap <= (1.0 - ALPHA * step) * gap
                suff = newphi <= phi + ALPHA * step * (-phi)
                return gap_cond & (relaxed_ok | suff) \
                    & torch.isfinite(newphi)

            step_p = _backtrack(D0["step0"], ~live, p_accept, ls_syncs)
            newgap_p, _ = eval_phi(ctx0, step_p)
            sigma = torch.minimum(newgap_p / gap,
                                  (newgap_p / gap) ** EXPON)

            # ---- corrector (i=1) with the relaxed line-search state
            # machine (cvxprog.py:1081-1261) ---------------------------
            D1 = compute_direction(sigma)
            dphi_c = -theta1 * (1.0 - sigma) * gap - theta2 * resx \
                - theta3 * resznl
            cur = dict(
                phi=phi, dphi=dphi_c, gap=gap, sigma=sigma,
                dsdz=D1["dsdz"], step=D1["step0"],
                x=x, y=y, s=s, z=z, W=W, lmbda=lmbda,
                dx=D1["dx"], dy=D1["dy"], ds2u=D1["ds2u"],
                dz2u=D1["dz2u"], dsq=D1["dsq"], dzq=D1["dzq"],
                sigs=D1["sigs"], sigz=D1["sigz"])

            # domain backtracking (cvxprog.py:1052-1062): shrink until
            # f is defined at the trial point
            step_dom = _backtrack(
                D1["step0"], ~live,
                lambda st_: torch.isfinite(
                    fB(x + _col(st_) * D1["dx"])).all(-1), ls_syncs)
            cur["step"] = step_dom

            if max_relaxed > 0:
                _, newphi_d = eval_phi(cur, step_dom)
                fin = torch.isfinite(newphi_d)
                suff_cur = (newphi_d <= phi + ALPHA * step_dom * dphi_c) \
                    & fin
                suff_saved = (newphi_d <= saved["phi"] + ALPHA
                              * saved["step"] * saved["dphi"]) & fin

                r = relaxed
                save_now = (r == 0) & ~suff_cur
                use_saved = (r == max_relaxed) & ~suff_saved
                need_bt = use_saved | (r == -1)
                zeros_i = torch.zeros_like(r)
                r_new = torch.where(
                    r == 0, torch.where(suff_cur, zeros_i, zeros_i + 1),
                    torch.where(
                        (r > 0) & (r < max_relaxed),
                        torch.where(suff_saved, zeros_i, r + 1),
                        torch.where(
                            r == max_relaxed,
                            torch.where(suff_saved, zeros_i, zeros_i - 1),
                            zeros_i)))

                saved_new = _where(save_now, cur, saved)
                ctx_f = _where(use_saved, saved, cur)

                # standard backtracking (r == -1, or resumed after a
                # failed relaxed series) on the selected context
                def bt_accept(step):
                    _, newphi = eval_phi(ctx_f, step)
                    return (newphi <= ctx_f["phi"] + ALPHA * step
                            * ctx_f["dphi"]) & torch.isfinite(newphi)

                bt_start = torch.where(use_saved, saved["step"], step_dom)
                step_bt = _backtrack(bt_start, ~(need_bt & live),
                                     bt_accept, ls_syncs)
                step = torch.where(need_bt, step_bt, step_dom)
            else:
                # max_relaxed == 0: always standard backtracking
                def bt_accept0(step):
                    _, newphi = eval_phi(cur, step)
                    return (newphi <= phi + ALPHA * step * dphi_c) \
                        & torch.isfinite(newphi)

                step = _backtrack(step_dom, ~live, bt_accept0, ls_syncs)
                ctx_f = cur
                r_new = relaxed
                saved_new = saved

            # ---- update (cvxprog.py:1264-1355) on the (possibly
            # restored) context -----------------------------------------
            lmbda_f = ctx_f["lmbda"]
            W_f = ctx_f["W"]
            st_ = _col(step)
            x2 = ctx_f["x"] + st_ * ctx_f["dx"]
            y2 = ctx_f["y"] + st_ * ctx_f["dy"]

            ds2 = torch.cat([e_lq + st_ * ctx_f["dsq"][:, :nlq],
                             ctx_f["dsq"][:, nlq:]], dim=-1)
            dz2 = torch.cat([e_lq + st_ * ctx_f["dzq"][:, :nlq],
                             ctx_f["dzq"][:, nlq:]], dim=-1)
            ds2 = nt.scale2(lmbda_f, ds2, dims, inverse="I")
            dz2 = nt.scale2(lmbda_f, dz2, dims, inverse="I")

            if dims.s:
                lam_s = lmbda_f[:, nlq:]
                sig_s = (1.0 + st_ * ctx_f["sigs"]) / lam_s
                sig_z = (1.0 + st_ * ctx_f["sigz"]) / lam_s
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

            W2, lmbda2 = nt.update_scaling(W_f, lmbda_f, ds2, dz2, dims)
            lam_full = cones.diag_embed(lmbda2, dims)
            s2 = nt.scale(lam_full, W2, dims, trans="T")
            z2 = nt.scale(lam_full, W2, dims, inverse="I")
            return x2, y2, s2, z2, W2, lmbda2, r_new, saved_new

        passes = [0]
        final = _run_loop(state, body, passes)
        raw = dict(
            x=final["x"], y=final["y"], s=final["s"], z=final["z"],
            status=final["status"], iterations=final["iters"],
            gap=final["gap"], relgap=final["relgap"],
            pcost=final["pcost"], dcost=final["dcost"],
            pres=final["pres"], dres=final["dres"],
            primal_slack=-cones.max_step(final["s"], dims),
            dual_slack=-cones.max_step(final["z"], dims),
            passes=passes[0], host_syncs=passes[0] + ls_syncs[0])
        return _unbatch(raw) if single else raw

    return core


def _prep_nl(G, h, dims, A, b, n, mnl, dtype, dev):
    kw = dict(dtype=dtype, device=dev)
    if G is None:
        G = torch.zeros((0, n), **kw)
        h = torch.zeros((0,), **kw)
    G = torch.as_tensor(G, **kw).reshape(-1, n)
    h = torch.as_tensor(h, **kw).reshape(-1)
    if dims is None:
        dims = ConeDims(l=h.shape[0], mnl=mnl)
    elif isinstance(dims, dict):
        dims = ConeDims.from_dict(dims, mnl=mnl)
    elif dims.mnl != mnl:
        dims = ConeDims(l=dims.l, q=dims.q, s=dims.s, mnl=mnl)
    if A is None:
        A = torch.zeros((0, n), **kw)
    A = torch.as_tensor(A, **kw).reshape(-1, n)
    if b is None:
        b = torch.zeros((A.shape[0],), **kw)
    b = torch.as_tensor(b, **kw).reshape(-1)
    # symmetrize 's' rows (reference 'L'-storage read semantics)
    h = cones.symmetrize_lower(torch.cat([h.new_zeros(mnl), h]), dims)[mnl:]
    Gt = torch.cat([G.new_zeros((mnl, n)), G])
    G = cones.symmetrize_lower(Gt.T, dims).T[mnl:]
    return G, h, dims, A, b


def _nl_result(raw, mnl):
    """cpl/cp result dict (cvxprog.py:750-755): snl/sl/znl/zl split."""
    status = int(raw["status"])

    def fin(v):
        v = float(v)
        return None if (v != v or abs(v) == float("inf")) else v

    s, z = raw["s"], raw["z"]
    return {
        "status": STATUS_STRINGS.get(status, "unknown"),
        "x": raw["x"], "y": raw["y"],
        "snl": s[:mnl], "sl": s[mnl:],
        "znl": z[:mnl], "zl": z[mnl:],
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


def _opts(options):
    from cvxopt_tpu_torch.solvers import options as global_options
    opts = dict(global_options)
    if options:
        opts.update(options)
    return opts


def cpl(c, F, x0, G=None, h=None, dims=None, A=None, b=None,
        kktsolver=None, options=None, matrix_free=False, device="cuda"):
    """Solve min c'x s.t. F(x) <= 0 (componentwise, convex), Gx+s=h,
    Ax=b (cvxprog.py:35) in float64.  `F` is a functional torch map of
    one point, (n,) -> (mnl,), NaN outside its domain; `x0` must lie
    strictly in the domain.  ``kktsolver(x, znl, W)`` and
    ``matrix_free`` as in `make_cpl`."""
    opts = _opts(options)
    dev = resolve_device(device)
    dtype = torch.float64
    c = torch.as_tensor(c, dtype=dtype, device=dev).reshape(-1)
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev).reshape(-1)
    n = c.shape[0]
    fx0 = F(x0)
    mnl = int(fx0.shape[0])
    if not bool(torch.isfinite(fx0).all()):
        # reference: F() must return a point in the domain of f
        # (cvxprog.py:68-75)
        raise ValueError("x0 must be in the domain of F")
    G, h, dims, A, b = _prep_nl(G, h, dims, A, b, n, mnl, dtype, dev)
    core = make_cpl(
        dims, F, kktsolver=kktsolver or "default",
        maxiters=int(opts.get("maxiters", 100)),
        abstol=float(opts.get("abstol", 1e-7)),
        reltol=float(opts.get("reltol", 1e-6)),
        feastol=float(opts.get("feastol", 1e-7)),
        refinement=int(opts.get("refinement", 1)),
        kktreg=opts.get("kktreg", None),
        show_progress=bool(opts.get("show_progress", False)),
        matrix_free=matrix_free,
        factor_dtype=kktmod.resolve_factor_dtype(
            opts.get("factor_dtype", None)), device=dev)
    return _nl_result(core(c, x0, G, h, A, b), mnl)


def cp(F, x0, G=None, h=None, dims=None, A=None, b=None,
       kktsolver=None, options=None, matrix_free=False, device="cuda"):
    """Solve min f0(x) s.t. fk(x) <= 0, Gx+s=h, Ax=b (cvxprog.py:1359).

    `F` is a functional torch map (n,) -> (1+mnl,); F(x)[0] is the
    objective.  Epigraph reduction (cvxprog.py:1746-1964): minimize t
    s.t. f0(x) - t <= 0, fk(x) <= 0 over the variable [x; t]."""
    dev = resolve_device(device)
    dtype = torch.float64
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev).reshape(-1)
    n = x0.shape[0]

    def Fe(xt):
        v = F(xt[:n])
        return torch.cat([v[:1] - xt[n:], v[1:]])

    ce = torch.zeros(n + 1, dtype=dtype, device=dev)
    ce[n] = 1.0
    x0e = torch.cat([x0, F(x0)[:1] + 1.0])

    def widen(M):
        M = torch.as_tensor(M, dtype=dtype, device=dev).reshape(-1, n)
        return torch.cat([M, M.new_zeros((M.shape[0], 1))], dim=1)

    Ge = None if G is None and h is None else widen(G)
    Ae = None if A is None else widen(A)
    sol = cpl(ce, Fe, x0e, Ge, h, dims, Ae, b, kktsolver=kktsolver,
              options=options, matrix_free=matrix_free, device=dev)
    x_full = sol["x"]
    sol["x"] = x_full[:n]
    if sol["status"] == "optimal":
        sol["primal objective"] = float(F(x_full[:n])[0])
    return sol


def gp(K, F, g, G=None, h=None, A=None, b=None, options=None,
       device="cuda"):
    """Geometric program in convex form (cvxprog.py:1967):

        minimize    lse(F[0] x + g[0])
        subject to  lse(F[k] x + g[k]) <= 0,  k = 1..mnl
                    G x <= h,  A x = b

    where lse(u) = log sum exp(u) and the rows of F and entries of g are
    partitioned by K (K[i] terms for posynomial i); one
    `torch.logsumexp` per group."""
    K = [int(k) for k in K]
    dev = resolve_device(device)
    Fm = torch.as_tensor(F, dtype=torch.float64, device=dev)
    gv = torch.as_tensor(g, dtype=torch.float64, device=dev).reshape(-1)
    n = Fm.shape[1]
    starts = np.cumsum([0] + K)

    def Fe(x):
        u = Fm @ x + gv
        return torch.stack([
            torch.logsumexp(u[int(starts[i]):int(starts[i + 1])], dim=0)
            for i in range(len(K))])

    return cp(Fe, Fm.new_zeros(n), G, h, None, A, b, options=options,
              device=dev)
