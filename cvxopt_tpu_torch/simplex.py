"""Dense two-phase revised simplex — the native backend of `glpk.lp`.

Twin of `cvxopt_tpu/simplex.py` (the reference's glpk.lp, glpk.c:85,
dispatched from solvers.lp(solver='glpk'), coneprog.py:2807-2875):

    minimize c'x   s.t.  G x <= h,  A x = b          (x free)

Standard form as in the JAX package: x = x+ - x-, slacks for the G rows,
artificials complete the phase-1 crash basis, rows sign-scaled to a
nonnegative rhs, data max-norm equilibrated.  Every pivot refactors the
basis from scratch by QR (no eta updates), so the pivot sequence follows
the JAX package's arithmetic; Dantzig pricing with Bland's rule after a
run of degenerate steps; a two-pass Harris ratio test; basic artificials
zero-capped in phase 2.

The JAX package writes one LP as a `lax.while_loop` and vmaps it.  Here
a batch of LPs is the leading axis of every tensor and each phase is a
Python loop over pivots: every pivot computes the body for the whole
batch, and instances that are done (optimal, unbounded, or at their
pivot cap) keep their basis, counts and code through ``torch.where``.
The host tests whether any instance is still running once every
`_SYNC_EVERY` pivots, not every pivot; the pivots in between change no
finished instance, so the results are those of a test every pivot.

Returns the glpk.lp tuple (status, x, z, y) with duals satisfying
c + G'z + A'y = 0, z >= 0 at optimality.  Statuses: 'optimal',
'primal infeasible', 'dual infeasible' (unbounded primal), 'unknown'
(iteration or time limit).
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.ops.matvec import mv, mvt

__all__ = ["simplex_core", "make_simplex", "lp"]

_BLAND_AFTER = 25      # degenerate steps before Bland's rule kicks in
_SYNC_EVERY = 8        # pivots between host tests of the running mask

# status codes (core)
OPTIMAL, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE, UNKNOWN = 0, 1, 2, 3
_STATUS = {OPTIMAL: "optimal", PRIMAL_INFEASIBLE: "primal infeasible",
           DUAL_INFEASIBLE: "dual infeasible", UNKNOWN: "unknown"}

# the clock of the tm_lim loop (a test substitutes a fake one)
_clock = time.monotonic


def _cols(W, idx):
    """Columns idx (B, k) of W (B, m, ncols) -> (B, m, k)."""
    return torch.gather(W, 2, idx.unsqueeze(1).expand(-1, W.shape[1], -1))


def _binv_xb(W, basis, r):
    """Fresh basis inverse and basic values via QR (stateless pivots:
    no eta file to drift)."""
    Q, R = torch.linalg.qr(_cols(W, basis))
    Binv = torch.linalg.solve_triangular(R, Q.transpose(-1, -2),
                                         upper=True)
    return Binv, mv(Binv, r)


def _phase(W, r, cost, enter_ok, basis, cap, cap_art=None, degen0=0,
           syncs=None):
    """One (resumable) simplex phase for a batch: minimize cost'x over
    {W x = r, x >= 0} from the given basis, for at most ``cap`` pivots
    per instance (an int or a (B,) tensor).  ``cap_art`` marks
    zero-capped columns (phase-2 artificials).  Returns (basis, code,
    it, degen), each (B, ...), with code == -1 where the pivot cap was
    hit mid-phase.  ``syncs`` (a one-element list) counts host tests."""
    Bsz, m, ncols = W.shape
    dev = W.device
    idx = torch.arange(ncols, device=dev)
    inf = torch.tensor(float("inf"), dtype=W.dtype, device=dev)
    dtol = 1e-9 * (1.0 + cost.abs().amax(-1, keepdim=True))
    wtol = 1e-7
    cap = torch.as_tensor(cap, device=dev).expand(Bsz)
    it = torch.zeros(Bsz, dtype=torch.int32, device=dev)
    degen = torch.full((Bsz,), int(degen0), dtype=torch.int32, device=dev)
    code = torch.full((Bsz,), -1, dtype=torch.int32, device=dev)
    enter_ok = enter_ok.expand(Bsz, ncols)
    k = 0
    while True:
        running = (code < 0) & (it < cap)
        if k % _SYNC_EVERY == 0:
            if syncs is not None:
                syncs[0] += 1
            if not bool(running.any()):
                break
        k += 1
        Binv, xB = _binv_xb(W, basis, r)
        xp = xB.clamp(min=0.0)
        in_basis = torch.zeros((Bsz, ncols), dtype=torch.bool,
                               device=dev).scatter_(1, basis, True)
        y = mvt(Binv, torch.gather(cost, 1, basis))
        d = cost - mvt(W, y)
        elig = ~in_basis & enter_ok & (d < -dtol)
        any_elig = elig.any(-1)

        use_bland = degen >= _BLAND_AFTER
        j_dantzig = torch.where(elig, d, inf).argmin(-1)
        j_bland = torch.where(elig, idx, ncols).argmin(-1)
        j = torch.where(use_bland, j_bland, j_dantzig)

        w = mv(Binv, _cols(W, j.unsqueeze(1)).squeeze(-1))
        ptol = 1e-9 * (1.0 + xp.amax(-1, keepdim=True))
        bu = w > wtol
        if cap_art is not None:
            bd = torch.gather(cap_art.expand(Bsz, ncols), 1, basis) & \
                (w < -wtol)
        else:
            bd = torch.zeros_like(bu)
        blocked = bu | bd
        unbounded = ~blocked.any(-1)

        wsafe_u = torch.where(bu, w, 1.0)
        wsafe_d = torch.where(bd, w, 1.0)
        # Harris pass 1: tolerance-relaxed bound
        rel = torch.where(bu, (xp + ptol) / wsafe_u, inf)
        rel = torch.where(
            bd, (xp / wsafe_d).clamp(min=0.0) + ptol / wsafe_d.abs(), rel)
        tb = rel.amin(-1, keepdim=True)
        # Harris pass 2: exact ratios; largest |pivot| under the bound
        rat = torch.where(bu, xp / wsafe_u, inf)
        rat = torch.where(bd, (xp / wsafe_d).clamp(min=0.0), rat)
        cand = blocked & (rat <= tb)
        i_harris = torch.where(cand, w.abs(), -inf).argmax(-1)
        # Bland's rule tie-breaks on the EXACT minimum-ratio set
        tmin = torch.where(blocked, rat, inf).amin(-1, keepdim=True)
        cand_exact = blocked & (rat <= tmin)
        i_bland = torch.where(cand_exact, basis, ncols).argmin(-1)
        i = torch.where(use_bland, i_bland, i_harris)
        t = torch.gather(rat, 1, i.unsqueeze(1)).squeeze(1).clamp(min=0.0)

        basis2 = basis.scatter(1, i.unsqueeze(1), j.unsqueeze(1))
        degen2 = torch.where(t <= 1e-11, degen + 1, 0).to(torch.int32)
        code2 = torch.where(~any_elig, OPTIMAL,
                            torch.where(unbounded, DUAL_INFEASIBLE, -1)
                            ).to(torch.int32)
        take = running & (code2 < 0)
        basis = torch.where(take.unsqueeze(1), basis2, basis)
        degen = torch.where(take, degen2, degen)
        it = torch.where(running, it + 1, it)
        code = torch.where(running, code2, code)
    return basis, code, it, degen


def _setup(c, G, h, A, b):
    """Standard-form setup for a batch (leading axis on every argument):
    equilibrate, sign-scale, build the working columns and the crash
    basis.  Returns a dict of tensors consumed by `_phase`/`_extract`."""
    Bsz, n = c.shape
    mG = G.shape[1]
    p = A.shape[1]
    m = mG + p
    dt, dev = c.dtype, c.device

    GA = torch.cat([G, A], dim=1)
    r0 = torch.cat([h, b], dim=1)

    # ---- max-norm equilibration --------------------------------------
    def _guard(v):
        return torch.where(v > 1e-300, v, 1.0)

    if m and n:
        rs = 1.0 / _guard(GA.abs().amax(-1))
        cs = 1.0 / _guard((GA * rs.unsqueeze(-1)).abs().amax(-2))
    else:
        rs = torch.ones((Bsz, m), dtype=dt, device=dev)
        cs = torch.ones((Bsz, n), dtype=dt, device=dev)
    GA = GA * rs.unsqueeze(-1) * cs.unsqueeze(-2)
    r0 = r0 * rs
    cobj = c * cs

    sgn = torch.where(r0 < 0, -1.0, 1.0).to(dt)
    # rows: [G I; A 0], sign-scaled; columns: x+ | x- | slack | artif.
    # The artificial identity is NOT sign-scaled: its columns must be
    # +e_i so that the crash basis has values r_i >= 0.
    S = torch.cat([torch.eye(mG, dtype=dt, device=dev),
                   torch.zeros((p, mG), dtype=dt, device=dev)], dim=0)
    W = torch.cat([GA, -GA, S.expand(Bsz, m, mG)], dim=-1) * \
        sgn.unsqueeze(-1)
    W = torch.cat([W, torch.eye(m, dtype=dt, device=dev).expand(Bsz, m, m)],
                  dim=-1)
    r = r0 * sgn
    ncols = 2 * n + mG + m
    nreal = 2 * n + mG

    # ---- crash basis: slacks where the sign allows -------------------
    row_idx = torch.arange(m, device=dev)
    slack_ok = (row_idx < mG) & (sgn > 0)
    basis0 = torch.where(slack_ok, 2 * n + row_idx, nreal + row_idx)

    is_art = torch.arange(ncols, device=dev) >= nreal
    c1 = torch.where(is_art, 1.0, 0.0).to(dt).expand(Bsz, ncols)
    c2 = torch.cat([cobj, -cobj,
                    torch.zeros((Bsz, mG + m), dtype=dt, device=dev)], -1)
    c2 = torch.where(is_art, 0.0, c2)
    return dict(W=W, r=r, c1=c1, c2=c2, is_art=is_art, basis0=basis0,
                cs=cs, rs=rs, sgn=sgn)


def _feas_ok(S, basis):
    """Phase-1 exit check: artificial infeasibility below tolerance."""
    _, xB1 = _binv_xb(S["W"], basis, S["r"])
    art = S["is_art"][basis]
    infeas = torch.where(art, xB1.clamp(min=0.0), 0.0).sum(-1)
    return infeas <= 1e-7 * (1.0 + torch.linalg.vector_norm(S["r"], dim=-1))


def _extract(S, basis):
    """Vertex and duals from the final basis (undo sign/equilibration)."""
    cs, rs, sgn = S["cs"], S["rs"], S["sgn"]
    Bsz, m, ncols = S["W"].shape
    n = cs.shape[-1]
    mG = ncols - 2 * n - m              # columns: x+ | x- | slack | art
    Binv, xB = _binv_xb(S["W"], basis, S["r"])
    xfull = torch.zeros((Bsz, ncols), dtype=xB.dtype,
                        device=xB.device).scatter(1, basis, xB)
    x = (xfull[:, :n] - xfull[:, n:2 * n]) * cs
    y_s = mvt(Binv, torch.gather(S["c2"], 1, basis))
    z = -sgn[:, :mG] * y_s[:, :mG] * rs[:, :mG]
    y = -sgn[:, mG:] * y_s[:, mG:] * rs[:, mG:]
    return x, z.clamp(min=0.0), y        # clip pivot-tolerance dust


def simplex_core(c, G, h, A, b, maxiters):
    """Batched core: c (B, n), G (B, mG, n), h (B, mG), A (B, p, n),
    b (B, p) -> (code, x, z, y) tensors with a leading batch axis.
    ``maxiters`` caps the TOTAL pivot count of each instance across
    both phases (GLPK's it_lim semantics)."""
    S = _setup(c, G, h, A, b)
    W, r, is_art = S["W"], S["r"], S["is_art"]

    # ---- phase 1: minimize the sum of the artificials ----------------
    basis, code1, it1, _ = _phase(W, r, S["c1"], ~is_art, S["basis0"],
                                  maxiters)
    feas_ok = _feas_ok(S, basis)

    # ---- phase 2: real costs; basic artificials zero-capped ----------
    basis, code2, _, _ = _phase(W, r, S["c2"], ~is_art, basis,
                                (maxiters - it1).clamp(min=0),
                                cap_art=is_art)
    code1 = torch.where(code1 < 0, UNKNOWN, code1)
    code2 = torch.where(code2 < 0, UNKNOWN, code2)

    x, z, y = _extract(S, basis)
    code = torch.where(
        ~feas_ok & (code1 == OPTIMAL), PRIMAL_INFEASIBLE,
        torch.where(code1 != OPTIMAL, UNKNOWN, code2)).to(torch.int32)
    return code, x, z, y


def make_simplex(n, mG, p, maxiters, batched=False, device="cuda"):
    """The simplex for LPs of one shape on `device` ("cuda" unless the
    caller asks for the CPU): run(c, G, h, A, b) -> (code, x, z, y).
    ``batched=True`` takes and returns a leading batch axis on every
    argument; arrays may be numpy or tensors, and compute in float64."""
    dev = resolve_device(device)

    def run(c, G, h, A, b):
        args = [torch.as_tensor(u, dtype=torch.float64, device=dev)
                for u in (c, G, h, A, b)]
        if not batched:
            args = [u.unsqueeze(0) for u in args]
        c_, G_, h_, A_, b_ = args
        Bsz = c_.shape[0]
        out = simplex_core(c_.reshape(Bsz, n), G_.reshape(Bsz, mG, n),
                           h_.reshape(Bsz, mG), A_.reshape(Bsz, p, n),
                           b_.reshape(Bsz, p), maxiters)
        return out if batched else tuple(u[0] for u in out)

    return run


_TIME_LIMIT = -2                        # host-loop marker, maps UNKNOWN


def _simplex_timed(c, G, h, A, b, maxiters, tm_lim_ms, verbose):
    """The tm_lim loop (GLPK smcp.tm_lim semantics, glpk.c:323-327): the
    phases run as host-driven chunks of pivots, checking the clock
    between chunks; exceeding the deadline returns 'unknown' (the
    reference maps GLP_ETMLIM the same way).  One LP, batch axis 1."""
    deadline = _clock() + tm_lim_ms / 1000.0
    S = _setup(c, G, h, A, b)
    chunk = 64
    not_art = ~S["is_art"]

    def phase1(basis, degen, cap):
        return _phase(S["W"], S["r"], S["c1"], not_art, basis, cap,
                      degen0=degen)

    def phase2(basis, degen, cap):
        return _phase(S["W"], S["r"], S["c2"], not_art, basis, cap,
                      cap_art=S["is_art"], degen0=degen)

    def run(phase_fn, basis, budget, label):
        done, degen, code = 0, 0, -1
        while code < 0 and done < budget:
            if _clock() >= deadline:
                return basis, _TIME_LIMIT, done
            cap = min(chunk, budget - done)
            basis, code, itc, degen = phase_fn(basis, degen, cap)
            code, done, degen = int(code[0]), done + int(itc[0]), \
                int(degen[0])
            if verbose:
                print(f"glpk.lp native simplex: {label} pivot {done}")
        return basis, code, done

    basis, code1, it1 = run(phase1, S["basis0"], maxiters, "phase 1")
    if code1 != OPTIMAL:
        return UNKNOWN, None, None, None
    if not bool(_feas_ok(S, basis)[0]):
        return PRIMAL_INFEASIBLE, None, None, None
    basis, code2, _ = run(phase2, basis, maxiters - it1, "phase 2")
    if code2 == _TIME_LIMIT or code2 == -1:
        return UNKNOWN, None, None, None
    x, z, y = _extract(S, basis)
    return code2, x[0], z[0], y[0]


_MSG_LEVELS = ("GLP_MSG_OFF", "GLP_MSG_ERR", "GLP_MSG_ON",
               "GLP_MSG_ALL")


def lp(c, G, h, A=None, b=None, options=None, device="cuda"):
    """glpk.lp-compatible entry: (status, x, z, y) — or (status, x, z)
    when A is omitted — via the simplex on `device`, with x, z, y as
    numpy arrays.  Options use GLPK parameter names with the reference's
    plumbing (glpk.c:214-330): when ``options`` is None the module-level
    `cvxopt_tpu_torch.glpk.options` dict applies; recognized keys are
    'it_lim' (total simplex pivot limit), 'tm_lim' (wall-clock limit in
    ms, enforced by a host-chunked drive of the phases), and 'msg_lev'
    (GLP_MSG_OFF/ERR/ON/ALL; ON prints a solve summary, ALL per-chunk
    progress).  Unrecognized values warn and fall back to defaults, as
    the reference's PyErr_WarnEx does."""
    dev = resolve_device(device)
    c = np.asarray(c, dtype=np.float64).reshape(-1)
    n = c.shape[0]
    G = np.asarray(G, dtype=np.float64).reshape(-1, n)
    h = np.asarray(h, dtype=np.float64).reshape(-1)
    has_A = A is not None
    if has_A:
        A = np.asarray(A, dtype=np.float64).reshape(-1, n)
        b = np.asarray(b, dtype=np.float64).reshape(-1)
    else:
        A = np.zeros((0, n))
        b = np.zeros((0,))
    if options is None:
        # reference fallback (glpk.c:214): the module options dict
        # applies when no options kwarg is passed
        from cvxopt_tpu_torch import glpk as _glpk
        options = _glpk.options
    opts = dict(options or {})

    msg_lev = opts.get("msg_lev", "GLP_MSG_OFF")
    if msg_lev not in _MSG_LEVELS:
        warnings.warn("replacing glpk.options['msg_lev'] with default "
                      "value")
        msg_lev = "GLP_MSG_OFF"
    it_lim = opts.get("it_lim")
    if it_lim is not None and not isinstance(it_lim, int):
        warnings.warn("replacing glpk.options['it_lim'] with default "
                      "value")
        it_lim = None
    tm_lim = opts.get("tm_lim")
    if tm_lim is not None and not isinstance(tm_lim, int):
        warnings.warn("replacing glpk.options['tm_lim'] with default "
                      "value")
        tm_lim = None
    maxiters = int(it_lim or 50 * (G.shape[0] + A.shape[0] + n) + 1000)

    t0 = time.perf_counter()
    if tm_lim and tm_lim > 0:
        data = [torch.as_tensor(u, device=dev).unsqueeze(0)
                for u in (c, G, h, A, b)]
        code, x, z, y = _simplex_timed(
            *data, maxiters, tm_lim, verbose=(msg_lev == "GLP_MSG_ALL"))
    else:
        run = make_simplex(n, G.shape[0], A.shape[0], maxiters,
                           device=dev)
        code, x, z, y = run(c, G, h, A, b)
        code = int(code)
    status = _STATUS[code]
    if msg_lev in ("GLP_MSG_ON", "GLP_MSG_ALL"):
        print(f"glpk.lp native simplex: n={n} m={G.shape[0]} "
              f"p={A.shape[0]} status={status} "
              f"({time.perf_counter() - t0:.3f}s)")
    if status != "optimal":
        out = (status, None, None)
        return out + (None,) if has_A else out
    x, z, y = (u.cpu().numpy() for u in (x, z, y))
    if has_A:
        return status, x, z, y
    return status, x, z
