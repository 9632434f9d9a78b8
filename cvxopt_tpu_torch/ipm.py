"""ipm — the interior-point loop layer under the port's cone solvers.

It sits between the cone algebra and the KKT solvers (`cones`,
`scaling`, `kkt`) and the solvers built on them (`conelp`, `coneqp`,
`cvxprog`, `parallel.conesolve`), and holds what they share:

  - the status codes and the step constants;
  - the batched IPM loop `_run_loop` (a Python loop over the
    per-instance status, or the replay of an `ipm_graph.Tape`) and the
    two-phase rescue's restart state;
  - the progressive-precision cascades' one run, `cascade`, and its phase C,
    `rescue_compacted`;
  - the input helpers of the solvers' entry points.

Status codes: 0 optimal, 1 primal infeasible, 2 dual infeasible,
3 unknown (maxiters), 4 unknown (singular KKT).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch import ipm_graph
from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.trace import span, spanned
from cvxopt_tpu_torch._tree import (
    _tmap, _leaves, _where, _take, _is_operator, _operator_maps,
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


def _running(st):
    return st["status"] == STATUS_RUNNING


def _run_loop(st, body, syncs, tape=None):
    """Iterate `body` while any instance is running; instances that are
    not keep their state.  Each pass is a `cvx.ipm.pass` span; each
    check of the status, counted in ``syncs[0]``, a `cvx.ipm.sync`.
    With an `ipm_graph.Tape` the passes are replayed from it."""
    if tape is not None:
        def step(st):
            running = _running(st)
            new = body(st)
            return {k: _where(running, new[k], st[k]) for k in st}
        return tape.run(st, step, lambda st: _running(st).any(), syncs)
    while True:
        running = _running(st)
        syncs[0] += 1
        with span("cvx.ipm.sync"):
            more = bool(running.any())     # the one host sync per pass
        if not more:
            return st
        with span("cvx.ipm.pass"):
            ipm_graph.COUNTS["eager_passes"] += 1
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


def rescue_compacted(raw, out_keys, run_batch, dev, syncs):
    """Phase C of the cascades: gather the instances whose status is
    NEEDS_F64 into batches padded to a power of two (the first straggler
    repeated in the padding lanes), solve each with ``run_batch(index
    tensor)`` and scatter `out_keys` back into `raw`.  Sets
    ``raw['rescue_iterations']``, adds it to ``raw['iterations']`` and
    returns the number of flagged instances.  Adds the phase's host
    syncs to ``syncs[0]``: its reads of the status and of each batch's
    iterations, each a `cvx.cascade.sync` span, and each batch solve's
    ``host_syncs``."""
    syncs[0] += 1
    with span("cvx.cascade.sync"):
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
        syncs[0] += sub["host_syncs"] + 1
        with span("cvx.cascade.sync"):
            its = sub["iterations"].cpu().numpy()
        resc[dst_np] = its[src_np]
    raw["rescue_iterations"] = torch.as_tensor(resc, device=dev)
    raw["iterations"] = raw["iterations"] + raw["rescue_iterations"]
    return int(flagged.size)


def cascade(phase_a, phase_b, phase_c, handoff, out_keys, nbatched,
            instrument, dev):
    """The progressive-precision cascades' one run: returns
    ``solve(*args)``.  It runs ``phase_a(*args)``, then
    ``phase_b(*args, *handoff(raw_a, args))`` and phase C
    (`rescue_compacted`) on the instances phase B flagged, solved by
    `phase_c` on their rows of the first ``nbatched`` arguments (those
    that hold a row per instance) and on the others whole.

    The result is phase B's, with phase C's instances scattered into
    `out_keys`, `iterations` summed over the phases and
    `phase1_iterations` phase A's.  With ``instrument`` it also holds
    ``profile``: per phase the wall seconds, iteration sums and host
    syncs, the passes phases A and B replayed from their tapes, the
    captures of the call and phase C's instance count.  A call is a
    `cvx.cascade.solve` span, its phases `cvx.cascade.a`, `.b` and
    `.c`.  The phases are also reachable as ``solve.phase_a``,
    ``solve.phase_b`` and ``solve.phase_c``."""

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(prof, phase, fn, *args):
        t0, r0 = time.perf_counter(), ipm_graph.COUNTS["replays"]
        with span("cvx.cascade." + phase):
            raw = fn(*args)
        if instrument:
            _sync()
            prof[phase + "_iters"] = int(raw["iterations"].sum())
            prof[phase + "_s"] = time.perf_counter() - t0
            prof[phase + "_host_syncs"] = raw["host_syncs"]
            prof[phase + "_replays"] = ipm_graph.COUNTS["replays"] - r0
        return raw

    @spanned("cvx.cascade.solve")
    def solve(*args):
        args = _tensors(dev, *args)
        prof = {}
        captures = ipm_graph.COUNTS["captures"]
        raw_a = run(prof, "a", phase_a, *args)
        raw = dict(run(prof, "b", phase_b, *args, *handoff(raw_a, args)))
        raw["iterations"] = raw["iterations"] + raw_a["iterations"]
        raw["phase1_iterations"] = raw_a["iterations"]

        # ---- phase C: host-compacted f64 rescue ----------------------
        t0 = time.perf_counter()

        def run_c(ii):
            return phase_c(*(u[ii] if k < nbatched else u
                             for k, u in enumerate(args)))

        c_syncs = [0]
        with span("cvx.cascade.c"):
            nflag = rescue_compacted(raw, out_keys, run_c, dev, c_syncs)
        if instrument:
            _sync()
            prof["c_iters"] = int(raw["rescue_iterations"].sum())
            prof["c_s"] = time.perf_counter() - t0
            prof["c_instances"] = nflag
            prof["c_host_syncs"] = c_syncs[0]
            prof["captures"] = ipm_graph.COUNTS["captures"] - captures
            raw["profile"] = prof
        return raw

    solve.phase_a = phase_a
    solve.phase_b = phase_b
    solve.phase_c = phase_c
    return solve


# ---------------------------------------------------------------------------
# the solvers' inputs


def _tensors(dev, *arrays, dtype=None):
    return tuple(torch.as_tensor(a, device=dev, dtype=dtype)
                 for a in arrays)


def _lp_maps(G, A):
    """Batched linear-map closures for G, A (dense or operator-form)."""
    Gf, GTf = _operator_maps(G)
    Af, ATf = _operator_maps(A)
    return dict(Gf=Gf, GTf=GTf, Af=Af, ATf=ATf)


def _unbatch(raw):
    """One instance's results: tensors and trees of tensors lose the
    batch axis, anything else (counters) stays."""
    return {k: (_take(v, 0) if torch.is_tensor(_leaves(v)[0]) else v)
            for k, v in raw.items()}


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
            with span("cvx.frontend.sync"):
                outside = float(cones.max_step(v, dims)[0]) >= 0
            if outside:
                raise ValueError(f"initial {k} is not positive")
        out[k] = v
    return out
