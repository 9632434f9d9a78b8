"""Mixed-integer linear programming — cvxopt.glpk.ilp equivalent.

Twin of `cvxopt_tpu/ilp.py` (the reference's GLPK branch-and-cut,
glpk.c:467 `ilp(c, G, h, A, b, I, B)`): a best-first branch-and-bound
over the port's batched cone-LP relaxations.

    status, x = ilp(c, G, h, A, b, I, B, device="cuda")

I: indices of integer variables; B: indices of binary variables (0/1
bounds added automatically).  Status strings follow the reference:
'optimal', 'LP relaxation is primal infeasible', 'LP relaxation is
dual infeasible', 'feasible' (incumbent, search incomplete), 'unknown'
(node or time limit without an incumbent).

Every node's relaxation has the same shape: branch bounds are box rows
``lo <= x_j <= hi`` appended to G, and root cover cuts are written into
preallocated rows of G in place, so node relaxations differ only in h.
Up to ``node_batch`` open nodes are solved per call of the batched
`make_conelp`/`make_conelp_ws` core with G shared (for 'l' cones the
'chol2' factor, in the batched fused-Cholesky kernels).  Branching uses
pseudo-costs (mean dual-bound degradation per unit fraction, the
product rule) once a variable has been observed in both directions,
most-fractional before that.  The search itself (heap, branching, cut
separation) is host numpy, as in the JAX package.
"""

from __future__ import annotations

import heapq
from typing import Optional, Sequence

import numpy as np
import torch

from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.conelp import make_conelp, make_conelp_ws
from cvxopt_tpu_torch.ipm import (
    STATUS_OPTIMAL, STATUS_PRIMAL_INFEASIBLE, STATUS_DUAL_INFEASIBLE,
)


def _parse_glpk_options(opts):
    """GLPK-parameter plumbing (reference: glpk.options /
    solvers.options['glpk'], tests/test_glpk.py:50-77).  Recognized
    names map onto this solver's controls:
        'it_lim' / 'mip_gap'-style node cap -> max_nodes
        'tm_lim' (milliseconds)             -> wall-clock limit
        'msg_lev' ('GLP_MSG_OFF'/.../'GLP_MSG_ON') -> progress printing
    Unknown names are accepted and ignored (GLPK behavior for
    inapplicable parameters)."""
    g = dict(opts.get("glpk", {}))
    for k in ("it_lim", "tm_lim", "msg_lev"):
        if k in opts:
            g.setdefault(k, opts[k])
    max_nodes = g.get("it_lim")
    tm_lim = g.get("tm_lim")
    msg = str(g.get("msg_lev", "GLP_MSG_OFF"))
    verbose = msg not in ("GLP_MSG_OFF", "0")
    return (int(max_nodes) if max_nodes else None,
            float(tm_lim) / 1e3 if tm_lim else None, verbose)


def _separate_cover_cuts(G, h, x, B_idx, max_new, tol=1e-4):
    """Lifted-cover-cut separation on binary-supported rows (the cover
    half of GLPK's branch-and-cut cut generation, glpk.c:467).

    For each row a'x <= b whose binary support can be complemented to
    a knapsack  sum a'_j y_j <= b' (a'_j > 0, y in {0,1}), a greedy
    minimal cover C (items by decreasing fractional value) with
    sum_C a'_j > b' yields the valid inequality sum_C y_j <= |C| - 1;
    it is added when the current fractional point violates it.
    Returns a list of (row, rhs) in the ORIGINAL x variables."""
    cuts = []
    nb = len(B_idx)
    if not nb:
        return cuts
    bset = set(B_idx)
    for i in range(G.shape[0]):
        supp = np.flatnonzero(G[i])
        if not len(supp) or not set(supp.tolist()) <= bset:
            continue
        a = G[i, supp]
        bprime = h[i] - a[a < 0].sum()     # complement a_j < 0 vars
        apos = np.abs(a)
        ystar = np.where(a > 0, x[supp], 1.0 - x[supp])
        if apos.sum() <= bprime + tol:
            continue                       # no cover exists
        # separation: minimize sum (1 - y*_j) over covers — greedy by
        # (1 - y*)/a ascending; violated iff the optimum is < 1
        slack = np.clip(1.0 - ystar, 0.0, None)
        order = np.argsort(slack / np.maximum(apos, 1e-12))
        acc = 0.0
        C = []
        for j in order:
            C.append(j)
            acc += apos[j]
            if acc > bprime + 1e-12:
                break
        if acc <= bprime + 1e-12:
            continue
        # reduce to a MINIMAL cover: drop largest-slack items while
        # the rest still covers
        C.sort(key=lambda j: -slack[j])
        keep = list(C)
        for j in list(keep):
            if acc - apos[j] > bprime + 1e-12:
                keep.remove(j)
                acc -= apos[j]
        C = np.asarray(keep)
        if ystar[C].sum() <= len(C) - 1 + tol:
            continue                       # not violated
        # extended cover E(C): items with a_j >= max_C a_k join the
        # lhs with coefficient 1 (rhs unchanged) — the standard
        # strengthening of the minimal cover inequality
        amax = apos[C].max()
        ext = np.flatnonzero(apos >= amax - 1e-12)
        members = set(C.tolist()) | set(ext.tolist())
        # back-substitute complements: sum_{a>0} x - sum_{a<0} x <=
        # |C| - 1 - #(complemented in members)
        row = np.zeros(G.shape[1])
        rhs = float(len(C) - 1)
        for j in members:
            col = supp[j]
            if a[j] > 0:
                row[col] = 1.0
            else:
                row[col] = -1.0
                rhs -= 1.0
        cuts.append((row, rhs))
        if len(cuts) >= max_new:
            break
    return cuts


def ilp(c, G, h, A=None, b=None, I: Optional[Sequence[int]] = None,
        B: Optional[Sequence[int]] = None, options=None,
        max_nodes: int = 1000, int_tol: float = 1e-6,
        node_batch: int = 8, bound: float = 1e6,
        warm_start: bool = True, cuts: bool = True,
        max_cuts: int = 32, device="cuda"):
    """Branch-and-bound over the relaxations, each node batch solved on
    `device` ("cuda" unless the caller asks for the CPU).  Returns
    (status, x) with x a numpy array.  ``options['_stats']``, when a
    dict, receives nodes, ipm_iterations, cuts and best_obj."""
    import time as _time
    dev = resolve_device(device)
    c = np.asarray(c, dtype=float).reshape(-1)
    n = c.shape[0]
    G = np.asarray(G, dtype=float).reshape(-1, n)
    h = np.asarray(h, dtype=float).reshape(-1)
    I = sorted(set(int(i) for i in (I or [])) |
               set(int(i) for i in (B or [])))
    B = sorted(set(int(i) for i in (B or [])))
    if options is None:
        # reference fallback: module glpk.options applies when no
        # options kwarg is passed (glpk.c:573)
        from cvxopt_tpu_torch import glpk as _glpk
        options = _glpk.options
    opts = dict(options or {})
    opts.setdefault("show_progress", False)
    g_nodes, tm_lim, verbose = _parse_glpk_options(opts)
    if g_nodes:
        max_nodes = g_nodes
    t_start = _time.time()
    ni = len(I)

    if A is None:
        A = np.zeros((0, n))
        b = np.zeros(0)
    else:
        A = np.asarray(A, dtype=float).reshape(-1, n)
        b = np.asarray(b, dtype=float).reshape(-1)

    # fixed-shape relaxation: [G; cut pool; box rows].  The cut pool
    # is max_cuts preallocated zero rows with inactive (+big) rhs —
    # root-node cover cuts are written into it WITHOUT changing the
    # relaxation's shape, so the jit-cached vmapped cores never
    # retrace (cut-and-branch, the fixed-shape analogue of GLPK's
    # branch-and-cut row additions, glpk.c:467)
    ncuts = max_cuts if (cuts and B) else 0
    rows = np.zeros((2 * ni, n))
    for k, j in enumerate(I):
        rows[k, j] = 1.0               # x_j <= hi_k
        rows[ni + k, j] = -1.0         # -x_j <= -lo_k
    cutpool = np.zeros((ncuts, n))
    hcuts = np.full(ncuts, 1e7)
    parts = [G] + ([cutpool] if ncuts else []) \
        + ([rows] if ni else [])
    Gx = np.concatenate(parts) if len(parts) > 1 else G
    ncut_used = [0]
    lo0 = np.full(ni, -bound)
    hi0 = np.full(ni, bound)
    for k, j in enumerate(I):
        if j in B:
            lo0[k], hi0[k] = 0.0, 1.0

    dims = ConeDims(l=Gx.shape[0])
    kw = dict(maxiters=int(opts.get("maxiters", 100)),
              abstol=float(opts.get("abstol", 1e-7)),
              reltol=float(opts.get("reltol", 1e-6)),
              feastol=float(opts.get("feastol", 1e-7)))
    core = make_conelp(dims, device=dev, **kw)
    # warm solves get a short budget: a failed warm node is re-solved
    # cold (below), so wasting the full maxiters on a hard warm start
    # (e.g. an infeasible child) would cost more than it saves
    kw_ws = dict(kw, maxiters=min(40, kw["maxiters"]))
    core_ws = make_conelp_ws(dims, device=dev, **kw_ws) \
        if warm_start else None

    # bound-propagation infeasibility pre-check (host, no solve): a
    # row supported ONLY on integer variables with min-activity > h is
    # infeasible under the node's box — the presolve analogue of
    # GLPK's branch-and-cut node preprocessing
    int_mask = np.zeros(n, bool)
    int_mask[I] = True
    _int_only = (np.abs(G[:, ~int_mask]).sum(axis=1) == 0) \
        if (~int_mask).any() else np.ones(G.shape[0], bool)
    _Gi = G[np.ix_(_int_only, I)] if ni else None
    _hi_rows = h[_int_only] if ni else None

    def node_infeasible(lo, hi):
        if _Gi is None or not _Gi.size:
            return False
        minact = np.where(_Gi > 0, _Gi * lo, _Gi * hi).sum(axis=1)
        return bool((minact > _hi_rows + 1e-9).any())
    f64 = dict(dtype=torch.float64, device=dev)
    cj = torch.as_tensor(c, **f64)
    Gj = torch.as_tensor(Gx, **f64)        # root cuts land in its rows
    Aj = torch.as_tensor(A, **f64)
    bj = torch.as_tensor(b, **f64)
    total_ipm_iters = [0]

    def solve_nodes(bounds, starts=None):
        """bounds: list of (lo, hi); returns per-node (status, obj, x,
        y, z).  With `starts` (parent (x, y, z) per node), children
        are warm-started from their parent's iterates."""
        hmid = [h] + ([hcuts] if ncuts else [])
        hs = np.stack([np.concatenate(hmid + [hi, -lo])
                       for lo, hi in bounds]) if ni else \
            np.stack([np.concatenate(hmid) for _ in bounds])
        hs = torch.as_tensor(hs, **f64)
        cb = cj.expand(hs.shape[0], n)
        if starts is not None and core_ws is not None:
            x0, y0, z0 = (torch.as_tensor(np.stack([s[k] for s in starts]),
                                          **f64) for k in range(3))
            out = core_ws(cb, Gj, hs, Aj, bj, x0, y0, z0)
        else:
            out = core(cb, Gj, hs, Aj, bj)
        total_ipm_iters[0] += int(out["iterations"].sum())
        return tuple(out[k].cpu().numpy()
                     for k in ("status", "pcost", "x", "y", "z"))

    # root
    st, obj, xs, ys, zs = solve_nodes([(lo0, hi0)])

    # root cutting-plane rounds (cut-and-branch): separate cover cuts
    # violated by the fractional root solution, write them into the
    # preallocated pool, re-solve, repeat until the pool is full or no
    # violated cut is found
    seen_cuts = set()

    def try_add_cuts(xsol):
        """Separate cover cuts violated by `xsol` into the pool.
        Cuts are derived from ORIGINAL rows, so they are globally
        valid; bounds of already-solved nodes remain valid lower
        bounds (cuts only tighten relaxations)."""
        if not ncuts or ncut_used[0] >= ncuts:
            return False
        new = _separate_cover_cuts(G, h, xsol, B,
                                   ncuts - ncut_used[0])
        new = [(row, rhs) for row, rhs in new
               if (tuple(np.nonzero(row)[0]), rhs) not in seen_cuts]
        if not new:
            return False
        base = G.shape[0]
        for row, rhs in new:
            kc = ncut_used[0]
            Gj[base + kc] = torch.as_tensor(row, **f64)
            hcuts[kc] = rhs
            seen_cuts.add((tuple(np.nonzero(row)[0]), rhs))
            ncut_used[0] += 1
        return True

    cut_rounds = 0
    while (ncuts and st[0] == STATUS_OPTIMAL
           and ncut_used[0] < ncuts and cut_rounds < 6):
        frac0 = np.array([abs(xs[0][j] - round(xs[0][j])) for j in I])
        if frac0.max() <= int_tol:
            break
        if not try_add_cuts(xs[0]):
            break
        cut_rounds += 1
        st, obj, xs, ys, zs = solve_nodes([(lo0, hi0)])
    if st[0] == STATUS_PRIMAL_INFEASIBLE:
        return "LP relaxation is primal infeasible", None
    if st[0] == STATUS_DUAL_INFEASIBLE:
        return "LP relaxation is dual infeasible", None
    if st[0] != STATUS_OPTIMAL:
        return "unknown", None
    if not I:
        return "optimal", xs[0]

    best_obj = np.inf
    best_x = None
    counter = 0
    heap = [(obj[0], 0, lo0, hi0, xs[0], ys[0], zs[0])]
    nodes = 0

    # pseudo-cost branching state: mean objective degradation per unit
    # of fraction removed, per integer variable and direction
    # (GLPK's branch-and-cut uses the same statistic; here it steers
    # which variable each node splits on)
    pc_dn = np.zeros(ni)
    pc_up = np.zeros(ni)
    pn_dn = np.zeros(ni, dtype=int)
    pn_up = np.zeros(ni, dtype=int)

    def pick_branch(frac):
        """Pseudo-cost product rule; most-fractional until a variable
        has been observed in both directions."""
        cand = np.flatnonzero(frac > int_tol)
        init = (pn_dn[cand] > 0) & (pn_up[cand] > 0)
        if init.any():
            f = frac[cand]
            dn = np.where(pn_dn[cand] > 0, pc_dn[cand] /
                          np.maximum(pn_dn[cand], 1), 1.0)
            up = np.where(pn_up[cand] > 0, pc_up[cand] /
                          np.maximum(pn_up[cand], 1), 1.0)
            score = np.maximum(dn * f, 1e-12) * \
                np.maximum(up * (1.0 - f), 1e-12)
            score = np.where(init, score, -1.0)
            return int(cand[np.argmax(score)])
        return int(cand[np.argmax(frac[cand])])

    timed_out = False
    dropped_unknown = False
    while heap and nodes < max_nodes:
        if tm_lim is not None and _time.time() - t_start > tm_lim:
            timed_out = True
            break
        # pop up to node_batch most promising nodes
        batch = []
        starts = []
        meta = []        # (k, direction, fraction, parent_obj)
        while heap and len(batch) < node_batch:
            bound_val, _, lo, hi, x, y, z = heapq.heappop(heap)
            if bound_val >= best_obj - 1e-9:
                continue
            frac = np.array([abs(x[j] - round(x[j])) for j in I])
            if frac.max() <= int_tol:
                o = float(c @ x)
                if o < best_obj:
                    best_obj = o
                    best_x = x.copy()
                    for j in I:
                        best_x[j] = round(best_x[j])
                continue
            k = pick_branch(frac)
            j = I[k]
            f = np.floor(x[j])
            fk = x[j] - f
            lo_up = lo.copy()
            lo_up[k] = f + 1.0
            hi_dn = hi.copy()
            hi_dn[k] = f
            if hi_dn[k] >= lo[k] and not node_infeasible(lo, hi_dn):
                batch.append((lo.copy(), hi_dn))
                starts.append((x, y, z))
                meta.append((k, 0, fk, bound_val))
            if lo_up[k] <= hi[k] and not node_infeasible(lo_up, hi):
                batch.append((lo_up, hi))
                starts.append((x, y, z))
                meta.append((k, 1, fk, bound_val))
        if not batch:
            continue
        nodes += len(batch)
        st, obj, xs, ys, zs = solve_nodes(
            batch, starts=starts if warm_start else None)
        # a node that did not converge must NOT be dropped (that would
        # unsoundly prune its subtree): re-solve cold, and if it still
        # fails, the final status degrades to 'feasible'
        done = (STATUS_OPTIMAL, STATUS_PRIMAL_INFEASIBLE,
                STATUS_DUAL_INFEASIBLE)
        bad = [i for i in range(len(batch)) if st[i] not in done]
        if bad and warm_start:
            st2, obj2, xs2, ys2, zs2 = solve_nodes(
                [batch[i] for i in bad])
            st, obj = np.array(st), np.array(obj)
            xs, ys, zs = np.array(xs), np.array(ys), np.array(zs)
            for t, i in enumerate(bad):
                st[i], obj[i], xs[i] = st2[t], obj2[t], xs2[t]
                ys[i], zs[i] = ys2[t], zs2[t]
        if any(st[i] not in done for i in range(len(batch))):
            dropped_unknown = True
        if verbose:
            print(f"ilp: nodes={nodes} best={best_obj:.6g} "
                  f"open={len(heap)}")
        for i, (lo, hi) in enumerate(batch):
            if st[i] != STATUS_OPTIMAL:
                continue
            if ncut_used[0] < ncuts:
                # keep harvesting cover cuts from fractional node
                # solutions while the pool has room (applies to
                # future node solves only — sound, see try_add_cuts)
                try_add_cuts(xs[i])
            k, dirn, fk, pobj = meta[i]
            degr = max(float(obj[i]) - float(pobj), 0.0)
            if dirn == 0 and fk > int_tol:
                pc_dn[k] += degr / fk
                pn_dn[k] += 1
            elif dirn == 1 and fk < 1.0 - int_tol:
                pc_up[k] += degr / (1.0 - fk)
                pn_up[k] += 1
            if obj[i] < best_obj - 1e-9:
                counter += 1
                heapq.heappush(
                    heap, (obj[i], counter, lo, hi, xs[i], ys[i],
                           zs[i]))

    incomplete = timed_out or dropped_unknown \
        or (nodes >= max_nodes and bool(heap))
    stats = opts.get("_stats")
    if isinstance(stats, dict):
        stats.update(nodes=nodes, ipm_iterations=total_ipm_iters[0],
                     cuts=ncut_used[0],
                     best_obj=(None if best_x is None else best_obj))
    if best_x is not None:
        # 'feasible' = incumbent found but optimality not proven
        # within the node/time budget (reference glpk.c:457-464)
        return ("feasible" if incomplete else "optimal"), best_x
    if incomplete:
        return "unknown", None
    return "primal infeasible", None
