"""Block-sparse (tile-map) Cholesky and LU for patterns beyond bands,
twin of `cvxopt_tpu/ops/blocksparse.py` (the CHOLMOD-supernodal and
UMFPACK analogue).

The fill-reducing-ordered matrix is tiled into (t, t) blocks; the
BLOCK fill pattern and static task tables are computed once on the host
(`analyze`, the symbolic phase), and the numeric factorization is a
loop over block columns whose work - the left-looking update sum, the
diagonal factor, the off-diagonal triangular solves - is a batch of
dense (t, t) products.  The loop depth is n/t, not n.  Each step takes
only the real entries of its column's tables (their counts are known
on the host), so no padded task is computed.

Storage: L as a slot table (nnzb + 1, t, t) over the block pattern;
slot nnzb is an all-zero dummy that the tables' padding points at.

Numeric functions take tensors and work on their device; the ones that
take a scipy matrix (`assemble`, `assemble_scipy`, `assemble_lu`,
`linsolve`, `make_kkt_plan`) take ``device=`` (default "cuda").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from cvxopt_tpu_torch._device import resolve_device, tensors
from cvxopt_tpu_torch.ops.banded import _chol_nan


@dataclass
class BlockSymbolic:
    """Host-side symbolic analysis of a tiled SPD pattern."""
    n: int                    # original dimension
    t: int                    # tile size
    nt: int                   # number of block rows/cols (padded)
    perm: np.ndarray          # fill-reducing ordering (new -> old)
    nnzb: int                 # blocks in the L pattern (incl. fill)
    # per-block-column tables, padded to fixed widths:
    col_slots: np.ndarray     # (nt, rmax) slot of block (i, k); pad=nnzb
    col_rows: np.ndarray      # (nt, rmax) block-row index i; pad=nt
    upd_dst: np.ndarray       # (nt, umax) destination position in col
    upd_src1: np.ndarray      # (nt, umax) slot of L[i, j]
    upd_src2: np.ndarray      # (nt, umax) slot of L[k, j]
    row_slots: np.ndarray     # (nt, wmax) slot of L[k, j], j < k
    row_js: np.ndarray        # (nt, wmax) block-col j; pad=nt
    # scatter plan for numeric assembly of A blocks:
    a_slot: np.ndarray        # (nnz,) slot*t*t + local offset (or OOB)
    fill_frac: float = 0.0    # diagnostic: block fill / block nnz


def analyze(S, t: int = 32, perm: Optional[np.ndarray] = None
            ) -> BlockSymbolic:
    """Symbolic phase: ordering, block fill and static task tables.

    S: scipy sparse SPD pattern or matrix (values ignored).  `perm`
    overrides the ordering (default: minimum degree from
    spsolve.amd_order)."""
    S = sp.csr_matrix(S)
    n = S.shape[0]
    if perm is None:
        from cvxopt_tpu_torch.ops.spsolve import amd_order
        perm = np.asarray(amd_order((S + S.T) != 0))
    pos = np.argsort(perm)
    nt = -(-n // t)

    coo = sp.coo_matrix(S)
    bi = pos[coo.row] // t
    bj = pos[coo.col] // t
    # block pattern of the permuted matrix (lower part, incl. diagonal)
    blocks = set(zip(np.minimum(bi, bj).tolist(),
                     np.maximum(bi, bj).tolist()))
    adj = [set() for _ in range(nt)]
    for a, b in blocks:
        if a != b:
            adj[a].add(b)
    for k in range(nt):
        adj[k].add(k)        # padded diagonals must exist

    # symbolic block Cholesky: the neighbours > k of k become a clique;
    # the native bitset elimination (native/blockfill.c) when it
    # builds, else the Python set loop
    from cvxopt_tpu_torch import native as _native
    indptr = np.zeros(nt + 1, np.int64)
    for a in range(nt):
        indptr[a + 1] = indptr[a] + len(adj[a])
    indices = np.concatenate(
        [np.asarray(sorted(r), np.int64) for r in adj]) \
        if nt else np.zeros(0, np.int64)
    out = _native.block_fill(indptr, indices, nt)
    if out is not None:
        colptr, colsv = out
        Lcols = [colsv[colptr[k]:colptr[k + 1]].tolist()
                 for k in range(nt)]
    else:
        Lcols = []
        for k in range(nt):
            nb = sorted(i for i in adj[k] if i > k)
            Lcols.append([k] + nb)
            for ix, i in enumerate(nb):
                adj[i].update(j for j in nb[ix + 1:])

    # slot numbering (column-major over the block pattern)
    slot = {}
    for k in range(nt):
        for i in Lcols[k]:
            slot[(i, k)] = len(slot)
    nnzb = len(slot)

    rmax = max(len(c) for c in Lcols)
    col_slots = np.full((nt, rmax), nnzb, np.int32)
    col_rows = np.full((nt, rmax), nt, np.int32)
    for k in range(nt):
        for ix, i in enumerate(Lcols[k]):
            col_slots[k, ix] = slot[(i, k)]
            col_rows[k, ix] = i

    # row structure: L[k, j] for j < k (updates and forward solve)
    rowpat = [[] for _ in range(nt)]
    for k in range(nt):
        for i in Lcols[k][1:]:
            rowpat[i].append(k)
    wmax = max((len(r) for r in rowpat), default=0) or 1
    row_slots = np.full((nt, wmax), nnzb, np.int32)
    row_js = np.full((nt, wmax), nt, np.int32)
    for k in range(nt):
        for ix, j in enumerate(rowpat[k]):
            row_slots[k, ix] = slot[(k, j)]
            row_js[k, ix] = j

    # update tasks of column k: for j in rowpat[k], for i in Lcols[j]
    # with i >= k: dest (i, k) -= L[i, j] @ L[k, j]'
    pos_in_col = {}
    for k in range(nt):
        for ix, i in enumerate(Lcols[k]):
            pos_in_col[(i, k)] = ix
    tasks = [[] for _ in range(nt)]
    for j in range(nt):
        cj = Lcols[j]
        for a in range(1, len(cj)):
            k = cj[a]
            for b in range(a, len(cj)):
                i = cj[b]
                tasks[k].append((pos_in_col[(i, k)],
                                 slot[(i, j)], slot[(k, j)]))
    umax = max((len(ta) for ta in tasks), default=0) or 1
    upd_dst = np.full((nt, umax), rmax, np.int32)
    upd_src1 = np.full((nt, umax), nnzb, np.int32)
    upd_src2 = np.full((nt, umax), nnzb, np.int32)
    for k in range(nt):
        for ix, (d, s1, s2) in enumerate(tasks[k]):
            upd_dst[k, ix] = d
            upd_src1[k, ix] = s1
            upd_src2[k, ix] = s2

    # assembly scatter plan: PERMUTED-lower entries (r >= c) land in
    # slot[(r//t, c//t)] at (r%t, c%t); permuted-upper entries drop
    pr, pc = pos[coo.row], pos[coo.col]
    lowmask = pr >= pc
    r2, c2 = pr[lowmask], pc[lowmask]
    sl = np.array([slot[(a, b)] for a, b in zip(r2 // t, c2 // t)],
                  np.int64)
    a_slot = np.full((coo.nnz,), (nnzb + 1) * t * t, np.int64)
    a_slot[lowmask] = sl * t * t + (r2 % t) * t + (c2 % t)
    return BlockSymbolic(
        n=n, t=t, nt=nt, perm=perm, nnzb=nnzb,
        col_slots=col_slots, col_rows=col_rows,
        upd_dst=upd_dst, upd_src1=upd_src1, upd_src2=upd_src2,
        row_slots=row_slots, row_js=row_js, a_slot=a_slot,
        fill_frac=nnzb / max(len(blocks), 1))


def _pad_diag(symb: BlockSymbolic, A, value=1.0):
    """Unit diagonal on the padding rows (beyond n) of the last block."""
    npad = symb.nt * symb.t - symb.n
    if npad:
        dslot = int(symb.col_slots[symb.nt - 1, 0])
        idx = torch.arange(symb.n - (symb.nt - 1) * symb.t, symb.t,
                           device=A.device)
        A[dslot, idx, idx] = value
    return A


def _scatter(size, idx, vals, dev):
    """A zero vector of `size` with vals added at idx; idx == size
    drops."""
    idx = torch.as_tensor(idx, device=dev)
    out = vals.new_zeros((size + 1,)).index_add_(0, idx, vals)
    return out[:size]


def assemble(symb: BlockSymbolic, S, device="cuda") -> torch.Tensor:
    """Numeric assembly: scatter the (permuted, lower) values of S into
    the slot table (nnzb + 1, t, t) with one scatter-add over the fixed
    pattern.  Diagonal tiles hold their lower half."""
    dev = resolve_device(device)
    coo = sp.coo_matrix(sp.csr_matrix(S))
    t, nnzb = symb.t, symb.nnzb
    vals = torch.as_tensor(coo.data, device=dev)
    A = _scatter((nnzb + 1) * t * t, symb.a_slot, vals, dev)
    return _pad_diag(symb, A.reshape(nnzb + 1, t, t))


def _slot_lookup(symb: BlockSymbolic) -> dict:
    d = {}
    for k in range(symb.nt):
        for ix in range(symb.col_slots.shape[1]):
            i = int(symb.col_rows[k, ix])
            if i < symb.nt:
                d[(i, k)] = int(symb.col_slots[k, ix])
    return d


def assemble_scipy(symb: BlockSymbolic, Sfull, device="cuda"
                   ) -> torch.Tensor:
    """Assembly from a FULL symmetric scipy matrix whose pattern the
    analysed one covers (a host-side plan per call; `assemble` is the
    fixed-pattern path)."""
    dev = resolve_device(device)
    coo = sp.coo_matrix(sp.csr_matrix(Sfull))
    t, nnzb = symb.t, symb.nnzb
    pos = np.argsort(symb.perm)
    pr, pc = pos[coo.row], pos[coo.col]
    mask = pr >= pc
    r2, c2 = pr[mask], pc[mask]
    lk = _slot_lookup(symb)
    sl = np.array([lk.get((a, b), nnzb)
                   for a, b in zip(r2 // t, c2 // t)], np.int64)
    if (sl == nnzb).any() and coo.data[mask][sl == nnzb].any():
        raise ValueError("matrix entries outside the analyzed pattern")
    idx = sl * t * t + (r2 % t) * t + (c2 % t)
    vals = torch.as_tensor(coo.data[mask], device=dev)
    A = _scatter((nnzb + 1) * t * t, idx, vals, dev).reshape(nnzb + 1, t, t)
    A[nnzb] = 0.0
    return _pad_diag(symb, A)


def _tables(symb: BlockSymbolic, dev) -> "_Tables":
    """The analysis' tables on `dev`, made once per device."""
    cache = symb.__dict__.setdefault("_tables", {})
    if str(dev) not in cache:
        cache[str(dev)] = _Tables(symb, dev)
    return cache[str(dev)]


class _Tables:
    """The symbolic tables as tensors on one device, with the host
    counts of real entries per block column."""

    def __init__(self, symb: BlockSymbolic, dev):
        def t(a):
            return torch.as_tensor(a.astype(np.int64), device=dev)
        self.cs, self.cr = t(symb.col_slots), t(symb.col_rows)
        self.dst, self.s1, self.s2 = (t(symb.upd_dst), t(symb.upd_src1),
                                      t(symb.upd_src2))
        self.rs, self.rj = t(symb.row_slots), t(symb.row_js)
        self.nr = (symb.col_rows < symb.nt).sum(1).tolist()
        self.nu = (symb.upd_src1 < symb.nnzb).sum(1).tolist()
        self.nw = (symb.row_js < symb.nt).sum(1).tolist()


def _mtt(X, Y):
    """X_u @ Y_u' for stacks of tiles."""
    return X @ Y.transpose(-1, -2)


def factor(symb: BlockSymbolic, A: torch.Tensor):
    """Numeric block Cholesky, one block column per step.  A: the slot
    table from `assemble` (or any same-pattern assembly).  Returns the L
    slot table (same layout).  NaN blocks signal non-PD pivots."""
    tb = _tables(symb, A.device)
    L = A.clone()
    for k in range(symb.nt):
        nr, nu = tb.nr[k], tb.nu[k]
        cslots = tb.cs[k, :nr]
        col = L[cslots]
        if nu:
            prod = _mtt(L[tb.s1[k, :nu]], L[tb.s2[k, :nu]])
            col.index_add_(0, tb.dst[k, :nu], prod, alpha=-1)
        # the assembly stores only the lower half of diagonal tiles
        D = torch.tril(col[0])
        Lkk = _chol_nan(D + torch.tril(D, -1).T)
        col[0] = Lkk
        if nr > 1:
            col[1:] = torch.linalg.solve_triangular(
                Lkk, col[1:].transpose(-1, -2), upper=False
            ).transpose(-1, -2)
        L[cslots] = col
    return L


def _rhs_tiles(symb, B):
    """B (n,) or (n, nrhs) permuted and padded into (nt, t, nrhs)."""
    Bm = B.unsqueeze(1) if B.dim() == 1 else B
    n, nrhs = Bm.shape
    if n == symb.n:
        Bm = Bm[torch.as_tensor(symb.perm, device=B.device)]
    Bp = torch.nn.functional.pad(Bm, (0, 0, 0, symb.nt * symb.t - symb.n))
    return Bp.reshape(symb.nt, symb.t, nrhs), B.dim() == 1


def _untile(symb, x, vec):
    inv = torch.as_tensor(np.argsort(symb.perm), device=x.device)
    X = x.reshape(symb.nt * symb.t, -1)[:symb.n][inv]
    return X[:, 0] if vec else X


def _rowsum(tiles, xs):
    """sum_w tiles[w] @ xs[w]."""
    return torch.einsum("wij,wjr->ir", tiles, xs)


def solve(symb: BlockSymbolic, L: torch.Tensor, B):
    """Solve L L' x = b in the ORIGINAL (unpermuted) indexing.
    B: (n,) or (n, nrhs)."""
    B, = tensors(B, device=L.device)
    tb = _tables(symb, L.device)
    Bp, vec = _rhs_tiles(symb, B)
    nt = symb.nt
    # forward: y_k = Lkk^{-1} (b_k - sum_j L[k,j] y_j)
    y = torch.empty_like(Bp)
    for k in range(nt):
        nw = tb.nw[k]
        acc = Bp[k]
        if nw:
            acc = acc - _rowsum(L[tb.rs[k, :nw]], y[tb.rj[k, :nw]])
        y[k] = torch.linalg.solve_triangular(L[tb.cs[k, 0]], acc,
                                             upper=False)
    # backward: x_k = Lkk^{-T} (y_k - sum_{i>k} L[i,k]' x_i)
    x = torch.empty_like(Bp)
    for k in range(nt - 1, -1, -1):
        nr = tb.nr[k]
        acc = y[k]
        if nr > 1:
            acc = acc - _rowsum(L[tb.cs[k, 1:nr]].transpose(-1, -2),
                                x[tb.cr[k, 1:nr]])
        x[k] = torch.linalg.solve_triangular(L[tb.cs[k, 0]].T, acc,
                                             upper=True)
    return _untile(symb, x, vec)


def linsolve(S, B, t: int = 32, perm=None, device="cuda"):
    """One-shot general-sparsity solve: analyze, assemble, factor and
    solve.  S: scipy sparse SPD.  The work runs on B's device when B is
    a tensor, else on `device`."""
    dev = B.device if torch.is_tensor(B) else resolve_device(device)
    symb = analyze(S, t=t, perm=perm)
    L = factor(symb, assemble(symb, S, device=dev))
    return solve(symb, L, tensors(B, device=dev)[0])


# ---------------------------------------------------------------------------
# Fixed-pattern KKT assembly and the general-sparsity kktsolver
# (the blocksparse analogue of sparse_kkt.kkt_chol2_banded)
# ---------------------------------------------------------------------------

@dataclass
class KKTPlan:
    symb: BlockSymbolic
    scatter_idx: torch.Tensor   # (m*r*r,) slot*t*t + local (or OOB)
    G: object                   # SparseELL (original indexing)
    Ablocks: Optional[torch.Tensor]   # static P contribution


def make_kkt_plan(G_sp, P_sp=None, t: int = 32, dtype=torch.float64,
                  device="cuda") -> KKTPlan:
    """Host-side symbolic setup for S = P + G' diag(w) G over a general
    (minimum-degree-ordered, tile-mapped) pattern: the scatter index of
    every Gram pair into the slot storage is computed once; each
    assembly is one multiply and one scatter-add."""
    from cvxopt_tpu_torch.ops.sparse_kkt import SparseELL, _pair_index, \
        _pattern
    dev = resolve_device(device)
    G_sp = sp.csr_matrix(G_sp)
    Gpat = _pattern(G_sp)
    Spat = Gpat.T @ Gpat
    if P_sp is not None:
        Spat = Spat + sp.csr_matrix(P_sp)
    symb = analyze((Spat != 0), t=t)
    tt = symb.t
    pos = np.argsort(symb.perm)

    ell = SparseELL.from_scipy(G_sp, device=dev, dtype=dtype)
    pi, pj, keep = _pair_index(ell.cols.cpu().numpy(),
                               ell.vals.cpu().numpy() != 0, pos)
    smap = np.full((symb.nt, symb.nt), symb.nnzb, np.int64)
    for (a, b), s in _slot_lookup(symb).items():
        smap[a, b] = s
    slots = smap[pi // tt, pj // tt]
    flat = slots * tt * tt + (pi % tt) * tt + pj % tt
    oob = (symb.nnzb + 1) * tt * tt
    flat = np.where(keep & (slots < symb.nnzb), flat, oob)

    Ablocks = None
    if P_sp is not None:
        Pd = sp.csr_matrix(P_sp)
        Psym = sp.tril(Pd) + sp.tril(Pd, -1).T
        # without the unit padding (assembly adds it again)
        Ablocks = _pad_diag(symb, assemble_scipy(symb, Psym, device=dev),
                            0.0).to(dtype)
    return KKTPlan(symb=symb,
                   scatter_idx=torch.as_tensor(flat.reshape(-1), device=dev),
                   G=ell, Ablocks=Ablocks)


def assemble_kkt(plan: KKTPlan, wrow):
    """Device-side assembly of S = P + G' diag(wrow) G into the slot
    storage (fixed pattern, one scatter-add)."""
    symb = plan.symb
    t, nnzb = symb.t, symb.nnzb
    v = plan.G.vals.to(wrow.dtype)
    contrib = wrow[:, None, None] * v[:, :, None] * v[:, None, :]
    size = (nnzb + 1) * t * t
    A = contrib.new_zeros((size + 1,)).index_add_(
        0, plan.scatter_idx, contrib.reshape(-1))[:size]
    A = A.reshape(nnzb + 1, t, t)
    A[nnzb] = 0.0
    if plan.Ablocks is not None:
        A = A + plan.Ablocks.to(A.dtype)
    return _pad_diag(symb, A)


def kkt_chol2_blocksparse(G_sp, dims, A=None, P_sp=None, t: int = 32,
                          dtype=torch.float64, device="cuda"):
    """General-sparsity callable kktsolver for 'l'-cone problems: the
    tile-map Cholesky behind the reference kkt_chol2 contract, for
    patterns the banded path cannot band (arrow heads, grid fill).
    Same contract as sparse_kkt.kkt_chol2_banded."""
    from cvxopt_tpu_torch.kkt_structured import _cho_solve
    from cvxopt_tpu_torch.ops.sparse_kkt import _dense
    if getattr(dims, "q", ()) or getattr(dims, "s", ()):
        raise ValueError("kkt_chol2_blocksparse supports 'l' cones only")
    dev = resolve_device(device)
    plan = make_kkt_plan(G_sp, P_sp=P_sp, t=t, dtype=dtype, device=dev)
    symb = plan.symb
    G = plan.G
    if A is not None and getattr(A, "shape", (0,))[0]:
        A = _dense(A, dtype, dev)
        p = A.shape[0]
    else:
        p = 0

    def kktsolver(W):
        di = W["di"]
        L = factor(symb, assemble_kkt(plan, (di * di).to(dtype)))

        def Sinv(v):
            return solve(symb, L, v)

        if p:
            SiAT = Sinv(A.T)
            Lk = torch.linalg.cholesky(A @ SiAT)

        def kkt_solve(bx, by, bz):
            zs = di * (di * bz)
            tv = Sinv(bx + G.rmatvec(zs))
            if p:
                uy = _cho_solve(Lk, A @ tv - by)
                ux = tv - SiAT @ uy
            else:
                uy = by
                ux = tv
            return ux, uy, di * (G.matvec(ux) - bz)

        return kkt_solve

    kktsolver.plan = plan
    return kktsolver


# ---------------------------------------------------------------------------
# Unsymmetric block LU over the symmetrized pattern (the umfpack path)
# ---------------------------------------------------------------------------
#
# As in the JAX module: the block pattern and task tables of the
# Cholesky analysis drive BOTH triangles, with U stored transposed
# (Ut[(i,k)] := U[k,i]'), so the two left-looking updates read
#
#     Lcol[(i,k)] -= L[(i,j)]  @ Ut[(k,j)]'
#     Ut[(i,k)]   -= Ut[(i,j)] @ L[(k,j)]'
#
# Diagonal blocks factor by Householder QR; there is no cross-block
# pivoting.  Factor convention (block Doolittle): A = L' U' with L'
# unit block lower, L'[i,j] = A[i,j] D_j^{-1}, U'[j,j] = D_j = Q_j R_j,
# U'[j,i] = A[j,i].  Ltab's diagonal slot holds R_j, Utab's holds Q_j.


def assemble_lu(symb: BlockSymbolic, S, device="cuda"):
    """Assembly of an UNSYMMETRIC matrix into the two slot tables
    (Alow, Aupt) over the symmetrized-pattern analysis `symb`: block-
    lower entries (and FULL diagonal blocks) go to Alow, strictly
    block-upper entries to Aupt, transposed, at the mirror slot."""
    dev = resolve_device(device)
    coo = sp.coo_matrix(sp.csr_matrix(S))
    t, nnzb = symb.t, symb.nnzb
    pos = np.argsort(symb.perm)
    lk = _slot_lookup(symb)
    pr, pc = pos[coo.row], pos[coo.col]
    bi, bj = pr // t, pc // t
    low = bi >= bj
    sl = np.full(coo.nnz, nnzb, np.int64)
    for idx in range(coo.nnz):
        key = (int(bi[idx]), int(bj[idx])) if low[idx] \
            else (int(bj[idx]), int(bi[idx]))
        s = lk.get(key)
        if s is None:
            raise ValueError("entry outside the analyzed pattern")
        sl[idx] = s
    flat = sl * t * t + np.where(low, pr % t, pc % t) * t \
        + np.where(low, pc % t, pr % t)
    size = (nnzb + 1) * t * t
    vals = torch.as_tensor(coo.data, device=dev)
    Alow = _scatter(size, np.where(low, flat, size), vals, dev)
    Aupt = _scatter(size, np.where(~low, flat, size), vals, dev)
    Alow = _pad_diag(symb, Alow.reshape(nnzb + 1, t, t))
    return Alow, Aupt.reshape(nnzb + 1, t, t)


def factor_lu(symb: BlockSymbolic, Alow: torch.Tensor,
              Aupt: torch.Tensor):
    """Numeric block LU over the symmetrized block pattern, one block
    column per step, updating BOTH triangles with the same tables.
    Returns (Ltab, Utab); NaN/inf blocks signal a singular diagonal
    block."""
    tb = _tables(symb, Alow.device)
    Ltab, Utab = Alow.clone(), Aupt.clone()
    for k in range(symb.nt):
        nr, nu = tb.nr[k], tb.nu[k]
        cslots = tb.cs[k, :nr]
        Lcol, Ucol = Ltab[cslots], Utab[cslots]
        if nu:
            s1, s2, dst = tb.s1[k, :nu], tb.s2[k, :nu], tb.dst[k, :nu]
            Lcol.index_add_(0, dst, _mtt(Ltab[s1], Utab[s2]), alpha=-1)
            Ucol.index_add_(0, dst, _mtt(Utab[s1], Ltab[s2]), alpha=-1)
        Q, R = torch.linalg.qr(Lcol[0])
        if nr > 1:
            # L[i,k] = Lcol[i] D^{-1} = (Q (R^{-T} Lcol[i]'))'
            tmp = torch.linalg.solve_triangular(
                R.T, Lcol[1:].transpose(-1, -2), upper=False)
            Lcol[1:] = (Q @ tmp).transpose(-1, -2)
        Lcol[0] = R
        Ucol[0] = Q
        Ltab[cslots] = Lcol
        Utab[cslots] = Ucol
    return Ltab, Utab


def solve_lu(symb: BlockSymbolic, Ltab: torch.Tensor,
             Utab: torch.Tensor, B, trans: str = "N"):
    """Solve A x = b (trans='N') or A' x = b (trans='T') from the
    block-LU tables, in the ORIGINAL (unpermuted) indexing; the same
    tables serve both directions."""
    B, = tensors(B, device=Ltab.device)
    tb = _tables(symb, Ltab.device)
    Bp, vec = _rhs_tiles(symb, B)
    nt = symb.nt
    z = torch.empty_like(Bp)
    x = torch.empty_like(Bp)
    # forward: unit block-lower L' (trans 'N') or U'^T with diagonal
    # D_k' = R' Q' (trans 'T'), over the row tables
    tabF = Ltab if trans == "N" else Utab
    for k in range(nt):
        nw = tb.nw[k]
        acc = Bp[k]
        if nw:
            acc = acc - _rowsum(tabF[tb.rs[k, :nw]], z[tb.rj[k, :nw]])
        if trans != "N":
            d = tb.cs[k, 0]
            acc = Utab[d] @ torch.linalg.solve_triangular(
                Ltab[d].T, acc, upper=False)
        z[k] = acc
    # backward: U' with D_k^{-1} = R^{-1} Q' (trans 'N') or unit L'^T
    # (trans 'T'), over the column tables
    tabB = Utab if trans == "N" else Ltab
    for k in range(nt - 1, -1, -1):
        nr = tb.nr[k]
        acc = z[k]
        if nr > 1:
            acc = acc - _rowsum(tabB[tb.cs[k, 1:nr]].transpose(-1, -2),
                                x[tb.cr[k, 1:nr]])
        if trans == "N":
            d = tb.cs[k, 0]
            acc = torch.linalg.solve_triangular(
                Ltab[d], Utab[d].T @ acc, upper=True)
        x[k] = acc
    return _untile(symb, x, vec)


def lu_linsolve_blocksparse(S, B, t: int = 32, perm=None,
                            refine: int = 1, device="cuda"):
    """One-shot general-sparsity unsymmetric solve: analyze the
    symmetrized pattern, block-LU factor, solve, and `refine` rounds of
    iterative refinement against the original matrix.  The work runs
    on B's device when B is a tensor, else on `device`."""
    dev = B.device if torch.is_tensor(B) else resolve_device(device)
    Ssp = sp.csr_matrix(S)
    symb = analyze(((Ssp + Ssp.T) != 0), t=t, perm=perm)
    Ltab, Utab = factor_lu(symb, *assemble_lu(symb, Ssp, device=dev))
    b, = tensors(B, device=dev)
    x = solve_lu(symb, Ltab, Utab, b)
    Sd = _sparse_tensor(Ssp, b.dtype, dev)
    for _ in range(refine):
        r = b - _spmv(Sd, x)
        x = x + solve_lu(symb, Ltab, Utab, r)
    return x


def _sparse_tensor(S, dtype, dev):
    coo = sp.coo_matrix(S)
    idx = torch.as_tensor(np.vstack([coo.row, coo.col]).astype(np.int64),
                          device=dev)
    return torch.sparse_coo_tensor(
        idx, torch.as_tensor(coo.data, device=dev).to(dtype), coo.shape,
        check_invariants=False)


def _spmv(Sd, x):
    return (Sd @ x.unsqueeze(-1)).squeeze(-1) if x.dim() == 1 else Sd @ x
