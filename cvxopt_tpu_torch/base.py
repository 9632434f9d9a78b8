"""Matrix constructors and typed elementwise functions, the cvxopt.base
equivalents; twin of `cvxopt_tpu/base.py`.

The reference's dense `matrix` is a dense tensor here and its sparse
`spmatrix` an UNCOALESCED ``torch.sparse_coo_tensor``: it keeps its
triplets in insertion order, duplicates included, as the JAX package's
BCOO does, so `sp_I`/`sp_J`/`sp_V` agree element for element (read
them through ``_indices()``/``_values()``, which an uncoalesced tensor
allows; ``to_dense()`` sums duplicates).

  matrix(data, size)   nested lists are COLUMNS, flat data fills
                       column-major
  spmatrix(V, I, J)    triplet sparse constructor
  sparse(blocks)       block assembly / sparsification, in triplet form
  spdiag(values)       (block-)diagonal matrix
  exp log sqrt sin cos elementwise math
  mul div emin emax    elementwise products, quotients and extrema

Constructors from Python or numpy data take ``device=`` (default
"cuda"); the other functions work on the device of their tensor
arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from cvxopt_tpu_torch._device import resolve_device, tensors

_TC = {None: None, "d": torch.float64, "i": torch.int32,
       "z": torch.complex128}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _is_sp(x):
    return torch.is_tensor(x) and x.is_sparse


def matrix(data, size=None, tc=None, device="cuda"):
    """cvxopt.matrix-compatible constructor: nested sequences are
    COLUMNS; flat data fills column-major; a scalar with a size
    broadcasts.  Typecodes 'i'/'d'/'z' give int32/float64/complex128;
    complex data stays complex."""
    dtype = _TC[tc]
    if isinstance(data, (list, tuple)) and data and \
            (isinstance(data[0], (list, tuple, np.ndarray))
             or torch.is_tensor(data[0])):
        blocks = []
        for c in data:
            a = _np(c)
            if not np.iscomplexobj(a):
                a = a.astype(float)
            blocks.append(a.reshape(-1, 1) if a.ndim < 2 else a)
        X = np.concatenate(blocks, axis=1)
    elif np.isscalar(data):
        X = np.full((1, 1) if size is None else size, data,
                    dtype=complex if isinstance(data, complex) else float)
    else:
        a = _np(data)
        if size is not None:
            X = a.reshape(size, order="F")
        else:
            X = a.reshape(-1, 1) if a.ndim == 1 else a
    dev = data.device if torch.is_tensor(data) else resolve_device(device)
    return torch.as_tensor(np.ascontiguousarray(X), dtype=dtype, device=dev)


def _coo(V, I, J, size, dev):
    idx = torch.as_tensor(np.stack([I, J]).astype(np.int64), device=dev)
    return torch.sparse_coo_tensor(idx, torch.as_tensor(np.array(V),
                                                        device=dev),
                                   size=size, check_invariants=False)


def spmatrix(V, I, J, size=None, tc=None, device="cuda"):
    """Triplet sparse constructor -> uncoalesced sparse COO tensor in
    the given order.  Complex values stay complex; tc='z' forces
    complex128."""
    I = _np(I).astype(np.int64).reshape(-1)
    J = _np(J).astype(np.int64).reshape(-1)
    Va = _np(V)
    if tc == "z":
        Va = Va.astype(np.complex128)
    elif not np.iscomplexobj(Va):
        Va = Va.astype(float)
    Va = np.ascontiguousarray(np.broadcast_to(Va.reshape(-1), I.shape))
    if size is None:
        size = (int(I.max()) + 1 if I.size else 0,
                int(J.max()) + 1 if J.size else 0)
    dev = V.device if torch.is_tensor(V) else resolve_device(device)
    return _coo(Va, I, J, tuple(size), dev)


def _block_coo(B):
    """Block -> (rows, cols, vals, shape) triplets on the host, without
    densifying sparse blocks."""
    if _is_sp(B):
        idx = _np(B._indices())
        return idx[0], idx[1], _np(B._values()), tuple(B.shape)
    if hasattr(B, "tocoo"):                  # scipy.sparse
        coo = B.tocoo()
        return (np.asarray(coo.row), np.asarray(coo.col),
                np.asarray(coo.data), coo.shape)
    D = _np(B)
    if D.ndim == 1:
        D = D.reshape(-1, 1)
    r, c = np.nonzero(D)
    return r, c, D[r, c], D.shape


def _fromdense(D):
    """Dense -> sparse COO of its nonzeros in row-major order (as
    BCOO.fromdense)."""
    r, c = torch.nonzero(D, as_tuple=True)
    return torch.sparse_coo_tensor(torch.stack([r, c]), D[r, c],
                                   size=tuple(D.shape),
                                   check_invariants=False)


def sparse(blocks, tc=None, device="cuda"):
    """Sparsify a dense matrix, or assemble a block matrix from nested
    lists of blocks: sparse([[B11, B21], [B12, B22]]) where inner lists
    are block COLUMNS.  Sparse blocks are assembled in triplet form,
    never densified.  The result lies on the device of a tensor block,
    else on `device`."""
    if not isinstance(blocks, (list, tuple)):
        return _fromdense(_dense2(blocks, device))
    flat = [b for cb in blocks
            for b in (cb if isinstance(cb, (list, tuple)) else [cb])]
    dev = next((b.device for b in flat if torch.is_tensor(b)), None) \
        or resolve_device(device)
    rows, cols, vals = [], [], []
    col_off = 0
    nrows_total = 0
    for colblocks in blocks:
        if not isinstance(colblocks, (list, tuple)):
            colblocks = [colblocks]
        row_off = 0
        width = None
        for B in colblocks:
            r, c, v, shp = _block_coo(B)
            if width is None:
                width = shp[1]
            elif shp[1] != width:
                raise ValueError("block column width mismatch")
            rows.append(r + row_off)
            cols.append(c + col_off)
            vals.append(v)
            row_off += shp[0]
        nrows_total = max(nrows_total, row_off)
        col_off += width if width is not None else 0
    if not rows:
        return _fromdense(torch.zeros((0, 0), device=dev))
    dt = complex if any(np.iscomplexobj(v) for v in vals) else float
    V = np.concatenate([np.asarray(v, dtype=dt) for v in vals])
    if tc == "z":
        V = V.astype(np.complex128)
    return _coo(V, np.concatenate(rows), np.concatenate(cols),
                (nrows_total, col_off), dev)


def spdiag(values, device="cuda"):
    """(Block-)diagonal sparse matrix: a vector gives a diagonal matrix,
    a list of matrices a block-diagonal one."""
    dev = values.device if torch.is_tensor(values) else \
        resolve_device(device)
    if isinstance(values, (list, tuple)) and values and \
            _np(values[0]).ndim == 2:
        mats = [_np(v) for v in values]
        n = sum(m.shape[0] for m in mats)
        dt = complex if any(np.iscomplexobj(m) for m in mats) else float
        D = np.zeros((n, n), dtype=dt)
        off = 0
        for m in mats:
            k = m.shape[0]
            D[off:off + k, off:off + k] = m
            off += k
        return _fromdense(torch.as_tensor(D, device=dev))
    v = torch.as_tensor(_np(values).reshape(-1), device=dev)
    if not v.is_complex() and not v.is_floating_point():
        v = v.double()
    return _fromdense(torch.diag(v))


def matrix_tofile(M, f):
    """Write a dense matrix's raw element bytes to an open binary file
    (matrix.tofile): the column-major element stream."""
    f.write(np.ascontiguousarray(_np(M).T).tobytes())


def matrix_fromfile(f, size, tc="d", device="cuda"):
    """Read a dense matrix written by `matrix_tofile`: `size` = (nrows,
    ncols), tc 'd' | 'z' | 'i'."""
    dt = {"d": np.float64, "z": np.complex128, "i": np.int64}[tc]
    m, n = size
    a = np.frombuffer(f.read(m * n * np.dtype(dt).itemsize), dtype=dt)
    return torch.as_tensor(np.ascontiguousarray(a.reshape(n, m).T),
                           device=resolve_device(device))


def spmatrix_tofile(S, f):
    """Write a sparse matrix's triplets (I, J, V back to back) to an
    open binary file."""
    idx = _np(S._indices())
    f.write(np.ascontiguousarray(idx[0], np.int64).tobytes())
    f.write(np.ascontiguousarray(idx[1], np.int64).tobytes())
    f.write(np.ascontiguousarray(_np(S._values())).tobytes())


def spmatrix_fromfile(f, nnz, size, tc="d", device="cuda"):
    """Read triplets written by `spmatrix_tofile`."""
    dt = {"d": np.float64, "z": np.complex128}[tc]
    I = np.frombuffer(f.read(nnz * 8), dtype=np.int64)
    J = np.frombuffer(f.read(nnz * 8), dtype=np.int64)
    V = np.frombuffer(f.read(nnz * np.dtype(dt).itemsize), dtype=dt)
    return spmatrix(V.copy(), I, J, size=size, device=device)


def _dense2(B, device="cuda"):
    if _is_sp(B):
        B = B.to_dense()
    if hasattr(B, "toarray"):
        B = B.toarray()
    B, = tensors(B, device=device)
    if not B.is_complex():
        B = B.double()
    return B.reshape(-1, 1) if B.dim() == 1 else B


# ---- mixed sparse/dense linear algebra (base.c axpy/gemv/gemm/syrk) -----

def _dense_of(x):
    return x.to_dense() if _is_sp(x) else x


def _matmul(A, B):
    if B.dim() == 1:
        return (A @ B.unsqueeze(-1)).squeeze(-1)
    return A @ B


def axpy(x, y, alpha=1.0):
    """y + alpha*x for any dense/sparse mix."""
    x, y = tensors(x, y)
    return _dense_of(y) + alpha * _dense_of(x)


def gemv(A, x, trans="N", alpha=1.0, beta=0.0, y=None):
    """alpha*A*x (+ beta*y); A dense or sparse."""
    A, x, y = tensors(A, x, y)
    out = alpha * _matmul(A.t() if trans == "T" else A, x)
    if y is not None and beta != 0.0:
        out = out + beta * y
    return out


def gemm(A, B, transA="N", transB="N", alpha=1.0):
    """alpha*op(A)*op(B); either operand may be sparse (the product of
    two sparse operands is sparse)."""
    A, B = tensors(A, B)
    Ao = A.t() if transA == "T" else A
    Bo = B.t() if transB == "T" else B
    out = Ao @ Bo
    return out * alpha if alpha != 1.0 else out


def syrk(A, trans="N", alpha=1.0):
    """alpha*A*A' (or A'*A with trans='T'), dense; A dense or sparse.
    For the fixed-pattern re-assembly see
    ops/sparse_kkt.make_band_plan/assemble_band."""
    A, = tensors(A)
    out = A.t() @ A if trans == "T" else A @ A.t()
    return alpha * _dense_of(out)


def symv(A, x, alpha=1.0):
    """alpha * sym(A) * x, reading only the lower triangle of A."""
    A, x = tensors(A, x)
    Ad = _dense_of(A)
    S = torch.tril(Ad) + torch.tril(Ad, -1).transpose(-1, -2)
    return alpha * _matmul(S, x)


# ---- spmatrix accessors (.I/.J/.V/.CCS) ----------------------------------

def sp_I(X):
    """Row indices of the entries (spmatrix.I), in stored order."""
    return X._indices()[0]


def sp_J(X):
    """Column indices of the entries (spmatrix.J)."""
    return X._indices()[1]


def sp_V(X):
    """Entry values (spmatrix.V)."""
    return X._values()


def sp_CCS(X):
    """Compressed-column triple (colptr, rowind, values) on the host,
    the spmatrix.CCS attribute."""
    idx = _np(X._indices())
    vals = _np(X._values())
    order = np.lexsort((idx[0], idx[1]))
    colptr = np.zeros(X.shape[1] + 1, dtype=np.int64)
    np.add.at(colptr, idx[1][order] + 1, 1)
    return np.cumsum(colptr), idx[0][order], vals[order]


def trans(x):
    """Matrix transpose."""
    return _as(x).transpose(-1, -2)


def ctrans(x):
    """Conjugate (Hermitian) transpose."""
    return _as(x).transpose(-1, -2).conj().resolve_conj()


def real(x):
    x = _as(x)
    return x.real if x.is_complex() else x


def imag(x):
    x = _as(x)
    return x.imag if x.is_complex() else torch.zeros_like(x)


# ---- elementwise math ----------------------------------------------------

def exp(x):
    return torch.exp(_as(x))


def log(x):
    return torch.log(_as(x))


def sqrt(x):
    return torch.sqrt(_as(x))


def sin(x):
    return torch.sin(_as(x))


def cos(x):
    return torch.cos(_as(x))


def mul(*args):
    args = tensors(*map(_dense_of, args))
    out = args[0]
    for a in args[1:]:
        out = out * a
    return out


def div(x, y):
    x, y = tensors(_dense_of(x), _dense_of(y))
    return x / y


def emin(*args):
    args = tensors(*map(_dense_of, args))
    out = args[0]
    for a in args[1:]:
        out = torch.minimum(out, a)
    return out


def emax(*args):
    args = tensors(*map(_dense_of, args))
    out = args[0]
    for a in args[1:]:
        out = torch.maximum(out, a)
    return out


def _as(x):
    x, = tensors(_dense_of(x))
    return x
