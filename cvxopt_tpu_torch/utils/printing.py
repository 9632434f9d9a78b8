"""Matrix formatting, the cvxopt.printing equivalent; twin of
`cvxopt_tpu/utils/printing.py`.

`options` controls the formats; `matrix_str_default` / `matrix_repr`
format dense matrices the way the reference formats its matrix type,
`spmatrix_str_triplet` formats sparse matrices (the port's torch sparse
COO, or scipy) in triplet form, in stored order.
"""

from __future__ import annotations

import numpy as np
import torch

options = {"dformat": "% .2e", "iformat": "% i", "width": 7,
           "height": -1}


def _np(X):
    if torch.is_tensor(X):
        X = X.to_dense() if X.is_sparse else X
        return X.detach().cpu().numpy()
    return np.asarray(X)


def matrix_str_default(X) -> str:
    X = np.atleast_2d(_np(X))
    m, n = X.shape
    width = options["width"] if options["width"] >= 0 else n
    height = options["height"] if options["height"] >= 0 else m
    fmt = (options["iformat"] if np.issubdtype(X.dtype, np.integer)
           else options["dformat"])
    rows = []
    for i in range(min(m, height)):
        entries = [fmt % X[i, j] for j in range(min(n, width))]
        if n > width:
            entries.append("...")
        rows.append("[" + " ".join(entries) + "]")
    if m > height:
        rows.append("[...]")
    return "\n".join(rows) + "\n"


def matrix_repr(X) -> str:
    X = np.atleast_2d(_np(X))
    tc = "i" if np.issubdtype(X.dtype, np.integer) else (
        "z" if np.issubdtype(X.dtype, np.complexfloating) else "d")
    return f"<{X.shape[0]}x{X.shape[1]} matrix, tc='{tc}'>"


def _triplets(X):
    if torch.is_tensor(X):
        idx = X._indices().cpu().numpy()
        return idx[0], idx[1], X._values().cpu().numpy()
    import scipy.sparse as sp
    C = sp.coo_matrix(X)
    return C.row, C.col, C.data


def spmatrix_str_triplet(X) -> str:
    fmt = options["dformat"]
    lines = [f"({i},{j}) {fmt % v}" for i, j, v in zip(*_triplets(X))]
    return "\n".join(lines) + "\n"


def spmatrix_repr(X) -> str:
    nnz = X._nnz() if torch.is_tensor(X) else X.nnz
    return f"<{X.shape[0]}x{X.shape[1]} sparse matrix, nnz={nnz}>"
