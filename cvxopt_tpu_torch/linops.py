"""Operator-form linear maps, twin of `cvxopt_tpu/linops.py`:

    op.mv(x)  == G @ x        (R^n -> cone space)
    op.rmv(z) == G.T @ z      (cone space -> R^n)

Both act on torch tensors with optional leading batch axes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from cvxopt_tpu_torch._device import as_tensor, resolve_device
from cvxopt_tpu_torch.ops.matvec import mv, mvt


@dataclass(frozen=True)
class LinearOperator:
    mv: Callable       # x -> A @ x
    rmv: Callable      # y -> A.T @ y
    shape: Tuple[int, int]

    def __call__(self, x, trans: str = "N"):
        return self.mv(x) if trans == "N" else self.rmv(x)


def aslinearoperator(A, device="cuda") -> LinearOperator:
    """A as a LinearOperator.  A tensor keeps its dtype and device; other
    data goes to `device` (default the card, as every entry point) in
    float64 when it is integer or boolean, as the JAX package's x64
    arrays are."""
    if isinstance(A, LinearOperator):
        return A
    if torch.is_tensor(A):
        M = A
    else:
        a = np.asarray(A)
        if a.dtype.kind in "iub":
            a = a.astype(np.float64)
        M = as_tensor(a, resolve_device(device))
    return LinearOperator(mv=lambda x: mv(M, x), rmv=lambda y: mvt(M, y),
                          shape=tuple(M.shape[-2:]))
