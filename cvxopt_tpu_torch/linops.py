"""Operator-form linear maps, twin of `cvxopt_tpu/linops.py`:

    op.mv(x)  == G @ x        (R^n -> cone space)
    op.rmv(z) == G.T @ z      (cone space -> R^n)

Both act on torch tensors with optional leading batch axes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from cvxopt_tpu_torch.ops.matvec import mv, mvt


@dataclass(frozen=True)
class LinearOperator:
    mv: Callable       # x -> A @ x
    rmv: Callable      # y -> A.T @ y
    shape: Tuple[int, int]

    def __call__(self, x, trans: str = "N"):
        return self.mv(x) if trans == "N" else self.rmv(x)


def aslinearoperator(A) -> LinearOperator:
    if isinstance(A, LinearOperator):
        return A
    M = torch.as_tensor(A)
    return LinearOperator(mv=lambda x: mv(M, x), rmv=lambda y: mvt(M, y),
                          shape=tuple(M.shape[-2:]))
