"""cvxopt.amd-compatible namespace, twin of `cvxopt_tpu/amd.py`:
`order(A)`, a minimum-degree fill-reducing ordering of the symmetrized
pattern, computed on the host by the port's native library
(cvxopt_tpu_torch/native/mindeg.c) or, without a C compiler, in pure
Python."""

from cvxopt_tpu_torch.ops.spsolve import amd_order as order

__all__ = ["order"]
