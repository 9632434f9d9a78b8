"""cvxopt_tpu_torch — the PyTorch/CUDA port of `cvxopt_tpu`.

The cone solvers (`coneqp`, `conelp`; batched cores and cascades), their
front ends (`lp`, `qp`, `socp`, `sdp`) and the nonlinear solvers (`cp`,
`cpl`, `gp`; batched `cvxprog.make_cpl`), all in `solvers`, over
R^l_+ x SOC x PSD, with the reference's advanced forms: operator-form
G/A/P (`LinearOperator`, `aslinearoperator`), callable kktsolvers,
dict-valued x in `conelp`, and the structure-exploiting kktsolvers of
`kkt_structured`.  The condensed-KKT factor `kkt.kkt_chol2` runs its
Schur assembly, blocked Cholesky and panel solves in hand-written CUDA
kernels (`ops/fused_chol.py`, `csrc/fused_chol.cu`).

The LP modeling and integer path: the piecewise-linear modeling DSL
(`modeling`) with MPS I/O (`mpsio`), the batched dense simplex
(`simplex`; `lp(..., solver='glpk')`), branch-and-bound with cover cuts
(`ilp`), both under the `glpk` namespace, and the MOSEK bridge (`msk`;
`solver='mosek'`).

Module and public names follow `cvxopt_tpu`, so each function has a
twin there.  This package imports torch and numpy only.

The IPM diverges on reduced-precision matmul passes, so TF32 is turned
off for matmuls and cuDNN when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from cvxopt_tpu_torch.cones import ConeDims  # noqa: E402
from cvxopt_tpu_torch._device import resolve_device  # noqa: E402
from cvxopt_tpu_torch.linops import LinearOperator, \
    aslinearoperator  # noqa: E402
from cvxopt_tpu_torch import kkt_structured  # noqa: E402
from cvxopt_tpu_torch import solvers  # noqa: E402
from cvxopt_tpu_torch import modeling  # noqa: E402
from cvxopt_tpu_torch import mpsio  # noqa: E402

__all__ = ["ConeDims", "resolve_device", "LinearOperator",
           "aslinearoperator", "kkt_structured", "solvers", "modeling",
           "mpsio"]
