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

The sparse direct path: `ops.sparse_kkt` (`lp_sparse`/`qp_sparse`, the
banded and tile-map kktsolvers), `ops.banded`, `ops.blocksparse`,
`ops.spsolve` and the `cholmod`/`umfpack`/`amd` namespaces; the dense
numeric namespaces `ops.blas`, `ops.lapack`, `utils.fft`; the matrix
constructors of `base` (`matrix`, `spmatrix` as an uncoalesced torch
sparse COO tensor, `sparse`, `spdiag`) with the elementwise functions,
and `normal`/`uniform`/`setseed`/`getseed` on a seeded torch.Generator.

Module and public names follow `cvxopt_tpu`, so each function has a
twin there, but for two layers of the port's own: `ipm` (the status
codes, the IPM loop and the cascade's run that the JAX package keeps in
`conelp` and `coneqp`) and `ipm_graph` (the CUDA-graph tapes).  This
package imports torch, numpy and scipy only.

The IPM diverges on reduced-precision matmul passes, so TF32 is turned
off for matmuls and cuDNN when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from cvxopt_tpu_torch.cones import ConeDims  # noqa: E402
from cvxopt_tpu_torch._device import resolve_device  # noqa: E402
from cvxopt_tpu_torch import cones  # noqa: E402
from cvxopt_tpu_torch import scaling  # noqa: E402
from cvxopt_tpu_torch import kkt  # noqa: E402
from cvxopt_tpu_torch.linops import LinearOperator, \
    aslinearoperator  # noqa: E402
from cvxopt_tpu_torch import kkt_structured  # noqa: E402
from cvxopt_tpu_torch import solvers  # noqa: E402
from cvxopt_tpu_torch import modeling  # noqa: E402
from cvxopt_tpu_torch import mpsio  # noqa: E402
from cvxopt_tpu_torch import base  # noqa: E402

# the reference's top-level API
from cvxopt_tpu_torch.base import (  # noqa: E402
    matrix, spmatrix, sparse, spdiag, exp, log, sqrt, sin, cos, mul,
    div, emin, emax, trans, ctrans, real, imag,
)
from cvxopt_tpu_torch.utils.rng import normal, uniform, setseed, \
    getseed  # noqa: E402
from cvxopt_tpu_torch.utils import printing  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ConeDims", "cones", "scaling", "kkt", "solvers", "modeling",
    "mpsio", "base", "LinearOperator", "aslinearoperator",
    "matrix", "spmatrix", "sparse", "spdiag", "exp", "log", "sqrt",
    "sin", "cos", "mul", "div", "emin", "emax", "trans", "ctrans",
    "real", "imag",
    "normal", "uniform", "setseed", "getseed", "printing",
    "__version__", "resolve_device", "kkt_structured",
]
