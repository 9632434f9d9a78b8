"""cvxopt_tpu_torch — the PyTorch/CUDA port of `cvxopt_tpu`.

The batched cone-QP interior-point solve (`coneqp.make_coneqp`,
`coneqp.make_coneqp_cascade`, `coneqp.coneqp`) with its cone algebra,
Nesterov-Todd scaling and the condensed-KKT factor `kkt.kkt_chol2`,
whose Schur assembly, blocked Cholesky and panel solves run in
hand-written CUDA kernels (`ops/fused_chol.py`, `csrc/fused_chol.cu`).

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

__all__ = ["ConeDims", "resolve_device"]
