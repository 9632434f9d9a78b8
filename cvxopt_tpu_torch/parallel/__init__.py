"""Parallel / distributed execution layer on torch.distributed.

Twin of `cvxopt_tpu/parallel/`:

  - mesh.py: meshes of ranks and sharded batch solving (data
    parallelism over independent problem instances)
  - collectives.py: reductions used by distributed solves (residual
    norms, step lengths, Schur assembly), over NCCL on cards and gloo
    on the CPU
  - schur.py: the block-arrow and block-partitioned KKT solvers (model
    parallelism for one large scenario-coupled QP)
  - conesolve.py: coneqp with its cone blocks sharded across ranks
  - multihost.py: process-group initialization
"""

from cvxopt_tpu_torch.parallel.mesh import (
    make_mesh, shard_batch, sharded_batch_solve,
)
from cvxopt_tpu_torch.parallel import collectives

__all__ = ["make_mesh", "shard_batch", "sharded_batch_solve",
           "collectives"]
