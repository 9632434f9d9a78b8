"""Multi-process initialization helpers.

Twin of `cvxopt_tpu/parallel/multihost.py`.  Call `initialize()` once in
every process (one process per card) before building a mesh; then
`global_mesh()` is a mesh over all ranks of the world.  Where JAX's
`jax.distributed.initialize` is told a coordinator, the port gives
`dist.init_process_group` its address, world size and rank; with none
of them it reads torchrun's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from cvxopt_tpu_torch._device import resolve_device
from cvxopt_tpu_torch.parallel.mesh import BACKEND, Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               **kwargs):
    """`dist.init_process_group` for this process: the backend follows
    `device` (NCCL on 'cuda', gloo on 'cpu'), the rendezvous is
    ``tcp://coordinator_address`` (else ``env://``, or kwargs'
    `init_method`), `num_processes` ranks and this one `process_id`;
    other kwargs (`timeout`, `store`, ...) pass through.  A no-op when a
    process group is initialized already; a failed init raises.

    On 'cuda' the process is first bound to one card, so that the ranks
    of a host do not all land on card 0: card LOCAL_RANK (torchrun's),
    else this rank (`process_id`, else RANK, else 0) modulo the host's
    card count."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            rank = process_id if process_id is not None else \
                int(os.environ.get("RANK", 0))
            card = rank % torch.cuda.device_count()
        else:
            card = int(local)
        torch.cuda.set_device(card)
    if "init_method" not in kwargs and "store" not in kwargs:
        kwargs["init_method"] = (f"tcp://{coordinator_address}"
                                 if coordinator_address else "env://")
    dist.init_process_group(
        BACKEND[dev.type],
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)


def global_mesh(axis: str = "batch", device="cuda") -> Mesh:
    """1-D mesh over all ranks of the world (all hosts)."""
    return make_mesh(axis=axis, device=device)


def local_batch_slice(total: int, axis_size: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """The slice of a globally-sharded batch owned by this process (for
    per-process data loading)."""
    up = dist.is_initialized()
    nproc = (dist.get_world_size() if up else 1) if axis_size is None \
        else axis_size
    pid = (dist.get_rank() if up else 0) if index is None else index
    per = total // nproc
    return slice(pid * per, (pid + 1) * per)
