"""Device meshes and sharded batch solving on torch.distributed.

Twin of `cvxopt_tpu/parallel/mesh.py`.  JAX runs one program over a mesh
of devices in one process; the port runs SPMD, one process per device,
all of them ranks of one `torch.distributed` process group.  A `Mesh`
names that group, its axis, this process's rank, the group's size and
the rank's `torch.device`.  Where JAX shards a leading axis of length K
over the mesh (`shard_map` with ``P(axis)``), rank r takes the rows
``[r*K/size, (r+1)*K/size)`` (`Mesh.local_rows`); a sharded output is
all-gathered, so that every rank holds what JAX's global array holds,
and a replicated output is already equal on every rank.

Backend by device: a mesh on 'cuda' runs NCCL, a mesh on 'cpu' gloo, and
`make_mesh` raises when the group's backend is the other one.  A mesh
needs an initialized process group (`multihost.initialize`, or
`dist.init_process_group`); `make_mesh` raises without one.  The
single-device path is ``mesh=None``, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from cvxopt_tpu_torch._device import as_tensor, resolve_device
from cvxopt_tpu_torch._tree import _leaves, _tmap
from cvxopt_tpu_torch.parallel import collectives as coll

BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the ranks of `group` (the world's process group) along
    `axis`."""
    axis: str
    rank: int
    size: int
    device: torch.device
    group: object

    def local_rows(self, total: int) -> slice:
        """This rank's rows of a leading axis of length `total` sharded
        over the mesh; raises unless `total` divides evenly, as
        `shard_map` does."""
        if total % self.size:
            raise ValueError(f"a leading axis of {total} does not shard "
                             f"over {self.size} ranks")
        per = total // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's axis "
                         f"{mesh.axis!r}")


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              device="cuda") -> Mesh:
    """A 1-D mesh over the ranks of the process group (the world).

    The rank runs on `device`; on a card, the current CUDA device
    (`torch.cuda.set_device`).  `n_devices`, when given, must be the
    world's size.  Raises RuntimeError when no process group is
    initialized."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: call parallel.multihost."
            "initialize (or torch.distributed.init_process_group) first; "
            "mesh=None is the single-device path")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the process group "
                         f"has {size} ranks")
    backend = str(dist.get_backend())
    if backend != BACKEND[dev.type]:
        raise ValueError(f"a mesh on {dev.type} runs "
                         f"{BACKEND[dev.type]}, but the group's backend "
                         f"is {backend}")
    return Mesh(axis, dist.get_rank(), size, dev, dist.group.WORLD)


def shard_batch(tree, mesh: Mesh, axis: str = "batch"):
    """Every array of `tree` on the mesh's device, cut to this rank's
    rows of its leading axis; arrays whose leading dimension does not
    divide by the mesh size are replicated (kept whole)."""
    check_axis(mesh, axis)

    def put(x):
        x = as_tensor(x, mesh.device).to(mesh.device)
        if x.dim() >= 1 and x.shape[0] > 0 and x.shape[0] % mesh.size == 0:
            return x[mesh.local_rows(x.shape[0])]
        return x

    return _tmap(put, tree)


def sharded_batch_solve(solver_fn, batched_args: Sequence,
                        static_args: Sequence = (),
                        mesh: Optional[Mesh] = None,
                        axis: str = "batch"):
    """Solve a batch of independent problems, sharded across a mesh.

    The JAX function vmaps `solver_fn` over one instance.  The port's
    solver cores are batched already (and their data-dependent loops do
    not run under `torch.func.vmap`), so here ``solver_fn(*static_args,
    *local_batched_args)`` receives this rank's whole slice of the batch;
    every rank solves its instances with no collective, as under JAX.
    Every tensor it returns must carry the local batch as leading axis
    (else ValueError) and is all-gathered, so that every rank returns the
    whole batch's results; a leaf that is not a tensor (a host count) is
    returned as this rank computed it.  A batch that does not divide by
    the mesh size is solved whole on every rank.  Without `mesh`, a mesh
    over the world on the card (`make_mesh`)."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    local = shard_batch(list(batched_args), mesh, axis=axis)
    out = solver_fn(*static_args, *local)
    nb = batched_args[0].shape[0]
    if nb == 0 or nb % mesh.size:
        return out
    per = nb // mesh.size
    for t in _leaves(out):
        if torch.is_tensor(t) and (t.dim() == 0 or t.shape[0] != per):
            raise ValueError(
                f"solver_fn returned a tensor of shape {tuple(t.shape)} "
                f"without the local batch of {per} as leading axis")
    return _tmap(lambda t: coll.all_gather(t, mesh, tiled=True)
                 if torch.is_tensor(t) else t, out)
