"""Collectives over a mesh's process group.

Twin of `cvxopt_tpu/parallel/collectives.py`: the reductions of a
distributed solve (residual norms, duality gaps, global step lengths,
Schur-complement assembly).  Each function takes the `Mesh` where the
JAX function takes the axis name, and is called by every rank of the
mesh, as JAX's are called inside `shard_map`:

  psum / pmax / pmin     `dist.all_reduce` with SUM / MAX / MIN
  all_gather             `dist.all_gather` into a list, then stack/cat
  ppermute_ring          `dist.batch_isend_irecv`, one send and one
                         receive a rank

A tensor off the mesh's device raises: an NCCL mesh takes
CUDA tensors only, a gloo mesh CPU tensors only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cvxopt_tpu_torch import cones
from cvxopt_tpu_torch._device import as_tensor, check_on


def _on(x, mesh):
    """A tensor stays where it is and must lie on the mesh's device; a
    Python number becomes a tensor there."""
    if not torch.is_tensor(x):
        return as_tensor(x, mesh.device)
    check_on(mesh.device, x)
    return x


def _all_reduce(x, mesh, op):
    y = _on(x, mesh).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=mesh.group)
    return y


def psum(x, mesh):
    """Sum across the mesh (gap, s'z, Schur terms)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmax(x, mesh):
    """Max across the mesh (max_step aggregation: the global
    min{t : x + t e >= 0} is the max of per-shard values)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def pmin(x, mesh):
    return _all_reduce(x, mesh, dist.ReduceOp.MIN)


def pnorm2(x, mesh):
    """Global 2-norm of a sharded vector."""
    return torch.sqrt(psum(torch.sum(x * x), mesh))


def pdot(x, y, mesh):
    """Global inner product of sharded vectors."""
    return psum(torch.sum(x * y), mesh)


def all_gather(x, mesh, tiled: bool = False):
    """Every rank's `x`, stacked along a new leading axis, or
    concatenated along the leading axis when `tiled`."""
    x = _on(x, mesh)
    parts = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
             for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts) if tiled else torch.stack(parts)


def ppermute_ring(x, mesh, n: int, shift: int = 1):
    """Ring permutation: rank i < n sends `x` to rank (i + shift) % n;
    a rank that receives nothing (i >= n) gets zeros, as under
    `lax.ppermute`."""
    x = _on(x, mesh)
    r = mesh.rank
    if r >= n:
        return torch.zeros_like(x)
    dst, src = (r + shift) % n, (r - shift) % n
    if dst == r:
        return x.clone()
    ranks = dist.get_process_group_ranks(mesh.group)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[dst], mesh.group),
           dist.P2POp(dist.irecv, out, ranks[src], mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# ---------------------------------------------------------------------
# Cone-aware distributed reductions (block-sharded cone vectors)
#
# One large cone program sharded so that each rank holds whole cone
# blocks (a shard-local ConeDims describes its slice: 'l' entries split
# anywhere, 'q'/'s' blocks whole per shard).  The NT scaling is
# blockwise and needs no communication; each quantity of the IPM's
# outer loop reduces to one scalar collective.
# ---------------------------------------------------------------------

def psdot(x_local, y_local, local_dims, mesh):
    """Global cone inner product <x, y> of a block-sharded pair
    (cones.sdot per shard + psum): the distributed duality gap."""
    return psum(cones.sdot(x_local, y_local, local_dims), mesh)


def psnrm2(x_local, local_dims, mesh):
    """Global cone norm of a block-sharded vector (distributed residual
    norms)."""
    s = psum(cones.sdot(x_local, x_local, local_dims), mesh)
    return torch.sqrt(torch.clamp(s, min=0.0))


def pmax_step(x_local, local_dims, mesh):
    """Global min{t : x + t e >=_K 0} of a block-sharded cone vector:
    the per-shard `cones.max_step` followed by one pmax."""
    return pmax(cones.max_step(x_local, local_dims), mesh)


def pstep_length(ds_local, dz_local, local_dims, mesh, step: float = 0.99):
    """Global IPM step length for sharded scaled directions
    (coneprog.py:2459 semantics): min(1, step / max(ts, tz, 0))."""
    ts = pmax_step(ds_local, local_dims, mesh)
    tz = pmax_step(dz_local, local_dims, mesh)
    t = torch.clamp(torch.maximum(ts, tz), min=0.0)
    one = torch.ones_like(t)
    return torch.where(t == 0.0, one, torch.minimum(one, step / t))
