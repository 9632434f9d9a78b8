"""The port's parallel layer on spawned CPU ranks: the harness of the
parallel twins, the rank programs they run, and the port's own tests of
`parallel.mesh` and `parallel.multihost`.

`run_world(fn, world, path, *args)` starts `world` processes with
`torch.multiprocessing`'s spawn method; rank r joins a gloo group whose
rendezvous is a file under `path` (never a TCP port: several test
workers run at once), calls ``fn(r, world, *args)`` with one torch
thread, and saves what it returns under `path`.  Every process is
joined with a timeout; a world that is not done by then is terminated
and the test fails, so a deadlock fails its test instead of stalling the
run.  A rank that raises fails the test with its traceback.

The spawned ranks import this module, so it imports no JAX: the twins
(`test_torch_{schur,block_kkt,collectives,conesolve}.py`) run the JAX
side in the pytest process, on a mesh of as many of the 8 virtual
devices that tests/conftest.py gives, and compare."""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from cvxopt_tpu_torch.cones import ConeDims
from cvxopt_tpu_torch.coneqp import coneqp, make_coneqp
from cvxopt_tpu_torch.parallel import (
    make_mesh, shard_batch, sharded_batch_solve, collectives as coll,
)
from cvxopt_tpu_torch.parallel import mesh as pmesh
from cvxopt_tpu_torch.parallel import multihost
from cvxopt_tpu_torch.parallel.schur import (
    random_arrow_qp, make_arrow_kktsolver, random_block_qp,
    make_block_kktsolver,
)
from cvxopt_tpu_torch.parallel.conesolve import make_coneqp_sharded
from cvxopt_tpu_torch.scaling import identity_scaling, compute_scaling

torch.set_num_threads(1)

INIT_TIMEOUT_S = 60     # gloo: process-group init and every collective
WORLD_TIMEOUT_S = 180   # a whole world, spawn to exit


def _rank_main(rank, fn, world, rdv, outdir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + rdv, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def run_world(fn, world, path, *args, timeout=WORLD_TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` on `world` spawned gloo ranks;
    returns their results by rank.  Raises TimeoutError (after
    terminating every rank) when the world is not done in `timeout`
    seconds."""
    path = str(path)
    os.makedirs(path, exist_ok=True)
    ctx = tmp.start_processes(
        _rank_main, args=(fn, world, os.path.join(path, "rdv"), path, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"a world of {world} ranks was not "
                                   f"done within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(os.path.join(path, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy() if torch.is_tensor(tree) else tree


def _solution(sol):
    return {"x": sol["x"], "y": sol["y"], "z": sol["z"],
            "status": sol["status"], "iterations": sol["iterations"]}


def assert_replicated(results, keys=None):
    """Replicated outputs are the same on every rank, bit for bit (an
    all-reduce hands every rank the same sum, and all-gathered blocks
    are copies)."""
    for r in results[1:]:
        for k in (keys or results[0]):
            np.testing.assert_array_equal(np.asarray(r[k]),
                                          np.asarray(results[0][k]), k)


# ---- rank programs of the twins ------------------------------------------

def rank_collectives(rank, world, ldims, xs, ys, v, w):
    """tests/test_torch_collectives.py: each collective on this rank's
    shard."""
    mesh = make_mesh(world, axis="shards", device="cpu")
    x, y = torch.as_tensor(xs[rank]), torch.as_tensor(ys[rank])
    vr, wr = torch.as_tensor(v[rank]), torch.as_tensor(w[rank])
    out = dict(
        psdot=coll.psdot(x, y, ldims, mesh),
        psnrm2=coll.psnrm2(x, ldims, mesh),
        pmax_step=coll.pmax_step(-x, ldims, mesh),
        pstep_length=coll.pstep_length(-x, -y, ldims, mesh),
        psum=coll.psum(vr, mesh), pmax=coll.pmax(vr, mesh),
        pmin=coll.pmin(vr, mesh), pnorm2=coll.pnorm2(vr, mesh),
        pdot=coll.pdot(vr, wr, mesh),
        all_gather=coll.all_gather(vr, mesh),
        all_gather_tiled=coll.all_gather(vr, mesh, tiled=True),
        ring=coll.ppermute_ring(vr, mesh, world),
        ring_back=coll.ppermute_ring(vr, mesh, world, shift=-1),
        ring_part=coll.ppermute_ring(vr, mesh, world - 1))
    return _np(out)


def _arrow_w(m, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 2.0, m)
    W = identity_scaling(ConeDims(l=m), device="cpu")
    W["d"], W["di"] = torch.as_tensor(d), torch.as_tensor(1.0 / d)
    return d, W, rng


def rank_schur(rank, world, K, nk, n0, mk):
    """tests/test_torch_schur.py: the sharded arrow kktsolver against
    its mesh=None run (tests/test_schur.py:85-113), and a full coneqp
    with it (:68-82)."""
    mesh = make_mesh(world, device="cpu")
    qp = random_arrow_qp(K, nk, n0, mk, seed=5, device="cpu")
    m, n = K * mk, K * nk + n0
    _, W, rng = _arrow_w(m, 2)
    bx = torch.as_tensor(rng.standard_normal(n))
    bz = torch.as_tensor(rng.standard_normal(m))
    by = torch.zeros(0, dtype=torch.float64)
    ux, _, Wuz = make_arrow_kktsolver(qp, mesh=mesh)(W)(bx, by, bz)
    ux1, _, Wuz1 = make_arrow_kktsolver(qp)(W)(bx, by, bz)
    qp = random_arrow_qp(K, nk, n0, mk, seed=7, device="cpu")
    sol = coneqp(qp.flat_P(), qp.flat_q(), qp.flat_G(), qp.flat_h(),
                 kktsolver=make_arrow_kktsolver(qp, mesh=mesh), device="cpu")
    return _np(dict(ux=ux, Wuz=Wuz, ux1=ux1, Wuz1=Wuz1, **_solution(sol)))


def block_w(qp, seed):
    """A non-identity NT scaling of the block QP's global cone (from
    strictly interior s, z) and right-hand sides, made with numpy."""
    rng = np.random.default_rng(seed)
    dims = qp.dims

    def interior():
        parts = [rng.uniform(0.5, 2.0, dims.l)]
        for m in dims.q:
            u = rng.standard_normal(m)
            u[0] = np.linalg.norm(u[1:]) + rng.uniform(0.5, 1.5)
            parts.append(u)
        return np.concatenate(parts)

    s, z = interior(), interior()
    n = qp.K * qp.nk + qp.n0
    p = qp.K * qp.pk + qp.p0
    rhs = (rng.standard_normal(n), rng.standard_normal(p),
           rng.standard_normal(dims.cdim))
    return s, z, rhs


def block_solve(qp, mesh, seed):
    """(ux, uy, W uz) of the block kktsolver at block_w's scaling."""
    s, z, rhs = block_w(qp, seed)
    W, _ = compute_scaling(torch.as_tensor(s), torch.as_tensor(z), qp.dims)
    solve = make_block_kktsolver(qp, mesh=mesh)(W)
    return solve(*(torch.as_tensor(r) for r in rhs))


def solve_block(qp, mesh=None):
    return coneqp(qp.flat_P(), qp.flat_q(), qp.flat_G(), qp.flat_h(),
                  dims=qp.dims, A=qp.flat_A(), b=qp.flat_b(),
                  kktsolver=make_block_kktsolver(qp, mesh=mesh), device="cpu")


BLOCK_SHARDED = dict(K=8, nk=8, n0=4, l=6, q=(3,), pk=2, seed=4)


def rank_block(rank, world):
    """tests/test_torch_block_kkt.py: tests/test_block_kkt.py:76-87's
    sharded solve, and the sharded kktsolver's outputs at one scaling
    against its mesh=None run."""
    mesh = make_mesh(world, device="cpu")
    qp = random_block_qp(**BLOCK_SHARDED, device="cpu")
    u = block_solve(qp, mesh, 9)
    u1 = block_solve(qp, None, 9)
    out = dict(ux=u[0], uy=u[1], Wuz=u[2], ux1=u1[0], uy1=u1[1],
               Wuz1=u1[2], **_solution(solve_block(qp, mesh)))
    return _np(out)


def sharded_cone_solve(mesh, ldims, P, q, G, h, A=None, b=None):
    kw = dict(maxiters=50, abstol=1e-7, reltol=1e-6, feastol=1e-7)
    out = make_coneqp_sharded(ldims, mesh, axis="cone", **kw)(
        P, q, G, h, A, b)
    return _np(out)


def rank_conesolve(rank, world, problems):
    """tests/test_torch_conesolve.py: make_coneqp_sharded on each
    problem (local dims, P, q, G, h, A, b)."""
    mesh = make_mesh(world, axis="cone", device="cpu")
    return [sharded_cone_solve(mesh, *pr) for pr in problems]


# ---- rank program of this file's own tests ---------------------------------

def _qp_batch(nb, n):
    """__graft_entry__._qp_batch: min 1/2 x'Px + q'x, x >= 0, sum x = 1."""
    rng = np.random.default_rng(0)
    F = rng.standard_normal((nb, n, n))
    P = F @ F.transpose(0, 2, 1) + np.eye(n)
    q = rng.standard_normal((nb, n))
    G = np.broadcast_to(-np.eye(n), (nb, n, n)).copy()
    h = np.zeros((nb, n))
    A = np.ones((nb, 1, n))
    b = np.ones((nb, 1))
    return P, q, G, h, A, b


BATCH_TOL = dict(maxiters=30, abstol=1e-4, reltol=1e-4, feastol=1e-4)


def rank_mesh(rank, world, nb, n):
    mesh = make_mesh(world, device="cpu")
    multihost.initialize(device="cpu")         # already up: a no-op
    gm = multihost.global_mesh(device="cpu")
    data = _qp_batch(nb, n)
    local = shard_batch(list(data), mesh)
    odd = shard_batch({"v": np.arange(world + 1.0)}, mesh)["v"]
    core = make_coneqp(ConeDims(l=n), device="cpu", **BATCH_TOL)
    out = sharded_batch_solve(core, data, mesh=mesh)
    v = torch.full((3,), float(rank + 1), dtype=torch.float64)
    toy = sharded_batch_solve(lambda u: {"x": 2.0 * u, "n": 7},
                              (torch.arange(float(nb)),), mesh=mesh)
    with pytest.raises(ValueError, match="leading axis"):
        sharded_batch_solve(lambda u: {"x": u, "w": torch.zeros(nb)},
                            (torch.arange(float(nb)),), mesh=mesh)
    return _np(dict(
        mesh=(mesh.rank, mesh.size, mesh.axis, str(mesh.device)),
        global_mesh=(gm.rank, gm.size),
        local_P=local[0], local_b=local[5], odd=odd,
        slice=multihost.local_batch_slice(nb),
        ring_part=coll.ppermute_ring(v, mesh, 1),
        x=out["x"], status=out["status"], iterations=out["iterations"],
        toy_x=toy["x"], toy_n=toy["n"]))


def rank_hang(rank, world):
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    if rank == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(INIT_TIMEOUT_S)


# ---- tests -----------------------------------------------------------------

def test_make_mesh_needs_a_process_group():
    """No process group, no mesh: make_mesh raises (mesh=None is the
    single-device path), and so does a solve that asks for one."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        multihost.global_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_coneqp_sharded(ConeDims(l=2), make_mesh(axis="cone",
                                                     device="cpu"))


def test_mesh_backend_follows_device(monkeypatch):
    """A CPU mesh in an NCCL group (and so a card's mesh in a gloo group)
    raises instead of running elsewhere."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 0)
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
    monkeypatch.setattr(dist, "group", type("G", (), {"WORLD": None}))
    with pytest.raises(ValueError, match="gloo"):
        make_mesh(device="cpu")
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "gloo")
    assert make_mesh(2, device="cpu").size == 2
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(4, device="cpu")
    assert pmesh.BACKEND == {"cuda": "nccl", "cpu": "gloo"}


def test_local_batch_slice():
    assert multihost.local_batch_slice(12, axis_size=4, index=2) == \
        slice(6, 9)
    assert multihost.local_batch_slice(10) == slice(0, 10)


def test_collective_refuses_tensor_off_the_mesh_device():
    mesh = pmesh.Mesh("batch", 0, 1, torch.device("cuda"), dist.group.WORLD)
    with pytest.raises(ValueError, match="device"):
        coll.psum(torch.ones(2), mesh)


def test_two_rank_mesh_and_sharded_batch_solve(tmp_path):
    """shard_batch, sharded_batch_solve (the dryrun's batched QPs,
    __graft_entry__.py:84-110), multihost and a partial ring on two
    gloo ranks; the gathered batch equals the unsharded solve, a host
    count comes back as computed, and a tensor without the local batch
    as leading axis is refused."""
    nb, n = 4, 4
    res = run_world(rank_mesh, 2, tmp_path, nb, n)
    data = _qp_batch(nb, n)
    core = make_coneqp(ConeDims(l=n), device="cpu", **BATCH_TOL)
    ref = _np(core(*(torch.as_tensor(u) for u in data)))
    for r, out in enumerate(res):
        assert out["mesh"] == (r, 2, "batch", "cpu")
        assert out["global_mesh"] == (r, 2)
        np.testing.assert_array_equal(out["local_P"],
                                      data[0][2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["local_b"],
                                      data[5][2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["odd"], np.arange(3.0))
        assert out["slice"] == slice(2 * r, 2 * r + 2)
        # rank 0 keeps its ring value (n = 1), rank 1 receives none
        np.testing.assert_array_equal(out["ring_part"],
                                      np.full(3, 1.0) if r == 0 else 0.0)
        assert (out["status"] == 0).all()
        np.testing.assert_allclose(out["x"], ref["x"], atol=1e-12)
        np.testing.assert_array_equal(out["iterations"], ref["iterations"])
        # a host count is returned as the rank computed it
        np.testing.assert_array_equal(out["toy_x"], 2.0 * np.arange(nb))
        assert out["toy_n"] == 7
    assert_replicated(res, ["x", "status", "iterations", "toy_x"])


def test_deadlocked_world_fails_within_its_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_world(rank_hang, 2, tmp_path, timeout=10)
    assert time.monotonic() - t0 < 35
