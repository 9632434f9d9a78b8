"""Four repairs of the port against the JAX package: `aslinearoperator`
on non-tensor data, `multihost.initialize` binding a card before NCCL,
Python numbers in `shard_batch` and the collectives, and the `sweeps=` /
`force=` arguments of the accurate eigensolvers.  Each test fails on the
port before its repair."""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cvxopt_tpu import linops as jlinops
from cvxopt_tpu.ops import jacobi as jjac
from cvxopt_tpu.parallel import mesh as jmesh
from cvxopt_tpu_torch.linops import aslinearoperator
from cvxopt_tpu_torch.ops import jacobi as tjac
from cvxopt_tpu_torch.parallel import collectives as coll
from cvxopt_tpu_torch.parallel import make_mesh, multihost, shard_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("A", [
    [[1.0, 2.0, 0.5], [0.0, -1.0, 3.0]],
    np.array([[1, 2, 0], [0, -1, 3]]),
    np.array([[True, False, True], [False, True, True]]),
])
def test_aslinearoperator_takes_lists_and_integer_arrays(A):
    """A list and integer or boolean arrays become float64 on the device
    asked for; mv/rmv on float64 vectors agree with JAX's operator."""
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(3), rng.standard_normal(2)
    op = aslinearoperator(A, device="cpu")
    jop = jlinops.aslinearoperator(A)
    assert op.shape == tuple(jop.shape) == (2, 3)
    got_mv = op.mv(torch.as_tensor(x))
    got_rmv = op.rmv(torch.as_tensor(y))
    assert got_mv.dtype == got_rmv.dtype == torch.float64
    assert got_mv.device.type == "cpu"
    np.testing.assert_allclose(got_mv.numpy(),
                               np.asarray(jop.mv(jnp.asarray(x))),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(got_rmv.numpy(),
                               np.asarray(jop.rmv(jnp.asarray(y))),
                               rtol=1e-15, atol=1e-15)


def test_aslinearoperator_on_the_default_device_needs_a_card(monkeypatch):
    """Non-tensor data goes to the default device, the card, and raises
    without one instead of staying on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        aslinearoperator([[1.0, 2.0]])
    t = torch.ones((2, 2), dtype=torch.float64)
    assert aslinearoperator(t).mv(torch.ones(2, dtype=torch.float64)) \
        .tolist() == [2.0, 2.0]


@pytest.mark.parametrize("env,process_id,count,card", [
    ({"LOCAL_RANK": "3"}, 7, 8, 3),
    ({}, 5, 4, 1),
    ({"RANK": "6"}, None, 4, 2),
    ({}, None, 2, 0),
])
def test_initialize_binds_a_card_before_nccl(monkeypatch, env, process_id,
                                             count, card):
    """On 'cuda', `initialize` sets the card (LOCAL_RANK, else the rank
    modulo the card count) before it starts the NCCL group."""
    calls = []
    for k in ("LOCAL_RANK", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            ("init", backend, kw["rank"])))
    multihost.initialize("localhost:1234", num_processes=8,
                         process_id=process_id)
    assert calls == [("set_device", card),
                     ("init", "nccl", -1 if process_id is None
                      else process_id)]


def test_initialize_on_the_cpu_binds_no_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(("init",
                                                            backend)))
    multihost.initialize(num_processes=1, process_id=0, device="cpu",
                         init_method="file:///nonexistent")
    assert calls == [("init", "gloo")]


def test_python_numbers_on_a_mesh_are_float64_and_int64(tmp_path):
    """On a gloo world of one rank, `shard_batch([2.5, 3], mesh)` gives
    float64 and int64 and `psum(1.5, mesh)` float64, as JAX's arrays
    under x64; before the repair both floats were float32."""
    dist.init_process_group(
        "gloo", init_method="file://" + str(tmp_path / "rdv"),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(device="cpu")
        a, b = shard_batch([2.5, 3], mesh)
        s = coll.psum(1.5, mesh)
        v = shard_batch(np.array([1, 2]), mesh)
    finally:
        dist.destroy_process_group()
    jm = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("batch",))
    ja, jb = jmesh.shard_batch([2.5, 3], jm)
    assert (a.dtype, b.dtype) == (torch.float64, torch.int64)
    assert (str(ja.dtype), str(jb.dtype)) == ("float64", "int64")
    assert (float(a), int(b)) == (float(ja), int(jb)) == (2.5, 3)
    assert s.dtype == torch.float64 and float(s) == 1.5
    assert str(jnp.asarray(1.5).dtype) == "float64"
    assert v.dtype == torch.int64 and v.tolist() == [1, 2]


def _spd(n, cond, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.logspace(0, -np.log10(cond), n)
    return (Q * w) @ Q.T


def test_eigh_accurate_takes_sweeps_and_force():
    """tests/test_jacobi.py:37's call.  The port ignores both arguments
    and runs float64 eigh; JAX's forced polish reaches the same values
    within f64 accuracy on the largest eigenvalue."""
    S = _spd(32, 1e10, seed=2)
    w, V = tjac.eigh_accurate(torch.as_tensor(S), sweeps=6, force=True)
    wj, Vj = jjac.eigh_accurate(jnp.asarray(S), sweeps=6, force=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-7,
                               atol=1e-13)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(S),
                               rtol=1e-7, atol=1e-13)
    Vn = V.numpy()
    assert np.abs(Vn.T @ Vn - np.eye(32)).max() < 1e-12
    assert np.abs(S @ Vn - Vn * w.numpy()).max() < 1e-12
    w0, _ = tjac.eigh_accurate(torch.as_tensor(S))
    assert torch.equal(w, w0)


def test_gram_eigh_accurate_takes_sweeps_and_force():
    """tests/test_jacobi.py:59's call (kappa(M'M) = 1e12).  JAX's forced
    one-sided Jacobi keeps relative accuracy on the small eigenvalues;
    the port's float64 eigh of M'M agrees with it within f64 accuracy on
    the largest eigenvalue (1e-15), as JAX's own unforced path does."""
    m = 24
    rng = np.random.default_rng(3)
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    Vt, _ = np.linalg.qr(rng.standard_normal((m, m)))
    sig = np.logspace(0.0, -6.0, m)
    M = (U * sig) @ Vt.T
    w, V = tjac.gram_eigh_accurate(torch.as_tensor(M), sweeps=6,
                                   force=True)
    wj, _ = jjac.gram_eigh_accurate(jnp.asarray(M), sweeps=6, force=True)
    wu, _ = jjac.gram_eigh_accurate(jnp.asarray(M))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(w.numpy(), np.asarray(wu), rtol=0,
                               atol=1e-15)
    G = M.T @ M
    Vn = V.numpy()
    off = Vn.T @ G @ Vn - np.diag(w.numpy())
    assert np.abs(off).max() < 1e-10 * np.abs(G).max() + 1e-12


def test_gram_eigh_accurate_batched_takes_sweeps_and_force():
    """tests/test_jacobi.py:79's call, a batch of three."""
    rng = np.random.default_rng(4)
    Ms = []
    for _ in range(3):
        U, _ = np.linalg.qr(rng.standard_normal((8, 8)))
        Ms.append((U * np.logspace(0, -4, 8)) @ U.T)
    M = np.stack(Ms)
    w, _ = tjac.gram_eigh_accurate(torch.as_tensor(M), sweeps=6,
                                   force=True)
    wj, _ = jjac.gram_eigh_accurate(jnp.asarray(M), sweeps=6, force=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-8,
                               atol=1e-15)
