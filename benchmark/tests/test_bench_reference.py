"""The torch transcription of the reference iteration agrees with the
frozen numpy reference it was transcribed from, and the judge reads a
reference answer as it should."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import npref, qp_check, qp_torch


def problem(n, seed, eq):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, n // 4)) / np.sqrt(n)
    P = F @ F.T + 0.1 * np.eye(n)
    q = -rng.uniform(0, 0.1, n) if eq else rng.standard_normal(n)
    if eq:
        G = np.concatenate([-np.eye(n), np.eye(n)])
        h = np.concatenate([np.zeros(n), np.ones(n)])
        A, b = np.ones((1, n)), np.ones(1)
    else:
        G = rng.standard_normal((n, n)) / np.sqrt(n)
        h = G @ rng.standard_normal(n) + rng.uniform(0.5, 2.0, n)
        A, b = np.zeros((0, n)), np.zeros(0)
    return P, q, G, h, A, b


@pytest.mark.parametrize("n, seed, eq", [(32, 0, True), (64, 1, True),
                                         (48, 2, False)])
def test_transcription_matches_frozen_reference(n, seed, eq):
    data = problem(n, seed, eq)
    tol = dict(maxiters=60, abstol=1e-9, reltol=0.0, feastol=1e-9)
    a = npref.coneqp_np(*data, **tol)
    b = qp_torch.coneqp_l(*(torch.as_tensor(u) for u in data), **tol)
    assert a["status"] == b["status"] == "optimal"
    assert a["iterations"] == b["iterations"]
    for k in ("x", "y", "s", "z"):
        np.testing.assert_allclose(b[k].numpy(), a[k], rtol=0, atol=1e-10)
    nums = qp_check.kkt_numbers(*data, b["x"], b["y"], b["s"], b["z"])
    assert max(nums["pres"], nums["dres"]) <= 1e-9
    assert nums["gap"] <= 1e-9 and nums["cone"] == 0.0


def test_float32_stays_float32():
    data = [torch.as_tensor(u, dtype=torch.float32)
            for u in problem(32, 3, True)]
    out = qp_torch.coneqp_l(*data, maxiters=50, abstol=1e-7, reltol=1e-7,
                            feastol=1e-7)
    assert all(out[k].dtype == torch.float32 for k in ("x", "y", "s", "z"))
