"""The problem generators give equal data for equal seeds, other data for
other seeds, the same sizes for every seed, and convex, strictly
feasible problems."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import harness

from .conftest import TINY

SPEC = harness.load_spec()


def pool(cell, seed):
    _, cfg, traffic = harness.cell_parts(SPEC, cell)
    cfg = {**cfg, **TINY[cell]["config"]}
    traffic = {**traffic, **TINY[cell]["traffic"]}
    family = harness.load_module(
        os.path.join(harness.HERE, "problems", cfg["problem"] + ".py"),
        "gen_" + cfg["problem"])
    return family.make_pool(cfg, traffic, seed, "cpu"), traffic


@pytest.mark.parametrize("cell", sorted(TINY))
def test_equal_seeds_equal_data(cell):
    big = 2 ** 31 + 12345
    a, traffic = pool(cell, big)
    b, _ = pool(cell, big)
    c, _ = pool(cell, big + 1)
    assert len(a) == traffic["pool"]
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k])
            assert x[k].shape == z[k].shape
        assert not torch.equal(x["P"], z["P"])
        assert not torch.equal(x["q"], z["q"])
    assert not torch.equal(a[0]["P"], a[1]["P"])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_problems_are_convex_and_feasible(cell):
    data, _ = pool(cell, 3)
    for d in data:
        P = d["P"] if d["P"].dim() == 3 else d["P"][None]
        assert torch.equal(P, P.mT)
        assert float(torch.linalg.eigvalsh(P).min()) > 0.05
        assert d["P"].dtype == torch.float64
        if d["A"].shape[0] == 0:
            # h = G x0 + s0 with s0 >= 0.5: x0 is strictly feasible
            assert d["h"].shape[0] == d["G"].shape[0]
