"""Random matrices, the cvxopt.gsl equivalents and the package-level
normal/uniform/setseed/getseed API; twin of `cvxopt_tpu/utils/rng.py`.

A module-level seed and draw counter stand for the reference's
stateful generator, as in the JAX module.  Each draw seeds an explicit
``torch.Generator`` on the target device from (seed, count), so a seed
gives the same sequence of draws on a device every time.  The values
are torch's, not the JAX package's threefry draws.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cvxopt_tpu_torch._device import resolve_device

_state = {"seed": 0, "count": 0}


def setseed(value: int = None):
    """Set the seed (value=None re-seeds from the clock)."""
    if value is None:
        value = int(time.time_ns() % (2 ** 31))
    _state["seed"] = int(value)
    _state["count"] = 0


def getseed() -> int:
    return _state["seed"]


def _next_generator(dev):
    key = np.random.SeedSequence([_state["seed"], _state["count"]])
    _state["count"] += 1
    g = torch.Generator(device=dev)
    g.manual_seed(int(key.generate_state(1, np.uint64)[0] >> 1))
    return g


def normal(nrows: int, ncols: int = 1, mean: float = 0.0,
           std: float = 1.0, device="cuda"):
    """Matrix of N(mean, std^2) samples in float64 (cvxopt.normal); a
    vector when ncols == 1."""
    dev = resolve_device(device)
    x = torch.randn((nrows, ncols), generator=_next_generator(dev),
                    dtype=torch.float64, device=dev)
    x = mean + std * x
    return x[:, 0] if ncols == 1 else x


def uniform(nrows: int, ncols: int = 1, a: float = 0.0, b: float = 1.0,
            device="cuda"):
    """Matrix of U[a, b) samples in float64 (cvxopt.uniform); a vector
    when ncols == 1."""
    dev = resolve_device(device)
    x = torch.rand((nrows, ncols), generator=_next_generator(dev),
                   dtype=torch.float64, device=dev)
    x = a + (b - a) * x
    return x[:, 0] if ncols == 1 else x
