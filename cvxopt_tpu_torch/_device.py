"""Device resolution for the port's entry points.

Every entry point takes ``device=`` with the default ``"cuda"``.  When
no card is present and the caller did not ask for the CPU, the entry
point raises instead of running on the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises RuntimeError when CUDA is
    asked for (the default) and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run "
            "the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_on(dev: torch.device, *tensors) -> None:
    """Raise unless every tensor lies on `dev` (device type match)."""
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(
                f"tensor on {t.device} but device={str(dev)!r}")


def as_tensor(x, dev=None, dtype=None):
    """`x` as a tensor.  A tensor keeps its device (and its dtype unless
    `dtype` is given); other data goes to `dev` (default: the card,
    through `resolve_device`).  Python floats and lists of them become
    float64, as numpy makes them, not torch's float32 default."""
    if torch.is_tensor(x):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    import numpy as np
    dev = resolve_device("cuda") if dev is None else dev
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def tensors(*xs, device=None):
    """Each of `xs` as a tensor (None stays None).  Non-tensors go to
    the device of the first tensor among `xs`, else to `device`
    (default "cuda", through `resolve_device`)."""
    dev = next((x.device for x in xs if torch.is_tensor(x)), None)
    if dev is None:
        dev = resolve_device("cuda" if device is None else device)
    return tuple(None if x is None else as_tensor(x, dev) for x in xs)
