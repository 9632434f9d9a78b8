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
