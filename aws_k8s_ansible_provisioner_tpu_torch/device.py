"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Asking for CUDA on a machine without it raises; nothing falls back to the
    CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device) but "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "on the CPU")
    return dev
