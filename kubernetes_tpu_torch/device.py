"""Where the solver's tensors live.

Every entry point of the port runs on the card unless its caller names
another device: ``device=None`` means ``"cuda"``, and with no visible
card that is an error, never a quiet move to the CPU. The CPU is for
tests, which ask for it by name; there the solver runs the plain
PyTorch version of each kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device to solve on: the card by default; raises when a
    CUDA device is asked for (or defaulted to) and none is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kubernetes_tpu_torch solves on a CUDA device by default and "
            "none is visible; pass device='cpu' to run the plain PyTorch "
            "solver on the CPU"
        )
    return dev


def synchronize(device) -> None:
    """Block until the device has finished its queued work (a no-op on
    the CPU, where every op is synchronous)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
