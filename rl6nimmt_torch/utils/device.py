"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and no card exists.

    Entry points default to ``"cuda"``; on a machine without a card the caller
    must ask for the CPU explicitly (the tests pass ``device="cpu"``).  There
    is no silent fallback.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rl6nimmt_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device) -> None:
    """Wait for the card's queued work when ``device`` is a CUDA device (a host
    clock read after it times the work, not its enqueue); nothing on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
