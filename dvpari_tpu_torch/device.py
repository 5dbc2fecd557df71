"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """`device` -> torch.device; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run the plain PyTorch path"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
