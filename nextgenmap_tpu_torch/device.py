"""Device selection for the port: explicit, with no fallback."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """torch.device for `name`; "cuda" raises when no CUDA card is present.

    The CPU is used only when it is named: a run asked to use the card never
    falls back to the CPU.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain PyTorch path"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
