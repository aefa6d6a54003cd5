"""Device selection for the port's entry points.

`Renderer`, `SceneBuilder.compile` and `scene.convert.from_numpy` default to
the card (`"cuda"`); the CPU runs only where the caller asks for it, as the
tests do. Asking for a CUDA device where none is present raises: nothing
falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """`device` (a string or torch.device) as a torch.device; raises
    RuntimeError for a CUDA device when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run on "
            "the CPU"
        )
    return dev
