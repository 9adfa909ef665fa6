"""Device selection shared by the port's public entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and there is
    none. Entry points default to ``"cuda"`` and never fall back to the CPU
    on their own: the caller asks for ``device="cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
