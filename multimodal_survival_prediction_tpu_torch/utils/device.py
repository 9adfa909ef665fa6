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


def pin_fp32_policy() -> str:
    """Turn TF32 off for cuDNN and for matmuls in this process, so that
    convolutions and products run in true fp32 as the JAX reference
    computes them; returns a line stating both flags. The port's CLIs call
    it once at start-up; library functions set no global flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return ("precision: torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
            " (fp32 convolutions and matmuls, as the JAX reference computes)")
