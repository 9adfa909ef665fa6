"""The card a run measures: refuse to run without it, pin the precision the
configuration states, and describe it beside every result."""

from __future__ import annotations

import subprocess


class NoDevice(RuntimeError):
    """The run asked for more CUDA devices than this machine has."""


def require_cuda(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: the benchmark "
                       "measures the CUDA port and does not fall back to the "
                       "CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA devices, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")


def pin_precision(precision: str):
    """float32 with TF32 off for matmuls and cuDNN (``f32``), or with both
    on (``tf32``: the control); ``cudnn.benchmark`` off either way."""
    import torch

    if precision not in ("f32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cudnn.benchmark = False


def power_limit_w():
    """The card's power limit in watts as ``nvidia-smi`` reads it, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(chips: int, peak_bytes: int, power_limit,
             device_type: str = "cuda") -> dict:
    """The result's ``device``; ``device_type`` is ``cpu`` only in the
    CPU tests, which describe no card."""
    import torch

    on_card = device_type == "cuda"
    return {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": chips,
        "memory_peak_bytes": int(peak_bytes),
        "power_limit_w": power_limit,
        "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
        "tf32_cudnn": bool(torch.backends.cudnn.allow_tf32),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
