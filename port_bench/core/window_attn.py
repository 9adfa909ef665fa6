"""What the Swin-ViT cell's per-layer readers match: the window attention's
device kernels by parts of their names, and the port's token counters.

``scaled_dot_product_attention`` in float32 with an additive mask that
takes a gradient runs PyTorch's memory-efficient attention (CUTLASS's
``fmha_cutlassF_*`` forward and ``fmha_cutlassB_*`` backward kernels in a
profile of an H100); the flash kernels (``flash_fwd``, ``flash_bwd``) are
listed for a program that takes them. The padding counters are
``utils/profiling.py``'s, named by ``models/swin3d.py``.
"""

from __future__ import annotations

import numpy as np

ATTN_KERNEL_PARTS = ("fmha_cutlassF", "fmha_cutlassB", "flash_fwd",
                     "flash_bwd")
REAL_TOKENS = "swin.window_tokens.real"
ATTENDED_TOKENS = "swin.window_tokens.attended"


def is_attn_kernel(name: str) -> bool:
    return any(part in name for part in ATTN_KERNEL_PARTS)


def attn_share(summary, start: float, end: float):
    """The attention kernels' share of the device's busy time (the union of
    its kernel and copy intervals) inside ``[start, end)``, in %, or None
    where no attention kernel ran there."""
    attn = sum(min(e, end) - max(s, start) for s, e, name in summary.kernels
               if is_attn_kernel(name) and e > start and s < end)
    b = summary.busy_intervals()
    busy = float((np.clip(b[:, 1], start, end)
                  - np.clip(b[:, 0], start, end)).sum())
    if attn <= 0 or busy <= 0:
        return None
    return 100.0 * attn / busy


def pad_share():
    """Padded tokens over attended tokens, in %, from the port's counters;
    None for a program without them or where no window attention ran."""
    try:
        from multimodal_survival_prediction_tpu_torch.utils.profiling import (
            counters,
        )
    except ImportError:
        return None
    c = counters()
    attended = c.get(ATTENDED_TOKENS, 0)
    if attended <= 0:
        return None
    return 100.0 * (attended - c.get(REAL_TOKENS, 0)) / attended
