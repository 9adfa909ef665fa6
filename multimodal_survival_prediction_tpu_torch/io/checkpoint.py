"""Fold checkpoints of the port: ``torch.save`` state_dicts
(``fold_K_best.pt``) with the same ``<ckpt>.meta.json`` sidecar and keys as
``multimodal_survival_prediction_tpu/io/checkpoint.py``.

The JAX package's fold checkpoints are flax msgpack files; reading them
here needs a pure-Python msgpack reader (ROADMAP.md Queue 1 item 2). Until
then, weights
cross from JAX through ``io/jax_import.py``.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch


def save_checkpoint(path, state_dict: dict) -> None:
    """Write a state_dict (tensors moved to the CPU) to one ``.pt`` file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_checkpoint(path, device="cpu") -> dict:
    """Read a state_dict saved by :func:`save_checkpoint` onto ``device``."""
    return torch.load(path, map_location=device, weights_only=True)


def save_fold_meta(ckpt_path, **meta) -> None:
    """Write ``<ckpt>.meta.json`` beside a fold checkpoint — the
    training-time facts scoring must match (backbone, image_shape,
    hu_window, rna_dim, use_pallas_resample, resample_mode, ...)."""
    p = Path(str(ckpt_path) + ".meta.json")
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(meta, indent=2, default=str))


def load_fold_meta(ckpt_path) -> dict | None:
    """The ``.meta.json`` beside a checkpoint, or None."""
    p = Path(str(ckpt_path) + ".meta.json")
    return json.loads(p.read_text()) if p.exists() else None
