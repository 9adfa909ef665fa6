"""Fold checkpoints of the port: ``torch.save`` state_dicts
(``fold_K_best.pt``) with the same ``<ckpt>.meta.json`` sidecar and keys as
``multimodal_survival_prediction_tpu/io/checkpoint.py``.

The CV driver's resume state (``fold_K_resume/``) is one ``state.pt``
(:func:`save_train_state`: the model, Adam's moments, the step and the
dropout generator's state), ``best.pt`` (the best weights so far, a
state_dict) and a ``progress.json`` beside them, which the driver writes.

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


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def save_train_state(path, saved: dict) -> None:
    """Write ``train.engine.train_state_dict``'s dict (tensors moved to the
    CPU) to one ``.pt`` file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_cpu(saved), path)


def load_train_state(path) -> dict:
    """Read a dict saved by :func:`save_train_state` (tensors on the CPU;
    ``train.engine.load_train_state_dict`` copies them into place)."""
    return torch.load(path, map_location="cpu", weights_only=True)


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
