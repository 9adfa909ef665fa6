"""Fold checkpoints of the port, in three formats picked by suffix, with
the same ``<ckpt>.meta.json`` sidecar and keys as
``multimodal_survival_prediction_tpu/io/checkpoint.py``:

  * ``.pt`` — the port's own: a ``torch.save`` state_dict (the CV driver
    writes ``fold_K_best.pt``);
  * ``.msgpack`` — the JAX package's: flax ``to_bytes`` of the
    ``{"params", "batch_stats"}`` tree (``fold_K_best.msgpack``), read and
    written by the port's pure-Python codec (``io/msgpack.py``) through the
    weight maps (``io/torch_import.py`` one way, ``io/jax_import.py`` the
    other);
  * ``.pth`` — the reference's: a torch state_dict in the reference layout
    (``io/torch_import.py:load_torch_state_dict`` reads the variants).

:func:`load_checkpoint` returns a state_dict that the port's modules take
with ``strict=True``, whatever the format.

The CV driver's resume state (``fold_K_resume/``) is one ``state.pt``
(:func:`save_train_state`: the model, Adam's moments, the step and the
dropout generator's state), ``best.pt`` (the best weights so far, a
state_dict) and a ``progress.json`` beside them, which the driver writes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import msgpack
from .jax_import import export_torch_state_dict
from .torch_import import (
    REFERENCE_FAMILIES,
    import_state_dict,
    load_torch_state_dict,
)

SUFFIXES = (".pt", ".msgpack", ".pth")


def _suffix(path) -> str:
    suffix = Path(path).suffix
    if suffix not in SUFFIXES:
        raise ValueError(f"{path}: a fold checkpoint ends in one of "
                         f"{SUFFIXES}")
    return suffix


def _family(path, model_name):
    if model_name is None:
        model_name = (load_fold_meta(path) or {}).get("model")
    return model_name


def _needs_family(path, model_name):
    if model_name is None:
        raise ValueError(
            f"{path}: the model family is needed to map this format; pass "
            "model_name or write it as 'model' in the .meta.json")
    return model_name


def save_checkpoint(path, state_dict: dict, model_name: str | None = None
                    ) -> None:
    """Write a state_dict of the port (tensors are moved to the CPU) in the
    format of ``path``'s suffix. ``.msgpack`` and ``.pth`` need the model
    family (``model_name``); ``.pth`` has no ``mmsurv`` layout."""
    path = Path(path)
    suffix = _suffix(path)
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    if suffix == ".msgpack":
        tree = import_state_dict(_needs_family(path, model_name), sd)
        data = msgpack.packb(tree)
    elif suffix == ".pth":
        name = _needs_family(path, model_name)
        if name not in REFERENCE_FAMILIES:
            raise ValueError(f"{name!r} has no reference torch layout, so "
                             "no .pth route")
        import_state_dict(name, sd)  # every key in the reference layout
    path.parent.mkdir(parents=True, exist_ok=True)
    if suffix == ".msgpack":
        path.write_bytes(data)
    else:
        torch.save(sd, path)


def load_checkpoint(path, device="cpu", model_name: str | None = None
                    ) -> dict:
    """Read a fold checkpoint of any of the three formats onto ``device``
    as a state_dict the port's modules load strictly. ``model_name`` (the
    family) defaults to the sidecar's ``model`` key; ``.msgpack`` needs it,
    and for ``.pth`` it checks that every key maps to that family."""
    suffix = _suffix(path)
    if suffix == ".pt":
        return torch.load(path, map_location=device, weights_only=True)
    name = _family(path, model_name)
    if suffix == ".pth":
        sd = load_torch_state_dict(path)
        if name is not None:
            import_state_dict(name, sd)
        return {k: v.to(device) for k, v in sd.items()}
    name = _needs_family(path, name)
    tree = msgpack.unpackb(Path(path).read_bytes())
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path} holds no flax {{params, batch_stats}} tree")
    try:
        sd = export_torch_state_dict(name, tree)
    except KeyError as e:
        raise ValueError(f"{path}: the tree lacks {e} of a {name!r} "
                         "model; wrong model family?") from None
    # the export reads only the leaves it knows: a tree of another family
    # that holds them all (partial_modality read as final) must not load
    mapped = _leaf_paths(import_state_dict(name, sd))
    extra = sorted(_leaf_paths(tree) - mapped)
    if extra:
        raise ValueError(f"{path}: leaves that a {name!r} model does not "
                         f"have: {extra[:6]}; wrong model family?")
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in sd.items()}


def _leaf_paths(tree, prefix="") -> set:
    if isinstance(tree, dict):
        return set().union(*(_leaf_paths(v, f"{prefix}/{k}")
                             for k, v in tree.items()))
    return {prefix}


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
