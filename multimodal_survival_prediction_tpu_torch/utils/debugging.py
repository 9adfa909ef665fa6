"""Debug utilities: non-finite guards and parameter counts (port of
``multimodal_survival_prediction_tpu/utils/debugging.py``).

Trees are a module's ``state_dict`` or nested dicts / lists / tuples of
tensors or numpy arrays; a leaf's path is written as JAX's
``jax.tree_util.keystr`` writes it (``['block']['weight']``)."""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def check_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first offending paths if any
    floating leaf holds NaN or Inf (reads every leaf to the host: use
    between epochs, not inside a step)."""
    bad = [path for path, leaf in _leaves(tree)
           if (arr := _as_numpy(leaf)).dtype.kind == "f"
           and not np.all(np.isfinite(arr))]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:5]}")


def nan_guard(x, label: str = ""):
    """Return ``x``; raise ``FloatingPointError`` naming ``label`` where a
    value is not finite. Reading the check's result costs a host sync, so
    each call waits for the device to finish ``x``."""
    finite = (bool(torch.isfinite(x).all()) if isinstance(x, torch.Tensor)
              else bool(np.all(np.isfinite(x))))
    if not finite:
        raise FloatingPointError(f"non-finite value at {label}")
    return x


def param_count(params) -> int:
    """Number of elements of a module's parameters, or of every array leaf
    of a tree."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(leaf.shape)) for _, leaf in _leaves(params)
               if hasattr(leaf, "shape"))
