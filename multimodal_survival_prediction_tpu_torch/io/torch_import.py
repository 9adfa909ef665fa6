"""Reference ``.pth`` state_dicts into the port, and the port's state_dicts
into flax trees.

The port's numpy copy of the import half of
``multimodal_survival_prediction_tpu/io/torch_import.py``
(``load_torch_state_dict``, the ``import_*`` maps, ``_assert_consumed``,
``import_torch_checkpoint``); ``io/jax_import.py`` holds the export half.

* :func:`load_torch_state_dict` reads a ``.pth`` file into the port's own
  layout, which is the reference's: a bare state_dict or one wrapped as
  ``{"state_dict": ...}``, a ``module.`` (DataParallel) prefix stripped,
  torchvision's DenseNet naming given MONAI's ``.layers.`` segment (the
  inverse of the JAX package's ``_normalize_key``, since the port's
  modules carry MONAI's names), and every missing BatchNorm
  ``num_batches_tracked`` filled with 0. A strict ``load_state_dict``
  takes the result.
* :func:`import_state_dict` maps such a state_dict (numpy or torch
  values) to the flax ``{"params", "batch_stats"}`` tree of the JAX
  family, as JAX's ``import_*`` maps do: every key must map, and every
  mapped key must exist. The DenseNet map walks whatever ``block_config``
  the keys hold, where JAX's hard-codes DenseNet121's. ``mmsurv``, which
  has no reference layout, gets the inverse of the port's own map (in the
  docstring of ``io/jax_import.py``).

Layout conventions (the inverse of ``io/jax_import.py``'s):
  * torch Linear weight (out, in) -> flax Dense kernel (in, out)
  * torch Conv3d (out, in, kd, kh, kw) -> flax Conv kernel (kd, kh, kw, in, out)
  * torch BatchNorm weight/bias -> flax scale/bias (params),
    running_mean/running_var -> mean/var (batch_stats);
    ``num_batches_tracked`` is dropped.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# families with a reference torch layout (mmsurv has none)
REFERENCE_FAMILIES = ("rnaseq_only", "image_only", "partial_modality",
                      "simple_fusion", "flexible_multimodal", "final",
                      "simmim")
# families whose CT backbone varies (image_only's CNN is fixed)
IMAGE_FAMILIES = frozenset(("partial_modality", "simple_fusion",
                            "flexible_multimodal", "final", "simmim",
                            "mmsurv"))
MMSURV_HEADS = 4  # models/mmsurv.py TransformerBlock's heads


def normalize_key(k: str) -> str:
    """A reference key in the port's layout: ``module.`` stripped, and
    torchvision's ``denselayerN.norm1`` given MONAI's ``.layers.``."""
    if k.startswith("module."):
        k = k[len("module."):]
    return re.sub(r"(\.denselayer\d+)\.(?!layers\.)", r"\1.layers.", k)


def normalize_state_dict(sd: dict) -> dict:
    """:func:`normalize_key` on every key, and a 0 ``num_batches_tracked``
    beside every BatchNorm that lacks one."""
    out = {normalize_key(k): v for k, v in sd.items()}
    for k in list(out):
        if k.endswith(".running_mean"):
            nbt = k[:-len("running_mean")] + "num_batches_tracked"
            out.setdefault(nbt, torch.tensor(0, dtype=torch.long))
    return out


def load_torch_state_dict(path) -> dict:
    """Read a ``.pth`` state_dict into ``{key: CPU tensor}`` in the port's
    layout (see :func:`normalize_state_dict`)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if (isinstance(obj, dict) and "state_dict" in obj
            and not torch.is_tensor(obj["state_dict"])):
        obj = obj["state_dict"]
    if not isinstance(obj, dict) or not all(torch.is_tensor(v)
                                            for v in obj.values()):
        raise ValueError(f"{path} holds no state_dict of tensors")
    return normalize_state_dict(obj)


def detect_backbone(keys) -> str:
    """'densenet121' when the keys hold MONAI dense blocks, else the
    reference's MONAI-less fallback CNN (JAX ``import_torch_checkpoint``)."""
    return ("densenet121" if any("denseblock" in k for k in keys)
            else "simple_cnn")


def _numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _take(sd: dict, key: str) -> np.ndarray:
    try:
        return sd.pop(key)
    except KeyError:
        raise KeyError(
            f"state_dict is missing {key!r}: wrong model family or "
            "backbone for this checkpoint?") from None


def _linear(sd, prefix):
    out = {"kernel": np.ascontiguousarray(_take(sd, f"{prefix}.weight").T)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _take(sd, f"{prefix}.bias")
    return out


def _conv3d(sd, prefix):
    w = _take(sd, f"{prefix}.weight")
    out = {"kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))}
    if f"{prefix}.bias" in sd:
        out["bias"] = _take(sd, f"{prefix}.bias")
    return out


def _bn(sd, prefix):
    params = {"scale": _take(sd, f"{prefix}.weight"),
              "bias": _take(sd, f"{prefix}.bias")}
    stats = {"mean": _take(sd, f"{prefix}.running_mean"),
             "var": _take(sd, f"{prefix}.running_var")}
    sd.pop(f"{prefix}.num_batches_tracked", None)
    return params, stats


def block_config_of_keys(sd: dict, prefix: str) -> tuple:
    """The dense-block layer counts of a DenseNet state_dict under
    ``prefix``."""
    counts: dict = {}
    pat = re.compile(re.escape(prefix)
                     + r"\.features\.denseblock(\d+)\.denselayer(\d+)\.")
    for k in sd:
        m = pat.match(k)
        if m:
            bi, li = int(m[1]) - 1, int(m[2])
            counts[bi] = max(counts.get(bi, 0), li)
    if sorted(counts) != list(range(len(counts))):
        raise ValueError(f"DenseNet keys under {prefix!r} have gaps in their "
                         f"blocks: {sorted(counts)}")
    return tuple(counts[b] for b in range(len(counts)))


def _densenet121(sd, prefix):
    p, s = {}, {}
    blocks = block_config_of_keys(sd, prefix)
    p["conv0"] = {"conv": _conv3d(sd, f"{prefix}.features.conv0")}
    p["norm0"], s["norm0"] = ({"bn": x} for x in
                              _bn(sd, f"{prefix}.features.norm0"))
    for bi, n_layers in enumerate(blocks):
        for li in range(n_layers):
            tp = (f"{prefix}.features.denseblock{bi + 1}"
                  f".denselayer{li + 1}.layers")
            name = f"block{bi}_layer{li}"
            n1p, n1s = _bn(sd, f"{tp}.norm1")
            n2p, n2s = _bn(sd, f"{tp}.norm2")
            p[name] = {"norm1": {"bn": n1p},
                       "conv1": {"conv": _conv3d(sd, f"{tp}.conv1")},
                       "norm2": {"bn": n2p},
                       "conv2": {"conv": _conv3d(sd, f"{tp}.conv2")}}
            s[name] = {"norm1": {"bn": n1s}, "norm2": {"bn": n2s}}
        if bi != len(blocks) - 1:
            tp = f"{prefix}.features.transition{bi + 1}"
            np_, ns_ = _bn(sd, f"{tp}.norm")
            p[f"transition{bi}"] = {"norm": {"bn": np_},
                                    "conv": {"conv": _conv3d(sd, f"{tp}.conv")}}
            s[f"transition{bi}"] = {"norm": {"bn": ns_}}
    p["norm5"], s["norm5"] = ({"bn": x} for x in
                              _bn(sd, f"{prefix}.features.norm5"))
    p["head"] = _linear(sd, f"{prefix}.class_layers.out")
    return p, s


def _simple_cnn(sd, prefix):
    p, s = {}, {}
    for i, seq in enumerate((0, 3, 6)):
        p[f"conv{i}"] = {"conv": _conv3d(sd, f"{prefix}.{seq}")}
        bnp, bns = _bn(sd, f"{prefix}.{seq + 1}")
        p[f"bn{i}"] = {"bn": bnp}
        s[f"bn{i}"] = {"bn": bns}
    return p, s


def _image_encoder(sd, prefix, backbone):
    if backbone == "densenet121":
        dn_p, dn_s = _densenet121(sd, prefix)
        return {"densenet": dn_p}, {"densenet": dn_s}
    if backbone == "simple_cnn":
        c_p, c_s = _simple_cnn(sd, prefix)
        return {"cnn": c_p}, {"cnn": c_s}
    raise ValueError(f"unknown backbone {backbone!r}")


def _rna_deep(sd, prefix):
    p, s = {}, {}
    for i, seq in enumerate((0, 4)):
        bnp, bns = _bn(sd, f"{prefix}.{seq + 1}")
        p[f"block{i}"] = {"linear": {"dense": _linear(sd, f"{prefix}.{seq}")},
                          "norm": {"bn": bnp}}
        s[f"block{i}"] = {"norm": {"bn": bns}}
    p["proj"] = {"dense": _linear(sd, f"{prefix}.8")}
    return p, s


def _rna_compact(sd, prefix):
    bnp, bns = _bn(sd, f"{prefix}.1")
    p = {"block0": {"linear": {"dense": _linear(sd, f"{prefix}.0")},
                    "norm": {"bn": bnp}},
         "proj": {"dense": _linear(sd, f"{prefix}.4")}}
    return p, {"block0": {"norm": {"bn": bns}}}


def _fusion_head(sd, prefix):
    bnp, bns = _bn(sd, f"{prefix}.1")
    p = {"block0": {"linear": {"dense": _linear(sd, f"{prefix}.0")},
                    "norm": {"bn": bnp}},
         "linear1": {"dense": _linear(sd, f"{prefix}.4")},
         "out": {"dense": _linear(sd, f"{prefix}.7")}}
    return p, {"block0": {"norm": {"bn": bns}}}


def _layer_norm(sd, prefix):
    return {"scale": _take(sd, f"{prefix}.weight"),
            "bias": _take(sd, f"{prefix}.bias")}


def _attention(sd, prefix, heads):
    tree = {}
    for name in ("query", "key", "value"):
        w = _take(sd, f"{prefix}.{name}.weight")  # (D, D) = (out, in)
        d = w.shape[1]
        tree[name] = {
            "kernel": np.ascontiguousarray(w.T).reshape(d, heads, -1),
            "bias": _take(sd, f"{prefix}.{name}.bias").reshape(heads, -1)}
    w = _take(sd, f"{prefix}.out.weight")
    tree["out"] = {"kernel": np.ascontiguousarray(w.T).reshape(
                       heads, -1, w.shape[0]),
                   "bias": _take(sd, f"{prefix}.out.bias")}
    return tree


def _rnaseq(sd, backbone):
    params, stats = {}, {}
    for i in range(3):
        bnp, bns = _bn(sd, f"mlp.{4 * i + 1}")
        params[f"block{i}"] = {
            "linear": {"dense": _linear(sd, f"mlp.{4 * i}")},
            "norm": {"bn": bnp}}
        stats[f"block{i}"] = {"norm": {"bn": bns}}
    params["head"] = {"dense": _linear(sd, "mlp.12")}
    return params, stats


def _image_only(sd, backbone):
    enc_p, enc_s = _simple_cnn(sd, "encoder")
    params = {"encoder": enc_p,
              "fc": {"dense": _linear(sd, "fc.0")},
              "risk_head": {"dense": _linear(sd, "risk_head")}}
    return params, {"encoder": enc_s}


def _gated_or_final(sd, backbone, gated):
    params, stats = {}, {}
    params["ct_encoder"], stats["ct_encoder"] = _image_encoder(
        sd, "ct_encoder", backbone)
    params["rna_encoder"], stats["rna_encoder"] = _rna_compact(
        sd, "rna_encoder")
    params["clinical_encoder"] = {
        "proj": {"dense": _linear(sd, "clinical_encoder.0")}}
    if gated:
        params["gate0"] = {"dense": _linear(sd, "gate.0")}
        params["gate1"] = {"dense": _linear(sd, "gate.2")}
    fbn_p, fbn_s = _bn(sd, "fusion.1")
    params["fusion_block"] = {"linear": {"dense": _linear(sd, "fusion.0")},
                              "norm": {"bn": fbn_p}}
    stats["fusion_block"] = {"norm": {"bn": fbn_s}}
    params["fusion_proj"] = {"dense": _linear(sd, "fusion.4")}
    params["cox_head"] = {"dense": _linear(sd, "cox_head")}
    return params, stats


def _simple_fusion(sd, backbone):
    params, stats = {}, {}
    params["rna_encoder"], stats["rna_encoder"] = _rna_deep(sd, "rna_encoder")
    params["image_encoder"], stats["image_encoder"] = _image_encoder(
        sd, "image_encoder", backbone)
    params["fusion"], stats["fusion"] = _fusion_head(sd, "fusion")
    return params, stats


def _flexible(sd, backbone):
    params, stats = {}, {}
    params["image_encoder"], stats["image_encoder"] = _image_encoder(
        sd, "image_encoder", backbone)
    params["rna_encoder"], stats["rna_encoder"] = _rna_deep(sd, "rna_encoder")
    params["missing_image_bias"] = _take(sd, "missing_image_bias")
    params["missing_rna_bias"] = _take(sd, "missing_rna_bias")
    params["fusion"], stats["fusion"] = _fusion_head(sd, "fusion")
    return params, stats


def _simmlm(sd, backbone):
    params, stats = {}, {}
    params["expert_image"], stats["expert_image"] = _image_encoder(
        sd, "expert_image.encoder", backbone)
    params["cox_image"] = {"dense": _linear(sd, "expert_image.cox_head")}
    params["expert_rnaseq"], stats["expert_rnaseq"] = _rna_compact(
        sd, "expert_rnaseq.encoder")
    params["cox_rnaseq"] = {"dense": _linear(sd, "expert_rnaseq.cox_head")}
    params["expert_clinical"] = {
        "fc0": {"dense": _linear(sd, "expert_clinical.encoder.0")},
        "fc1": {"dense": _linear(sd, "expert_clinical.encoder.2")}}
    params["cox_clinical"] = {
        "dense": _linear(sd, "expert_clinical.cox_head")}
    params["gating"] = {"fc0": {"dense": _linear(sd, "gating.gate.0")},
                        "fc1": {"dense": _linear(sd, "gating.gate.3")},
                        "fc2": {"dense": _linear(sd, "gating.gate.5")}}
    params["ensemble_cox"] = {"dense": _linear(sd, "ensemble_cox")}
    return params, stats


def _mmsurv(sd, backbone):
    params, stats = {}, {}
    params["image_encoder"], stats["image_encoder"] = _image_encoder(
        sd, "image_encoder", backbone)
    params["rna_encoder"], stats["rna_encoder"] = _rna_compact(
        sd, "rna_encoder")
    params["clinical_encoder"] = {
        "proj": {"dense": _linear(sd, "clinical_encoder.0")}}
    params["cbp_proj"] = {"dense": _linear(sd, "cbp_proj")}
    params["pos_embed"] = _take(sd, "pos_embed")
    for prefix in ("layer0", "layer1"):
        params[prefix] = {
            "ln1": _layer_norm(sd, f"{prefix}.ln1"),
            "attn": _attention(sd, f"{prefix}.attn", MMSURV_HEADS),
            "ln2": _layer_norm(sd, f"{prefix}.ln2"),
            "ff0": {"dense": _linear(sd, f"{prefix}.ff0")},
            "ff1": {"dense": _linear(sd, f"{prefix}.ff1")}}
    params["cox_head"] = {"dense": _linear(sd, "cox_head")}
    return params, stats


_IMPORTERS = {
    "rnaseq_only": _rnaseq,
    "image_only": _image_only,
    "partial_modality": lambda sd, b: _gated_or_final(sd, b, gated=True),
    "simple_fusion": _simple_fusion,
    "flexible_multimodal": _flexible,
    "final": lambda sd, b: _gated_or_final(sd, b, gated=False),
    "simmim": _simmlm,
    "mmsurv": _mmsurv,
}


def _assert_consumed(sd: dict) -> None:
    leftovers = [k for k in sd if not k.endswith("num_batches_tracked")]
    if leftovers:
        raise ValueError(
            "state_dict has unmapped keys (wrong model family, or an "
            f"architecture this map does not cover): {leftovers[:8]}")


def import_state_dict(model_name: str, state_dict: dict,
                      backbone: str | None = None) -> dict:
    """A state_dict in the port's layout (numpy arrays or tensors) -> the
    JAX family's flax ``{"params", "batch_stats"}`` tree of numpy arrays.
    ``backbone`` defaults to :func:`detect_backbone`. Raises ``KeyError`` /
    ``ValueError`` on a state_dict of another family or backbone."""
    if model_name not in _IMPORTERS:
        raise ValueError(f"unknown model {model_name!r} "
                         f"(known: {sorted(_IMPORTERS)})")
    sd = {k: _numpy(v) for k, v in normalize_state_dict(state_dict).items()}
    if model_name in IMAGE_FAMILIES and backbone is None:
        backbone = detect_backbone(sd)
    params, stats = _IMPORTERS[model_name](sd, backbone)
    _assert_consumed(sd)
    return {"params": params, "batch_stats": stats}


def import_torch_checkpoint(model_name: str, path,
                            backbone: str | None = None):
    """Read a reference ``.pth`` and return ``(state_dict in the port's
    layout, backbone or None)``, after checking that every key maps to
    ``model_name``'s flax tree (the JAX function's checks)."""
    if model_name not in REFERENCE_FAMILIES:
        raise ValueError(
            f"no reference torch layout for {model_name!r} "
            f"(families with one: {list(REFERENCE_FAMILIES)})")
    sd = load_torch_state_dict(path)
    if model_name in IMAGE_FAMILIES:
        backbone = backbone or detect_backbone(sd)
    else:
        backbone = None
    import_state_dict(model_name, sd, backbone=backbone)
    return sd, backbone
