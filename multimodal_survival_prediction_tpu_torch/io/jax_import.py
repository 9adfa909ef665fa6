"""Carry weights from the JAX package into the port.

The port's own numpy-only copy of the export map in
``multimodal_survival_prediction_tpu/io/torch_import.py`` (the ``_exp_*``
helpers and every branch of ``export_torch_state_dict``): flax
``{"params", "batch_stats"}`` trees, as numpy arrays, become a state_dict
with the reference's torch/MONAI key names, which the port's modules
carry — so ``model.load_state_dict(..., strict=True)`` takes it.

Two differences: the DenseNet export walks whatever ``block_config`` the
tree holds (counted from its ``block{i}_layer{j}`` entries), where the JAX
export hard-codes DenseNet121's (6, 12, 24, 16), so small test DenseNets
carry over too; and ``mmsurv``, which has no reference layout (and no
branch in the JAX export), gets the port's own map:

  image_encoder.*, rna_encoder.{0,1,4}.*, clinical_encoder.0.*  (as above)
  cbp_proj.{weight,bias}                <- cbp_proj/dense
  pos_embed (1, 4, D)                   <- pos_embed
  layer{i}.ln1 / ln2.{weight,bias}      <- layer{i}/ln1, ln2 {scale, bias}
  layer{i}.attn.{query,key,value}.weight (D, D)
                                        <- kernel (D, H, D/H) as (D, D), transposed
  layer{i}.attn.{query,key,value}.bias (D,) <- bias (H, D/H) flattened
  layer{i}.attn.out.weight (D, D)       <- kernel (H, D/H, D) as (D, D), transposed
  layer{i}.attn.out.bias (D,)           <- bias (D,)
  layer{i}.ff0 / ff1.{weight,bias}      <- layer{i}/ff0, ff1 /dense
  cox_head.{weight,bias}                <- cox_head/dense
The count-sketch matrices (the JAX ``constants`` collection) are not
weights: the port rebuilds them from their seeds.

Layout conventions:
  * flax Dense kernel (in, out) -> torch Linear weight (out, in)
  * flax Conv kernel (kd, kh, kw, in, out) -> torch Conv3d (out, in, kd, kh, kw)
  * flax BatchNorm scale/bias + batch_stats mean/var -> torch
    weight/bias/running_mean/running_var (+ num_batches_tracked = 0)
"""

from __future__ import annotations

import re

import numpy as np


def _exp_linear(out, prefix, tree):
    out[f"{prefix}.weight"] = np.ascontiguousarray(
        np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _exp_conv3d(out, prefix, tree):
    out[f"{prefix}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(tree["kernel"]), (4, 3, 0, 1, 2)))
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _exp_bn(out, prefix, p, s):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    out[f"{prefix}.running_var"] = np.asarray(s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def block_config_of(densenet_params: dict) -> tuple:
    """The dense-block layer counts of a flax DenseNet121_3D param tree."""
    counts: dict = {}
    for name in densenet_params:
        m = re.fullmatch(r"block(\d+)_layer(\d+)", name)
        if m:
            bi, li = int(m[1]), int(m[2])
            counts[bi] = max(counts.get(bi, 0), li + 1)
    if sorted(counts) != list(range(len(counts))):
        raise ValueError(f"DenseNet tree has gaps in its blocks: {sorted(counts)}")
    return tuple(counts[b] for b in range(len(counts)))


def _exp_densenet121(out, prefix, p, s):
    blocks = block_config_of(p)
    _exp_conv3d(out, f"{prefix}.features.conv0", p["conv0"]["conv"])
    _exp_bn(out, f"{prefix}.features.norm0", p["norm0"]["bn"],
            s["norm0"]["bn"])
    for bi, n_layers in enumerate(blocks):
        for li in range(n_layers):
            tp = f"{prefix}.features.denseblock{bi + 1}.denselayer{li + 1}.layers"
            name = f"block{bi}_layer{li}"
            _exp_bn(out, f"{tp}.norm1", p[name]["norm1"]["bn"],
                    s[name]["norm1"]["bn"])
            _exp_conv3d(out, f"{tp}.conv1", p[name]["conv1"]["conv"])
            _exp_bn(out, f"{tp}.norm2", p[name]["norm2"]["bn"],
                    s[name]["norm2"]["bn"])
            _exp_conv3d(out, f"{tp}.conv2", p[name]["conv2"]["conv"])
        if bi != len(blocks) - 1:
            tp = f"{prefix}.features.transition{bi + 1}"
            name = f"transition{bi}"
            _exp_bn(out, f"{tp}.norm", p[name]["norm"]["bn"],
                    s[name]["norm"]["bn"])
            _exp_conv3d(out, f"{tp}.conv", p[name]["conv"]["conv"])
    _exp_bn(out, f"{prefix}.features.norm5", p["norm5"]["bn"],
            s["norm5"]["bn"])
    _exp_linear(out, f"{prefix}.class_layers.out", p["head"])


def _exp_simple_cnn(out, prefix, p, s):
    for i, seq in enumerate((0, 3, 6)):
        _exp_conv3d(out, f"{prefix}.{seq}", p[f"conv{i}"]["conv"])
        _exp_bn(out, f"{prefix}.{seq + 1}", p[f"bn{i}"]["bn"],
                s[f"bn{i}"]["bn"])


def _exp_image_encoder(out, prefix, p, s):
    if "densenet" in p:
        _exp_densenet121(out, prefix, p["densenet"], s["densenet"])
    else:
        _exp_simple_cnn(out, prefix, p["cnn"], s["cnn"])


def _exp_rna_compact(out, prefix, p, s):
    _exp_linear(out, f"{prefix}.0", p["block0"]["linear"]["dense"])
    _exp_bn(out, f"{prefix}.1", p["block0"]["norm"]["bn"],
            s["block0"]["norm"]["bn"])
    _exp_linear(out, f"{prefix}.4", p["proj"]["dense"])


def _exp_rna_deep(out, prefix, p, s):
    for i, seq in enumerate((0, 4)):
        _exp_linear(out, f"{prefix}.{seq}",
                    p[f"block{i}"]["linear"]["dense"])
        _exp_bn(out, f"{prefix}.{seq + 1}", p[f"block{i}"]["norm"]["bn"],
                s[f"block{i}"]["norm"]["bn"])
    _exp_linear(out, f"{prefix}.8", p["proj"]["dense"])


def _exp_fusion_head(out, prefix, p, s):
    _exp_linear(out, f"{prefix}.0", p["block0"]["linear"]["dense"])
    _exp_bn(out, f"{prefix}.1", p["block0"]["norm"]["bn"],
            s["block0"]["norm"]["bn"])
    _exp_linear(out, f"{prefix}.4", p["linear1"]["dense"])
    _exp_linear(out, f"{prefix}.7", p["out"]["dense"])


def _exp_layer_norm(out, prefix, tree):
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _exp_attention(out, prefix, tree):
    for name in ("query", "key", "value"):
        k = np.asarray(tree[name]["kernel"])  # (D, H, D/H)
        out[f"{prefix}.{name}.weight"] = np.ascontiguousarray(
            k.reshape(k.shape[0], -1).T)
        out[f"{prefix}.{name}.bias"] = np.asarray(tree[name]["bias"]).reshape(-1)
    k = np.asarray(tree["out"]["kernel"])  # (H, D/H, D)
    out[f"{prefix}.out.weight"] = np.ascontiguousarray(
        k.reshape(-1, k.shape[-1]).T)
    out[f"{prefix}.out.bias"] = np.asarray(tree["out"]["bias"])


def _exp_mmsurv(out, p, s):
    _exp_image_encoder(out, "image_encoder", p["image_encoder"],
                       s["image_encoder"])
    _exp_rna_compact(out, "rna_encoder", p["rna_encoder"], s["rna_encoder"])
    _exp_linear(out, "clinical_encoder.0",
                p["clinical_encoder"]["proj"]["dense"])
    _exp_linear(out, "cbp_proj", p["cbp_proj"]["dense"])
    out["pos_embed"] = np.asarray(p["pos_embed"])
    for prefix in ("layer0", "layer1"):
        tree = p[prefix]
        _exp_layer_norm(out, f"{prefix}.ln1", tree["ln1"])
        _exp_attention(out, f"{prefix}.attn", tree["attn"])
        _exp_layer_norm(out, f"{prefix}.ln2", tree["ln2"])
        _exp_linear(out, f"{prefix}.ff0", tree["ff0"]["dense"])
        _exp_linear(out, f"{prefix}.ff1", tree["ff1"]["dense"])
    _exp_linear(out, "cox_head", p["cox_head"]["dense"])


def export_torch_state_dict(model_name: str, variables: dict) -> dict:
    """flax variables -> state_dict ``{key: np.ndarray}`` in the reference's
    layout (the port's own for ``mmsurv``), for any of the eight families
    (either CT backbone, any DenseNet ``block_config``)."""
    p = variables["params"]
    s = variables.get("batch_stats", {})
    out: dict = {}
    if model_name == "rnaseq_only":
        for i in range(3):
            _exp_linear(out, f"mlp.{4 * i}",
                        p[f"block{i}"]["linear"]["dense"])
            _exp_bn(out, f"mlp.{4 * i + 1}", p[f"block{i}"]["norm"]["bn"],
                    s[f"block{i}"]["norm"]["bn"])
        _exp_linear(out, "mlp.12", p["head"]["dense"])
    elif model_name == "image_only":
        _exp_simple_cnn(out, "encoder", p["encoder"], s["encoder"])
        _exp_linear(out, "fc.0", p["fc"]["dense"])
        _exp_linear(out, "risk_head", p["risk_head"]["dense"])
    elif model_name == "partial_modality":
        _exp_image_encoder(out, "ct_encoder", p["ct_encoder"],
                           s["ct_encoder"])
        _exp_rna_compact(out, "rna_encoder", p["rna_encoder"],
                         s["rna_encoder"])
        _exp_linear(out, "clinical_encoder.0",
                    p["clinical_encoder"]["proj"]["dense"])
        _exp_linear(out, "gate.0", p["gate0"]["dense"])
        _exp_linear(out, "gate.2", p["gate1"]["dense"])
        _exp_linear(out, "fusion.0", p["fusion_block"]["linear"]["dense"])
        _exp_bn(out, "fusion.1", p["fusion_block"]["norm"]["bn"],
                s["fusion_block"]["norm"]["bn"])
        _exp_linear(out, "fusion.4", p["fusion_proj"]["dense"])
        _exp_linear(out, "cox_head", p["cox_head"]["dense"])
    elif model_name == "simple_fusion":
        _exp_rna_deep(out, "rna_encoder", p["rna_encoder"], s["rna_encoder"])
        _exp_image_encoder(out, "image_encoder", p["image_encoder"],
                           s["image_encoder"])
        _exp_fusion_head(out, "fusion", p["fusion"], s["fusion"])
    elif model_name == "flexible_multimodal":
        _exp_image_encoder(out, "image_encoder", p["image_encoder"],
                           s["image_encoder"])
        _exp_rna_deep(out, "rna_encoder", p["rna_encoder"], s["rna_encoder"])
        out["missing_image_bias"] = np.asarray(p["missing_image_bias"])
        out["missing_rna_bias"] = np.asarray(p["missing_rna_bias"])
        _exp_fusion_head(out, "fusion", p["fusion"], s["fusion"])
    elif model_name == "final":
        _exp_image_encoder(out, "ct_encoder", p["ct_encoder"],
                           s["ct_encoder"])
        _exp_rna_compact(out, "rna_encoder", p["rna_encoder"],
                         s["rna_encoder"])
        _exp_linear(out, "clinical_encoder.0",
                    p["clinical_encoder"]["proj"]["dense"])
        _exp_linear(out, "fusion.0", p["fusion_block"]["linear"]["dense"])
        _exp_bn(out, "fusion.1", p["fusion_block"]["norm"]["bn"],
                s["fusion_block"]["norm"]["bn"])
        _exp_linear(out, "fusion.4", p["fusion_proj"]["dense"])
        _exp_linear(out, "cox_head", p["cox_head"]["dense"])
    elif model_name == "simmim":
        _exp_image_encoder(out, "expert_image.encoder", p["expert_image"],
                           s["expert_image"])
        _exp_linear(out, "expert_image.cox_head", p["cox_image"]["dense"])
        _exp_rna_compact(out, "expert_rnaseq.encoder", p["expert_rnaseq"],
                         s["expert_rnaseq"])
        _exp_linear(out, "expert_rnaseq.cox_head", p["cox_rnaseq"]["dense"])
        _exp_linear(out, "expert_clinical.encoder.0",
                    p["expert_clinical"]["fc0"]["dense"])
        _exp_linear(out, "expert_clinical.encoder.2",
                    p["expert_clinical"]["fc1"]["dense"])
        _exp_linear(out, "expert_clinical.cox_head",
                    p["cox_clinical"]["dense"])
        _exp_linear(out, "gating.gate.0", p["gating"]["fc0"]["dense"])
        _exp_linear(out, "gating.gate.3", p["gating"]["fc1"]["dense"])
        _exp_linear(out, "gating.gate.5", p["gating"]["fc2"]["dense"])
        _exp_linear(out, "ensemble_cox", p["ensemble_cox"]["dense"])
    elif model_name == "mmsurv":
        _exp_mmsurv(out, p, s)
    else:
        raise ValueError(f"unknown model {model_name!r}")
    return out
