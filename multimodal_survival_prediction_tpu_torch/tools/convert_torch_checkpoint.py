"""Convert a reference torch ``.pth`` fold checkpoint into a fold checkpoint
of this package (port of ``scripts/tools/convert_torch_checkpoint.py``).

The reference saves ``torch.save(model.state_dict(),
'models/<name>/fold_K_best.pth')``. Converted once, it serves every scoring
tool here (``predict_risk``, ``RiskScorer``, ``analysis.generate_km_curves``):

    python -m multimodal_survival_prediction_tpu_torch.tools.convert_torch_checkpoint \\
        --model partial_modality \\
        --torch-checkpoint models/partial_modality/fold_1_best.pth \\
        --out models_port/partial_modality/fold_1_best.msgpack \\
        --image-shape 64,64,32

The format follows ``--out``'s suffix: ``.pt`` (the port's) or ``.msgpack``
(the JAX package's). A ``.meta.json`` with the JAX tool's keys is written
beside it. Supported: every family with a reference layout (rnaseq_only,
partial_modality, simple_fusion, flexible_multimodal, final, image_only,
simmim); image families take either CT backbone, found from the keys. The
result is checked by a strict ``load_state_dict`` into the port's model and
a forward pass on zeros (on ``--device``) before anything is written.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from ..config import ALL_CONFIGS
from ..io.checkpoint import save_checkpoint, save_fold_meta
from ..io.torch_import import REFERENCE_FAMILIES, import_torch_checkpoint
from ..train.adapters import make_model_and_adapters
from ..utils import parse_hu_window
from ..utils.device import resolve_device


def rna_dim_of(model_name: str, sd: dict) -> int:
    """The RNA input width of a reference-layout state_dict (5,005 for
    image_only, which reads no RNA, as the JAX tool records)."""
    key = {"rnaseq_only": "mlp.0.weight", "image_only": None,
           "simmim": "expert_rnaseq.encoder.0.weight"}.get(
               model_name, "rna_encoder.0.weight")
    return 5005 if key is None else int(sd[key].shape[1])


def zeros_batch(image_shape, rna_dim, device) -> dict:
    """One all-zero patient with every modality flagged present."""
    shapes = {"image": (1, *image_shape, 1), "rnaseq": (1, rna_dim),
              "clinical": (1, 1), "time": (1,), "event": (1,)}
    batch = {k: torch.zeros(s, device=device) for k, s in shapes.items()}
    batch.update(mask=torch.ones(1, 3, device=device),
                 svalid=torch.ones(1, device=device),
                 valid=torch.ones(1, device=device))
    return batch


def validate(model_name, sd, backbone, rna_dim, image_shape, device):
    """Strict load into the port's model, then one forward pass on zeros:
    the output must be finite. Stands in for JAX's validate_against_model."""
    model, b2i, hazard_and_aux = make_model_and_adapters(
        ALL_CONFIGS[model_name], rna_dim=rna_dim,
        backbone=backbone or "densenet121")
    model = model.to(device).eval()
    model.load_state_dict({k: v.to(device) for k, v in sd.items()},
                          strict=True)
    batch = zeros_batch(image_shape, rna_dim, device)
    with torch.inference_mode():
        out = model(*b2i(batch))
        hazard = (hazard_and_aux(out, batch)[0] if hazard_and_aux else out)
    if not bool(torch.isfinite(hazard).all()):
        raise ValueError(f"converted {model_name} model gives a non-finite "
                         f"hazard on zeros: {hazard}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True, choices=list(REFERENCE_FAMILIES))
    p.add_argument("--torch-checkpoint", required=True)
    p.add_argument("--out", required=True,
                   help="output .pt or .msgpack path (.meta.json beside it)")
    p.add_argument("--backbone", default=None,
                   choices=["densenet121", "simple_cnn"],
                   help="CT backbone (default: found from the keys)")
    p.add_argument("--image-shape", default="64,64,32",
                   help="training-time CT shape to record in .meta.json "
                        "(the reference flagship used 64,64,32)")
    p.add_argument("--hu-window", default=None,
                   help="lo,hi HU window if the torch run windowed CTs")
    p.add_argument("--device", default="cuda",
                   help="where the forward check runs")
    args = p.parse_args(argv)

    out = Path(args.out)
    if out.suffix not in (".pt", ".msgpack"):
        raise SystemExit(f"--out must end in .pt or .msgpack, not {out.suffix!r}")
    device = resolve_device(args.device)
    sd, backbone = import_torch_checkpoint(args.model, args.torch_checkpoint,
                                           backbone=args.backbone)
    rna_dim = rna_dim_of(args.model, sd)
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    hu_window = parse_hu_window(args.hu_window)
    validate(args.model, sd, backbone, rna_dim, image_shape, device)

    save_checkpoint(out, sd, model_name=args.model)
    save_fold_meta(
        out, model=args.model, backbone=backbone,
        image_shape=list(image_shape), rna_dim=rna_dim,
        hu_window=(list(hu_window) if hu_window else None),
        use_pallas_resample=False, ties="breslow",
        imported_from=str(args.torch_checkpoint))
    print(f"[convert-torch] wrote {out} (+.meta.json): model={args.model} "
          f"backbone={backbone} rna_dim={rna_dim} image_shape={image_shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
