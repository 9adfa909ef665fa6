"""Export a fold checkpoint of this package (``.pt`` or ``.msgpack``) to a
reference-layout torch ``.pth`` state_dict (port of
``scripts/tools/export_torch_checkpoint.py``; the inverse of
``convert_torch_checkpoint``).

The file loads into the reference's own model classes with
``load_state_dict(strict=True)`` (MONAI's DenseNet121 key layout, with its
``.layers.`` nesting):

    python -m multimodal_survival_prediction_tpu_torch.tools.export_torch_checkpoint \\
        --checkpoint models/partial_modality/fold_1_best.msgpack \\
        --out fold_1_best.pth

The model family comes from the checkpoint's ``.meta.json`` (or
``--model``); mmsurv has no reference layout. The ``.meta.json`` is copied
beside the ``.pth`` (with ``exported_from``), so the port's scoring tools
read the ``.pth`` with the training-time facts; reference tooling ignores
it. A file conversion on the host: no device is used.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..io.checkpoint import (
    load_checkpoint,
    load_fold_meta,
    save_checkpoint,
    save_fold_meta,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True, help=".pt or .msgpack path")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--model", default=None,
                   help="model family (default: from .meta.json)")
    args = p.parse_args(argv)

    out = Path(args.out)
    if out.suffix != ".pth":
        raise SystemExit(f"--out must end in .pth, not {out.suffix!r}")
    meta = load_fold_meta(args.checkpoint) or {}
    model_name = args.model or meta.get("model")
    if not model_name:
        raise SystemExit("--model required (no .meta.json with 'model' "
                         "beside the checkpoint)")
    sd = load_checkpoint(args.checkpoint, "cpu", model_name=model_name)
    save_checkpoint(out, sd, model_name=model_name)
    save_fold_meta(out, **dict(meta, model=model_name,
                               exported_from=str(args.checkpoint)))
    print(f"[export-torch] wrote {out} (+.meta.json): model={model_name} "
          f"backbone={meta.get('backbone')} ({len(sd)} tensors)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
