"""DICOM -> NIfTI conversion (parity with reference scripts/preprocessing/convert_dicom_to_nifti.py): per patient, per series directory, assemble the slice stack, write data/imaging/nifti/<pid>/series_{idx:02d}.nii.gz, record geometry + the 7 DICOM tags per series as JSON, and summarize to conversion_results.csv.

    python -m multimodal_survival_prediction_tpu_torch.preprocess.convert_dicom_to_nifti \\
        --data-root <root> [--dicom-root DIR] [--nifti-root DIR]

The port's counterpart of ``scripts/preprocessing/convert_dicom_to_nifti.py``
(the same flags and artifacts, without pandas).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data.nifti import write_nifti
from .dicom import read_dicom_series
from .tables import from_records, write_table


def base_parser(desc: str) -> argparse.ArgumentParser:
    """The flags every preprocessing entry point takes."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--data-root", default=".",
                   help="root containing the data/ tree")
    return p


def main(argv=None):
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--dicom-root", default=None)
    p.add_argument("--nifti-root", default=None)
    args = p.parse_args(argv)

    root = Path(args.data_root)
    dicom_root = Path(args.dicom_root or root / "data" / "imaging" / "dicom")
    nifti_root = Path(args.nifti_root or root / "data" / "imaging" / "nifti")

    if not dicom_root.is_dir():
        print(f"no DICOM directory at {dicom_root}")
        return

    rows = []
    for pdir in sorted(d for d in dicom_root.iterdir() if d.is_dir()):
        pid = pdir.name
        out_dir = nifti_root / pid
        series_dirs = sorted(d for d in pdir.iterdir() if d.is_dir()) or [pdir]
        for idx, sdir in enumerate(series_dirs):
            rec = dict(patient_id=pid, series_dir=str(sdir), series_index=idx,
                       status="ok", error="")
            try:
                series = read_dicom_series(sdir)
                out_dir.mkdir(parents=True, exist_ok=True)
                out_path = out_dir / f"series_{idx:02d}.nii.gz"
                write_nifti(out_path, series.volume,
                            spacing=series.spacing, origin=series.origin)
                meta = dict(series.metadata)
                meta.update(
                    spacing=list(series.spacing),
                    origin=list(series.origin),
                    output=str(out_path),
                )
                (out_dir / f"series_{idx:02d}_metadata.json").write_text(
                    json.dumps(meta, indent=2))
                rec.update(output=str(out_path),
                           num_slices=series.metadata["num_slices"])
            except Exception as e:  # a failed series is recorded, not fatal
                rec.update(status="failed", error=str(e)[:300])
            rows.append(rec)
            print(f"{pid} series {idx}: {rec['status']}")

    df = from_records(rows)
    nifti_root.mkdir(parents=True, exist_ok=True)
    write_table(nifti_root / "conversion_results.csv", df)
    ok = sum(s == "ok" for s in df.column("status")) if len(df) else 0
    print(f"\nconverted {ok}/{len(df)} series -> {nifti_root}")


if __name__ == "__main__":
    main()
