"""Preprocessing: DICOM decoding and genomic normalization, without pandas
(the port of ``multimodal_survival_prediction_tpu/preprocess/``).

Entry points (the counterparts of ``scripts/preprocessing/``, with the same
flags and artifacts):

    python -m multimodal_survival_prediction_tpu_torch.preprocess.convert_dicom_to_nifti --data-root <root>
    python -m multimodal_survival_prediction_tpu_torch.preprocess.preprocess_genomic --data-root <root>
    python -m multimodal_survival_prediction_tpu_torch.preprocess.create_full_matching_table --data-root <root>
    python -m multimodal_survival_prediction_tpu_torch.preprocess.create_multimodal_dataset --data-root <root>
"""

from .genomic import (  # noqa: F401
    build_rnaseq_matrix,
    mutation_matrix_from_maf,
    normalize_rnaseq,
)
