"""PyTorch/CUDA port of ``multimodal_survival_prediction_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference. This package mirrors its
module paths (``ops/resample.py`` here is the counterpart of
``ops/resample.py`` there) and imports nothing from it. Public entry points
run on the card (``device="cuda"``) and raise when CUDA is missing unless the
caller passes ``device="cpu"``.

Ported: all eight model families of the JAX package (``models/``:
``rnaseq_only``, ``image_only``, ``simple_fusion``, ``flexible_multimodal``,
``final``, the flagship gated ``partial_modality``, ``simmim`` and
``mmsurv``), their weight carry-over from JAX (``io.jax_import``), and:
  * serving — batch scoring (``train.predict.predict_risk``) and the HTTP
    scorer (``serving.RiskScorer`` + ``serving.make_server``), with the CT
    W-pass kernel (``ops/csrc/resample_wpass.cu``);
  * training — ``train.engine.Trainer`` with the Cox loss, the C-index and
    the LR schedules, and DenseNet121-3D's ``fused_bn1`` train mode through
    the fused BN->ReLU->1x1-conv kernels (``ops/csrc/fused_dense.cu``);
  * cross-validation — the K-fold driver (``train.cv``, SimMLM's two-stage
    schedule included), both ``cv_results.json`` schemas (``io.results``)
    and one training CLI a family, ``python -m
    multimodal_survival_prediction_tpu_torch.train.<entry>`` with entry
    ``train_rnaseq_only``, ``image_only``, ``simple_fusion``,
    ``flexible_multimodal``, ``final_multimodal``,
    ``partial_modality_training``, ``simmlm`` or ``mmsurv``;
  * fold checkpoints in the port's ``.pt``, the JAX package's flax
    ``.msgpack`` and the reference's ``.pth`` (``io.checkpoint``,
    ``io.msgpack``, ``io.torch_import``), with the converters and the
    ensemble calibration under ``tools/``;
  * evaluation — ``ops.km`` and ``analysis`` (``evaluate_predictions``, the
    ``generate_km_curves`` and ``evaluate_model`` entry points);
  * the host ingest engine (``csrc/msp_native.cpp`` via ``data.native``,
    ``resample='host'``/``'auto'`` in ``data.pipeline``), preprocessing of
    raw DICOM and STAR files (``preprocess``), and the comparison
    (``analysis.comparison``, ``analysis.final_comparison``, ``run_all``).
  * multi-device training over ``torch.distributed`` (``parallel``: data
    and tensor parallelism on a (data, model) ``DeviceMesh``, multi-process
    runs; ``ops.cox_distributed``: the sharded Cox risk set), behind the
    Trainer's and the CV driver's ``mesh`` and the CLIs' ``--mesh``,
    ``--tp``, ``--sharded-risk-set`` and ``--multihost``.
ROADMAP.md lists what is still to come.
"""

__version__ = "0.1.0"
