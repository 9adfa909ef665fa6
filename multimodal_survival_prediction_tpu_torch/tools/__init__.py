"""Command-line tools over fold checkpoints: ``convert_torch_checkpoint``,
``export_torch_checkpoint`` and ``calibrate`` (``python -m
multimodal_survival_prediction_tpu_torch.tools.<tool>``)."""
