"""``--resume`` under tensor parallelism on 2 gloo ranks the CLI spawns
(``--mesh 2 --tp 2``): a run of one epoch resumed to two gives fold
checkpoints bit-equal to those of two epochs in one run, and the resume
state on disk holds the single-device tensors (the TP shards gathered;
restored into each rank's rows)."""

import json

import torch

from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    load_checkpoint,
)
from multimodal_survival_prediction_tpu_torch.train import (
    train_rnaseq_only as rna,
)


def _argv(root, *extra, epochs=1):
    return ["--data-root", str(root), "--results-dir", str(root / "results"),
            "--models-dir", str(root / "models"), "--synthetic",
            "--synthetic-patients", "32", "--epochs", str(epochs),
            "--n-folds", "2", "--device", "cpu", *extra]


def test_resume_under_tp_restores_the_shards(tmp_path):
    """``--mesh 2 --tp 2 --resume``: one epoch, then a second run resumes
    it to two; the fold checkpoints equal those of two epochs in one run,
    and the resume state holds the single-device tensors."""
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    flags = ["--mesh", "2", "--tp", "2", "--resume", "--checkpoint-every",
             "1"]
    rna.main(_argv(whole, *flags, epochs=2))
    rna.main(_argv(parts, *flags))
    state = torch.load(parts / "models" / "rnaseq_only" / "fold_1_resume"
                       / "state.pt", weights_only=False)
    assert state["model"]["mlp.0.weight"].shape[0] == 1024
    assert state["opt_mu"][0].shape[0] == 1024
    payload = rna.main(_argv(parts, *flags, epochs=2))
    assert len(payload["fold_results"]) == 2
    for name in ("fold_1_best.pt", "fold_2_best.pt"):
        got = load_checkpoint(parts / "models" / "rnaseq_only" / name)
        want = load_checkpoint(whole / "models" / "rnaseq_only" / name)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), name
    progress = json.loads((parts / "models" / "rnaseq_only" / "fold_1_resume"
                           / "progress.json").read_text())
    assert progress["epoch"] == 2 and len(progress["history"]) == 2
