"""The training CLIs on several gloo ranks on the CPU: ``--mesh 2 --tp 2``
(4 ranks the CLI spawns itself), ``--mesh 2 --sharded-risk-set``,
``--mesh 1`` in this process, ``--multihost`` with two processes launched
here, and the usage errors of the JAX scripts (``--resume`` under tensor
parallelism: ``tests/test_torch_multidevice_resume.py``).

Each multi-rank run is held to the single-device run (``--mesh 0``) of the
same synthetic cohort: one ``cv_results.json``, written by rank 0, with
each fold's C-index within 1e-5, and fold checkpoints that load strictly
into the single-device model."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from multimodal_survival_prediction_tpu_torch.config import RNASEQ_ONLY
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    load_checkpoint,
)
from multimodal_survival_prediction_tpu_torch.models import (
    PartialModalityNet,
    RNASeqSurvivalModel,
)
from multimodal_survival_prediction_tpu_torch.train import (
    partial_modality_training as pmt,
)
from multimodal_survival_prediction_tpu_torch.train import (
    train_rnaseq_only as rna,
)
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoints,
)

ROOT = Path(__file__).resolve().parents[1]
C_TOL = 1e-5


def _argv(root, *extra, patients=32):
    return ["--data-root", str(root), "--results-dir", str(root / "results"),
            "--models-dir", str(root / "models"), "--synthetic",
            "--synthetic-patients", str(patients), "--epochs", "1",
            "--n-folds", "2", "--device", "cpu", *extra]


def _pm_argv(root, *extra):
    return _argv(root, "--backbone", "simple_cnn", "--image-shape", "16,16,8",
                 *extra, patients=16)


def _held(payload, want):
    got = [f["best_c_index"] for f in payload["fold_results"]]
    ref = [f["best_c_index"] for f in want["fold_results"]]
    assert got == pytest.approx(ref, abs=C_TOL)
    assert [f["train_size"] for f in payload["fold_results"]] == \
        [f["train_size"] for f in want["fold_results"]]


def _written_once(root, model):
    """The run's files: one cv_results.json, both folds, no rendezvous
    file left behind."""
    results = sorted(p.name for p in (root / "results").rglob("*")
                     if p.is_file())
    assert results == ["cv_results.json"], results
    on_disk = json.loads((root / "results" / model / "cv_results.json")
                         .read_text())
    ckpts = fold_checkpoints(root / "models", model)
    assert [c.name for c in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"]
    return on_disk, ckpts


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-device runs: rnaseq_only and partial_modality."""
    a = tmp_path_factory.mktemp("rna0")
    b = tmp_path_factory.mktemp("pm0")
    return {"rna": rna.main(_argv(a)), "pm": pmt.main(_pm_argv(b))}


def test_mesh_2_tp_2_matches_single_device(tmp_path, single, capfd):
    payload = rna.main(_argv(tmp_path, "--mesh", "2", "--tp", "2"))
    on_disk, ckpts = _written_once(tmp_path, "rnaseq_only")
    assert on_disk == payload
    _held(payload, single["rna"])
    rna_dim = load_checkpoint(ckpts[0])["mlp.0.weight"].shape[1]
    for ckpt in ckpts:  # gathered: the single-device model's tensors
        RNASeqSurvivalModel(rna_dim=rna_dim).load_state_dict(
            load_checkpoint(ckpt), strict=True)
    assert capfd.readouterr().out.count("RNASeq-Only: C-index") == 1


def test_mesh_2_sharded_risk_set_matches_single_device(tmp_path, single):
    payload = pmt.main(_pm_argv(tmp_path, "--mesh", "2",
                                "--sharded-risk-set"))
    _, ckpts = _written_once(tmp_path, "partial_modality")
    _held(payload, single["pm"])
    sd = load_checkpoint(ckpts[0])
    PartialModalityNet(rna_dim=sd["rna_encoder.0.weight"].shape[1],
                       backbone="simple_cnn").load_state_dict(sd,
                                                              strict=True)


def test_mesh_1_runs_in_this_process(tmp_path, single):
    """``--mesh 1`` without a process group makes a group of this process
    alone (gloo on the CPU, NCCL on a GPU: ``chip_smoke.py`` phase 13's
    path) and tears it down after the run."""
    payload = rna.main(_argv(tmp_path, "--mesh", "1", "--sharded-risk-set"))
    _written_once(tmp_path, "rnaseq_only")
    _held(payload, single["rna"])
    assert not torch.distributed.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("launch", ["coordinator", "torchrun_env"])
def test_multihost_two_processes(tmp_path, single, launch):
    """``--multihost --tp 2`` in two processes launched here, rendezvous
    at rank 0's address given by the JAX flags or by torchrun's
    environment: the coordinator writes the synthetic cohort and the
    artifacts and prints the summary.

    The free port is found by binding and closing a socket, so another
    process may take it before rank 0 listens there; rank 0 then fails
    with EADDRINUSE, and rank 1 waits on whatever holds the port. Only
    then are both launched again, on a fresh port and in a fresh
    directory, at most three times in all."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)

    def how(i, port):
        if launch == "coordinator":
            return env, ["--coordinator", f"127.0.0.1:{port}",
                         "--num-processes", "2", "--process-id", str(i)]
        return dict(env, RANK=str(i), WORLD_SIZE="2",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)), []

    for attempt in range(3):
        root, port = tmp_path / f"attempt{attempt}", _free_port()
        procs = []
        for i in range(2):
            env_i, flags = how(i, port)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "multimodal_survival_prediction_tpu_torch.train."
                 "train_rnaseq_only",
                 *_argv(root, "--multihost", "--tp", "2", *flags)],
                cwd=ROOT, env=env_i, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        try:
            outs = [procs[0].communicate(timeout=180)]
            if procs[0].returncode and "EADDRINUSE" in outs[0][1]:
                continue
            outs.append(procs[1].communicate(timeout=180))
            break
        finally:
            for p in procs:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "RNASeq-Only: C-index" in outs[0][0]
    assert "C-index" not in outs[1][0]
    payload, _ = _written_once(root, "rnaseq_only")
    _held(payload, single["rna"])


@pytest.mark.parametrize("flags,raises,match", [
    (["--multihost", "--mesh", "2"], SystemExit,
     "--multihost builds its own global mesh"),
    (["--multihost", "--fold-parallel", "1"], SystemExit,
     "--multihost builds its own global mesh"),
    (["--fold-parallel", "1", "--sharded-risk-set"], SystemExit,
     "mutually exclusive"),
    (["--fold-parallel", "1", "--mesh", "2", "--tp", "2"], SystemExit,
     "mutually exclusive"),
    (["--sharded-risk-set"], ValueError, "sharded_risk_set requires a mesh"),
    (["--mesh", "3", "--tp", "2"], ValueError,
     "3 devices not divisible by model=2"),
    (["--multihost"], ValueError, "no cluster to join"),
    (["--multihost", "--coordinator", "127.0.0.1:1"], ValueError,
     "needs num_processes and process_id"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_usage_errors(tmp_path, monkeypatch, flags, raises, match):
    """What the JAX scripts refuse (scripts/training/common.py), refused
    before the cohort is built; the port's --multihost also needs a
    cluster to join (JAX's is found on a Cloud TPU pod)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(raises, match=match):
        rna.main(_argv(tmp_path, *flags))
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("flags", [
    ["--fold-parallel", "1", "--sharded-risk-set"],
    ["--fold-parallel", "1", "--tp", "2"],
    ["--fold-dp", "2"],
], ids=lambda v: "_".join(v))
def test_usage_errors_read_as_jax(tmp_path, flags):
    """The same flags through the JAX script's run_training: the same
    SystemExit message."""
    sys.path.insert(0, str(ROOT / "scripts" / "training"))
    try:
        import common as jcommon
    finally:
        sys.path.remove(str(ROOT / "scripts" / "training"))
    from multimodal_survival_prediction_tpu import config as jconfig

    argv = [a for a in _argv(tmp_path / "jax", *flags)
            if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit) as want:
        jcommon.run_training(jcommon.base_parser("x").parse_args(argv),
                             jconfig.RNASEQ_ONLY)
    with pytest.raises(SystemExit) as got:
        rna.main(_argv(tmp_path / "port", *flags))
    assert str(got.value) == str(want.value)
    assert RNASEQ_ONLY.name == jconfig.RNASEQ_ONLY.name
