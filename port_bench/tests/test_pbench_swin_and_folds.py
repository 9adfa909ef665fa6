"""The Swin-ViT cell and the fold-parallel cell on the CPU at tiny sizes:
the Swin configuration's frozen FLOP counts and full-width keys, a sound
run of each comes out correct and a state left unchanged does not, the
fold-parallel readings take the worst fold, and the window readers on
synthetic events."""

import copy
import json
import time
from types import SimpleNamespace

import pytest
import torch

import pbench_tiny
from port_bench.core import flops, registry
from port_bench.core.trace import Summary
from port_bench.reference import model as ref_model

SWIN = "final-swinvit96-f32"
LIMITS = {"loss1_gap": 1e-4, "loss2_gap": 1e-4, "loss3_gap": 1e-4,
          "grad_gap": 1e-2, "change_gap": 0.1, "stats_gap": 0.1,
          "count_gap": 0.0, "hazard_gap": 1e-3}


def _swin_config(tiny=True):
    cfg = json.loads((registry.BENCH / "configs" / f"{SWIN}.json"
                      ).read_text())
    if tiny:  # the published widths on a 36x20x16 CT, 64 genes
        cfg = copy.deepcopy(cfg)
        cfg["arch"]["rna_dim"] = 64
        cfg["arch"]["image_shape"] = [36, 20, 16]
        cfg["train"]["eval_batch_size"] = 8
    return cfg


def _swin_cell():
    cell = SimpleNamespace(name="final_swin96_train_b4", chips=1,
                           config=_swin_config(), limits=LIMITS,
                           per_layer=[])
    cell.traffic = pbench_tiny.tiny_traffic("epochs_final_b4")
    return cell


def test_swin_frozen_flop_counts():
    cfg = _swin_config(tiny=False)
    counted = flops.per_patient(cfg)
    assert counted["train_per_patient"] == cfg["flops"]["train_per_patient"]
    assert counted["eval_per_patient"] == cfg["flops"]["eval_per_patient"]


def test_swin_keys_and_shapes_at_full_width():
    cfg = _swin_config(tiny=False)
    with torch.device("meta"):
        port = registry.load_program("final").model(cfg)
    spec = [(k, tuple(s)) for k, s, _ in ref_model.param_spec(cfg)]
    assert [(k, tuple(v.shape)) for k, v in port.state_dict().items()] \
        == spec


def test_swin_program_refuses_other_widths():
    cfg = _swin_config()
    cfg["arch"]["swin"]["num_heads"] = [4, 8, 16, 32]
    with pytest.raises(ValueError, match="widths"):
        registry.load_program("final").model(cfg)


def _unchanged(trainer):
    trainer.train_step = lambda state, batch, lr: trainer.loss_and_grads(
        state, batch)[0]


@pytest.mark.parametrize("plant", [None, _unchanged],
                         ids=["sound", "state_unchanged"])
def test_swin_run(plant):
    r = registry.load_driver("train_epochs").run(
        _swin_cell(), seed=2 ** 33 + 5, seconds=0.1, trace=False,
        t_start=time.perf_counter(), device="cpu", plant=plant)
    assert r.correct == (plant is None), r.checks
    assert r.metrics["train_patients_per_s"][0] > 0


def test_fold_parallel_run_and_readings():
    cell = pbench_tiny.TinyCell("pm_cv_fold_parallel_k3",
                                "partial_modality-dn121-f32",
                                "folds_vmapped_k3_b8", limits=LIMITS)
    driver = registry.load_driver("train_folds_vmapped")
    r = driver.run(cell, seed=2 ** 34 + 9, seconds=0.1, trace=False,
                   t_start=time.perf_counter(), device="cpu")
    assert r.correct, r.checks
    assert r.notes["folds"] == 3 and r.attempted == 3 * 7
    assert r.metrics["train_patients_per_s"][0] > 0
    rows = []
    driver.readings(cell, [4], [5], None, rows.append, device="cpu")
    kinds = [row["kind"] for row in rows]
    assert kinds == ["program", "control_tf32", "fault_half_batch",
                     "fault_state_unchanged", "fault_padding_in_loss"]
    by = {row["kind"]: row for row in rows}
    assert by["fault_state_unchanged"]["numbers"]["change_gap"] == 1.0
    assert by["fault_half_batch"]["numbers"]["loss1_gap"] > 0.1
    assert by["program"]["numbers"]["loss1_gap"] < 1e-4
    assert {w["fold"] for w in by["program"]["where"].values()} <= {0, 1, 2}


def test_worst_takes_each_numbers_worst_fold():
    worst = registry.load_driver("train_folds_vmapped").worst
    numbers, where = worst([({"a": 1.0, "b": 5.0}, {"a": "x"}),
                            ({"a": 3.0, "b": 2.0}, {"a": "y"})])
    assert numbers == {"a": 3.0, "b": 5.0}
    assert where == {"a": {"fold": 1, "at": "y"},
                     "b": {"fold": 0, "at": None}}


def test_window_readers():
    kernels = [(0.1, 0.3, "fmha_cutlassF_f32_aligned_64x64_rf_sm80(x)"),
               (0.3, 0.4, "sm90_xmma_gemm"),
               (0.5, 0.6, "fmha_cutlassB_f32_aligned_64x64_k32_sm80(x)"),
               (1.2, 1.3, "fmha_cutlassF_f32_aligned_64x64_rf_sm80(x)")]
    copies = [(0.35, 0.45, "Memcpy HtoD")]
    spans = [("pbench.train_epoch", 0.0, 1.0), ("pbench.evaluate", 1.0, 1.5)]
    run = SimpleNamespace(summary=Summary(kernels, copies, spans, 2.0, []))
    share = registry.load_metric("window_attn_share.train")
    # busy 0.1-0.45 and 0.5-0.6 = 0.45 s, attention 0.3 s of it
    assert share(run) == pytest.approx(100 * 0.3 / 0.45)
    none = Summary(kernels[1:2], [], spans, 2.0, [])
    assert share(SimpleNamespace(summary=none)) is None
    assert share(SimpleNamespace(summary=None)) is None

    from multimodal_survival_prediction_tpu_torch.models.swin3d import (
        SwinViT3D,
    )
    from multimodal_survival_prediction_tpu_torch.utils import profiling

    pad = registry.load_metric("window_pad_share.train")
    profiling.reset_counters()
    assert pad(run) is None  # nothing counted
    with torch.no_grad():
        SwinViT3D(feature_size=12)(torch.rand(1, 36, 20, 16, 1))
    real = 2 * (18 * 10 * 8 + 9 * 5 * 4 + 5 * 3 * 2 + 3 * 2 * 1)
    attended = 2 * (21 * 14 * 14 + 14 * 5 * 4 + 5 * 3 * 2 + 3 * 2 * 1)
    assert pad(run) == pytest.approx(100 * (attended - real) / attended)
    assert pad(SimpleNamespace(summary=None)) is None
    profiling.reset_counters()
