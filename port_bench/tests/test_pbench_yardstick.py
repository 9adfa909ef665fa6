"""The yardstick's arithmetic: the fused stages of DenseNet121-3D and their
bounds (copied from the smoke test, which they must equal), the frozen
FLOP counts, and the per-layer readers on synthetic events."""

import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import pbench_tiny
from port_bench.core import flops, peaks, registry
from port_bench.core.trace import Summary

CONFIGS = ["partial_modality-dn121-f32", "simple_fusion-dn121-f32"]


def _config(name):
    return json.loads((registry.BENCH / "configs" / f"{name}.json"
                       ).read_text())


def test_stages_reproduce_the_smoke_tests_shapes():
    cfg = _config("partial_modality-dn121-f32")
    stages = peaks.densenet_fused_stages(cfg["arch"]["densenet"],
                                         cfg["arch"]["image_shape"], 8)
    assert len(stages) == 61
    assert sorted({n for n, _, _ in stages}) == [32, 256, 2048, 16384]
    for case in peaks.FUSED_CASES[:8]:
        assert tuple(case) in stages
    assert peaks.FUSED_CASES[:8] == [
        tuple(c) for c in __import__("chip_smoke").FUSED_CASES[:8]]


@pytest.mark.parametrize("name", peaks.FUSED_NAMES)
def test_bound_equals_the_smoke_tests(name):
    sys.path.insert(0, str(pbench_tiny.ROOT))
    import chip_smoke

    for n, c, f in peaks.FUSED_CASES:
        assert peaks.fused_bound_ms(name, n, c, f) == \
            chip_smoke.fused_bound_ms(name, n, c, f)
    assert peaks.FUSED_DEVICE_KERNELS == chip_smoke.FUSED_DEVICE_KERNELS
    assert peaks.FUSED_FOLD_KERNEL == chip_smoke.FUSED_FOLD_KERNEL
    assert (peaks.H100_BYTES_PER_S, peaks.H100_F32_OPS_PER_S,
            peaks.H100_TF32_OPS_PER_S) == (
        chip_smoke.H100_BYTES_PER_S, chip_smoke.H100_F32_OPS_PER_S,
        chip_smoke.H100_TF32_OPS_PER_S)


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_flop_counts(name):
    cfg = _config(name)
    counted = flops.per_patient(cfg)
    assert counted["train_per_patient"] == cfg["flops"]["train_per_patient"]
    assert counted["eval_per_patient"] == cfg["flops"]["eval_per_patient"]
    # linear in the batch, so per patient is enough
    assert flops.count(cfg, 8, True) == 8 * cfg["flops"][
        "train_per_patient"]


def _summary():
    # two train steps' kernels in [0, 1), an eval kernel, one copy; the
    # host ran aten::mm over [0.5, 0.7) and nothing else
    kernels = [(0.1, 0.2, "void ::apply_kernel<4>"),
               (0.25, 0.3, "void ::fold_parts_kernel<1>"),
               (0.3, 0.4, "sm80_xmma_fprop"), (0.8, 0.9, "sm80_xmma_fprop"),
               (1.2, 1.3, "eval_kernel")]
    copies = [(0.35, 0.45, "Memcpy HtoD")]
    spans = [("pbench.train_epoch", 0.0, 1.0), ("pbench.evaluate", 1.0, 1.5)]
    return Summary(kernels, copies, spans, 2.0, [(0.5, 0.7, "aten::mm")])


def test_summary_busy_idle_and_breakdown():
    s = _summary()
    assert s.busy_s() == pytest.approx(0.1 + 0.2 + 0.1 + 0.1)
    gaps = s.idle_gaps()
    assert gaps[0] == pytest.approx((0.0, 0.1))
    assert sum(g for _, g in gaps) == pytest.approx(2.0 - 0.5)
    b = s.breakdown()
    assert b["device_ops"][0] == ["sm80_xmma_fprop", pytest.approx(0.2)]
    labels = dict(b["idle_gaps"])
    assert labels["aten::mm"] == pytest.approx(0.35)  # the gap 0.45-0.8
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_training_readers():
    run = SimpleNamespace(summary=_summary(), plain_epoch_s=2.0, steps=2,
                          peak_bytes=3 * 2 ** 30,
                          epoch_flops=1.34e12,
                          fused_stages=[(16384, 224, 128)])
    read = {m: registry.load_metric(m) for m in (
        "step_mfu.train", "launches_per_step.train",
        "fused_roofline_share.train", "device_idle_share.train",
        "peak_mem_gib.train")}
    assert read["step_mfu.train"](run) == pytest.approx(1.0)
    assert read["launches_per_step.train"](run) == 2.0
    bound = peaks.fused_step_bound_ms([(16384, 224, 128)]) / 1e3 * 2
    assert read["fused_roofline_share.train"](run) == pytest.approx(
        100 * bound / 0.15)
    assert read["device_idle_share.train"](run) == pytest.approx(75.0)
    assert read["peak_mem_gib.train"](run) == 3.0
    # nothing to read: None, never 0
    none = SimpleNamespace(**(run.__dict__ | {"fused_stages": None}))
    assert read["fused_roofline_share.train"](none) is None
    empty = Summary([], [], [("pbench.train_epoch", 0.0, 1.0)], 1.0, [])
    assert read["fused_roofline_share.train"](
        SimpleNamespace(**(run.__dict__ | {"summary": empty}))) is None

