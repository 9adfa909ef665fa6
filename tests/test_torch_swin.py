"""The Swin-ViT CT encoder (``models/swin3d.py``, MONAI SwinUNETR's
``swinViT``) against the benchmark's plain reference
(``port_bench/reference/swin.py`` and ``families/final.py``: explicit
matmuls and softmax, MONAI's own helpers), at small sizes on the CPU.

The shapes are chosen so that each part of MONAI's block is exercised: a
36x20x16 CT is 18x10x8 patches, so stage 1 pads every axis to whole 7^3
windows and shifts them (the roll and the region mask), stage 2 (9x5x4)
clamps its window to (7, 5, 4) with a shift along one axis and takes a
sliced 140x140 block of the 7^3 relative index, stages 3 and 4 are single
clamped windows, and the merges of 5x3x2 and 3x2x1 pad odd axes. A
31x17x15 CT adds the patch embedding's padding.

The test that needs a card (``cuda``) replays ``train_epoch``'s CUDA graph
of a Swin step and holds it to the eager steps; on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_swin.py -m cuda
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from multimodal_survival_prediction_tpu_torch.config import (  # noqa: E402
    FINAL_MULTIMODAL,
)
from multimodal_survival_prediction_tpu_torch.models import (  # noqa: E402
    MultiModalSurvivalNet,
    image_encoder,
)
from multimodal_survival_prediction_tpu_torch.models.swin3d import (  # noqa: E402
    ATTENDED_TOKENS,
    PUBLISHED,
    REAL_TOKENS,
    SwinViT3D,
)
from multimodal_survival_prediction_tpu_torch.models.layers import (  # noqa: E402
    set_dropout_generator,
)
from multimodal_survival_prediction_tpu_torch.ops.cox import (  # noqa: E402
    cox_partial_likelihood,
)
from multimodal_survival_prediction_tpu_torch.train import (  # noqa: E402
    cli,
    engine,
)
from multimodal_survival_prediction_tpu_torch.train.adapters import (  # noqa: E402
    make_adapters,
)
from multimodal_survival_prediction_tpu_torch.utils import (  # noqa: E402
    profiling,
)
from port_bench.core import synth  # noqa: E402
from port_bench.reference import model as ref_model  # noqa: E402
from port_bench.reference import swin as ref_swin  # noqa: E402
from port_bench.reference import train as ref_train  # noqa: E402

SMALL = {"feature_size": 12, "depths": [2, 2, 2, 2],
         "num_heads": [3, 6, 12, 24], "window_size": 7, "patch_size": 2,
         "mlp_ratio": 4.0, "out_features": 16}
RNA_DIM = 24
CT = (20, 18, 16)  # 10x9x8 patches: stage 1 padded and shifted, then clamped


def _final_cfg(image_shape=CT) -> dict:
    swin = {k: list(v) if isinstance(v, tuple) else v
            for k, v in PUBLISHED.items()}
    return {"family": "final",
            "arch": {"rna_dim": RNA_DIM, "image_shape": list(image_shape),
                     "dropout": 0.3, "swin": {**swin, "out_features": 128}},
            "train": {"gate_entropy_weight": 0.0}}


def _cohort(n: int, seed: int = 0) -> dict:
    spec = {"patterns": [[1, 1, 1, 1, n - 2], [1, 0, 1, 1, 2]]}
    return synth.make_cohort(spec, CT, RNA_DIM, seed, "cpu")


@pytest.mark.parametrize("shape", [(2, 36, 20, 16), (1, 31, 17, 15)],
                         ids=["padded_shifted_clamped", "patch_padding"])
def test_encoder_matches_reference_float64(shape):
    """The encoder's output and every parameter's gradient against the
    reference on the same seeded weights, loaded by key (``strict``), in
    float64. The two compute the same sums in other orders (SDPA against
    explicit matmuls and softmax): ~1e-15 apart relative. 1e-10 leaves room
    for that and fails on any wrong term: a missing mask or bias, another
    index slice or merge order moves the output by more than 1e-3."""
    spec = []
    ref_swin.swin_spec(spec, "enc", SMALL)
    enc = SwinViT3D(out_features=16, feature_size=12).double()
    assert [k[len("enc."):] for k, _, _ in spec] == list(enc.state_dict())
    weights = {k: v.double() for k, v in synth.make_weights(
        spec, 7, "cpu").items()}
    # LayerNorm at 1/0 would hide a swapped weight and bias
    weights = {k: v + 0.1 * torch.randn(v.shape, dtype=torch.float64,
                                        generator=torch.Generator()
                                        .manual_seed(i))
               if k.endswith(("norm1.weight", "norm2.bias", "norm.bias"))
               else v for i, (k, v) in enumerate(weights.items())}
    enc.load_state_dict({k[len("enc."):]: v for k, v in weights.items()},
                        strict=True)
    x = torch.rand((*shape, 1), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3))
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want = ref_swin.swin(leaves, "enc", SMALL, x)
    got = enc(x)
    assert got.shape == want.shape == (shape[0], 16)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-10 * scale
    g_ref = torch.autograd.grad(want.square().sum(), list(leaves.values()))
    g_prog = torch.autograd.grad(got.square().sum(),
                                 list(enc.parameters()))
    for k, a, b in zip(leaves, g_ref, g_prog):
        assert (a - b).abs().max() <= 1e-10 * a.abs().max() + 1e-300, k


def test_family_hazard_loss_and_grads_match_reference():
    """``MultiModalSurvivalNet(backbone="swin_vit")`` at the published
    widths against ``reference/families/final.py``: train-mode hazards
    (dropout on, both sides drawing from generators seeded alike), the
    Breslow Cox loss and every parameter's gradient, on the benchmark's
    seeded weights loaded by key (``strict``). Float32, the program's
    precision: the hazards and the loss agree to ~1e-6 relative; 2e-5
    holds them with room. The gradients (sums over the batch of products
    of those activations) sit ~1e-5 apart for the worst leaf relative to
    its own size; 1e-3 of the largest leaf's norm holds every leaf, while
    a wrong term moves the worst leaf by more than its whole size."""
    cfg = _final_cfg()
    data = _cohort(6)
    batch = {k: v[:6] for k, v in data.items()}
    batch["valid"] = torch.ones(6)
    weights = synth.make_weights(ref_model.param_spec(cfg), 11, "cpu")
    model = MultiModalSurvivalNet(rna_dim=RNA_DIM, backbone="swin_vit")
    model.load_state_dict(weights, strict=True)
    set_dropout_generator(model, torch.Generator().manual_seed(5))
    model.train()
    b2i, _ = make_adapters(FINAL_MULTIMODAL)
    hazard = model(*b2i(batch))
    loss = cox_partial_likelihood(hazard, batch["time"], batch["event"],
                                  valid=batch["svalid"], ties="breslow")
    leaves = {k: v.clone().requires_grad_(True) for k, v in weights.items()
              if ref_model.is_trained(k)}
    ctx = ref_model.Context(True, torch.Generator().manual_seed(5))
    want_h, gates = ref_model.forward(cfg, ctx, {**weights, **leaves}, batch)
    want_loss = ref_train.train_loss(
        cfg, ref_model.Context(True, torch.Generator().manual_seed(5)),
        {**weights, **leaves}, batch)
    assert gates is None
    assert (hazard - want_h).abs().max() <= 2e-5 * want_h.abs().max()
    got_l, want_l = float(loss.detach()), float(want_loss.detach())
    assert abs(got_l - want_l) <= 2e-5 * abs(want_l)
    names = [n for n, _ in model.named_parameters()]
    assert names == list(leaves)
    g_prog = torch.autograd.grad(loss, list(model.parameters()))
    g_ref = torch.autograd.grad(want_loss, list(leaves.values()))
    top = max(float(g.norm()) for g in g_ref)
    assert top > 0
    for k, a, b in zip(names, g_ref, g_prog):
        assert float((a - b).norm()) <= 1e-3 * top, k


def _trainer(device, small: bool):
    """The final family's Trainer with the Swin-ViT; ``small``: its CT
    encoder at feature size 12 (the published widths cost ~10 s of CPU an
    epoch, and the static step's equality does not depend on them)."""

    def model_fn(g):
        net = MultiModalSurvivalNet(rna_dim=RNA_DIM, backbone="swin_vit",
                                    generator=g)
        if small:
            net.ct_encoder = SwinViT3D(feature_size=12, generator=g)
        return net

    b2i, haa = make_adapters(FINAL_MULTIMODAL)
    return engine.Trainer(model_fn, b2i, haa,
                          engine.TrainConfig(batch_size=4, learning_rate=1e-3),
                          device=device)


def _static_against_eager(device, small: bool = False, epochs: int = 2):
    """Step losses and the state after ``train_epoch`` (the static-input
    step: captured and replayed on a card) and after a loop of
    ``train_step`` over the same batches, ``epochs`` epochs of 3 steps of
    4 rows, the last 2 rows and 2 of padding."""
    data = {k: v.to(device) for k, v in _cohort(10).items()}
    rows = np.arange(10)
    runs = []
    for static in (False, True):
        tr = _trainer(device, small)
        state = tr.init_state(fold=1)
        rng = np.random.default_rng(5)
        losses = []
        for _ in range(epochs):
            if static:
                tr.train_epoch(state, data, rows, rng, 1e-3)
                losses.append(tr.step_losses)
                continue
            perm, bvalid = tr._pad_indices(rows, 4, rng)
            losses.append(torch.stack([
                tr.train_step(state, tr._gather_batch(
                    data, torch.from_numpy(i).long().to(device),
                    torch.from_numpy(v).to(device)), 1e-3)
                for i, v in zip(perm, bvalid)]))
        runs.append((torch.cat(losses), state, tr))
    return runs


@pytest.fixture
def one_thread():
    """Torch on one CPU thread for the test: with several, the backward of
    the bias tables' gather (a scatter-add) sums in an order that varies
    from run to run, so that two eager runs differ in the last bits."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_static_step_equals_eager_step(one_thread):
    """On the CPU the static-input step (the body a card captures) runs
    eagerly: its losses, parameters, buffers and Adam's moments are
    bit-equal to a loop of ``train_step``; the Swin encoder's shapes and
    masks depend on nothing but the batch's shape."""
    (want, ref, _), (got, state, _) = _static_against_eager(
        "cpu", small=True, epochs=1)
    assert torch.equal(got, want)
    for k, v in ref.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu,
                                                 ref.opt_state.mu))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA graph of the step)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_step_equals_eager_step_on_card(cuda_device):
    """On the card the second step of ``train_epoch`` is captured, and it
    and the rest are replays (``graph`` set, ``train.replay`` spans):
    every step's loss within 1e-5 relative of the eager steps'.
    Memory-efficient attention's backward adds its partial gradients with
    atomics, so two eager runs of the same steps differ in the last bits
    and Adam carries that on; 1e-5 is ~100 float32 ulps of the loss."""
    profiling.reset_spans()
    (want, _, _), (got, _, tr) = _static_against_eager(cuda_device)
    assert tr._static.graph is not None
    names = [r.name for r in profiling.spans()]
    assert names.count("train.replay") == 5  # steps 2 to 6
    rel = ((got - want).abs() / want.abs().clamp_min(1e-3)).max()
    assert float(rel) <= 1e-5, (got, want)


def test_spans_and_padding_counters():
    """Each forward records ``swin.patch_embed`` and ``swin.stage1`` ..
    ``swin.stage4``, and each attention call counts its tokens before and
    after padding to whole windows: at 36x20x16, stage by stage, 18x10x8
    -> 21x14x14, 9x5x4 -> 14x5x4, 5x3x2 and 3x2x1 unpadded, two blocks
    each."""
    enc = SwinViT3D(out_features=16, feature_size=12)
    profiling.reset_spans()
    profiling.reset_counters()
    with torch.no_grad():
        enc(torch.rand(2, 36, 20, 16, 1))
    names = [r.name for r in profiling.spans()]
    assert names == ["swin.patch_embed", "swin.stage1", "swin.stage2",
                     "swin.stage3", "swin.stage4"]
    real = 2 * 2 * (18 * 10 * 8 + 9 * 5 * 4 + 5 * 3 * 2 + 3 * 2 * 1)
    attended = 2 * 2 * (21 * 14 * 14 + 14 * 5 * 4 + 5 * 3 * 2 + 3 * 2 * 1)
    assert profiling.counters() == {REAL_TOKENS: real,
                                    ATTENDED_TOKENS: attended}
    profiling.reset_counters()
    assert profiling.counters() == {}


@pytest.mark.parametrize("kwargs", [{"dtype": torch.bfloat16},
                                    {"remat": True}, {"fused_bn1": True},
                                    {"block_config": (2, 2)}],
                         ids=["bf16", "remat", "fused_bn1", "block_config"])
def test_encoder_refuses_what_it_does_not_have(kwargs):
    with pytest.raises(ValueError, match="swin_vit"):
        image_encoder(backbone="swin_vit", **kwargs)


@pytest.mark.parametrize("flags", [["--bf16"], ["--remat"], ["--tp", "2"]],
                         ids=["bf16", "remat", "tp"])
def test_cli_refuses_with_swin_vit(flags, tmp_path):
    """The training CLI refuses ``--bf16``, ``--remat`` and ``--tp`` > 1
    with ``--backbone swin_vit`` before it builds anything (``fused_bn1``
    has no flag: ``image_encoder`` refuses it)."""
    args = cli.base_parser("t").parse_args(
        ["--backbone", "swin_vit", "--data-root", str(tmp_path),
         "--device", "cpu", *flags])
    with pytest.raises(SystemExit, match="swin_vit"):
        cli.run_training(args, FINAL_MULTIMODAL)
    assert not any(tmp_path.iterdir())
