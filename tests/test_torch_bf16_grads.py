"""chip_smoke.py phase 8b's step-1 gradient rule for the fused bf16 path,
held on the CPU against float32 in the port and in the JAX package (its
fused path in interpret mode, as tests/test_fused_dense.py runs it)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_survival_prediction_tpu import config as jconfig
from multimodal_survival_prediction_tpu.models.gated import (
    PartialModalityNet as JGated,
)
from multimodal_survival_prediction_tpu.train import adapters as jadapters
from multimodal_survival_prediction_tpu.train import engine as jengine
from multimodal_survival_prediction_tpu_torch.config import PARTIAL_MODALITY
from multimodal_survival_prediction_tpu_torch.models import PartialModalityNet
from multimodal_survival_prediction_tpu_torch.train import engine
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_model_and_adapters,
)
from test_torch_bf16 import BF16, RNA_DIM, ULP, _cohort, _NoDropout, _sd


def _fused_stage_names(names):
    """The fused stages' dW, dgamma and dbeta: each dense layer's norm1 /
    conv1 and each transition's norm / conv."""
    return [n for n in names
            if ("denselayer" in n and (".norm1." in n or ".conv1." in n))
            or ("transition" in n and (".norm." in n or ".conv." in n))]


def _rel(a, b) -> float:
    """||a - b|| / ||b||."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_fused_bf16_gradients_as_close_to_f32_as_unfused(monkeypatch):
    """chip_smoke.py phase 8b's step-1 rule, here and on the JAX package:
    each fused stage's dW, dgamma and dbeta on the fused bf16 path lie no
    further from the unfused float32 gradient than twice the unfused bf16
    path's distance + half a bf16 ulp (distances ||d|| / ||float32||).
    PartialModalityNet with block_config (2, 2) at 16x16x8, dropout off,
    from the JAX init, one train-mode loss and its gradients; the JAX
    fused path in interpret mode. Measured on this seed (fused / unfused
    bf16 from float32; fused from unfused; the largest fused-to-unfused
    distance ratio): JAX 19-33 % / 20-33 %; 11-17 %; 1.11. The port 23-38
    % / 26-44 %; 11-20 %; 1.01. Batch-statistics BatchNorm backward
    cancels, so bf16 rounding moves these gradients by a fifth or more on
    either path, in both frameworks."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    arrays = _cohort()
    cfg = jconfig.PARTIAL_MODALITY
    _, jb2i, jhaa = jadapters.make_model_and_adapters(cfg, rna_dim=RNA_DIM)
    jdata = {k: jnp.asarray(v) for k, v in arrays.items()}
    kw = dict(batch_size=8, learning_rate=cfg.learning_rate,
              weight_decay=cfg.weight_decay, optimizer=cfg.optimizer,
              grad_clip=cfg.grad_clip, ties=cfg.ties, seed=cfg.seed)
    _, b2i, haa = make_model_and_adapters(PARTIAL_MODALITY, rna_dim=RNA_DIM)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    jax_grads, port_grads, init = {}, {}, None
    for fused in (True, False):
        for jdt, dt in ((None, None), (jnp.bfloat16, BF16)):
            jm = JGated(block_config=(2, 2), fused_bn1=fused, dtype=jdt)
            jtr = jengine.Trainer(jm, jb2i, jhaa, jengine.TrainConfig(**kw))
            jstate = jtr.init_state(jdata, fold=1)
            (_, stats), grads = jax.value_and_grad(
                jtr._loss_fn, has_aux=True)(jstate.params, jstate.batch_stats,
                                            jdata, jax.random.PRNGKey(0))
            jax_grads[fused, dt] = _sd({"params": grads,
                                        "batch_stats": stats})
            init = init or _sd({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
            tr = engine.Trainer(
                lambda g, fused=fused, dt=dt: PartialModalityNet(
                    rna_dim=RNA_DIM, block_config=(2, 2), fused_bn1=fused,
                    dropout=0.0, generator=g, dtype=dt),
                b2i, haa, engine.TrainConfig(**kw), device="cpu")
            state = tr.init_state(fold=1)
            state.model.load_state_dict(init, strict=True)
            _, grads = tr.loss_and_grads(state, batch)
            port_grads[fused, dt] = dict(zip(
                (n for n, _ in state.model.named_parameters()), grads))
    names = _fused_stage_names(port_grads[True, None])
    assert len(names) == 3 * 5  # 2 + 2 dense layers and one transition
    for side, g in (("jax", jax_grads), ("port", port_grads)):
        ref = g[False, None]
        for n in names:
            fused = _rel(g[True, BF16][n], ref[n])
            unfused = _rel(g[False, BF16][n], ref[n])
            assert fused <= 2 * unfused + ULP / 2, (side, n, fused, unfused)
