"""Weight carry-over: the port's ``io/jax_import.py`` against the JAX
``export_torch_state_dict``, at the full width of the flagship
``partial_modality`` model (DenseNet121-3D, 64x64x32, 5,005 genes).

The flax tree comes from ``jax.eval_shape`` filled with seeded random
numpy — no forward pass. Exact equality: both maps only transpose and copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu.io.torch_import import (
    export_torch_state_dict as jax_export,
)
from multimodal_survival_prediction_tpu.models.gated import (
    PartialModalityNet as JGated,
)
from multimodal_survival_prediction_tpu_torch.io import checkpoint as ckpt
from multimodal_survival_prediction_tpu_torch.io.jax_import import (
    block_config_of,
    export_torch_state_dict,
)
from multimodal_survival_prediction_tpu_torch.models import PartialModalityNet


def _random_tree(backbone, seed):
    model = JGated(backbone=backbone)
    ex = (jnp.zeros((1, 64, 64, 32, 1)), jnp.zeros((1, 5005)),
          jnp.zeros((1, 1)), jnp.zeros((1, 3)))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *ex))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), dict(shapes))


@pytest.mark.parametrize("backbone", ["densenet121", "simple_cnn"])
def test_full_width_export_matches_jax_and_loads_strictly(backbone):
    tree = _random_tree(backbone, seed=11)
    want = jax_export("partial_modality", tree)
    got = export_torch_state_dict("partial_modality", tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype

    model = PartialModalityNet(rna_dim=5005, backbone=backbone)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in got.items()}
    model.load_state_dict(sd, strict=True)
    loaded = model.state_dict()
    assert set(loaded) == set(got)
    for k, v in sd.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
    if backbone == "densenet121":
        assert block_config_of(
            tree["params"]["ct_encoder"]["densenet"]) == (6, 12, 24, 16)


def test_unknown_family_is_refused():
    with pytest.raises(ValueError, match="unknown model"):
        export_torch_state_dict("resnet", {"params": {}})


def test_checkpoint_and_meta_roundtrip(tmp_path):
    model = PartialModalityNet(rna_dim=40, backbone="simple_cnn",
                               generator=torch.Generator().manual_seed(3))
    path = tmp_path / "m" / "fold_1_best.pt"
    ckpt.save_checkpoint(path, model.state_dict())
    ckpt.save_fold_meta(path, backbone="simple_cnn", image_shape=(16, 16, 8),
                        use_pallas_resample=True)
    back = ckpt.load_checkpoint(path)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    meta = ckpt.load_fold_meta(path)
    assert meta == {"backbone": "simple_cnn", "image_shape": [16, 16, 8],
                    "use_pallas_resample": True}
    assert ckpt.load_fold_meta(tmp_path / "missing.pt") is None
