"""Fold-checkpoint interop of the port (``io/msgpack.py``,
``io/torch_import.py``, ``io/checkpoint.py``, ``train/predict.py``'s
``fold_checkpoints`` and the two ``tools/`` converters) against the JAX
package and the reference-named torch twins, on the CPU.

* The port's ``.msgpack`` bytes equal JAX ``io/checkpoint.save_checkpoint``'s
  for every family (both CT backbones; DenseNet cut to ``block_config``
  (2, 2)) and for ``rnaseq_only`` at full width (the 5,005x1,024 leaf):
  the tree is a seeded fill of the JAX init's shapes, carried to the port
  by ``io/jax_import.py`` and back by the port's import map.
* A JAX-written fold loads strictly through the port's reader; flax's
  chunked leaves (a lowered ``MAX_CHUNK_SIZE``) read back.
* ``predict_risk`` on folds written by the JAX CV driver equals JAX's
  ``predict_risk`` within 1e-4 (Pallas W-pass in interpret mode, as the
  JAX package's own tests run it).
* A ``.pth`` from each twin in ``benchmarks/torch_reference_named.py``, in
  MONAI and torchvision naming, with a ``module.`` prefix, wrapped as
  ``{"state_dict": ...}`` and without ``num_batches_tracked``, loads
  strictly into the port and gives the twin's forward: 1e-5 for
  rnaseq_only, 2e-4 for the rest (the limits tests/test_torch_import.py
  holds JAX's import to).
"""

import json

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import torch_reference_named as named
from multimodal_survival_prediction_tpu import config as jconfig
from multimodal_survival_prediction_tpu.io.checkpoint import (
    save_checkpoint as jax_save,
)
from multimodal_survival_prediction_tpu.io.checkpoint import (
    save_fold_meta as jax_save_meta,
)
from multimodal_survival_prediction_tpu.io.torch_import import (
    import_torch_checkpoint as jax_import_torch,
)
from multimodal_survival_prediction_tpu.models import fusion as jfusion
from multimodal_survival_prediction_tpu.models import mmsurv as jmmsurv
from multimodal_survival_prediction_tpu.models import moe as jmoe
from multimodal_survival_prediction_tpu.models.encoders import (
    ImageEncoder as JImageEncoder,
)
from multimodal_survival_prediction_tpu.ops import resample as jr
from multimodal_survival_prediction_tpu.train import adapters as jadapters
from multimodal_survival_prediction_tpu.train import cv as jcv
from multimodal_survival_prediction_tpu.train.predict import (
    predict_risk as jax_predict,
)
from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu_torch.io import msgpack as mp
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_fold_meta,
    save_checkpoint,
    save_fold_meta,
)
from multimodal_survival_prediction_tpu_torch.io.jax_import import (
    export_torch_state_dict,
)
from multimodal_survival_prediction_tpu_torch.io.torch_import import (
    import_state_dict,
    load_torch_state_dict,
)
from multimodal_survival_prediction_tpu_torch.tools import (
    convert_torch_checkpoint,
    export_torch_checkpoint,
)
from multimodal_survival_prediction_tpu_torch.train.adapters import (
    make_model_and_adapters,
)
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoint,
    fold_checkpoints,
    predict_risk,
)

RNA_DIM = 24
IMAGE = (16, 16, 8)
SMALL_BLOCKS = (2, 2)
RISK_ATOL = 1e-4
OWN = ("rnaseq_only", "image_only")
BACKBONED = ("partial_modality", "simple_fusion", "flexible_multimodal",
             "final", "simmim", "mmsurv")
CASES = ([(n, None) for n in OWN]
         + [(n, b) for n in BACKBONED for b in ("simple_cnn", "densenet121")])
IDS = [f"{n}-{b or 'own'}" for n, b in CASES]


class _SmallImageEncoder(JImageEncoder):
    """JAX ``ImageEncoder`` whose DenseNet defaults to two blocks."""

    block_config: tuple | None = SMALL_BLOCKS


@pytest.fixture
def small_jax_densenet(monkeypatch):
    for mod in (jfusion, jmoe, jmmsurv):
        monkeypatch.setattr(mod, "ImageEncoder", _SmallImageEncoder)


def _jax_tree(name, backbone, seed, rna_dim=RNA_DIM, image=IMAGE):
    """A seeded fill of the JAX init's {params, batch_stats} shapes (no
    forward pass), as numpy arrays."""
    kw = {"backbone": backbone} if backbone else {}
    model, b2i, _ = jadapters.make_model_and_adapters(
        jconfig.ALL_CONFIGS[name], rna_dim=rna_dim, **kw)
    if name == "partial_modality" and backbone == "densenet121":
        model = model.clone(block_config=SMALL_BLOCKS)
    batch = {"image": jnp.zeros((1, *image, 1)),
             "rnaseq": jnp.zeros((1, rna_dim)), "clinical": jnp.zeros((1, 1)),
             "mask": jnp.zeros((1, 3))}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *b2i(batch)))
    rng = np.random.default_rng(seed)
    fill = lambda s: rng.normal(size=s.shape).astype(s.dtype)  # noqa: E731
    return {"params": jax.tree_util.tree_map(fill, dict(shapes["params"])),
            "batch_stats": jax.tree_util.tree_map(
                fill, dict(shapes.get("batch_stats", {})))}


def _port_model(name, backbone, rna_dim=RNA_DIM):
    if backbone == "densenet121":
        cls = type(make_model_and_adapters(
            ALL_CONFIGS[name], rna_dim=rna_dim, backbone="simple_cnn")[0])
        return cls(rna_dim=rna_dim, backbone=backbone,
                   block_config=SMALL_BLOCKS)
    return make_model_and_adapters(ALL_CONFIGS[name], rna_dim=rna_dim,
                                   backbone=backbone or "densenet121")[0]


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict), path
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{path}/{k}")


# ---------------------------------------------------------------------------
# msgpack: bytes, reading, chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,backbone", CASES, ids=IDS)
def test_msgpack_bytes_equal_jax(name, backbone, small_jax_densenet,
                                 tmp_path):
    tree = _jax_tree(name, backbone, seed=3)
    jax_save(tmp_path / "jax.msgpack", tree)
    sd = _tensors(export_torch_state_dict(name, tree))
    save_checkpoint(tmp_path / "port.msgpack", sd, model_name=name)
    want = (tmp_path / "jax.msgpack").read_bytes()
    got = (tmp_path / "port.msgpack").read_bytes()
    assert len(got) == len(want) and got == want


def test_msgpack_bytes_equal_jax_full_width_rnaseq(tmp_path):
    """rnaseq_only at 5,005 genes: the 5,005x1,024 float32 leaf (20 MB, a
    bin32 header inside an ext32)."""
    tree = _jax_tree("rnaseq_only", None, seed=4, rna_dim=5005)
    assert tree["params"]["block0"]["linear"]["dense"]["kernel"].shape == (
        5005, 1024)
    jax_save(tmp_path / "jax.msgpack", tree)
    save_checkpoint(tmp_path / "port.msgpack",
                    _tensors(export_torch_state_dict("rnaseq_only", tree)),
                    model_name="rnaseq_only")
    assert (tmp_path / "port.msgpack").read_bytes() == (
        tmp_path / "jax.msgpack").read_bytes()


@pytest.mark.parametrize("name,backbone", CASES, ids=IDS)
def test_port_reads_a_jax_fold_strictly(name, backbone, small_jax_densenet,
                                        tmp_path):
    tree = _jax_tree(name, backbone, seed=5)
    path = tmp_path / "fold_1_best.msgpack"
    jax_save(path, tree)
    jax_save_meta(path, model=name, backbone=backbone)
    _assert_trees_equal(mp.unpackb(path.read_bytes()), tree)
    sd = load_checkpoint(path)  # the family from the sidecar
    model = _port_model(name, backbone)
    model.load_state_dict(sd, strict=True)
    want = export_torch_state_dict(name, tree)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("name,backbone", CASES, ids=IDS)
def test_export_then_import_is_the_identity(name, backbone,
                                            small_jax_densenet):
    tree = _jax_tree(name, backbone, seed=6)
    back = import_state_dict(name, _tensors(export_torch_state_dict(name,
                                                                    tree)))
    _assert_trees_equal(back, tree)


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_chunked_leaves_read_back(chunk, monkeypatch, tmp_path):
    """flax splits leaves over MAX_CHUNK_SIZE bytes (patched down here
    only); the port joins them again and, with the same limit, writes the
    same bytes."""
    tree = _jax_tree("rnaseq_only", None, seed=7, rna_dim=40)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
    jax_save(tmp_path / "fold.msgpack", tree)
    data = (tmp_path / "fold.msgpack").read_bytes()
    assert b"__msgpack_chunked_array__" in data
    _assert_trees_equal(mp.unpackb(data), tree)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", chunk)
    assert mp.packb(tree) == data


def test_reader_refuses_what_no_fold_holds():
    with pytest.raises(ValueError, match="ext type 2"):
        mp.unpackb(bytes([0xD4, 0x02, 0x00]))
    bad = mp.packb({"x": np.zeros(2, np.float32)}).replace(b"float32",
                                                           b"floatXY")
    with pytest.raises(ValueError, match="floatXY"):
        mp.unpackb(bad)
    with pytest.raises(ValueError, match="truncated"):
        mp.unpackb(mp.packb({"x": np.zeros(8, np.float32)})[:-3])


# ---------------------------------------------------------------------------
# the wrong family, mixed formats
# ---------------------------------------------------------------------------

def test_a_wrong_family_raises(tmp_path):
    tree = _jax_tree("partial_modality", "simple_cnn", seed=8)
    path = tmp_path / "fold_1_best.msgpack"
    jax_save(path, tree)
    # final's map reads a subset of partial_modality's leaves: refused
    with pytest.raises(ValueError, match="gate0"):
        load_checkpoint(path, model_name="final")
    with pytest.raises(ValueError, match="wrong model family"):
        load_checkpoint(path, model_name="rnaseq_only")
    with pytest.raises(ValueError, match="model family is needed"):
        load_checkpoint(path)
    rna = named.build_reference_named_rnaseq(10)
    torch.save(rna.state_dict(), tmp_path / "rna.pth")
    with pytest.raises((KeyError, ValueError)):
        load_checkpoint(tmp_path / "rna.pth", model_name="partial_modality")
    with pytest.raises(ValueError, match="no reference torch layout"):
        save_checkpoint(tmp_path / "m.pth", {}, model_name="mmsurv")


def test_fold_checkpoints_sees_every_suffix(tmp_path):
    d = tmp_path / "partial_modality"
    d.mkdir()
    for name in ("fold_2_best.msgpack", "fold_10_best.pth", "fold_1_best.pt",
                 "fold_1_best.pt.meta.json", "calibration.json"):
        (d / name).write_bytes(b"")
    got = fold_checkpoints(tmp_path, "partial_modality")
    assert [p.name for p in got] == ["fold_1_best.pt", "fold_2_best.msgpack",
                                     "fold_10_best.pth"]
    assert fold_checkpoint(tmp_path, "partial_modality", 2).name == \
        "fold_2_best.msgpack"
    (d / "fold_2_best.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="two formats"):
        fold_checkpoints(tmp_path, "partial_modality")
    with pytest.raises(FileNotFoundError):
        fold_checkpoints(tmp_path, "final")


# ---------------------------------------------------------------------------
# predict_risk on folds of the JAX CV driver
# ---------------------------------------------------------------------------

@pytest.fixture
def _no_cached_jax_tracers():
    """JAX ``ops/resample.py:_matrices`` is an ``lru_cache`` filled inside
    a jit trace (tests/test_torch_cv.py says why it is emptied)."""
    jr._matrices.cache_clear()
    yield
    jr._matrices.cache_clear()


def test_predict_risk_on_jax_cv_folds_matches_jax(tmp_path,
                                                  _no_cached_jax_tracers):
    """partial_modality, simple_cnn at 16x16x8: the JAX driver trains 2
    folds x 1 epoch with the Pallas resample pinned and writes its
    .msgpack folds; the port scores each fold, and the ensemble of fold 1
    as .msgpack with fold 2 converted to .pt, as JAX scores them."""
    from multimodal_survival_prediction_tpu.data.synthetic import (
        SyntheticCohortSpec as JSpec,
    )
    from multimodal_survival_prediction_tpu.data.synthetic import (
        generate_synthetic_cohort as jgen,
    )

    jtable, paths = jgen(tmp_path / "cohort", JSpec(
        n_patients=14, rna_dim=RNA_DIM, seed=2, p_imaging=0.6,
        image_shapes=((12, 20, 20), (10, 18, 16))))
    jcfg = jconfig.PARTIAL_MODALITY.with_overrides(image_shape=IMAGE,
                                                   n_folds=2, num_epochs=1)
    models = tmp_path / "models"
    jcv.run_cross_validation(jcfg, jtable, rnaseq_csv=paths["rnaseq_csv"],
                             results_dir=tmp_path / "results",
                             models_dir=models, backbone="simple_cnn",
                             use_pallas_resample=True)
    jfolds = fold_checkpoints(models, "partial_modality")
    assert [p.name for p in jfolds] == ["fold_1_best.msgpack",
                                        "fold_2_best.msgpack"]
    assert load_fold_meta(jfolds[0])["use_pallas_resample"] is True
    rows = load_matching_table(paths["matching_table"])
    cfg = ALL_CONFIGS["partial_modality"]
    for fold in jfolds:
        want = jax_predict(jcfg, fold, jtable,
                           rnaseq_csv=paths["rnaseq_csv"], labeled_only=False)
        got = predict_risk(cfg, fold, rows, rnaseq_csv=paths["rnaseq_csv"],
                           labeled_only=False, device="cpu")
        assert list(got["patient_id"]) == list(want.patient_id)
        np.testing.assert_allclose(got["risk_score"], want.risk_score.values,
                                   atol=RISK_ATOL)

    mixed = tmp_path / "mixed" / "partial_modality"
    mixed.mkdir(parents=True)
    for src, dst in ((jfolds[0], "fold_1_best.msgpack"),
                     (jfolds[1], "fold_2_best.pt")):
        save_checkpoint(mixed / dst, load_checkpoint(src),
                        model_name="partial_modality")
        save_fold_meta(mixed / dst, **load_fold_meta(src))
    assert (mixed / "fold_1_best.msgpack").read_bytes() == \
        jfolds[0].read_bytes()
    want, wstats = jax_predict(jcfg, jfolds, jtable,
                               rnaseq_csv=paths["rnaseq_csv"],
                               return_fold_stats=True)
    got, gstats = predict_risk(
        cfg, fold_checkpoints(tmp_path / "mixed", "partial_modality"), rows,
        rnaseq_csv=paths["rnaseq_csv"], return_fold_stats=True, device="cpu")
    np.testing.assert_allclose(got["risk_score"], want.risk_score.values,
                               atol=RISK_ATOL)
    np.testing.assert_allclose(np.asarray(gstats), np.asarray(wstats),
                               atol=RISK_ATOL)


# ---------------------------------------------------------------------------
# reference .pth from the twins
# ---------------------------------------------------------------------------

TWINS = {
    "rnaseq_only": lambda monai: named.build_reference_named_rnaseq(RNA_DIM),
    "image_only": lambda monai: named.build_reference_named_image_only(),
    "partial_modality": lambda monai:
        named.build_reference_named_partial_modality(RNA_DIM,
                                                     use_monai=monai),
    "simple_fusion": lambda monai: named.build_reference_named_simple_fusion(
        RNA_DIM, use_monai=monai),
    "flexible_multimodal": lambda monai:
        named.build_reference_named_flexible(RNA_DIM, use_monai=monai),
    "final": lambda monai: named.build_reference_named_final(
        RNA_DIM, use_monai=monai),
    "simmim": lambda monai: named.build_reference_named_simmlm(
        RNA_DIM, use_monai=monai),
}
TWIN_CASES = ([(n, None) for n in OWN]
              + [(n, b) for n in TWINS if n not in OWN
                 for b in ("simple_cnn", "densenet121")])
FORMS = ("monai", "torchvision", "module", "wrapped", "no_batches_tracked")
TWIN_IMAGE = (32, 32, 32)  # the MONAI DenseNet121's smallest input


def _twin_inputs(name, n=3, seed=0):
    """Seeded inputs as the twin takes them and as the port's adapters do."""
    rng = np.random.default_rng(seed)
    ct = rng.normal(size=(n, 1, *TWIN_IMAGE)).astype(np.float32)
    rna = rng.normal(size=(n, RNA_DIM)).astype(np.float32)
    clin = rng.normal(size=(n, 1)).astype(np.float32)
    mask = np.asarray([[1, 1, 1], [0, 1, 1], [1, 0, 1]], np.float32)[:n]
    twin = {"rnaseq_only": (rna,), "image_only": (ct,),
            "partial_modality": (ct, rna, clin, mask),
            "simple_fusion": (ct, rna), "flexible_multimodal": (ct, rna,
                                                                mask[:, :2]),
            "final": (ct, rna, clin), "simmim": (ct, rna, clin, mask)}[name]
    batch = {"image": np.moveaxis(ct, 1, -1), "rnaseq": rna,
             "clinical": clin, "mask": mask}
    return ([torch.from_numpy(x) for x in twin],
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()})


def _twin(name, backbone, seed=0):
    """The twin with seeded weights and non-trivial running stats."""
    torch.manual_seed(seed)
    model = TWINS[name](backbone == "densenet121")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.normal_(0.0, 0.1, generator=gen)
            elif k.endswith("running_var"):
                v.uniform_(0.5, 1.5, generator=gen)
            elif k.endswith("num_batches_tracked"):
                v.fill_(7)
    return model.eval()


def _form(sd, form):
    if form == "torchvision":
        return {k.replace(".layers.", "."): v for k, v in sd.items()}
    if form == "module":
        return {f"module.{k}": v for k, v in sd.items()}
    if form == "wrapped":
        return {"state_dict": sd}
    if form == "no_batches_tracked":
        return {k: v for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}
    return sd


def _flat(out):
    return [o.detach().numpy().reshape(-1)
            for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name,backbone", TWIN_CASES,
                         ids=[f"{n}-{b or 'own'}" for n, b in TWIN_CASES])
def test_reference_pth_loads_strictly_in_every_form(name, backbone,
                                                    tmp_path):
    twin = _twin(name, backbone)
    twin_in, batch = _twin_inputs(name)
    with torch.no_grad():
        want = _flat(twin(*twin_in))
    sd = twin.state_dict()
    model, b2i, _ = make_model_and_adapters(
        ALL_CONFIGS[name], rna_dim=RNA_DIM,
        backbone=backbone or "densenet121")
    model.eval()
    atol = 1e-5 if name == "rnaseq_only" else 2e-4
    for form in FORMS:
        if form == "torchvision" and backbone != "densenet121":
            continue  # no dense layers to rename
        path = tmp_path / f"{form}.pth"
        torch.save(_form(sd, form), path)
        got_sd = load_checkpoint(path, model_name=name)
        model.load_state_dict(got_sd, strict=True)
        with torch.no_grad():
            got = _flat(model(*b2i(batch)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=atol, err_msg=form)
        if form == "no_batches_tracked":
            assert all(int(v) == 0 for k, v in got_sd.items()
                       if k.endswith("num_batches_tracked"))


def test_convert_then_export_round_trip_with_the_twin(tmp_path):
    """.pth -> convert (.msgpack, bytes equal to the JAX import's) ->
    export (.pth) loads strictly into the twin and gives its forward; the
    converter's .meta.json carries the JAX tool's keys."""
    twin = _twin("partial_modality", "densenet121", seed=2)
    twin_in, _ = _twin_inputs("partial_modality", seed=2)
    with torch.no_grad():
        want = _flat(twin(*twin_in))
    pth = tmp_path / "ref" / "fold_1_best.pth"
    pth.parent.mkdir()
    torch.save(_form(twin.state_dict(), "torchvision"), pth)
    out = tmp_path / "port" / "partial_modality" / "fold_1_best.msgpack"
    assert convert_torch_checkpoint.main([
        "--model", "partial_modality", "--torch-checkpoint", str(pth),
        "--out", str(out), "--image-shape", "32,32,32",
        "--device", "cpu"]) == 0
    meta = load_fold_meta(out)
    assert meta == {"model": "partial_modality", "backbone": "densenet121",
                    "image_shape": [32, 32, 32], "rna_dim": RNA_DIM,
                    "hu_window": None, "use_pallas_resample": False,
                    "ties": "breslow", "imported_from": str(pth)}
    variables, _ = jax_import_torch("partial_modality", pth)
    jax_save(tmp_path / "jax.msgpack", variables)
    assert out.read_bytes() == (tmp_path / "jax.msgpack").read_bytes()

    back = tmp_path / "back" / "fold_1_best.pth"
    assert export_torch_checkpoint.main(["--checkpoint", str(out),
                                         "--out", str(back)]) == 0
    assert load_fold_meta(back)["exported_from"] == str(out)
    twin2 = _twin("partial_modality", "densenet121", seed=9)
    twin2.load_state_dict(torch.load(back, weights_only=True), strict=True)
    with torch.no_grad():
        got = _flat(twin2(*twin_in))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-4)
    assert set(load_torch_state_dict(back)) == set(twin.state_dict())


def test_converter_refuses_what_it_cannot_write(tmp_path):
    torch.save(named.build_reference_named_rnaseq(RNA_DIM).state_dict(),
               tmp_path / "r.pth")
    with pytest.raises(SystemExit):
        convert_torch_checkpoint.main([
            "--model", "rnaseq_only", "--torch-checkpoint",
            str(tmp_path / "r.pth"), "--out", str(tmp_path / "r.pth2"),
            "--device", "cpu"])
    with pytest.raises(SystemExit):  # mmsurv has no reference layout
        convert_torch_checkpoint.main([
            "--model", "mmsurv", "--torch-checkpoint",
            str(tmp_path / "r.pth"), "--out", str(tmp_path / "m.pt"),
            "--device", "cpu"])
    out = tmp_path / "fold_1_best.pt"
    assert convert_torch_checkpoint.main([
        "--model", "rnaseq_only", "--torch-checkpoint",
        str(tmp_path / "r.pth"), "--out", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.with_name(out.name + ".meta.json").read_text())[
        "rna_dim"] == RNA_DIM
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert_torch_checkpoint.main([
                "--model", "rnaseq_only", "--torch-checkpoint",
                str(tmp_path / "r.pth"), "--out", str(out)])


def test_port_cv_fold_round_trips_through_every_format(tmp_path):
    """A port fold (.pt) written as .msgpack and exported to .pth scores
    the same as the .pt with predict_risk."""
    table, paths = generate_synthetic_cohort(tmp_path / "c",
                                             SyntheticCohortSpec(
                                                 n_patients=8,
                                                 rna_dim=RNA_DIM, seed=3,
                                                 p_imaging=0.6,
                                                 image_shapes=((12, 20,
                                                                20),)))
    cfg = ALL_CONFIGS["final"]
    model = make_model_and_adapters(cfg, rna_dim=RNA_DIM,
                                    backbone="simple_cnn",
                                    generator=torch.Generator().manual_seed(
                                        1))[0]
    meta = dict(model="final", backbone="simple_cnn",
                image_shape=list(IMAGE), rna_dim=RNA_DIM,
                use_pallas_resample=True, resample_mode="device")
    pt = tmp_path / "m" / "final" / "fold_1_best.pt"
    save_checkpoint(pt, model.state_dict())
    save_fold_meta(pt, **meta)
    mpk = tmp_path / "m2" / "final" / "fold_1_best.msgpack"
    save_checkpoint(mpk, load_checkpoint(pt), model_name="final")
    save_fold_meta(mpk, **meta)
    pth = tmp_path / "m3" / "final" / "fold_1_best.pth"
    assert export_torch_checkpoint.main(["--checkpoint", str(mpk), "--out",
                                         str(pth)]) == 0
    scores = [predict_risk(cfg, p, table, rnaseq_csv=paths["rnaseq_csv"],
                           labeled_only=False, device="cpu")["risk_score"]
              for p in (pt, mpk, pth)]
    for s in scores[1:]:
        np.testing.assert_array_equal(s, scores[0])
