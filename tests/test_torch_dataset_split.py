"""The complete-cohort dataset on the CPU: ``train/kfold.py``'s numpy twin
of sklearn's stratified ``train_test_split`` (values, order and refusals
equal for cohorts of 7-200 patients over a range of event shares), and the
two preprocessing entry points ``preprocess.create_full_matching_table``
and ``preprocess.create_multimodal_dataset`` against the JAX scripts on the
same cohort: the same printed lines, the matching tables and
``data_splits.json`` byte for byte, and a generated module that loads the
cohort through the port.
"""

import importlib.util
import json
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from sklearn.model_selection import train_test_split

from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu_torch.preprocess import (
    create_full_matching_table,
    create_multimodal_dataset,
)
from multimodal_survival_prediction_tpu_torch.train.kfold import (
    stratified_split,
)

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts" / "preprocessing"


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("share", [0.05, 0.2, 0.5, 0.75, 0.95])
def test_stratified_split_equals_sklearn(share):
    """Every cohort size from 7 to 200 at this event share, test sizes 0.3
    and 0.5 (the script's two calls), ids as strings and labels as
    floats, as the matching table gives them."""
    for n in range(7, 201):
        rng = np.random.default_rng(1000 * n + int(100 * share))
        y = (rng.uniform(size=n) < share).astype(np.float64)
        ids = [f"TCGA-{i:04d}" for i in range(n)]
        for test_size in (0.3, 0.5):
            def twin():
                tr, te = stratified_split(y, test_size, 42)
                return [ids[i] for i in tr], [ids[i] for i in te]

            want = _outcome(lambda: tuple(train_test_split(
                ids, test_size=test_size, random_state=42, stratify=y)))
            assert _outcome(twin) == want, (n, test_size)


def test_split_ids_follows_the_script():
    """Both calls chained, as the script chains them, on a cohort with a
    three-member class in the rest (sklearn raises there, so does the
    twin), and the tiny-cohort branch in order."""
    ids = [f"P{i}" for i in range(30)]
    strat = np.asarray([1.0] * 20 + [0.0] * 10)
    tr, va, te = create_multimodal_dataset.split_ids(ids, strat)
    a, rest, _, s_rest = train_test_split(ids, strat, test_size=0.3,
                                          random_state=42, stratify=strat)
    b, c = train_test_split(rest, test_size=0.5, random_state=42,
                            stratify=s_rest)
    assert (tr, va, te) == (a, b, c)
    assert create_multimodal_dataset.split_ids(ids[:6], strat[:6]) == (
        ids[:4], ids[4:5], ids[5:6])
    one_class = np.ones(9)
    assert create_multimodal_dataset.split_ids(ids[:9], one_class)[0] == \
        ids[:6]
    with pytest.raises(ValueError, match="only 1 member"):
        create_multimodal_dataset.split_ids(
            ids[:7], np.asarray([1.0] * 5 + [0.0] * 2))


def _run_jax_script(name, argv, monkeypatch):
    saved = sys.modules.pop("common", None)
    try:
        with monkeypatch.context() as m:
            m.syspath_prepend(str(SCRIPTS))
            m.setattr(sys, "argv", [name, *argv])
            runpy.run_path(str(SCRIPTS / name), run_name="__main__")
    finally:
        sys.modules.pop("common", None)
        if saved is not None:
            sys.modules["common"] = saved


@pytest.mark.parametrize("n,followup", [(40, True), (12, False)],
                         ids=["stratified", "tiny"])
def test_entry_points_write_the_jax_scripts_files(n, followup, tmp_path,
                                                  monkeypatch, capsys):
    """One synthetic cohort (its matching table removed), copied: the
    port's two entry points on one copy, the JAX scripts on the other."""
    mine, ref = tmp_path / "port", tmp_path / "jax"
    generate_synthetic_cohort(mine, SyntheticCohortSpec(
        n_patients=n, rna_dim=32, p_imaging=0.7, seed=n,
        image_shapes=((6, 8, 8),)))
    (mine / "data" / "processed" / "full_matching_table.csv").unlink()
    shutil.copytree(mine, ref)
    extra = ["--use-followup"] if followup else []
    size = ["--target-size", "8,8,8"]
    create_full_matching_table.main(["--data-root", str(mine), *extra])
    create_multimodal_dataset.main(["--data-root", str(mine), *size])
    out = capsys.readouterr().out
    _run_jax_script("create_full_matching_table.py",
                    ["--data-root", str(ref), *extra], monkeypatch)
    _run_jax_script("create_multimodal_dataset.py",
                    ["--data-root", str(ref), *size], monkeypatch)
    assert out.replace(str(mine), "ROOT") == \
        capsys.readouterr().out.replace(str(ref), "ROOT")

    proc, jproc = mine / "data" / "processed", ref / "data" / "processed"
    for name in ("full_matching_table.csv", "multimodal_matching_table.csv",
                 "data_splits.json"):
        assert (proc / name).read_text().replace(str(mine), "ROOT") == \
            (jproc / name).read_text().replace(str(ref), "ROOT"), name
    splits = json.loads((proc / "data_splits.json").read_text())
    assert len(splits["train"]) > len(splits["test"]) > 0
    # the generated module: JAX's template, importing the port
    src = (proc / "multimodal_dataset.py").read_text()
    assert "multimodal_survival_prediction_tpu_torch" in src
    assert "import multimodal_survival_prediction_tpu." not in src
    assert "from multimodal_survival_prediction_tpu." not in src
    assert "TARGET_SIZE = (8, 8, 8)" in src and "RNA_DIM = 5005" in src
    spec = importlib.util.spec_from_file_location(
        f"generated_{n}", proc / "multimodal_dataset.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    shutil.copy(proc / "rnaseq_normalized_mapped.csv",
                proc.parent / "rnaseq_normalized_mapped.csv")
    arrays, ids = module.load("train", device="cpu")
    assert ids == splits["train"]
    assert arrays.arrays["image"].shape[1:4] == (8, 8, 8)
    assert len(arrays.patient_ids) == len(
        (proc / "multimodal_matching_table.csv").read_text().splitlines()) - 1
