"""Port data layer (multimodal_survival_prediction_tpu_torch/data, config)
against the JAX package, on the CPU: NIfTI I/O, the pandas-free matching
table, RNA matrix and cohort arrays, the synthetic cohort generator, and the
config copy. Exact equality unless a tolerance is stated.
"""

import dataclasses
import struct

import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_survival_prediction_tpu import config as jcfg
from multimodal_survival_prediction_tpu.data import datasets as jds
from multimodal_survival_prediction_tpu.data import matching_table as jmt
from multimodal_survival_prediction_tpu.data import nifti as jnifti
from multimodal_survival_prediction_tpu.data.synthetic import (
    SyntheticCohortSpec as JSpec,
)
from multimodal_survival_prediction_tpu.data.synthetic import (
    generate_synthetic_cohort as jgen,
)
from multimodal_survival_prediction_tpu_torch import config as tcfg
from multimodal_survival_prediction_tpu_torch.data import datasets as tds
from multimodal_survival_prediction_tpu_torch.data import matching_table as tmt
from multimodal_survival_prediction_tpu_torch.data import nifti as tnifti
from multimodal_survival_prediction_tpu_torch.data.pipeline import (
    VolumePrefetcher,
)
from multimodal_survival_prediction_tpu_torch.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)

SPEC = dict(n_patients=14, rna_dim=40, seed=6, p_imaging=0.7,
            image_shapes=((20, 24, 24), (18, 30, 26)))


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    jroot = tmp_path_factory.mktemp("jax_cohort")
    troot = tmp_path_factory.mktemp("port_cohort")
    jtable, jpaths = jgen(jroot, JSpec(**SPEC))
    ttable, tpaths = generate_synthetic_cohort(troot, SyntheticCohortSpec(
        **SPEC))
    return jtable, jpaths, ttable, tpaths


def _same(a, b):
    """Equal, NaN == NaN; floats to 1e-12 relative (pandas' default CSV
    float parser is not correctly rounded, the last bit may differ)."""
    if isinstance(a, float):
        if np.isnan(a):
            return np.isnan(float(b))
        return bool(np.isclose(a, float(b), rtol=1e-12, atol=0))
    return a == b


def test_config_copy_matches_jax():
    assert set(tcfg.ALL_CONFIGS) == set(jcfg.ALL_CONFIGS)
    for name, c in jcfg.ALL_CONFIGS.items():
        assert dataclasses.asdict(tcfg.ALL_CONFIGS[name]) == \
            dataclasses.asdict(c)


def test_synthetic_cohort_matches_jax(cohorts):
    jtable, jpaths, ttable, tpaths = cohorts
    jrows = jtable.to_dict("records")
    assert len(ttable) == len(jrows)
    for t, j in zip(ttable, jrows):
        for c in tmt.MATCHING_COLUMNS:
            if c == "nifti_path":  # same file under each root
                assert (t[c] == "") == (j[c] == "")
                if t[c]:
                    rel_t = t[c][len(str(tpaths["root"])):]
                    rel_j = j[c][len(str(jpaths["root"])):]
                    assert rel_t == rel_j
                    np.testing.assert_array_equal(
                        tnifti.read_nifti(t[c]).data,
                        jnifti.read_nifti(j[c]).data)
            else:
                assert _same(float(t[c]) if c in ("age", "survival_time")
                             else t[c], j[c]), (c, t[c], j[c])
    # the port's RNA CSV reads back to JAX's float32 values
    trna = tds.load_rnaseq_matrix(tpaths["rnaseq_csv"])
    jrna = jds.load_rnaseq_matrix(jpaths["rnaseq_csv"])
    assert trna.patient_ids == list(jrna.index)
    assert trna.genes == list(jrna.columns)
    np.testing.assert_array_equal(trna.values, jrna.to_numpy(np.float32))


def test_load_matching_table_matches_pandas(cohorts):
    _, jpaths, _, _ = cohorts
    want = jmt.load_matching_table(jpaths["matching_table"]).to_dict(
        "records")
    got = tmt.load_matching_table(jpaths["matching_table"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for c in ("patient_id", *tmt._BOOL_COLUMNS):
            assert g[c] == w[c]
        for c in ("age", "survival_time", "survival_status"):
            assert _same(g[c], float(w[c]))
        assert g["nifti_path"] == ("" if pd.isna(w["nifti_path"])
                                   else w["nifti_path"])


def test_cohort_arrays_match_jax(cohorts):
    jtable, jpaths, _, _ = cohorts
    rows = jtable.to_dict("records")
    for model in ("partial_modality", "final", "rnaseq_only"):
        assert [r["patient_id"] for r in tds.select_cohort(rows, model)] \
            == list(jds.select_cohort(jtable, model).patient_id)
    want = jds.build_cohort_arrays(
        jtable, jds.load_rnaseq_matrix(jpaths["rnaseq_csv"]),
        with_image=True, image_shape=(16, 16, 8), resample="device")
    got = tds.build_cohort_arrays(
        rows, tds.load_rnaseq_matrix(jpaths["rnaseq_csv"]), with_image=True,
        image_shape=(16, 16, 8), device="cpu")
    assert got.patient_ids == want.patient_ids
    assert got.ingest_mode == "device"
    for k, v in want.arrays.items():
        # image: both resample in fp32 (1e-5, as tests/test_torch_resample)
        np.testing.assert_allclose(got.arrays[k], v,
                                   atol=1e-5 if k == "image" else 0,
                                   err_msg=k)


def test_labeled_row_with_nan_status_raises():
    row = dict(patient_id="P0", nifti_path="", has_imaging=False,
               has_rnaseq=False, has_clinical=False, age=float("nan"),
               survival_time=10.0, survival_status=float("nan"),
               has_survival=True)
    with pytest.raises(ValueError, match="survival_status"):
        tds.build_cohort_arrays([row], None, with_image=False, device="cpu")
    row["has_survival"] = False  # unlabeled: zero-filled, not fatal
    arr = tds.build_cohort_arrays([row], None, with_image=False,
                                  device="cpu")
    assert arr.arrays["event"][0] == 0.0 and arr.arrays["svalid"][0] == 0.0


def test_prefetcher_modes_and_failures(tmp_path):
    vol = np.random.default_rng(0).normal(size=(10, 12, 14)).astype(
        np.float32)
    good = tmp_path / "a.nii"
    tnifti.write_nifti(good, vol)
    bad = tmp_path / "b.nii"
    bad.write_bytes(b"not a nifti")
    pf = VolumePrefetcher(device="cpu")
    out = dict(pf.run([(0, str(good)), (1, str(bad)),
                       (2, str(tmp_path / "missing.nii"))], (8, 8, 8)))
    assert pf.last_mode == "device"  # 'auto' resolves to the device path
    assert out[1] is None and out[2] is None
    np.testing.assert_allclose(
        out[0], tds_resample_ref(vol), atol=1e-6)
    with pytest.raises(NotImplementedError, match="host"):
        list(pf.run([(0, str(good))], (8, 8, 8), resample="host"))


def tds_resample_ref(vol):
    from multimodal_survival_prediction_tpu_torch.ops.resample import (
        resample_normalize,
    )
    return resample_normalize(vol, (8, 8, 8), device="cpu").numpy()


def _write_big_endian(path, data):
    dz, dy, dx = data.shape
    hdr = bytearray(348)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, dx, dy, dz, 1, 1, 1, 1)
    struct.pack_into(">h", hdr, 70, 4)  # int16
    struct.pack_into(">h", hdr, 72, 16)
    struct.pack_into(">8f", hdr, 76, *([1.0] * 8))
    struct.pack_into(">f", hdr, 108, 352.0)
    struct.pack_into(">2f", hdr, 112, 1.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    voxels = data.astype(">i2").transpose(2, 1, 0).tobytes(order="F")
    path.write_bytes(bytes(hdr) + b"\x00" * 4 + voxels)


def test_big_endian_nifti_reads_native(tmp_path):
    data = np.random.default_rng(2).integers(
        -1024, 3000, size=(5, 6, 7)).astype(np.int16)
    path = tmp_path / "be.nii"
    _write_big_endian(path, data)
    jarr = jnifti.read_nifti(path).data
    assert not jarr.dtype.isnative  # the JAX reader keeps the file's order
    arr = tnifti.read_nifti(path).data
    assert arr.dtype == np.int16 and arr.dtype.isnative
    np.testing.assert_array_equal(arr, data)
    np.testing.assert_array_equal(arr, jarr)
    assert torch.equal(torch.from_numpy(arr), torch.from_numpy(data))


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_write_read_roundtrip_matches_jax(tmp_path, suffix):
    data = np.random.default_rng(3).normal(size=(4, 5, 6)).astype(np.float32)
    tnifti.write_nifti(tmp_path / f"t{suffix}", data, spacing=(0.7, 0.7, 2.5))
    jnifti.write_nifti(tmp_path / f"j{suffix}", data, spacing=(0.7, 0.7, 2.5))
    a = tnifti.read_nifti(tmp_path / f"t{suffix}")
    b = jnifti.read_nifti(tmp_path / f"j{suffix}")
    np.testing.assert_array_equal(a.data, b.data)
    assert a.spacing == b.spacing
    if suffix == ".nii":  # byte-identical files
        assert (tmp_path / f"t{suffix}").read_bytes() == \
            (tmp_path / f"j{suffix}").read_bytes()


def test_int16_uncompressed_cohort(tmp_path):
    """The options the card's run uses: int16 voxels in plain .nii files."""
    spec = SyntheticCohortSpec(n_patients=6, rna_dim=24, seed=1,
                               p_imaging=1.0, image_shapes=((6, 8, 10),),
                               image_dtype="int16", compress=False)
    table, _ = generate_synthetic_cohort(tmp_path, spec)
    for row in table:
        assert row["nifti_path"].endswith(".nii")
        assert tnifti.read_nifti(row["nifti_path"]).data.dtype == np.int16
