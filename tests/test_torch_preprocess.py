"""The port's preprocessing (``preprocess/``) against the JAX package's, on
the CPU.

* DICOM: ``read_dicom`` / ``read_dicom_series`` on the files of
  tests/test_dicom.py, bit-equal pixels, equal tags, spacing and metadata.
* RNA-seq: ``build_rnaseq_matrix`` and ``normalize_rnaseq`` against JAX's
  pandas frames: the same samples and genes in the same order, values equal
  bit for bit (NaN where JAX has NaN), the same selected genes, on cases
  with a gene some samples lack (NaN, selected first), a constant gene, .gz
  TSVs, ``N_`` rows, ``#`` comments, non-numeric cells and a 17-digit TPM
  column (pandas' C float parser, which ``tables.parse_float`` follows).
* Mutation and CNV matrices, the preprocessing chain of
  tests/test_preprocess_chain.py up to the training arrays (images 1e-6:
  both sides resample plain on the CPU; the rest exact), and the two
  preprocessing entry points' artifacts byte for byte against the JAX
  scripts' on the same raw files.
"""

import gzip
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from multimodal_survival_prediction_tpu.data import datasets as jds
from multimodal_survival_prediction_tpu.data import matching_table as jmt
from multimodal_survival_prediction_tpu.data.nifti import (
    write_nifti as jwrite_nifti,
)
from multimodal_survival_prediction_tpu.ops import resample as jr
from multimodal_survival_prediction_tpu.preprocess import dicom as jdicom
from multimodal_survival_prediction_tpu.preprocess import genomic as jgen
from multimodal_survival_prediction_tpu_torch.data import datasets as tds
from multimodal_survival_prediction_tpu_torch.data import matching_table as tmt
from multimodal_survival_prediction_tpu_torch.data.nifti import write_nifti
from multimodal_survival_prediction_tpu_torch.preprocess import dicom
from multimodal_survival_prediction_tpu_torch.preprocess import genomic
from multimodal_survival_prediction_tpu_torch.preprocess import tables
from multimodal_survival_prediction_tpu_torch.preprocess import (
    convert_dicom_to_nifti,
    preprocess_genomic,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_cached_jax_tracers():
    """The JAX package's ``ops/resample.py:_matrices`` (an ``lru_cache``
    filled inside a jit trace) can hold tracers that a later trace of the
    same shapes with another dtype or ``hu_window`` trips over: each test
    starts and ends with it empty (as tests/test_torch_data.py does)."""
    jr._matrices.cache_clear()
    yield
    jr._matrices.cache_clear()


def _same_matrix(mine, frame):
    """A port Matrix equal to a JAX DataFrame: labels, order, values bit
    for bit (NaN where NaN)."""
    assert list(mine.index) == list(frame.index)
    assert list(mine.columns) == list(frame.columns)
    np.testing.assert_array_equal(mine.values,
                                  frame.to_numpy(np.float64))


# ---------------------------------------------------------------------------
# DICOM
# ---------------------------------------------------------------------------

def _same_slice(a, b):
    assert a.pixels.dtype == b.pixels.dtype
    np.testing.assert_array_equal(a.pixels, b.pixels)
    assert a.tags == b.tags


def test_dicom_slice_matches_jax(tmp_path, rng):
    px = rng.integers(-1000, 2000, size=(32, 48)).astype(np.int16)
    dicom.write_dicom_slice(tmp_path / "s.dcm", px, instance=1, slope=2.0,
                            intercept=-1024.0)
    jdicom.write_dicom_slice(tmp_path / "j.dcm", px, instance=1, slope=2.0,
                             intercept=-1024.0)
    assert (tmp_path / "s.dcm").read_bytes() == \
        (tmp_path / "j.dcm").read_bytes()
    _same_slice(dicom.read_dicom(tmp_path / "s.dcm"),
                jdicom.read_dicom(tmp_path / "s.dcm"))


def test_dicom_implicit_le_with_preamble_matches_jax(tmp_path, rng):
    import struct

    px = rng.integers(-1000, 2000, size=(8, 10)).astype(np.int16)

    def imp(tag, value):
        if len(value) % 2:
            value += b"\x00"
        return struct.pack("<HHI", tag[0], tag[1], len(value)) + value

    def exp(tag, vr, value):
        if len(value) % 2:
            value += b"\x00"
        return struct.pack("<HH2sH", tag[0], tag[1], vr, len(value)) + value

    d = dicom
    meta = exp(d.TRANSFER_SYNTAX, b"UI", d.IMPLICIT_LE.encode())
    body = b"".join([
        imp(d.ROWS, struct.pack("<H", px.shape[0])),
        imp(d.COLS, struct.pack("<H", px.shape[1])),
        imp(d.BITS_ALLOCATED, struct.pack("<H", 16)),
        imp(d.PIXEL_REPRESENTATION, struct.pack("<H", 1)),
        imp(d.PIXEL_DATA, px.tobytes()),
    ])
    p = tmp_path / "imp.dcm"
    p.write_bytes(b"\x00" * 128 + b"DICM" + meta + body)
    mine, ref = dicom.read_dicom(p), jdicom.read_dicom(p)
    _same_slice(mine, ref)
    np.testing.assert_array_equal(mine.pixels, px.astype(np.float32))


def test_dicom_series_matches_jax(tmp_path, rng):
    vols = rng.integers(-100, 100, size=(5, 16, 16)).astype(np.int16)
    for i, z in enumerate([3, 0, 4, 1, 2]):
        dicom.write_dicom_slice(tmp_path / f"slice_{i}.dcm", vols[z],
                                instance=i, position=(0, 0, 2.5 * z),
                                spacing=(0.7, 0.7), thickness=2.5)
    mine = dicom.read_dicom_series(tmp_path)
    ref = jdicom.read_dicom_series(tmp_path)
    assert mine.volume.dtype == ref.volume.dtype == np.float32
    np.testing.assert_array_equal(mine.volume, ref.volume)
    np.testing.assert_array_equal(mine.volume, vols.astype(np.float32))
    assert mine.spacing == ref.spacing and mine.origin == ref.origin
    assert mine.metadata == ref.metadata


def test_dicom_refusals_match_jax(tmp_path):
    (tmp_path / "empty").mkdir()
    for mod in (dicom, jdicom):
        with pytest.raises(ValueError, match="no DICOM slices"):
            mod.read_dicom_series(tmp_path / "empty")
    bad = tmp_path / "bad.dcm"
    (tmp_path / "x").mkdir()
    p = tmp_path / "x" / "c.dcm"
    dicom.write_dicom_slice(p, np.zeros((2, 2), np.int16), instance=0)
    data = p.read_bytes().replace(dicom.EXPLICIT_LE.encode(),
                                  b"1.2.840.10008.1.2.4.50")
    bad.write_bytes(data)
    for mod in (dicom, jdicom):
        with pytest.raises(NotImplementedError, match="transfer syntax"):
            mod.read_dicom(bad)


# ---------------------------------------------------------------------------
# tables: pandas' parsing and writing rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e5, 1e-12, 1e20])
def test_parse_float_is_pandas_c_parser(scale):
    """17-digit decimals, 4-decimal TPMs and exponent forms parse to the
    double pandas' read_csv and to_numeric give, bit for bit (both differ
    from Python's correctly rounded float() on many such strings)."""
    rng = np.random.default_rng(int(np.log10(scale) + 30))
    v = rng.uniform(0, scale, 20000) * rng.choice([-1, 1], 20000)
    strs = ([repr(float(x)) for x in v] + [f"{x:.4f}" for x in v[:500]]
            + [f"{x:.6e}" for x in v[:500]]
            + ["0.000123456789012345678901", "1234567890123456789012.5",
               "00012.5", "1.", ".5", "-0.0", "1e5", "2E-3"])
    ref = pd.read_csv(io.StringIO("x\n" + "\n".join(strs) + "\n")).x
    mine = np.array([tables.parse_float(s) for s in strs])
    np.testing.assert_array_equal(mine, ref.to_numpy())
    coerced = pd.to_numeric(pd.Series(strs + ["abc", "1.5x", "NA"],
                                      dtype=object), errors="coerce")
    np.testing.assert_array_equal(
        np.array([tables.to_numeric(s) for s in strs] + [
            tables.to_numeric(None if s == "NA" else s)
            for s in ("abc", "1.5x", "NA")]),
        coerced.to_numpy())
    assert (mine != np.array([float(s) for s in strs])).any() or \
        scale == 1e20  # the two parsers do differ on such strings


def test_read_and_write_table_match_pandas(tmp_path):
    """Column types (int, int with a gap -> float, bool, float, string,
    all-missing), NA strings and to_csv's bytes, incl. concat and
    DataFrame-from-records."""
    text = ("a,b,c,d,e,f,g\n"
            "1,2.50,x,True,007,,NA\n"
            ",3,y,False,-2,,\n"
            "4,1e-3,N/A,true,+5,,null\n")
    p = tmp_path / "t.csv"
    p.write_text(text)
    t = tables.read_table(p)
    out = tmp_path / "o.csv"
    tables.write_table(out, t)
    assert out.read_text() == pd.read_csv(p).to_csv(index=False)
    q = tmp_path / "q.csv"
    q.write_text("b,h,a\n7,z,1.5\n8,w,2\n")
    cat = tables.concat([t, tables.read_table(q)])
    tables.write_table(out, cat)
    assert out.read_text() == pd.concat(
        [pd.read_csv(p), pd.read_csv(q)], ignore_index=True).to_csv(
        index=False)
    recs = [dict(a=1, b="x", c=""), dict(a=2, d=5), dict(e=True, a=3)]
    tables.write_table(out, tables.from_records(recs))
    assert out.read_text() == pd.DataFrame(recs).to_csv(index=False)


# ---------------------------------------------------------------------------
# RNA-seq
# ---------------------------------------------------------------------------

def _star(path, genes, cols, gz=False, comment=True):
    lines = (["# gene-model: GENCODE v36"] if comment else [])
    lines.append("\t".join(["gene_id", *cols]))
    for g, vals in genes:
        lines.append("\t".join([g, *vals]))
    data = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)


def _rnaseq_root(tmp_path, rng, n_samples=5, n_genes=40, tpm=False):
    """STAR TSVs: N_ rows, versioned ids, one gene missing in two samples
    (NaN after the union), one constant gene, one non-numeric cell, a .gz
    sample and (with ``tpm``) a 17-digit tpm_unstranded column only."""
    root = tmp_path / "rnaseq"
    genes = [f"ENSG{j:011d}.{j % 3 + 1}" for j in range(n_genes)]
    for i in range(n_samples):
        d = root / f"uuid-{i:02d}"
        d.mkdir(parents=True)
        rows = [("N_unmapped", ["12", ""] if not tpm else [""]),
                ("N_multimapping", ["3", ""] if not tpm else [""])]
        for j, g in enumerate(genes):
            if j == 5 and i in (1, 3):
                continue  # a gene two samples lack
            count = "100" if j == 7 else str(int(rng.integers(0, 5000)))
            if j == 9 and i == 2:
                count = "n.a."  # coerced to NaN and dropped
            val = repr(float(rng.uniform(0, 300))) if tpm else count
            rows.append((g, [val] if tpm else [count,
                                               f"{rng.uniform(0, 99):.4f}"]))
        cols = ["tpm_unstranded"] if tpm else ["unstranded", "tpm_unstranded"]
        _star(d / ("counts.tsv.gz" if i == 4 else "counts.tsv"), rows, cols,
              gz=(i == 4))
    return root


@pytest.mark.parametrize("tpm", [False, True], ids=["counts", "tpm17"])
def test_rnaseq_matrix_and_normalization_match_jax(tmp_path, rng, tpm):
    root = _rnaseq_root(tmp_path, rng, tpm=tpm)
    mine = genomic.build_rnaseq_matrix(root)
    ref = jgen.build_rnaseq_matrix(root)
    _same_matrix(mine, ref)
    assert np.isnan(mine.values).any()  # the gene two samples lack
    for k in (10, 25, 1000):
        norm, genes = genomic.normalize_rnaseq(mine, top_k=k)
        jnorm, jgenes = jgen.normalize_rnaseq(ref, top_k=k)
        assert genes == jgenes
        _same_matrix(norm, jnorm)
    norm, genes = genomic.normalize_rnaseq(mine, top_k=10)
    assert "ENSG00000000005" in genes  # the NaN gene is selected first


def test_star_counts_tsv_matches_jax(tmp_path, rng):
    root = _rnaseq_root(tmp_path, rng, n_samples=1)
    path = next(root.rglob("counts.tsv"))
    ids, values = genomic.read_star_counts_tsv(path)
    ref = jgen.read_star_counts_tsv(path)
    assert ids == list(ref.index)
    np.testing.assert_array_equal(values, ref.to_numpy(np.float64))
    assert not any("." in g for g in ids)
    (tmp_path / "no_gene.tsv").write_text("a\tb\n1\t2\n")
    assert genomic.read_star_counts_tsv(tmp_path / "no_gene.tsv") is None
    assert jgen.read_star_counts_tsv(tmp_path / "no_gene.tsv") is None
    # last-column fallback when no preferred count column exists
    _star(tmp_path / "other.tsv", [("ENSG1.4", ["5", "7"]),
                                   ("ENSG2", ["1", "x"])], ["c1", "c2"],
          comment=False)
    ids, values = genomic.read_star_counts_tsv(tmp_path / "other.tsv")
    ref = jgen.read_star_counts_tsv(tmp_path / "other.tsv")
    assert ids == list(ref.index) == ["ENSG1"]
    np.testing.assert_array_equal(values, ref.to_numpy(np.float64))


def test_mutation_and_cnv_match_jax(tmp_path):
    maf = pd.DataFrame({
        "Hugo_Symbol": ["TP53", "BRCA1", "TP53", "KRAS", "TP53"],
        "Tumor_Sample_Barcode": [
            "TCGA-AA-0001-01A", "TCGA-AA-0001-01A", "TCGA-BB-0002-01A",
            "TCGA-BB-0002-01A", "TCGA-AA-0001-01B"],
    })
    p = tmp_path / "m.maf"
    p.write_text("#version 2.4\n" + maf.to_csv(sep="\t", index=False))
    for min_patients in (0, 2):
        mine = genomic.mutation_matrix_from_maf(p, min_patients)
        ref = jgen.mutation_matrix_from_maf(p, min_patients)
        assert mine.index == list(ref.index)
        assert mine.columns == list(ref.columns)
        np.testing.assert_array_equal(mine.values, ref.to_numpy())
    (tmp_path / "bad.maf").write_text("a\tb\n1\t2\n")
    for mod in (genomic, jgen):
        with pytest.raises(ValueError, match="MAF missing"):
            mod.mutation_matrix_from_maf(tmp_path / "bad.maf")

    cnv = tmp_path / "cnv"
    (cnv / "a").mkdir(parents=True)
    (cnv / "a" / "s1.txt").write_text(
        "GDC_Aliquot\tChromosome\tStart\tEnd\tNum_Probes\tSegment_Mean\n"
        "u1\t1\t100\t2000\t12\t-0.2061\nu1\tX\t5\t90\t\t0.5\n")
    (cnv / "s2.tsv").write_text(
        "GDC_Aliquot\tChromosome\tStart\tEnd\tSegment_Mean\n"
        "u2\t2\t7\t70\t1.25\n")
    out_mine, out_ref = tmp_path / "a.csv", tmp_path / "b.csv"
    tables.write_table(out_mine, genomic.concat_cnv_segments(cnv))
    jgen.concat_cnv_segments(cnv).to_csv(out_ref, index=False)
    assert out_mine.read_text() == out_ref.read_text()


# ---------------------------------------------------------------------------
# The chain and the entry points
# ---------------------------------------------------------------------------

def _raw_tree(root, rng, n_img=3, n_rna=4, n=5, shape=(5, 20, 20)):
    """Raw DICOM series, STAR counts (one dir per patient), a MAF, CNV
    segments, a clinical CSV and the cohort list under ``root/data``."""
    pids = [f"TCGA-XX-{i:04d}" for i in range(n)]
    data = root / "data"
    for pid in pids[:n_img]:
        for s in range(2 if pid == pids[0] else 1):
            sdir = data / "imaging" / "dicom" / pid / f"s{s + 1}"
            sdir.mkdir(parents=True)
            for z in range(shape[0]):
                dicom.write_dicom_slice(
                    sdir / f"{z}.dcm",
                    rng.integers(-400, 1200, size=shape[1:]).astype(np.int16),
                    instance=z, position=(0, 0, 2.5 * z))
    bad = data / "imaging" / "dicom" / pids[2] / "s2"
    bad.mkdir()
    (bad / "0.dcm").write_bytes(b"\x00" * 200)  # a series that fails
    genes = [f"ENSG{j:011d}.2" for j in range(40)]
    for i in range(n_rna):
        d = data / "genomic" / "rnaseq" / pids[i]
        d.mkdir(parents=True)
        rows = [("N_unmapped", ["9"])] + [
            (g, [str(int(rng.integers(0, 900)))]) for g in genes]
        _star(d / "c.tsv", rows, ["unstranded"])
    mut = data / "genomic" / "mutation"
    mut.mkdir(parents=True)
    for k, syms in enumerate((["TP53", "BRCA1"], ["KRAS", "TP53"])):
        pd.DataFrame({"Hugo_Symbol": syms, "Tumor_Sample_Barcode": [
            f"{pids[k]}-01A", f"{pids[k + 1]}-01A"]}).to_csv(
            mut / f"m{k}.maf", sep="\t", index=False)
    cnv = data / "genomic" / "cnv"
    cnv.mkdir(parents=True)
    (cnv / "seg.txt").write_text(
        "GDC_Aliquot\tChromosome\tStart\tEnd\tSegment_Mean\n"
        "u1\t1\t100\t2000\t-0.2061\nu2\tX\t5\t90\t\n")
    clin = pd.DataFrame([
        {"submitter_id": pid,
         "demographic.vital_status": "Dead" if i % 2 == 0 else "Alive",
         "demographic.age_at_index": 55 + i,
         "demographic.days_to_death": 400 + 30 * i if i % 2 == 0 else None}
        for i, pid in enumerate(pids)])
    (data / "clinical").mkdir(parents=True)
    clin.to_csv(data / "clinical" / "clinical.csv", index=False)
    pd.DataFrame({"patient_id": pids[1:]}).to_csv(
        data / "multimodal_patients.csv", index=False)
    return pids


def test_preprocess_chain_matches_jax(tmp_path, rng):
    """tests/test_preprocess_chain.py's chain on both packages: DICOM ->
    NIfTI -> STAR counts -> normalized RNA -> matching table -> training
    arrays."""
    pids = [f"TCGA-XX-{i:04d}" for i in range(5)]
    for pid in pids[:3]:
        sdir = tmp_path / "dicom" / pid / "s1"
        sdir.mkdir(parents=True)
        for z in range(5):
            dicom.write_dicom_slice(
                sdir / f"{z}.dcm",
                rng.integers(-400, 1200, size=(20, 20)).astype(np.int16),
                instance=z, position=(0, 0, 2.5 * z))
    genes = [f"ENSG{j:011d}.2" for j in range(40)]
    for i in range(4):
        d = tmp_path / "rnaseq" / f"uuid-{i}"
        d.mkdir(parents=True)
        pd.DataFrame({"gene_id": genes,
                      "unstranded": rng.integers(0, 900, size=40)}
                     ).to_csv(d / "c.tsv", sep="\t", index=False)
    clin = pd.DataFrame([
        {"submitter_id": pid,
         "demographic.vital_status": "Dead" if i % 2 == 0 else "Alive",
         "demographic.age_at_index": 55 + i,
         "demographic.days_to_death": 400 + 30 * i if i % 2 == 0 else None}
        for i, pid in enumerate(pids)])
    clin_csv = tmp_path / "clinical.csv"
    clin.to_csv(clin_csv, index=False)
    mapping = {f"uuid-{i}": pids[i] for i in range(4)}

    side = {}
    for tag, dmod, gmod, write, mt, ds in (
            ("port", dicom, genomic, write_nifti, tmt, tds),
            ("jax", jdicom, jgen, jwrite_nifti, jmt, jds)):
        nroot = tmp_path / tag / "nifti"
        for pid in pids[:3]:
            series = dmod.read_dicom_series(tmp_path / "dicom" / pid / "s1")
            (nroot / pid).mkdir(parents=True)
            write(nroot / pid / "series_00.nii.gz", series.volume,
                  spacing=series.spacing)
        mat = gmod.build_rnaseq_matrix(tmp_path / "rnaseq")
        norm, selected = gmod.normalize_rnaseq(mat, top_k=25)
        rna_csv = tmp_path / tag / "rnaseq_normalized_mapped.csv"
        if tag == "port":
            norm.index = [mapping[u] for u in norm.index]
            norm.to_csv(rna_csv)
        else:
            norm.rename(index=mapping).to_csv(rna_csv)
        table = mt.build_full_matching_table(clin_csv, nroot, rna_csv)
        cohort = ds.select_cohort(table, "partial_modality")
        kw = dict(device="cpu", resample="device") if tag == "port" else {}
        arrays = ds.build_cohort_arrays(
            cohort, ds.load_rnaseq_matrix(rna_csv), with_image=True,
            image_shape=(8, 8, 8), **kw)
        side[tag] = (selected, rna_csv.read_text(), arrays)
    assert side["port"][0] == side["jax"][0]
    assert side["port"][1] == side["jax"][1]
    a, b = side["port"][2], side["jax"][2]
    assert a.patient_ids == list(b.patient_ids)
    for k, v in b.arrays.items():
        tol = 1e-6 if k == "image" else 0
        np.testing.assert_allclose(a.arrays[k], v, atol=tol, rtol=0,
                                   err_msg=k)
    assert a.arrays["mask"][:, 0].sum() == 3
    assert a.arrays["mask"][:, 1].sum() == 4


def _run_jax_script(name, *args):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "preprocessing" / name),
         *args], capture_output=True, text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_entry_points_write_the_jax_scripts_artifacts(tmp_path, rng,
                                                      capsys):
    """Both preprocessing entry points on one raw tree, the JAX scripts on
    a copy of it: every artifact equal byte for byte (NIfTI payloads and
    the metadata JSON up to the tree's path), the printed lines too."""
    import shutil

    mine, ref = tmp_path / "port", tmp_path / "jax"
    _raw_tree(mine, rng)
    shutil.copytree(mine, ref)

    convert_dicom_to_nifti.main(["--data-root", str(mine)])
    preprocess_genomic.main(["--data-root", str(mine), "--top-k", "25"])
    out = capsys.readouterr().out
    ref_out = _run_jax_script("convert_dicom_to_nifti.py", "--data-root",
                              str(ref))
    ref_out += _run_jax_script("preprocess_genomic.py", "--data-root",
                               str(ref), "--top-k", "25")
    assert out.replace(str(mine), "ROOT") == ref_out.replace(str(ref),
                                                             "ROOT")

    made = sorted(p.relative_to(mine) for p in (mine / "data").rglob("*")
                  if p.is_file())
    assert made == sorted(p.relative_to(ref) for p in
                          (ref / "data").rglob("*") if p.is_file())
    names = {p.name for p in made}
    assert {"series_00.nii.gz", "series_01.nii.gz",
            "series_00_metadata.json", "conversion_results.csv",
            "rnaseq_normalized.csv", "selected_genes.txt",
            "mutation_matrix.csv", "cnv_segments.csv",
            "clinical_processed.csv"} <= names
    for rel in made:
        a, b = (mine / rel).read_bytes(), (ref / rel).read_bytes()
        if rel.suffix == ".gz":
            a, b = gzip.decompress(a), gzip.decompress(b)
        if rel.suffix in (".json", ".csv"):
            a = a.replace(str(mine).encode(), b"ROOT")
            b = b.replace(str(ref).encode(), b"ROOT")
        assert a == b, rel
    results = (mine / "data" / "imaging" / "nifti"
               / "conversion_results.csv").read_text()
    assert "failed" in results  # the series of an undecodable file
    meta = json.loads(next((mine / "data").rglob(
        "series_00_metadata.json")).read_text())
    assert meta["num_slices"] == 5
