"""The ported serving slice end to end against the JAX package, on the CPU.

A ``partial_modality`` simple-CNN cohort at image_shape (16, 16, 8): the
JAX side gets flax msgpack fold checkpoints with ``.meta.json`` pinning
``use_pallas_resample: true`` (its Pallas W-pass runs in interpret mode
here); the port gets the same weights carried by ``io/jax_import.py`` as
``.pt`` fold checkpoints with the same meta. Then ``predict_risk``,
``RiskScorer.score_many`` and the HTTP contract are compared port vs JAX
with ``device="cpu"``.
Tolerance: 1e-5 absolute on risks (fp32 on both sides; measured agreement
is ~1e-7).
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu.config import PARTIAL_MODALITY as JCFG
from multimodal_survival_prediction_tpu.data.synthetic import (
    SyntheticCohortSpec,
    generate_synthetic_cohort,
)
from multimodal_survival_prediction_tpu.io.checkpoint import (
    save_checkpoint as jax_save,
)
from multimodal_survival_prediction_tpu.io.checkpoint import (
    save_fold_meta as jax_save_meta,
)
from multimodal_survival_prediction_tpu.models.gated import (
    PartialModalityNet as JGated,
)
from multimodal_survival_prediction_tpu.serving import RiskScorer as JScorer
from multimodal_survival_prediction_tpu.serving import (
    make_server as jax_make_server,
)
from multimodal_survival_prediction_tpu.train.predict import (
    predict_risk as jax_predict,
)
from multimodal_survival_prediction_tpu_torch.config import PARTIAL_MODALITY
from multimodal_survival_prediction_tpu_torch.data.matching_table import (
    load_matching_table,
)
from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
    save_checkpoint,
    save_fold_meta,
)
from multimodal_survival_prediction_tpu_torch.io.jax_import import (
    export_torch_state_dict,
)
from multimodal_survival_prediction_tpu_torch.ops import resample as tres
from multimodal_survival_prediction_tpu_torch.serving import RiskScorer
from multimodal_survival_prediction_tpu_torch.serving import make_server
from multimodal_survival_prediction_tpu_torch.train.predict import (
    fold_checkpoints,
    predict_risk,
)

ATOL = 1e-5
RNA_DIM = 40
META = dict(backbone="simple_cnn", image_shape=[16, 16, 8], rna_dim=RNA_DIM,
            use_pallas_resample=True, resample_mode="device")


def _fold_variables(seed, inputs):
    model = JGated(backbone="simple_cnn")
    v = model.init({"params": jax.random.PRNGKey(seed),
                    "dropout": jax.random.PRNGKey(seed)}, *inputs)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    rng = np.random.default_rng(seed)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.normal(0, 0.1, size=x.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, size=x.shape)
                      ).astype(np.float32), v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def slice_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    table, paths = generate_synthetic_cohort(root, SyntheticCohortSpec(
        n_patients=14, rna_dim=RNA_DIM, seed=6, p_imaging=0.7,
        image_shapes=((20, 24, 24), (18, 30, 26))))
    ex = (np.zeros((1, 16, 16, 8, 1), np.float32),
          np.zeros((1, RNA_DIM), np.float32), np.zeros((1, 1), np.float32),
          np.ones((1, 3), np.float32))
    jax_ckpts, port_ckpts = [], []
    for fold, seed in ((1, 21), (2, 22)):
        v = _fold_variables(seed, ex)
        jp = root / "jax" / "partial_modality" / f"fold_{fold}_best.msgpack"
        jax_save(jp, {"params": v["params"], "batch_stats": v["batch_stats"]})
        jax_save_meta(jp, **META)
        tp = root / "port" / "partial_modality" / f"fold_{fold}_best.pt"
        save_checkpoint(tp, {k: torch.from_numpy(np.array(a)) for k, a in
                             export_torch_state_dict("partial_modality",
                                                     v).items()})
        save_fold_meta(tp, **META)
        jax_ckpts.append(jp)
        port_ckpts.append(tp)
    return dict(table=table, paths=paths, jax=jax_ckpts, port=port_ckpts,
                root=root)


def _assert_pred_equal(got, want):
    assert list(got["patient_id"]) == list(want.patient_id)
    np.testing.assert_allclose(got["risk_score"], want.risk_score.values,
                               atol=ATOL)
    np.testing.assert_array_equal(got["survival_time"],
                                  want.survival_time.values)
    np.testing.assert_array_equal(got["event"], want.event.values)


@pytest.mark.parametrize("use_pallas", [None, False],
                         ids=["meta-pinned-kernel", "plain-ingest"])
def test_predict_risk_matches_jax(slice_env, use_pallas, monkeypatch):
    """Single fold; the meta pin routes every CT through the fused
    resample (the CUDA kernel on the card, its plain W-pass here)."""
    env = slice_env
    calls = {"fused": 0, "bucketed": 0}
    for name, key in (("resample_normalize_cuda", "fused"),
                      ("resample_normalize_bucketed", "bucketed")):
        orig = getattr(tres, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(tres, name, counted)

    want = jax_predict(JCFG, env["jax"][0], env["table"],
                       rnaseq_csv=env["paths"]["rnaseq_csv"],
                       use_pallas=use_pallas)
    rows = load_matching_table(env["paths"]["matching_table"])
    got = predict_risk(PARTIAL_MODALITY, env["port"][0], rows,
                       rnaseq_csv=env["paths"]["rnaseq_csv"],
                       use_pallas=use_pallas, device="cpu")
    _assert_pred_equal(got, want)
    n_img = sum(bool(r["has_imaging"]) for r in rows)
    assert n_img > 0
    kernel_path = use_pallas is None  # the meta pin
    assert calls == {"fused": n_img if kernel_path else 0,
                     "bucketed": 0 if kernel_path else n_img}


def test_predict_risk_ensemble_matches_jax(slice_env):
    env = slice_env
    want, wstats = jax_predict(JCFG, env["jax"], env["table"],
                               rnaseq_csv=env["paths"]["rnaseq_csv"],
                               labeled_only=False, return_fold_stats=True)
    got, gstats = predict_risk(
        PARTIAL_MODALITY, fold_checkpoints(env["root"] / "port",
                                           "partial_modality"),
        env["table"].to_dict("records"),
        rnaseq_csv=env["paths"]["rnaseq_csv"], labeled_only=False,
        return_fold_stats=True, device="cpu")
    _assert_pred_equal(got, want)
    np.testing.assert_allclose(np.asarray(gstats), np.asarray(wstats),
                               atol=ATOL)


def _patients(env):
    rng = np.random.default_rng(12)
    img = [r for r in env["table"].to_dict("records") if r["has_imaging"]]
    vol = rng.normal(100, 50, size=(20, 24, 24)).astype(np.float32)
    return [
        dict(rnaseq=rng.normal(size=RNA_DIM), age=60.0),
        dict(volume=vol, age=55.0),
        dict(rnaseq=rng.normal(size=RNA_DIM),
             volume=rng.integers(-1024, 3000, size=(18, 30, 26)
                                 ).astype(np.int16)),
        dict(nifti_path=img[0]["nifti_path"], age=70.0),
        dict(age=45.0),
    ]


@pytest.mark.parametrize("folds,calibrated", [(1, False), (2, False),
                                              (2, True)])
def test_scorer_matches_jax(slice_env, folds, calibrated):
    env = slice_env
    cal = [(0.1, 2.0), (-0.2, 0.5)][:folds] if calibrated else None
    jp = env["jax"][0] if folds == 1 else env["jax"]
    tp = env["port"][0] if folds == 1 else env["port"]
    want = JScorer("partial_modality", jp, batch_size=2,
                   fold_calibration=cal).score_many(_patients(env))
    port = RiskScorer("partial_modality", tp, batch_size=2,
                      fold_calibration=cal, device="cpu")
    assert port.image_shape == (16, 16, 8) and port.rna_dim == RNA_DIM
    got = port.score_many(_patients(env))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["risk_score"] == pytest.approx(w["risk_score"], abs=ATOL)
        assert {k: v for k, v in g.items() if k != "risk_score"} == \
            {k: v for k, v in w.items() if k != "risk_score"}
    # the device-built zero image gives the same scores
    fast = RiskScorer("partial_modality", tp, batch_size=2,
                      fold_calibration=cal, no_image_variant=True,
                      device="cpu")
    for g, f in zip(got, fast.score_many(_patients(env))):
        assert f["risk_score"] == pytest.approx(g["risk_score"], abs=1e-6)


def test_scorer_rejects_what_jax_rejects(slice_env, tmp_path):
    port = RiskScorer("partial_modality", slice_env["port"][0], device="cpu")
    with pytest.raises(ValueError, match=f"{RNA_DIM} genes"):
        port.score(rnaseq=np.zeros(7))
    with pytest.raises(ValueError, match="at least one modality"):
        port.score()
    with pytest.raises(ValueError, match="fold_calibration"):
        RiskScorer("partial_modality", slice_env["port"], device="cpu",
                   fold_calibration=[(0.0, 1.0)])
    # aot_cache_dir (refused until io/aot_cache.py was ported) loads the
    # host engine through the cache and changes no risk
    from multimodal_survival_prediction_tpu_torch.io import aot_cache

    saved = aot_cache.CACHE_DIR
    try:
        cached = RiskScorer("partial_modality", slice_env["port"][0],
                            device="cpu", aot_cache_dir=tmp_path / "aot")
    finally:
        aot_cache.CACHE_DIR = saved
    assert cached.aot_info == aot_cache.report()
    assert cached.aot_info["msp_native_port"]["path"].startswith(
        str(tmp_path / "aot"))
    assert port.aot_info == {}
    want = port.score_many(_patients(slice_env))
    assert cached.score_many(_patients(slice_env)) == want


def _serve(scorer, maker):
    server = maker(scorer, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t


def _call(base, path, body=None):
    req = (urllib.request.Request(f"{base}{path}", data=body)
           if body is not None else f"{base}{path}")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_http_contract_matches_jax(slice_env):
    env = slice_env
    nifti = [r for r in env["table"].to_dict("records")
             if r["has_imaging"]][0]["nifti_path"]
    rna = [0.1] * RNA_DIM
    requests = [
        ("/healthz", None),
        ("/score", json.dumps({"rnaseq": rna, "age": 61}).encode()),
        ("/score", json.dumps({"rnaseq": rna, "age": 50,
                               "nifti_path": nifti}).encode()),
        ("/score_batch", json.dumps({"patients": [
            {"rnaseq": rna}, {"age": 70, "nifti_path": nifti},
            {"rnaseq": [0.3] * RNA_DIM, "age": 40}]}).encode()),
        ("/score", json.dumps({"rnaseq": [1.0] * 3}).encode()),
        ("/score", b"[1, 2]"),
        ("/score_batch", b'{"patients": ["x"]}'),
        ("/score", b"{not json"),
        ("/nope", None),
    ]
    servers = []
    try:
        outs = []
        for scorer, maker in (
                (JScorer("partial_modality", env["jax"][0]),
                 jax_make_server),
                (RiskScorer("partial_modality", env["port"][0],
                            device="cpu"), make_server)):
            server, t = _serve(scorer, maker)
            servers.append((server, t))
            host, port = server.server_address
            outs.append([_call(f"http://{host}:{port}", p, b)
                         for p, b in requests])
        for (jcode, jbody), (tcode, tbody), (path, _) in zip(*outs,
                                                            requests):
            assert tcode == jcode, path
            if jcode != 200:
                assert "error" in tbody
                continue
            if path == "/score_batch":
                jbody, tbody = jbody["results"], tbody["results"]
            elif path == "/score":
                jbody, tbody = [jbody], [tbody]
            else:
                assert tbody == jbody
                continue
            for j, t in zip(jbody, tbody):
                assert t["risk_score"] == pytest.approx(j["risk_score"],
                                                        abs=ATOL)
                assert t["modalities_used"] == j["modalities_used"]
        assert [c for c, _ in outs[1]] == [200, 200, 200, 200, 400, 400, 400,
                                           400, 404]
    finally:
        for server, t in servers:
            server.shutdown()
            server.server_close()
            t.join(timeout=10)
            assert not t.is_alive()
