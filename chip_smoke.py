#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each one raises on failure; the script exits non-zero and prints no
result then):
  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmul and cuDNN — the JAX
     reference contracts at precision="highest".
  2. build: compiles ops/csrc/resample_wpass.cu from this checkout (nvcc,
     sm_90a) and prints the build time and ptxas report.
  3. kernel vs plain: the W-pass kernel against its plain torch version on
     CT-sized volumes (int16 128x512x512, ragged int16 97x500x500, float32,
     uint8, an HU-window case): max |d| <= 2e-6 on the normalized output,
     exact min/max; CUDA-event times of the kernel, the plain version and
     one library call (torch.matmul of the f32 rows with rx^T, which covers
     the contraction only), beside the H100's memory bound.
  4. cohort + checkpoint: a synthetic cohort (12 patients, 5,005 genes,
     int16 CTs of real in-plane size as .nii) and a seeded full-width
     partial_modality model (DenseNet121-3D, 64x64x32) with non-trivial
     BatchNorm running stats, saved as a port fold checkpoint whose
     .meta.json pins use_pallas_resample.
  5. predict_risk (the main path): the kernel's launch count is reset just
     before and must equal the number of imaging patients just after; risks
     finite and within 1e-4 of predict_risk(use_pallas=False).
  6. server: RiskScorer + make_server on 127.0.0.1 — /healthz, /score,
     /score_batch, a malformed request (400); /score agrees with
     predict_risk within 1e-4.
  7. summary: one JSON line of per-kernel numbers, then the final line
     {"ok": true, "device": {...}}.

Everything it writes goes under build/ in this checkout (kernel build,
temporary cohort); the cohort is removed at the end.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
RESAMPLE_TOL = 2e-6
RISK_TOL = 1e-4
OUT_W = 32


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(f"chip_smoke: {msg}", flush=True)


def cuda_ms(fn, warmup=3, iters=20):
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``iters`` calls after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# 1-2: device and build
# --------------------------------------------------------------------------

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from multimodal_survival_prediction_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _, info = _build.build("resample_wpass.cu")
    log(f"built resample_wpass.cu in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['build_sec']:.2f} s, fresh={info['built']})")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


# --------------------------------------------------------------------------
# 3: kernel vs plain
# --------------------------------------------------------------------------

def _volume(shape, dtype, gen, device):
    import torch

    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device=device) * 400 + 40
    lo, hi = ((0, 256) if dtype == torch.uint8 else (-1024, 3072))
    return torch.randint(lo, hi, shape, generator=gen, device=device,
                         dtype=torch.int32).to(dtype)


def wpass_bound_ms(shape, itemsize, hu_window):
    """Least time on an H100 SXM for the W-pass on this volume: bytes read
    (volume, rx^T) and written (rows x 32 f32, min, max) over the memory
    rate, against fp32 operations (convert, [clip x2], min, max per voxel;
    2 multiplies + 1 add per output) over the fp32 rate."""
    d, h, w = shape
    n_bytes = d * h * w * itemsize + w * OUT_W * 4 + d * h * OUT_W * 4 + 8
    ops = d * h * w * (3 + (2 if hu_window else 0)) + d * h * OUT_W * 3
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_vs_plain(device="cuda", cases=None, timed_case=0):
    """Returns (max |d| over all cases, timing dict of the ``timed_case``)."""
    import torch

    from multimodal_survival_prediction_tpu_torch.ops import resample as rs

    if cases is None:
        cases = [((128, 512, 512), torch.int16, None),
                 ((97, 500, 500), torch.int16, None),
                 ((96, 512, 512), torch.float32, None),
                 ((96, 512, 512), torch.uint8, None),
                 ((128, 512, 512), torch.int16, (-150, 250))]
    gen = torch.Generator(device=device).manual_seed(0)
    worst, timing = 0.0, None
    for ci, (shape, dtype, hu) in enumerate(cases):
        vol = _volume(shape, dtype, gen, device)
        d, h, w = shape
        rows = vol.view(d * h, w)
        out, mn, mx = rs.wpass(rows, OUT_W, hu)
        ref, rmn, rmx = rs.wpass_plain(rows, OUT_W, hu)
        check(mn.item() == rmn.item() and mx.item() == rmx.item(),
              f"min/max differ for {shape} {dtype}: kernel "
              f"({mn.item()}, {mx.item()}) plain ({rmn.item()}, {rmx.item()})")
        wpass_err = (out - ref).abs().max().item()
        got = rs.resample_normalize_cuda(vol, (64, 64, OUT_W), hu_window=hu,
                                         device=device)
        want = rs.resample_normalize(vol, (64, 64, OUT_W), hu_window=hu,
                                     device=device)
        err = (got - want).abs().max().item()
        check(math.isfinite(err) and err <= RESAMPLE_TOL,
              f"kernel vs plain max |d| {err} > {RESAMPLE_TOL} for {shape} "
              f"{dtype} hu={hu}")
        worst = max(worst, err)
        log(f"kernel vs plain {tuple(shape)} {str(dtype)[6:]} hu={hu}: "
            f"normalized max|d|={err:.3e} (tol {RESAMPLE_TOL}), W-pass "
            f"max|d|={wpass_err:.3e}, min/max exact ({mn.item()}, "
            f"{mx.item()})")
        if ci == timed_case and device != "cpu":
            rx_t = rs._matrix(w, OUT_W, vol.device).T.contiguous()
            kernel_ms = cuda_ms(lambda: rs.wpass(rows, OUT_W, hu))
            plain_ms = cuda_ms(lambda: rs.wpass_plain(rows, OUT_W, hu))
            library_ms = cuda_ms(lambda: torch.matmul(rows.float(), rx_t))
            bound_ms, bound_by = wpass_bound_ms(shape, vol.element_size(), hu)
            timing = dict(shape=list(shape), dtype=str(dtype)[6:],
                          kernel_ms=kernel_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
            log(f"W-pass times {tuple(shape)} {str(dtype)[6:]}: kernel "
                f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"(matmul) {library_ms:.4f} ms, H100 bound {bound_ms:.4f} ms "
                f"({bound_by}); kernel at {bound_ms / kernel_ms:.1%} of bound")
        del vol, rows, out, ref, got, want
    return worst, timing


# --------------------------------------------------------------------------
# 4-6: cohort, main path, server
# --------------------------------------------------------------------------

def phase_cohort(work, image_shapes, rna_dim, backbone="densenet121",
                 image_shape=(64, 64, 32), generator_seed=0):
    import torch

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY,
    )
    from multimodal_survival_prediction_tpu_torch.data.synthetic import (
        SyntheticCohortSpec,
        generate_synthetic_cohort,
    )
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        save_checkpoint,
        save_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.models.layers import (
        BatchNorm,
    )
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        make_model_and_adapters,
    )

    t0 = time.perf_counter()
    table, paths = generate_synthetic_cohort(work / "cohort", SyntheticCohortSpec(
        n_patients=12, rna_dim=rna_dim, seed=6, p_imaging=0.67,
        image_shapes=image_shapes, image_dtype="int16", compress=False))
    n_img = sum(bool(r["has_imaging"]) for r in table)
    log(f"cohort: {len(table)} patients, {n_img} int16 CTs "
        f"{list(image_shapes)}, rna_dim {rna_dim} "
        f"({time.perf_counter() - t0:.1f} s)")

    gen = torch.Generator().manual_seed(generator_seed)
    model, _, _ = make_model_and_adapters(
        PARTIAL_MODALITY, rna_dim=rna_dim, backbone=backbone, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    ckpt = work / "models" / "partial_modality" / "fold_1_best.pt"
    save_checkpoint(ckpt, model.state_dict())
    save_fold_meta(ckpt, use_pallas_resample=True, resample_mode="device",
                   backbone=backbone, image_shape=list(image_shape),
                   rna_dim=rna_dim)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: partial_modality ({backbone}, image_shape "
        f"{tuple(image_shape)}), {n_params} parameters, checkpoint "
        f"{ckpt.relative_to(work)} (+ .meta.json)")
    return table, paths, ckpt, n_img


def phase_predict(table, paths, ckpt, n_img, device="cuda",
                  expect_launches=True):
    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train import predict as pm

    ingest = {}
    build = pm.build_cohort_arrays

    def timed_build(*a, **k):  # splits the main path's wall time
        t = time.perf_counter()
        out = build(*a, **k)
        if device != "cpu":
            torch.cuda.synchronize()
        ingest["sec"] = time.perf_counter() - t
        return out

    pm.build_cohort_arrays = timed_build
    try:
        rs.wpass.launches = 0  # the main path's count starts here
        t0 = time.perf_counter()
        pred = pm.predict_risk(PARTIAL_MODALITY, ckpt, table,
                               rnaseq_csv=paths["rnaseq_csv"],
                               labeled_only=False, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = rs.wpass.launches  # ... and is read here
    finally:
        pm.build_cohort_arrays = build
    risk = pred["risk_score"]
    log(f"predict_risk (meta pins use_pallas_resample): {len(risk)} "
        f"patients, wall {total:.3f} s = ingest {ingest['sec']:.3f} s + "
        f"scoring {total - ingest['sec']:.3f} s; resample_wpass launches "
        f"{launches} for {n_img} imaging patients")
    if expect_launches:
        check(launches == n_img,
              f"resample_wpass launched {launches} times on the main path, "
              f"expected {n_img} (one per imaging patient)")
    check(risk.shape == (len(table),) and np.all(np.isfinite(risk)),
          f"risks not finite / wrong shape: {risk}")
    plain = pm.predict_risk(PARTIAL_MODALITY, ckpt, table,
                            rnaseq_csv=paths["rnaseq_csv"],
                            labeled_only=False, use_pallas=False,
                            device=device)
    diff = float(np.abs(plain["risk_score"] - risk).max())
    check(list(plain["patient_id"]) == list(pred["patient_id"])
          and diff <= RISK_TOL,
          f"predict_risk kernel ingest vs plain ingest max |d| {diff} > "
          f"{RISK_TOL}")
    log(f"predict_risk kernel ingest vs plain bucketed ingest: max |d| "
        f"{diff:.3e} (tol {RISK_TOL}); risks {np.round(risk, 4).tolist()}")
    return pred, launches


def _post(base, path, payload=None, raw=None):
    body = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(f"{base}{path}", data=body)
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, out = r.status, json.load(r)
    except urllib.error.HTTPError as e:
        code, out = e.code, json.load(e)
    return code, out, (time.perf_counter() - t) * 1e3


def phase_server(table, paths, ckpt, pred, device="cuda"):
    import numpy as np

    from multimodal_survival_prediction_tpu_torch.data.datasets import (
        load_rnaseq_matrix,
    )
    from multimodal_survival_prediction_tpu_torch.serving import (
        RiskScorer,
        make_server,
    )

    t0 = time.perf_counter()
    scorer = RiskScorer("partial_modality", ckpt, device=device)
    log(f"RiskScorer loaded in {time.perf_counter() - t0:.2f} s")
    rna = load_rnaseq_matrix(paths["rnaseq_csv"])
    full = [r for r in table if r["has_imaging"] and r["has_rnaseq"]
            and r["has_clinical"]]
    check(full, "cohort has no patient with all three modalities")
    p = full[0]
    server = make_server(scorer, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        base = f"http://{host}:{port}"
        t = time.perf_counter()
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = (r.status, json.load(r))
        log(f"GET /healthz -> {health[0]} {health[1]} "
            f"({(time.perf_counter() - t) * 1e3:.1f} ms)")
        check(health[0] == 200 and health[1]["status"] == "ok",
              f"/healthz answered {health}")

        body = {"rnaseq": rna.row(p["patient_id"]).tolist(),
                "age": float(p["age"]), "nifti_path": p["nifti_path"]}
        lat = []
        for _ in range(3):
            code, out, ms = _post(base, "/score", body)
            check(code == 200, f"/score answered {code}: {out}")
            lat.append(ms)
        i = list(pred["patient_id"]).index(p["patient_id"])
        diff = abs(out["risk_score"] - float(pred["risk_score"][i]))
        log(f"POST /score ({p['patient_id']}: CT + RNA + age) -> 200 risk "
            f"{out['risk_score']:.6f}, predict_risk {pred['risk_score'][i]:.6f}"
            f", |d| {diff:.3e} (tol {RISK_TOL}); latency ms "
            f"{[round(x, 1) for x in lat]}")
        check(out["modalities_used"] == {"image": True, "rnaseq": True,
                                         "clinical": True},
              f"/score modalities {out['modalities_used']}")
        check(diff <= RISK_TOL, f"/score vs predict_risk |d| {diff}")

        img = [r for r in table if r["has_imaging"]]
        batch = {"patients": [
            {"rnaseq": rna.row(p["patient_id"]).tolist()},
            {"nifti_path": img[-1]["nifti_path"], "age": 61.0},
            {"age": 47.0}]}
        code, out, ms = _post(base, "/score_batch", batch)
        check(code == 200 and len(out["results"]) == 3
              and all(np.isfinite(x["risk_score"]) for x in out["results"]),
              f"/score_batch answered {code}: {out}")
        log(f"POST /score_batch (3 mixed-modality patients) -> 200 "
            f"{[round(x['risk_score'], 6) for x in out['results']]} "
            f"({ms:.1f} ms)")
        code, out, ms = _post(base, "/score", {"rnaseq": [1.0, 2.0]})
        check(code == 400 and "genes" in out.get("error", ""),
              f"malformed /score answered {code}: {out}")
        code2, out2, _ = _post(base, "/score", raw=b"{not json")
        check(code2 == 400, f"non-JSON /score answered {code2}: {out2}")
        log(f"malformed requests -> {code}, {code2} ({out['error']})")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    max_err, timing = phase_kernel_vs_plain()
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        table, paths, ckpt, n_img = phase_cohort(
            work, ((96, 512, 512), (128, 512, 512), (97, 500, 500)), 5005)
        pred, launches = phase_predict(table, paths, ckpt, n_img)
        phase_server(table, paths, ckpt, pred)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernel = {
        "name": "resample_wpass",
        "route": "cuda",
        "source": "multimodal_survival_prediction_tpu_torch/ops/csrc/"
                  "resample_wpass.cu",
        "replaces": "multimodal_survival_prediction_tpu/ops/resample.py:152",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "kernel_ms": timing["kernel_ms"],
        "bound_us": timing["bound_ms"] * 1e3,
        "timed_shape": timing["shape"],
        "timed_dtype": timing["dtype"],
    }
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
