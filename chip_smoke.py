#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each one raises on failure; the script exits non-zero and prints no
result then):
  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmul and cuDNN — the JAX
     reference contracts at precision="highest".
  2. build: compiles ops/csrc/resample_wpass.cu and ops/csrc/fused_dense.cu
     from this checkout (one nvcc each, started together; sm_90a) and prints
     the build times and ptxas reports.
  3. kernel vs plain: the W-pass kernel against its plain torch version on
     CT-sized volumes (int16 128x512x512, ragged int16 97x500x500, float32,
     uint8, an HU-window case): max |d| <= 2e-6 on the normalized output,
     exact min/max; device times (torch.profiler kernel durations) of the
     kernel, the plain version and one library call (torch.matmul of the
     f32 rows with rx^T, which covers the contraction only), beside the
     H100's memory bound, and the kernel's per-call time by CUDA events
     (host dispatch included where it is the longer).
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
  7. fused kernels vs plain: the four fused BN->ReLU->1x1-conv kernels
     (moments, apply, bwd_reduce, bwd_dx) against their plain versions on
     the same inputs at the training path's shapes (16,384x64->128 ...
     32x992->128, and a ragged one), then the autograd op against torch
     autograd through bn_relu_conv1x1_reference; outputs to rtol 1e-5 and
     gradients to rtol 1e-4, each with atol 1e-5 x the tensor's largest
     |value|. Device times at one shape per dense block and the widest
     transition (16,384x224->128, 2,048x480->128, 256x992->128,
     32x992->128, 256x1,024->512) beside the H100 bound, the plain version
     and a library call, as in phase 3. For each case bwd_dx's plan (F
     chunks, one thread-block cluster of them a tile) and the clusters the
     card keeps resident at once; at the timed shapes bwd_dx's planned
     launch in turns with its unsplit launch (one F chunk).
  8. training (the main path of the training slice): a Trainer on
     PartialModalityNet(fused_bn1=True) at full width takes two epochs over
     the phase-4 cohort (batch 8) and a pooled evaluation; each fused
     kernel's launch count, reset just before, must be 61 x the steps just
     after (none in evaluation). Then the same seeds with fused_bn1=False
     (BatchNorm + cuDNN 1x1 conv), and the fused path once more: the first
     step's loss within 1e-5 relative, later steps within 2e-2 (Adam's
     drift, see LOSS_DRIFT_RTOL), hazards within a tenth of their range,
     C-index within the comparable pairs whose order that hazard difference
     could swap. ms per train step by CUDA events, and a torch.profiler
     breakdown of one step, for both, with each fused kernel's summed
     device time and launches in that step.
  9. summary: one JSON line of per-kernel numbers, then the final line
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
H100_TF32_OPS_PER_S = 495e12  # TF32 on the tensor cores, dense
RESAMPLE_TOL = 2e-6
RISK_TOL = 1e-4
OUT_W = 32
SOURCES = ("resample_wpass.cu", "fused_dense.cu")
FUSED_FWD_RTOL = 1e-5   # fused kernels: outputs and batch statistics
FUSED_GRAD_RTOL = 1e-4  # ... gradients
FUSED_ATOL = 1e-5       # times max(1, the tensor's largest |value|)
# fused vs unfused training from the same weights, batches and dropout
# masks: the first step's loss to FIRST_LOSS_RTOL; later steps only to
# LOSS_DRIFT_RTOL, because Adam steps every parameter by about lr whatever
# its gradient's size, so last-bit differences (and ReLU-kink flips) grow:
# the same path run twice drifts too, which the phase shows beside it
FIRST_LOSS_RTOL = 1e-5
LOSS_DRIFT_RTOL = 2e-2
HAZARD_SPREAD_TOL = 0.1  # max |d hazard| over the hazards' range (max - min)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(f"chip_smoke: {msg}", flush=True)


SENTINEL_KERNEL = "spin_kernel"  # torch.cuda._sleep's


class _profiled:
    """A torch.profiler window on the device that opens with one launch of
    ``torch.cuda._sleep`` (the first launch of a window can be missing from
    its trace) and closes with a synchronize. ``.events`` then holds
    ``key_averages()``' device events without the sentinel, ``.prof`` the
    profiler."""

    def __init__(self, cpu=False):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA]
                            + ([ProfilerActivity.CPU] if cpu else []))

    def __enter__(self):
        import torch

        self.prof.__enter__()
        torch.cuda._sleep(1 << 16)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        if exc[0] is None:
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.events = [e for e in self.prof.key_averages()
                           if e.device_type == DeviceType.CUDA
                           and SENTINEL_KERNEL not in e.key]
        return False


def device_ms(fn, warmup=3, iters=20, windows=3, attempts=3, kernels=()):
    """Mean device milliseconds per call of ``fn``: the summed durations of
    the GPU kernels (and copies) it launched over ``iters`` calls, from
    torch.profiler, so host dispatch between launches does not count; the
    median of ``windows`` such windows.

    A trace can come back with launches lost: the window's first (hence the
    sentinel of ``_profiled``), and after many profiler windows in one
    process all of them or some. ``fn`` launches the same work every call,
    so a whole window holds each device event name ``iters`` times or a
    multiple of that, and at least ``iters`` events whose names hold one of
    ``kernels`` (the wrapper's own kernel, which every call launches). A
    window that does not is run again, up to ``attempts`` times; if none is
    whole, that window's reading is ``queued_event_ms`` instead, and the log
    says so. A window can also hold every launch and read about half the
    time of the others: the median keeps it out, and a spread of more than
    1.5x between windows is logged."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(windows):
        for attempt in range(attempts):
            with _profiled() as window:
                for _ in range(iters):
                    fn()
            events = window.events
            own = sum(e.count for e in events
                      if any(k in e.key for k in kernels))
            short = [f"{e.key[:60]} x{e.count}" for e in events
                     if e.count % iters]
            if kernels and own < iters:
                short.append(f"{' or '.join(kernels)} x{own}")
            if events and not short:
                readings.append(sum(e.self_device_time_total
                                    for e in events) / iters / 1e3)
                break
            log(f"torch.profiler lost launches over {iters} calls (attempt "
                f"{attempt + 1} of {attempts}): "
                + ("no device event" if not events else "; ".join(short)))
        else:
            readings.append(queued_event_ms(fn, iters))
            log(f"no whole trace in {attempts} windows: this window's reading "
                f"is {readings[-1]:.5f} ms a call by CUDA events behind a "
                "spin kernel (gaps between launches included)")
    readings.sort()
    if readings[-1] > 1.5 * readings[0]:
        log(f"device_ms windows disagree: {[round(r, 5) for r in readings]}"
            " ms a call; the median is kept")
    return readings[len(readings) // 2]


def queued_event_ms(fn, iters=20):
    """Mean device milliseconds per call of ``fn`` by CUDA events around
    ``iters`` calls that the host queues behind one ``torch.cuda._sleep``
    long enough to cover their dispatch: the stream holds them all before
    the first runs, so host dispatch does not count, the device's gaps
    between launches do."""
    import torch

    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    dispatch_s = time.perf_counter() - t0  # dispatch and device, an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * dispatch_s * 2e9) + (1 << 16))  # ~2 GHz clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, warmup=3, iters=20):
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``iters`` back-to-back calls after ``warmup``: the device
    time, or the host's dispatch time where that is longer."""
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
    """Build every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_survival_prediction_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        infos = list(pool.map(lambda src: _build.build(src)[1], SOURCES))
    log(f"built {len(SOURCES)} kernel sources in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, info in zip(SOURCES, infos):
        log(f"  {src}: nvcc {info['build_sec']:.2f} s, "
            f"fresh={info['built']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"    ptxas: {line.strip()}")


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
            kernel_ms = device_ms(lambda: rs.wpass(rows, OUT_W, hu),
                                  kernels=("wpass_kernel<",))
            call_ms = cuda_ms(lambda: rs.wpass(rows, OUT_W, hu))
            plain_ms = device_ms(lambda: rs.wpass_plain(rows, OUT_W, hu))
            library_ms = device_ms(lambda: torch.matmul(rows.float(), rx_t))
            bound_ms, bound_by = wpass_bound_ms(shape, vol.element_size(), hu)
            timing = dict(shape=list(shape), dtype=str(dtype)[6:],
                          kernel_ms=kernel_ms, call_ms=call_ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            log(f"W-pass device times {tuple(shape)} {str(dtype)[6:]}: "
                f"kernel {kernel_ms:.4f} ms (per call by CUDA events "
                f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
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


# --------------------------------------------------------------------------
# 7: fused BN -> ReLU -> 1x1-conv kernels vs plain
# --------------------------------------------------------------------------

# (N, C, F) of the training path's fused stages at batch 8, 64x64x32 (trunk
# 16x16x8 after conv0 + pool), and one ragged case
FUSED_CASES = [
    (16384, 64, 128),    # block 0, first dense layer
    (16384, 224, 128),   # block 0, last dense layer (timed)
    (16384, 256, 128),   # transition 0
    (2048, 480, 128),    # block 1, last dense layer
    (2048, 512, 256),    # transition 1
    (256, 992, 128),     # block 2, last dense layer
    (256, 1024, 512),    # transition 2
    (32, 992, 128),      # block 3, last dense layer
    (5003, 200, 72),     # ragged N, C and F
]
FUSED_TIMED = (16384, 224, 128)  # the `ms` of the kernels line
# one shape per dense block and the widest transition
FUSED_TIMED_SHAPES = [FUSED_TIMED, (2048, 480, 128), (256, 992, 128),
                      (32, 992, 128), (256, 1024, 512)]
FUSED_NAMES = ("moments", "apply", "bwd_reduce", "bwd_dx")
FUSED_REPLACES = {
    "moments": "multimodal_survival_prediction_tpu/ops/fused_dense.py:97",
    "apply": "multimodal_survival_prediction_tpu/ops/fused_dense.py:124",
    "bwd_reduce": "multimodal_survival_prediction_tpu/ops/fused_dense.py:180",
    "bwd_dx": "multimodal_survival_prediction_tpu/ops/fused_dense.py:228",
}
# the device kernels each wrapper launches, by a part of their names in a
# profile (ops/csrc/fused_dense.cu); all but bwd_dx end with a launch of the
# one fold kernel, which a profile shows under one name for all three
FUSED_DEVICE_KERNELS = {
    "moments": ("::moments_partial_kernel",),
    "apply": ("::apply_kernel<",),
    "bwd_reduce": ("::bwd_reduce_kernel<",),
    "bwd_dx": ("::bwd_dx_kernel<", "::bwd_dx_cluster_kernel<"),
}
FUSED_FOLD_KERNEL = "::fold_parts_kernel<"
FUSED_LIBRARY = {
    "moments": "torch.var_mean(x, 0, correction=0)",
    "apply": "torch.matmul(x, W) (the contraction alone)",
    "bwd_reduce": "torch.matmul(x.T, g) + torch.matmul(g, W.T) (the two "
                  "contractions alone)",
    "bwd_dx": "torch.matmul(g, W.T) (the contraction alone)",
}


def fused_bound_ms(name, n, c, f):
    """``(bound ms, bound by, CUDA-core bound ms)``: the least time on an
    H100 SXM for one call, from the JAX kernels' CostEstimate formulas
    (ops/fused_dense.py:105-108, 137-142, 200-205, 242-247 of the JAX
    package; f32, 4 bytes an element). The bound is the larger of bytes over
    the memory rate and operations over their unit's rate: the products run
    on the tensor cores as three TF32 products each (3 x their operations
    over the TF32 rate), the elementwise work at the fp32 rate. The last
    value charges every operation at the fp32 rate outside the tensor
    cores, as the kernels ran before the products moved there."""
    product, elementwise, n_bytes = {
        "moments": (0, 3 * n * c, 4 * n * c + 8 * c),
        "apply": (2 * n * c * f, 3 * n * c,
                  4 * (n * c + c * f + n * f) + 8 * c),
        "bwd_reduce": (4 * n * c * f, 8 * n * c,
                       4 * (n * c + n * f) + 5 * c * f * 4 + 24 * c),
        "bwd_dx": (2 * n * c * f, 10 * n * c,
                   4 * (2 * n * c + n * f + c * f) + 24 * c),
    }[name]
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = (3 * product / H100_TF32_OPS_PER_S
             + elementwise / H100_F32_OPS_PER_S)
    t_cuda_core = max(t_bytes, (product + elementwise) / H100_F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", t_cuda_core * 1e3)


def _fused_inputs(n, c, f, device, gen):
    """x, gamma, beta, W (as the conv kernel's (C, F) view, strides (1, C)),
    and an output cotangent. x is moved 1e-3 (normalized units) away from
    each channel's ReLU kink, so that two computations whose batch
    statistics differ in the last bits take the same ReLU branch."""
    import torch

    x = torch.randn((n, c), generator=gen, device=device) * 2.0 + 0.5
    gamma = torch.randn(c, generator=gen, device=device) * 0.3 + 1.0
    beta = torch.randn(c, generator=gen, device=device) * 0.1
    w = (torch.randn((f, c), generator=gen, device=device)
         * (2.0 / c) ** 0.5).t()
    g = torch.randn((n, f), generator=gen, device=device)
    xd = x.double()
    mean = xd.mean(0)
    rstd = torch.rsqrt((xd * xd).mean(0) - mean * mean + 1e-5)
    z = (xd - mean) * rstd * gamma + beta
    step = 2e-3 / (rstd * gamma.abs().clamp_min(0.1))
    sign = torch.where(z >= 0, 1.0, -1.0) * torch.sign(gamma)
    x = torch.where(z.abs() < 1e-3, xd + sign * step, xd).float()
    return x, gamma, beta, w, g


def _held(name, got, want, rtol):
    """max |got - want|, raising if any element exceeds
    rtol·|want| + FUSED_ATOL·max(1, max|want|)."""
    got, want = got.detach().double(), want.detach().double()
    diff = (got - want).abs()
    atol = FUSED_ATOL * max(1.0, float(want.abs().max()))
    bad = diff > atol + rtol * want.abs()
    err = float(diff.max())
    check(math.isfinite(err) and not bool(bad.any()),
          f"{name}: {int(bad.sum())} elements beyond rtol {rtol} / atol "
          f"{atol:.3e}; max |d| {err:.3e}")
    return err


def phase_fused_vs_plain(device="cuda", cases=None, timed=None):
    """Returns (max |d| per kernel over all cases, timing dict per kernel:
    the first shape of ``timed``, with every timed shape under
    ``by_shape``)."""
    import torch

    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd

    cases = FUSED_CASES if cases is None else cases
    timed = FUSED_TIMED_SHAPES if timed is None else [tuple(t) for t in timed]
    gen = torch.Generator(device=device).manual_seed(1)
    worst = dict.fromkeys(FUSED_NAMES, 0.0)
    by_shape = {}
    for n, c, f in cases:
        x, gamma, beta, w, g = _fused_inputs(n, c, f, device, gen)
        tag = f"{n}x{c}->{f}"
        # each kernel against its plain version on the same inputs
        s, sq = fd.moments(x)
        ps, psq = fd.moments_plain(x)
        err = {"moments": max(_held(f"moments sum {tag}", s, ps,
                                    FUSED_FWD_RTOL),
                              _held(f"moments sumsq {tag}", sq, psq,
                                    FUSED_FWD_RTOL))}
        mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
        err["apply"] = _held(f"apply {tag}", fd.apply(x, mul, add, w),
                             fd.apply_plain(x, mul, add, w), FUSED_FWD_RTOL)
        got = fd.bwd_reduce(x, g, w, mul, add, mean, rstd)
        want = fd.bwd_reduce_plain(x, g, w, mul, add, mean, rstd)
        err["bwd_reduce"] = max(
            _held(f"bwd_reduce {part} {tag}", a, b, FUSED_GRAD_RTOL)
            for part, a, b in zip(("dW", "dgamma", "dbeta"), got, want))
        c1, c2 = want[2] / n, want[1] / n
        if device != "cpu":
            _log_dx_plan(fd, x, w, tag)
        err["bwd_dx"] = _held(
            f"bwd_dx {tag}", fd.bwd_dx(x, g, w, mul, add, mean, rstd, c1, c2),
            fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, c1, c2),
            FUSED_GRAD_RTOL)
        # the autograd op against torch autograd through the oracle
        results = []
        for fn in (fd.fused_bn_relu_conv1x1, fd.bn_relu_conv1x1_reference):
            args = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
            args.append(w.detach().clone().requires_grad_(True))
            out, mean_, var_ = fn(*args)
            grads = torch.autograd.grad(out, args, g)
            results.append((out, mean_, var_, *grads))
        op_err = 0.0
        for part, a, b in zip(("out", "mean", "var", "dx", "dgamma", "dbeta",
                               "dW"), *results):
            rtol = FUSED_FWD_RTOL if part in ("out", "mean", "var") \
                else FUSED_GRAD_RTOL
            op_err = max(op_err, _held(f"op {part} {tag}", a, b, rtol))
        for k in FUSED_NAMES:
            worst[k] = max(worst[k], err[k])
        log(f"fused kernels vs plain {tag}: max|d| "
            + ", ".join(f"{k} {err[k]:.3e}" for k in FUSED_NAMES)
            + f"; op vs autograd(reference) max|d| {op_err:.3e}")
        if (n, c, f) in timed and device != "cpu":
            by_shape[(n, c, f)] = _time_fused(fd, x, w, g, mul, add, mean,
                                              rstd, c1, c2)
        del x, g, results
    _one_row_cancellation(fd, device, gen)
    check(device == "cpu" or set(by_shape) == set(timed),
          f"timed shapes {timed} are not all among the cases")
    timing = {}
    if by_shape:
        for name in FUSED_NAMES:
            timing[name] = dict(by_shape[timed[0]][name], by_shape=[
                by_shape[shape][name] for shape in timed])
    return worst, timing


def _log_dx_plan(fd, x, w, tag):
    """Prints bwd_dx's plan for x and W and, where it splits F, how many of
    its clusters the card keeps resident at once; fails if none fits."""
    n, c = x.shape
    plan = fd._plan_for(x, w.shape[1])
    clusters = fd.bwd_dx_max_clusters(x, w)
    log(f"bwd_dx plan {tag}: tile 64x{plan.dx_tile_cols}, F in "
        f"{plan.dx_chunks} chunk(s) of {plan.dx_k_per_chunk}, "
        f"{math.ceil(n / 64) * math.ceil(c / plan.dx_tile_cols)} tiles; "
        + ("unsplit launch" if clusters is None else
           f"clusters of {plan.dx_chunks} blocks, {clusters} resident at "
           "once (cudaOccupancyMaxActiveClusters)"))
    check(clusters is None or clusters >= 1,
          f"bwd_dx {tag}: no cluster of {plan.dx_chunks} blocks fits")


def _one_row_cancellation(fd, device, gen, draws=50):
    """bwd_dx at N = 1. With the batch's own sums dx = mul·(dz − c1 − xhat·c2)
    is exactly 0 in the plain version (c1 = dz, xhat = 0), and mul =
    γ/sqrt(eps) times the last bit of g Wᵀ in a kernel that sums in another
    order: that residual is logged, not held. Held, to the gradients'
    tolerance, is the product that is left when nothing cancels (c1 = c2 =
    0)."""
    import torch

    for c, f in ((5, 3), (224, 128)):
        residual = over = worst = largest = 0.0
        for _ in range(draws):
            x, gamma, beta, w, g = _fused_inputs(1, c, f, device, gen)
            mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
            _, dgamma, dbeta = fd.bwd_reduce_plain(x, g, w, mul, add, mean,
                                                   rstd)
            dx = fd.bwd_dx(x, g, w, mul, add, mean, rstd, dbeta, dgamma)
            want = fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, dbeta,
                                   dgamma)
            d = float((dx - want).abs().max())
            residual = max(residual, d)
            over += d > FUSED_ATOL * max(1.0, float(want.abs().max()))
            zero = torch.zeros_like(dbeta)
            want = fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, zero, zero)
            largest = max(largest, float(want.abs().max()))
            worst = max(worst, _held(
                f"bwd_dx 1x{c}->{f}, c1 = c2 = 0",
                fd.bwd_dx(x, g, w, mul, add, mean, rstd, zero, zero), want,
                FUSED_GRAD_RTOL))
        log(f"bwd_dx 1x{c}->{f} over {draws} draws: with the batch's own "
            f"sums (plain dx = 0) max|d| {residual:.3e}, {int(over)} draws "
            f"beyond {FUSED_ATOL} (logged, not held); with c1 = c2 = 0 "
            f"max|d| {worst:.3e} on |dx| up to {largest:.3e}, all within "
            "tolerance")


def _time_fused(fd, x, w, g, mul, add, mean, rstd, c1, c2):
    import torch

    n, c = x.shape
    f = w.shape[1]
    w_c = w.contiguous()
    calls = {
        "moments": (lambda: fd.moments(x), lambda: fd.moments_plain(x),
                    lambda: torch.var_mean(x, 0, correction=0)),
        "apply": (lambda: fd.apply(x, mul, add, w),
                  lambda: fd.apply_plain(x, mul, add, w),
                  lambda: torch.matmul(x, w_c)),
        "bwd_reduce": (
            lambda: fd.bwd_reduce(x, g, w, mul, add, mean, rstd),
            lambda: fd.bwd_reduce_plain(x, g, w, mul, add, mean, rstd),
            lambda: (torch.matmul(x.T, g), torch.matmul(g, w_c.T))),
        "bwd_dx": (
            lambda: fd.bwd_dx(x, g, w, mul, add, mean, rstd, c1, c2),
            lambda: fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, c1, c2),
            lambda: torch.matmul(g, w_c.T)),
    }
    timing = {}
    for name, (kernel, plain, library) in calls.items():
        kernel_ms = device_ms(kernel, kernels=FUSED_DEVICE_KERNELS[name])
        call_ms = cuda_ms(kernel)
        plain_ms = device_ms(plain)
        library_ms = device_ms(library)
        bound_ms, bound_by, cuda_core_ms = fused_bound_ms(name, n, c, f)
        timing[name] = dict(kernel_ms=kernel_ms, call_ms=call_ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            bound_cuda_core_ms=cuda_core_ms, shape=[n, c, f])
        log(f"{name} device times {n}x{c}->{f}: kernel {kernel_ms:.4f} ms "
            f"(per call by CUDA events {call_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library {library_ms:.4f} ms "
            f"({FUSED_LIBRARY[name]}), H100 bound {bound_ms:.4f} ms "
            f"({bound_by}; {cuda_core_ms:.4f} ms with the products on the "
            f"CUDA cores); kernel at {bound_ms / kernel_ms:.1%} of bound")
    timing["bwd_dx"].update(_time_dx_split(fd, x, w, g, mul, add, mean, rstd,
                                           c1, c2))
    return timing


def _time_dx_split(fd, x, w, g, mul, add, mean, rstd, c1, c2, rounds=3):
    """bwd_dx's planned launch (F split across a cluster where the grid is
    small) and its unsplit launch (one F chunk, the kernel before the split)
    in turns, by device time (one build: ``_launch_bwd_dx`` at the plan's
    F chunk and at all of F). A turn is one profiler window: the turns'
    median, not a window's, is the reading."""
    n, c = x.shape
    f = w.shape[1]
    plan = fd._plan_for(x, f)
    vecs = (mul, add, mean, rstd, c1, c2)
    launches = {"planned": (plan.dx_tile_cols, plan.dx_k_per_chunk),
                "unsplit": (plan.dx_tile_cols, math.ceil(f / 16) * 16)}
    turns = {k: [] for k in launches}
    for _ in range(rounds):  # in order, then in reverse
        for k in ("planned", "unsplit", "unsplit", "planned"):
            turns[k].append(device_ms(
                lambda k=k: fd._launch_bwd_dx(x, g, w, vecs, *launches[k]),
                windows=1, kernels=FUSED_DEVICE_KERNELS["bwd_dx"]))
    log(f"bwd_dx {n}x{c}->{f} in turns, device ms: planned ({plan.dx_chunks} "
        f"F chunk(s)) {[round(t, 5) for t in turns['planned']]}, unsplit "
        f"{[round(t, 5) for t in turns['unsplit']]}; medians "
        f"{sorted(turns['planned'])[rounds]:.5f} / "
        f"{sorted(turns['unsplit'])[rounds]:.5f}")
    return dict(dx_chunks=plan.dx_chunks, planned_turns_ms=turns["planned"],
                unsplit_turns_ms=turns["unsplit"])


# --------------------------------------------------------------------------
# 8: training (the main path of the training slice)
# --------------------------------------------------------------------------

def _comparable_pairs(time_, event, valid, hazard, margin):
    """``(comparable, fragile)``: the Harrell-comparable pairs
    (ops/cindex.py's definition), and those whose hazards lie within
    ``margin`` of each other — the only pairs whose credit can change when
    every hazard moves by at most ``margin / 2``."""
    t_i, t_j = time_[:, None], time_[None, :]
    e_i, e_j = event[:, None] > 0, event[None, :] > 0
    comp = ((t_i < t_j) & e_i) | ((t_i == t_j) & e_i & ~e_j)
    comp &= (valid[:, None] > 0) & (valid[None, :] > 0)
    near = abs(hazard[:, None] - hazard[None, :]) <= margin
    return int(comp.sum()), int((comp & near).sum())


def _profile_step(tr, state, data, rows, label, top=8, attempts=3):
    """One more train step (lr 0) under torch.profiler: device time by
    kernel, and the fused kernels' sums and launch counts in the step
    (returned with the step's device-busy time and launch count). The
    profiler's own overhead inflates the wall time. A trace that holds
    fewer of a fused wrapper's own kernels than the wrapper counted
    launches in the step has lost events (see ``device_ms``): the step is
    profiled again, up to ``attempts`` times. If no trace is whole, the
    last is reported with ``whole`` false: its sums are short."""
    import torch
    from torch.autograd import DeviceType

    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd

    idx, bvalid = tr._device_indices(*tr._pad_indices(rows, tr.cfg.batch_size,
                                                      None))
    batch = tr._gather_batch(data, idx[0], bvalid[0])
    tr.train_step(state, batch, 0.0)  # warm, outside the window
    torch.cuda.synchronize()
    for attempt in range(attempts):
        before = [k.launches for k in fd.KERNELS]
        with _profiled(cpu=True) as window:
            t0 = time.perf_counter()
            tr.train_step(state, batch, 0.0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof = window.prof
        counted = {name: k.launches - b for name, k, b in
                   zip(FUSED_NAMES, fd.KERNELS, before)}
        traced = {name: sum(e.count for e in window.events
                            if any(part in e.key for part in parts))
                  for name, parts in FUSED_DEVICE_KERNELS.items()}
        whole = traced == counted
        if whole:
            break
        log(f"profile {label}: the trace holds fused launches {traced}, the "
            f"wrappers counted {counted} (attempt {attempt + 1} of "
            f"{attempts})" + ("" if attempt + 1 < attempts else
                              "; reported as it is, marked not whole"))

    kernels = list(window.events)
    total = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log(f"profile {label}: one train step, wall {wall_ms:.1f} ms (under the "
        f"profiler), device busy {total / 1e3:.1f} ms, "
        f"{sum(e.count for e in kernels)} device launches; top by device "
        "time:")
    for e in kernels[:top]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    # the fused kernels' sums, whatever the top holds. A fold launch counts
    # for the wrapper whose kernel ran last before it on the stream.
    sums = {w: dict(device_ms=0.0, by_kernel={})
            for w in FUSED_DEVICE_KERNELS}
    owner = None
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        if FUSED_FOLD_KERNEL in e.name:
            check(owner is not None, "a fold launch before any fused kernel")
            hit = (owner, FUSED_FOLD_KERNEL)
        else:
            hit = next(((w, part) for w, parts in FUSED_DEVICE_KERNELS.items()
                        for part in parts if part in e.name), None)
            if hit is None:
                continue
            owner = hit[0]
        k = sums[hit[0]]["by_kernel"].setdefault(
            hit[1], dict(device_ms=0.0, launches=0))
        k["device_ms"] += e.self_device_time_total / 1e3
        k["launches"] += 1
        sums[hit[0]]["device_ms"] += e.self_device_time_total / 1e3
    for wrapper, found in sums.items():
        log(f"    fused {wrapper}: {found['device_ms']:.3f} ms in the step = "
            + " + ".join(f"{part} {k['device_ms']:.3f} ms x{k['launches']}"
                         for part, k in found["by_kernel"].items()))
    return dict(device_busy_ms=total / 1e3,
                device_launches=sum(e.count for e in kernels), fused=sums,
                whole=whole)


def phase_train(table, paths, rna_dim, device="cuda", image_shape=(64, 64, 32),
                block_config=None, epochs=2, expect_launches=True):
    """Train full-width partial_modality with fused_bn1=True, then the same
    seeds unfused. Returns the fused kernels' launch counts and the train
    summary."""
    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY as CFG,
    )
    from multimodal_survival_prediction_tpu_torch.data.datasets import (
        build_cohort_arrays,
        load_rnaseq_matrix,
    )
    from multimodal_survival_prediction_tpu_torch.models import (
        PartialModalityNet,
    )
    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
    from multimodal_survival_prediction_tpu_torch.train.adapters import (
        make_model_and_adapters,
    )
    from multimodal_survival_prediction_tpu_torch.train.engine import (
        TrainConfig,
        Trainer,
    )

    arrays = build_cohort_arrays(
        table, load_rnaseq_matrix(paths["rnaseq_csv"]), with_image=True,
        image_shape=image_shape, use_pallas=True, device=device)
    data = arrays.to_device(device)
    rows = np.arange(arrays.n)
    _, b2i, haa = make_model_and_adapters(CFG, rna_dim=rna_dim)
    cfg = TrainConfig(batch_size=CFG.batch_size,
                      learning_rate=CFG.learning_rate,
                      weight_decay=CFG.weight_decay, optimizer=CFG.optimizer,
                      grad_clip=CFG.grad_clip, ties=CFG.ties, seed=CFG.seed)
    kw = {} if block_config is None else {"block_config": block_config}
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    runs = {}
    for label, fused in (("fused", True), ("unfused", False),
                         ("fused again", True)):
        tr = Trainer(lambda gen, fused=fused: PartialModalityNet(
            rna_dim=rna_dim, fused_bn1=fused, generator=gen, **kw),
            b2i, haa, cfg, device=device)
        state = tr.init_state(fold=1)
        stages = sum(state.model.ct_encoder.block_config) + \
            len(state.model.ct_encoder.block_config) - 1
        weights0 = {k: v.clone() for k, v in state.model.state_dict().items()}
        shuffle = np.random.default_rng(CFG.seed + 1)
        losses, epoch_ms = [], []
        sync()
        fd.reset_launches()  # the main path's counts start here
        for _ in range(epochs):
            if device != "cpu":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            state, _ = tr.train_epoch(state, data, rows, shuffle,
                                      CFG.learning_rate)
            if device != "cpu":
                end.record()
                end.synchronize()
                epoch_ms.append(start.elapsed_time(end))
            losses += tr.step_losses.tolist()
        launches = {k: fd.KERNELS[i].launches
                    for i, k in enumerate(FUSED_NAMES)}  # ... and read here
        cindex, eval_loss, hazards = tr.evaluate(state, data, rows)
        sync()
        eval_launches = {k: fd.KERNELS[i].launches
                         for i, k in enumerate(FUSED_NAMES)}
        steps = state.step
        runs[label] = dict(weights0=weights0, losses=losses, cindex=cindex,
                           eval_loss=eval_loss, hazards=hazards,
                           launches=launches, steps=steps, stages=stages,
                           epoch_ms=epoch_ms)
        per_step = [round(ms / (steps // epochs), 3) for ms in epoch_ms]
        log(f"train {label} (fused_bn1={fused}): {steps} steps over "
            f"{epochs} epochs of {arrays.n} rows (batch {cfg.batch_size}); "
            f"ms/step by epoch {per_step or 'not measured (CPU)'}; losses "
            f"{[round(x, 7) for x in losses]}; eval C-index {cindex:.6f}, "
            f"loss {eval_loss:.6f}; fused kernel launches {launches}")
        check(all(math.isfinite(x) for x in losses) and math.isfinite(
            eval_loss) and np.all(np.isfinite(hazards))
            and hazards.shape == (arrays.n,),
            f"training gave non-finite or misshaped results ({label})")
        want = stages * steps if (fused and expect_launches) else 0
        check(all(v == want for v in launches.values()),
              f"fused kernel launches {launches} on the training path, "
              f"expected {want} each ({stages} fused stages x {steps} steps)")
        check(eval_launches == launches,
              f"evaluation launched fused kernels: {eval_launches}")
        if device != "cpu":
            runs[label]["profile"] = _profile_step(tr, state, data, rows,
                                                   label)

    def rel(x, y):
        return [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(x, y)]

    a, b, again = runs["fused"], runs["unfused"], runs["fused again"]
    for other in (b, again):
        for k, v in a["weights0"].items():
            check(torch.equal(v, other["weights0"][k]),
                  f"the training runs started from other weights ({k})")
    drift = rel(a["losses"], b["losses"])
    repeat = rel(a["losses"], again["losses"])
    check(drift[0] <= FIRST_LOSS_RTOL,
          f"first-step loss fused {a['losses'][0]} vs unfused "
          f"{b['losses'][0]}: rel {drift[0]:.3e} > {FIRST_LOSS_RTOL}")
    check(max(drift) <= LOSS_DRIFT_RTOL,
          f"per-step losses fused {a['losses']} vs unfused {b['losses']}: "
          f"max rel {max(drift):.3e} > {LOSS_DRIFT_RTOL}")
    dh = float(np.abs(a["hazards"] - b["hazards"]).max())
    dh_repeat = float(np.abs(a["hazards"] - again["hazards"]).max())
    spread = float(b["hazards"].max() - b["hazards"].min())
    check(dh <= HAZARD_SPREAD_TOL * spread,
          f"hazards fused vs unfused max |d| {dh:.3e} > "
          f"{HAZARD_SPREAD_TOL} x their range {spread:.3e}")
    pairs, fragile = _comparable_pairs(
        arrays.arrays["time"], arrays.arrays["event"],
        arrays.arrays["svalid"], b["hazards"], 2 * dh)
    c_tol = fragile / max(pairs, 1) + 1e-6
    dc = abs(a["cindex"] - b["cindex"])
    check(dc <= c_tol, f"C-index fused {a['cindex']} vs unfused "
          f"{b['cindex']}: |d| {dc:.3e} > {c_tol:.3e}")
    log("fused vs unfused per-step loss rel "
        f"{['%.2e' % x for x in drift]} (step 1 tol {FIRST_LOSS_RTOL}, later "
        f"{LOSS_DRIFT_RTOL}); fused vs fused again "
        f"{['%.2e' % x for x in repeat]}; hazards max |d| {dh:.3e} (tol "
        f"{HAZARD_SPREAD_TOL} x range {spread:.3e}; fused vs fused again "
        f"{dh_repeat:.3e}: the same path's own spread); C-index |d| {dc:.3e} "
        f"(tol {c_tol:.3e}: {fragile} of {pairs} comparable pairs within "
        "2 x max |d hazard|)")
    steady = {k: (r["epoch_ms"][-1] / (r["steps"] // epochs)
                  if r["epoch_ms"] else None) for k, r in runs.items()}
    return a["launches"], dict(
        steps=a["steps"], stages=a["stages"], loss_drift=drift,
        loss_repeat=repeat, hazard_diff=dh, hazard_repeat=dh_repeat,
        cindex_diff=dc,
        ms_per_step_fused=steady["fused"],
        ms_per_step_unfused=steady["unfused"],
        profile_fused=a.get("profile"), profile_unfused=b.get("profile"))


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
        fused_err, fused_timing = phase_fused_vs_plain()
        fused_launches, train = phase_train(table, paths, 5005)
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
        "call_ms": timing["call_ms"],
        "bound_us": timing["bound_ms"] * 1e3,
        "timed_shape": timing["shape"],
        "timed_dtype": timing["dtype"],
    }
    kernels = [kernel]
    for name in FUSED_NAMES:
        t = fused_timing[name]
        kernels.append({
            "name": f"fused_dense_{name}",
            "route": "cuda",
            "source": "multimodal_survival_prediction_tpu_torch/ops/csrc/"
                      "fused_dense.cu",
            "replaces": FUSED_REPLACES[name],
            "launches": fused_launches[name],
            "max_abs_err": fused_err[name],
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": FUSED_LIBRARY[name],
            "call_ms": t["call_ms"],
            "timed_shape": t["shape"],
            "bound_cuda_core_ms": t["bound_cuda_core_ms"],
            "by_shape": t["by_shape"],
            "train_step": dict(train["profile_fused"]["fused"][name],
                               whole_trace=train["profile_fused"]["whole"]),
        })
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
