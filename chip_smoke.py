#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each one raises on failure; the script exits non-zero and prints no
result then):
  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmul and cuDNN — the JAX
     reference contracts at precision="highest".
  2. build: compiles ops/csrc/resample_wpass.cu and ops/csrc/fused_dense.cu
     (six times: the float32 and, with -DMSP_FUSED_BF16, the bf16 entry
     points of each of its three parts, -DMSP_FUSED_FWD, _BWD_REDUCE and
     _BWD_DX) from this checkout (one nvcc each, all seven started
     together; sm_90a) and prints the build times and ptxas reports.
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
     (BatchNorm + cuDNN 1x1 conv), and the fused path once more; before the
     first two, step 1's gradients on the first batch (printed, fused vs
     unfused; phase 8b's yardstick): the first
     step's loss within 1e-5 relative, later steps within 2e-2 (Adam's
     drift, see LOSS_DRIFT_RTOL), hazards within a tenth of their range,
     C-index within the comparable pairs whose order that hazard difference
     could swap. ms per train step by CUDA events, and a torch.profiler
     breakdown of one step, for both, with each fused kernel's summed
     device time and launches in that step.
     Part of phase 7: bwd_dx at N = 1, c1 and c2 from the bwd_reduce
     kernel, must cancel to max |dx| <= 1e-5 (the plain version's 0).
  7b. bf16 fused kernels vs plain: the four bf16 kernels (x, W and g in
     bf16) against their plain versions at phase 7's shapes, bf16 results
     (out, dx) to one bf16 ulp (2^-7 of the value) and float32 ones
     (moments, dW, dgamma, dbeta) to phase 7's limits, each with atol 1e-5
     x the largest |value|; the autograd op against the same op on CPU
     copies (its plain versions); no float32 kernel launches. bwd_reduce's
     dW, dgamma and dbeta also against float64 over the same bf16 operands
     (relative error at most 2 x the float32 plain version's + 1e-6; both
     printed). The bf16 plans of moments (row chunks, clusters, partials),
     apply (channel chunks, one cluster of them a tile, clusters resident),
     bwd_reduce (dW row chunks, their clusters, the scratch) and bwd_dx (F
     chunks, clusters resident). Device times of
     all four at phase 7's five timed shapes beside the bf16 bound (2-byte
     elements at 3.35 TB/s, products at 989 TFLOP/s), the plain version and
     torch.matmul in bf16 (torch.var_mean for moments).
  8b. bf16 training: phase 8 with dtype=torch.bfloat16 (fused, unfused,
     fused again): each bf16 kernel 61 x the steps, no float32 fused
     kernel; fused vs unfused loss within 1e-2 relative at step 1 and 5e-2
     at step 2, after the first update (BF16_TRAIN_LIMITS); step 1's
     gradients of the 61 fused stages' dW, dgamma and dbeta, from the same
     weights, batch and masks as phase 8: each no further from phase 8's
     float32 unfused gradient (||d|| / ||float32||) than twice the unfused
     bf16 autograd's distance + half a bf16 ulp (BF16_GRAD_RATIO). The
     later losses, hazards and C-index are printed beside the fused path's
     own spread (fused again) and each path's gap to phase 8's float32
     run, and not held: bf16 rounding moves step 1's gradients by up to
     ~90 % on either path, and Adam's first steps (about lr x
     sign(gradient)) carry that into every later step. The profile of one
     step of fused and unfused.
  9. CV (the main path of the CV slice): the partial_modality training
     CLI's main(argv) in-process on the phase-4 cohort at full width with
     --pallas-resample --n-folds 2 --epochs 2: the W-pass launch count,
     reset just before, must equal the imaging patients after the ingest;
     no fused kernel launches (the driver's model is unfused, as JAX's);
     cv_results.json in the standard schema; both fold checkpoints with a
     .meta.json pinning use_pallas_resample and resample_mode "device";
     the logged TF32 flags both off. Then predict_risk on each fold
     checkpoint (one W-pass launch per imaging patient) reproduces the
     fold's best_c_index on its validation patients (a pair whose hazards
     differ by under 1e-5 may count either way), and the fold ensemble's
     risks are finite. Prints the phase's and each fold's wall, each
     epoch's ms by CUDA events and epoch 2's steps and ms/step.
  9b. --bf16: the partial_modality and rnaseq_only training CLIs'
     main([..., "--bf16", "--pallas-resample", "--n-folds", "2", "--epochs",
     "1"]) on the phase-4 cohort: W-pass launches in the ingest as phase 9,
     no fused launch of either dtype, float32 fold checkpoints whose
     .meta.json names no dtype; predict_risk (float32) on each reproduces
     the fold's best_c_index but for the pairs whose hazards lie within
     twice the fold's bf16-vs-f32 hazard gap.
  10. families: one 32-patient cohort (seed 15; CTs 48-64x256x256 int16,
     p_imaging 0.75, p_rnaseq 0.9, p_dead 0.75, one labeled patient with no
     modality at all), then each of the seven other families' training CLI
     main(argv) in-process at full width (rnaseq_only, image_only,
     simple_fusion, flexible_multimodal, final, simmim, mmsurv) with
     --pallas-resample --n-folds 2 --epochs 1 (simmim also
     --stage1-epochs 1): the W-pass launches in the ingest, reset just
     before, one per imaging patient of the family's cohort (0 for
     rnaseq_only); no fused launch; cv_results.json (image_only: the
     reference's legacy schema) and both fold checkpoints; each fold's
     C-index from predict_risk on its checkpoint equal to its best_c_index
     (pairs within 1e-5 may swap); RiskScorer on both fold checkpoints,
     calibrated by predict_risk's fold stats, scoring one at a time up to
     4 patients of each modality pattern (which of CT, RNA and age a
     patient has) of the cohort: within 1e-4 of the ensemble on the
     log-hazard (the limit carried through the fold z-score), and fold 1's
     raw log-hazards within 1e-4 of predict_risk's; simmim's log holds a stage-1 epoch before each
     fold's main epoch; mmsurv's risks are finite on the patient with no
     modality. Prints each family's parameter count, CLI and ingest walls
     and each epoch's ms by CUDA events beside the card's name and limit.
  11. summary: one JSON line of per-kernel numbers, then the final line
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
H100_BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores, dense
RESAMPLE_TOL = 2e-6
RISK_TOL = 1e-4
OUT_W = 32
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
# the same in bf16 (first step, later steps): the fused and unfused bf16
# paths round the normalized trunk to bf16 at the same point, but their
# float32 sums (the moments, the products) differ in order, and a
# last-bit difference moves a bf16 rounding by a whole ulp (2^-8) wherever
# it crosses a boundary
BF16_TRAIN_LIMITS = (1e-2, 5e-2)
# bf16 step 1, from the same weights, batch and dropout masks: each fused
# stage's dW, dgamma and dbeta on the fused bf16 path lie no further from
# the float32 gradient (phase 8's unfused autograd) than BF16_GRAD_RATIO x
# the unfused bf16 autograd's own distance + half a bf16 ulp, each
# distance ||d|| / ||float32||. Batch-statistics BatchNorm backward
# cancels, so bf16 rounding moves these gradients by up to ~90 % on either
# path at full width on an H100 (the JAX package's lie 19-33 % from its
# float32 ones at block_config (2, 2), tests/test_torch_bf16_grads.py),
# and fused and unfused bf16 differ by nearly as much; the fused kernels
# skip one rounding (the conv's input gradient) and should sit no further
# than the unfused path
BF16_GRAD_RATIO = 2.0


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

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])

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
    """Build every kernel library, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_survival_prediction_tpu_torch.ops import _build
    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd

    # (source, -D macros): fused_dense.cu builds six times, three parts in
    # f32 and in bf16
    builds = (("resample_wpass.cu", ()), *fd.BUILDS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        infos = list(pool.map(lambda b: _build.build(*b)[1], builds))
    log(f"built {len(builds)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s")
    for (src, macros), info in zip(builds, infos):
        log(f"  {src} {' '.join(f'-D{m}' for m in macros)}: nvcc "
            f"{info['build_sec']:.2f} s, fresh={info['built']}")
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
    H100 SXM for one call: the operations of the JAX kernels' CostEstimate
    formulas (ops/fused_dense.py:105-108, 137-142, 200-205, 242-247 of the
    JAX package), the bytes of each input read once and each output written
    once (f32, 4 bytes an element; bwd_reduce reads x, g, W and the
    statistics and writes dW, dgamma, dbeta: 4(NC + NF + CF) + 4CF + 24C,
    where CostEstimate's 5CF x 4 counts W and dW more than once). The bound
    is the larger of bytes over
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
                       4 * (n * c + n * f + c * f) + 4 * c * f + 24 * c),
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
    """bwd_dx at N = 1 (ROADMAP Queue 3's former fault). With the batch's
    own sums xhat = 0 and c1 = Σ dz = dz, so the reference's dx = mul·(dz −
    c1 − xhat·c2) is exactly 0. The op's backward takes c1 and c2 from the
    bwd_reduce kernel and dz from the bwd_dx kernel, each at launch_plan's
    own plan: held, over ``draws`` draws, is max |dx| <= FUSED_ATOL through
    the wrappers and through the autograd op (the plain pair gives 0).
    Held too, to the gradients' tolerance, is the product that is left when
    nothing cancels (c1 = c2 = 0)."""
    import torch

    for c, f in ((5, 3), (224, 128)):
        cancel = op = worst = largest = 0.0
        for _ in range(draws):
            x, gamma, beta, w, g = _fused_inputs(1, c, f, device, gen)
            mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
            _, dgamma, dbeta = fd.bwd_reduce(x, g, w, mul, add, mean, rstd)
            dx = fd.bwd_dx(x, g, w, mul, add, mean, rstd, dbeta, dgamma)
            cancel = max(cancel, float(dx.abs().max()))
            args = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
            out, _, _ = fd.fused_bn_relu_conv1x1(*args, w)
            op = max(op, float(torch.autograd.grad(out, args[0], g)[0]
                               .abs().max()))
            _, pg, pb = fd.bwd_reduce_plain(x, g, w, mul, add, mean, rstd)
            plain = fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, pb, pg)
            check(float(plain.abs().max()) == 0.0,
                  f"plain bwd_dx 1x{c}->{f} does not cancel: {plain}")
            zero = torch.zeros_like(dbeta)
            want = fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, zero, zero)
            largest = max(largest, float(want.abs().max()))
            worst = max(worst, _held(
                f"bwd_dx 1x{c}->{f}, c1 = c2 = 0",
                fd.bwd_dx(x, g, w, mul, add, mean, rstd, zero, zero), want,
                FUSED_GRAD_RTOL))
        plan = fd._plan_for(x, f) if device != "cpu" else None
        chunks = f"{plan.da_chunks} / {plan.dx_chunks}" if plan else "-"
        log(f"bwd_dx 1x{c}->{f} over {draws} draws, c1 and c2 from the "
            f"bwd_reduce kernel (F chunks of bwd_reduce / bwd_dx: {chunks}):"
            f" max|dx| "
            f"{cancel:.3e} through the wrappers, {op:.3e} through the op "
            f"(plain 0; tol {FUSED_ATOL}); with c1 = c2 = 0 max|d| "
            f"{worst:.3e} on |dx| up to {largest:.3e}")
        check(cancel <= FUSED_ATOL and op <= FUSED_ATOL,
              f"bwd_dx 1x{c}->{f} does not cancel: max|dx| {cancel:.3e} "
              f"(wrappers), {op:.3e} (op) > {FUSED_ATOL}")


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
# 7b: the bf16 fused kernels vs plain
# --------------------------------------------------------------------------

# bf16 outputs (out, dx) round one float32 sum once: a kernel and its plain
# version may land on neighbouring bf16 values where their sums differ in
# the last bits, one ulp, at most 2^-7 of the value
BF16_ULP = 2.0 ** -7
# the bf16 kernels each wrapper launches, by a part of their names; the one
# fold kernel is the float32 path's fold_parts_kernel, after bwd_reduce
# (moments and apply fold inside their one launch)
FUSED_BF16_DEVICE_KERNELS = {
    "moments": ("::moments_bf16_kernel",),
    "apply": ("::apply_bf16_kernel<",),
    "bwd_reduce": ("::bwd_reduce_bf16_kernel<",),
    "bwd_dx": ("::bwd_dx_bf16_kernel<", "::bwd_dx_cluster_bf16_kernel<"),
}
FUSED_BF16_FOLD_KERNELS = (FUSED_FOLD_KERNEL,)
FUSED_BF16_LIBRARY = {
    "moments": "torch.var_mean(x, 0, correction=0) on the bf16 x",
    "apply": "torch.matmul(x, W) in bf16 (the contraction alone)",
    "bwd_reduce": "torch.matmul(x.T, g) + torch.matmul(g, W.T) in bf16 "
                  "(the two contractions alone)",
    "bwd_dx": "torch.matmul(g, W.T) in bf16 (the contraction alone)",
}


def fused_bf16_bound_ms(name, n, c, f):
    """``(bound ms, bound by)`` of one bf16 call on an H100 SXM, as
    ``fused_bound_ms`` counts it with 2-byte x, g, W, out and dx (the
    statistics, dW, dgamma and dbeta stay 4-byte; bwd_reduce moves
    2(NC + NF + CF) + 4CF + 24C bytes): the larger of the
    bytes over the memory rate and the operations over their unit's rate,
    the products at the bf16 tensor rate, the elementwise work at the fp32
    rate."""
    product, elementwise, n_bytes = {
        "moments": (0, 3 * n * c, 2 * n * c + 8 * c),
        "apply": (2 * n * c * f, 3 * n * c,
                  2 * (n * c + c * f + n * f) + 8 * c),
        "bwd_reduce": (4 * n * c * f, 8 * n * c,
                       2 * (n * c + n * f + c * f) + 4 * c * f + 24 * c),
        "bwd_dx": (2 * n * c * f, 10 * n * c,
                   2 * (2 * n * c + n * f + c * f) + 24 * c),
    }[name]
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_ops = (product / H100_BF16_OPS_PER_S
             + elementwise / H100_F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _held_bf16(name, got, want, extra=0.0):
    """max |got - want| for a bf16 result, raising if any element exceeds
    one bf16 ulp (BF16_ULP·|want|) + FUSED_ATOL·max(1, max|want|), +
    ``extra``."""
    check(got.dtype == want.dtype, f"{name}: {got.dtype} vs {want.dtype}")
    got, want = got.detach().double(), want.detach().double()
    diff = (got - want).abs()
    atol = FUSED_ATOL * max(1.0, float(want.abs().max()))
    bad = diff > atol + BF16_ULP * want.abs() + extra
    err = float(diff.max())
    check(math.isfinite(err) and not bool(bad.any()),
          f"{name}: {int(bad.sum())} elements beyond one bf16 ulp + atol "
          f"{atol:.3e}; max |d| {err:.3e}")
    return err


# the kernel-level float64 yardstick of bwd_reduce's bf16 kernel: its
# relative error (||d|| / ||float64||) in dW, dgamma and dbeta at most
# F64_RATIO x the float32 plain version's on the same bf16 operands +
# F64_SLACK
F64_RATIO, F64_SLACK = 2.0, 1e-6


def bwd_reduce_f64(x, g, w, mul, add, mean, rstd):
    """``(dW, dgamma, dbeta)`` in float64 over the kernels' own bf16
    operands: z = x·mul + add in float32 (the kernels' two roundings, so
    the same ReLU mask), a = relu(z) rounded to x's dtype, then dW = aᵀg,
    dz = [z > 0]·(g Wᵀ), xhat = (x − mean)·rstd and the sums in float64."""
    import torch

    z = x.float() * mul + add
    a = torch.relu(z).to(x.dtype).double()
    gd = g.double()
    dz = torch.where(z > 0, gd @ w.double().T, 0.0)
    xhat = (x.double() - mean.double()) * rstd.double()
    return a.T @ gd, (dz * xhat).sum(0), dz.sum(0)


def f64_yardstick(tag, got, plain, exact):
    """Holds each of bwd_reduce's results (dW, dgamma, dbeta) to
    F64_RATIO x the plain version's relative error + F64_SLACK, both
    against float64 (``bwd_reduce_f64``); returns (kernel, plain) relative
    errors, the largest of the three."""
    errs = []
    for part, a, b, e in zip(("dW", "dgamma", "dbeta"), got, plain, exact):
        norm = max(float(e.norm()), 1e-30)
        kernel = float((a.double() - e).norm()) / norm
        ref = float((b.double() - e).norm()) / norm
        check(math.isfinite(kernel) and kernel <= F64_RATIO * ref + F64_SLACK,
              f"bwd_reduce {part} {tag}: relative error {kernel:.3e} against "
              f"float64 > {F64_RATIO} x the float32 plain version's "
              f"{ref:.3e} + {F64_SLACK}")
        errs.append((kernel, ref))
    return max(k for k, _ in errs), max(r for _, r in errs)


def phase_fused_bf16_vs_plain(device="cuda", cases=None, timed=None):
    """The four bf16 kernels against their plain versions at phase 7's
    shapes (x, W and g of ``_fused_inputs`` rounded to bf16; N = 1 left
    out: there dx cancels to rounding noise times rstd = 1/sqrt(eps)), then
    the autograd op against the same op on CPU copies of its inputs (whose
    ``out`` and dW may also differ by the products of the a = relu(z) that
    the two sides' statistics round to neighbouring bf16 values). bf16
    results (out, dx, the op's dW) to one bf16 ulp, float32 ones (the
    moments, dW, dgamma, dbeta) to phase 7's limits; bwd_reduce's also to
    the float64 yardstick (``f64_yardstick``); the launches counted in the
    bf16 counts, none in the float32 ones. Device times at every shape of
    ``timed`` (``FUSED_TIMED_SHAPES``). Returns (max |d| per kernel, timing
    per kernel: the first timed shape's, every timed shape under
    ``by_shape``)."""
    import torch

    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd

    cases = FUSED_CASES if cases is None else cases
    timed = FUSED_TIMED_SHAPES if timed is None else [tuple(t) for t in timed]
    gen = torch.Generator(device=device).manual_seed(3)
    bf16 = torch.bfloat16
    worst = dict.fromkeys(FUSED_NAMES, 0.0)
    by_shape = {}
    before = [k.launches for k in fd.KERNELS]
    for n, c, f in cases:
        x, gamma, beta, w, g = _fused_inputs(n, c, f, device, gen)
        x, w, g = x.to(bf16), w.to(bf16), g.to(bf16)
        tag = f"{n}x{c}->{f} bf16"
        s, sq = fd.moments(x)
        ps, psq = fd.moments_plain(x)
        err = {"moments": max(_held(f"moments sum {tag}", s, ps,
                                    FUSED_FWD_RTOL),
                              _held(f"moments sumsq {tag}", sq, psq,
                                    FUSED_FWD_RTOL))}
        mean, var, rstd, mul, add = fd._stats(x, gamma, beta, 1e-5)
        err["apply"] = _held_bf16(f"apply {tag}", fd.apply(x, mul, add, w),
                                  fd.apply_plain(x, mul, add, w))
        got = fd.bwd_reduce(x, g, w, mul, add, mean, rstd)
        want = fd.bwd_reduce_plain(x, g, w, mul, add, mean, rstd)
        err["bwd_reduce"] = max(
            _held(f"bwd_reduce {part} {tag}", a, b, FUSED_GRAD_RTOL)
            for part, a, b in zip(("dW", "dgamma", "dbeta"), got, want))
        f64 = f64_yardstick(tag, got, want,
                            bwd_reduce_f64(x, g, w, mul, add, mean, rstd))
        c1, c2 = want[2] / n, want[1] / n
        if device != "cpu":
            _log_forward_plan(fd, x, w, tag)
            _log_reduce_plan(fd, x, w, tag)
            _log_dx_plan(fd, x, w, tag)
        err["bwd_dx"] = _held_bf16(
            f"bwd_dx {tag}", fd.bwd_dx(x, g, w, mul, add, mean, rstd, c1, c2),
            fd.bwd_dx_plain(x, g, w, mul, add, mean, rstd, c1, c2))
        # the op against itself on CPU copies (its plain versions there):
        # autograd through the oracle is no yardstick in bf16, as its
        # backward rounds da to bf16 at the cast where the op keeps it in
        # float32 (so does the JAX op's VJP)
        # The two sides' batch statistics differ in the last bits, so a =
        # relu(z) may round to neighbouring bf16 values on the two sides
        # before the products: out may also differ by Σ_c |Δa_c|·|W_cf|,
        # dW by Σ_n |Δa_nc|·|g_nf|.
        results, acts = [], []
        for dev in (x.device, "cpu"):
            args = [t.detach().to(dev, copy=True).requires_grad_(True)
                    for t in (x, gamma, beta, w)]
            out, mean_, var_ = fd.fused_bn_relu_conv1x1(*args)
            grads = torch.autograd.grad(out, args, g.to(dev))
            results.append([t.to(x.device) for t in
                            (out, mean_, var_, *grads)])
            _, _, _, mul_, add_ = fd._stats(*(t.detach() for t in args[:3]),
                                           1e-5)
            acts.append(torch.relu(args[0].detach().float() * mul_ + add_)
                        .to(bf16).float().to(x.device))
        flips = (acts[0] - acts[1]).abs()
        slack = {"out": (flips @ w.float().abs()).double(),
                 "dW": (flips.T @ g.float().abs()).double()}
        op_err = 0.0
        for part, a, b in zip(("out", "mean", "var", "dx", "dgamma", "dbeta",
                               "dW"), *results):
            if a.dtype == bf16:
                op_err = max(op_err, _held_bf16(f"op {part} {tag}", a, b,
                                                slack.get(part, 0.0)))
            else:
                op_err = max(op_err, _held(
                    f"op {part} {tag}", a, b, FUSED_FWD_RTOL
                    if part in ("mean", "var") else FUSED_GRAD_RTOL))
        for k in FUSED_NAMES:
            worst[k] = max(worst[k], err[k])
        log(f"fused bf16 kernels vs plain {tag}: max|d| "
            + ", ".join(f"{k} {err[k]:.3e}" for k in FUSED_NAMES)
            + f"; op vs the op on CPU copies max|d| {op_err:.3e} ("
            f"{int((flips > 0).sum())} of {flips.numel()} a = relu(z) "
            "rounded to another bf16 value); bwd_reduce vs float64: "
            f"relative error {f64[0]:.3e} (float32 plain {f64[1]:.3e}; limit "
            f"{F64_RATIO} x plain + {F64_SLACK})")
        if (n, c, f) in timed and device != "cpu":
            by_shape[(n, c, f)] = _time_fused_bf16(fd, x, w, g, mul, add,
                                                   mean, rstd, c1, c2)
        del x, g, results
    check([k.launches for k in fd.KERNELS] == before,
          "a bf16 tensor launched a float32 fused kernel")
    check(device == "cpu" or set(by_shape) == set(timed),
          f"timed shapes {timed} are not all among the cases")
    timing = {}
    if by_shape:
        for name in FUSED_NAMES:
            timing[name] = dict(by_shape[timed[0]][name], by_shape=[
                by_shape[shape][name] for shape in timed])
    return worst, timing


def _log_forward_plan(fd, x, w, tag):
    """Prints the bf16 plans of moments (row chunks of 32-channel slabs,
    the partials the last block of a slab folds) and apply (tile,
    channel chunks, one cluster of them a tile, clusters resident at once);
    fails if apply's clusters do not fit."""
    n, c = x.shape
    plan = fd._plan_for(x, w.shape[1])
    rows = fd.moments_rows_bf16(n, c, fd._sm_count(x.device))
    partials = fd._moments_bf16_partials(n, rows)
    clusters = fd.apply_max_clusters(x, w)
    tiles = (math.ceil(n / plan.apply_tile_rows)
             * math.ceil(w.shape[1] / plan.apply_tile_cols))
    log(f"moments plan {tag}: {math.ceil(c / 32)} slab(s) x "
        f"{math.ceil(n / rows)} chunk(s) of {rows} rows, "
        + (f"{partials} partials a slab folded by its last block"
           if partials else "no partial in device memory")
        + f"; apply plan {tag}: tile {plan.apply_tile_rows}x"
        f"{plan.apply_tile_cols}, C in {plan.apply_chunks} chunk(s) of "
        f"{plan.apply_k_per_chunk}, {tiles} tiles; "
        + ("unclustered launch" if clusters is None else
                      f"clusters of {plan.apply_cluster} blocks, {clusters} "
                      "resident at once (cudaOccupancyMaxActiveClusters)"))
    check(clusters is None or clusters >= 1,
          f"apply {tag}: no cluster of {plan.apply_cluster} blocks fits")


def _log_reduce_plan(fd, x, w, tag):
    """Prints bwd_reduce's bf16 plan for x and W: dW's row chunks and their
    clusters, and the scratch against x's bytes."""
    n, c = x.shape
    f = w.shape[1]
    plan = fd._plan_for(x, f)
    partials = fd._dw_partials(plan.dw_chunks, plan.dw_cluster,
                               x.element_size())
    log(f"bwd_reduce plan {tag}: dW in {plan.dw_chunks} row chunk(s) of "
        f"{plan.dw_rows_per_chunk}, clusters of {plan.dw_cluster}, "
        f"{partials} partial(s) in scratch ({partials * c * f * 4} bytes; "
        f"x {x.numel() * x.element_size()}); g W^T in {plan.da_chunks} F "
        f"chunk(s) of {plan.da_k_per_chunk}; scratch "
        f"{plan.reduce_scratch * 4} bytes")


def _time_fused_bf16(fd, x, w, g, mul, add, mean, rstd, c1, c2):
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
        kernel_ms = device_ms(kernel,
                              kernels=FUSED_BF16_DEVICE_KERNELS[name])
        call_ms = cuda_ms(kernel)
        plain_ms = device_ms(plain)
        library_ms = device_ms(library)
        bound_ms, bound_by = fused_bf16_bound_ms(name, n, c, f)
        timing[name] = dict(kernel_ms=kernel_ms, call_ms=call_ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            shape=[n, c, f])
        log(f"{name} bf16 device times {n}x{c}->{f}: kernel {kernel_ms:.4f} "
            f"ms (per call by CUDA events {call_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library {library_ms:.4f} ms "
            f"({FUSED_BF16_LIBRARY[name]}), H100 bound {bound_ms:.4f} ms "
            f"({bound_by}); kernel at {bound_ms / kernel_ms:.1%} of bound")
    return timing


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


def _profile_step(tr, state, data, rows, label, top=8, attempts=3,
                  bf16=False):
    """One more train step (lr 0) under torch.profiler: device time by
    kernel, and the fused kernels' sums and launch counts in the step
    (returned with the step's device-busy time and launch count). The
    profiler's own overhead inflates the wall time. A trace that holds
    fewer of a fused wrapper's own kernels than the wrapper counted
    launches in the step has lost events (see ``device_ms``): the step is
    profiled again, up to ``attempts`` times. If no trace is whole, the
    last is reported with ``whole`` false: its sums are short. ``bf16``:
    the bf16 kernels and counts."""
    import torch
    from torch.autograd import DeviceType

    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd

    device_kernels = (FUSED_BF16_DEVICE_KERNELS if bf16
                      else FUSED_DEVICE_KERNELS)
    folds = FUSED_BF16_FOLD_KERNELS if bf16 else (FUSED_FOLD_KERNEL,)
    count = "launches_bf16" if bf16 else "launches"

    idx, bvalid = tr._device_indices(*tr._pad_indices(rows, tr.cfg.batch_size,
                                                      None))
    batch = tr._gather_batch(data, idx[0], bvalid[0])
    tr.train_step(state, batch, 0.0)  # warm, outside the window
    torch.cuda.synchronize()
    for attempt in range(attempts):
        before = [getattr(k, count) for k in fd.KERNELS]
        with _profiled() as window:
            t0 = time.perf_counter()
            tr.train_step(state, batch, 0.0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof = window.prof
        counted = {name: getattr(k, count) - b for name, k, b in
                   zip(FUSED_NAMES, fd.KERNELS, before)}
        traced = {name: sum(e.count for e in window.events
                            if any(part in e.key for part in parts))
                  for name, parts in device_kernels.items()}
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
    sums = {w: dict(device_ms=0.0, by_kernel={}) for w in device_kernels}
    owner = None
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        fold = next((k for k in folds if k in e.name), None)
        if fold is not None:
            check(owner is not None, "a fold launch before any fused kernel")
            hit = (owner, fold)
        else:
            hit = next(((w, part) for w, parts in device_kernels.items()
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


def _fused_stage_param(name):
    """Whether parameter ``name`` is one the fused op's gradients reach
    directly: a dense layer's norm1 / conv1 or a transition's norm / conv
    (dgamma, dbeta and dW of bwd_reduce)."""
    return (("denselayer" in name and (".norm1." in name or ".conv1." in name))
            or ("transition" in name and (".norm." in name
                                          or ".conv." in name)))


def _first_step_grads(tr, state, data, rows, seed, weights0):
    """Step 1's train-mode loss and gradients (float32, by parameter name)
    on the batch ``train_epoch`` draws first from a shuffle seeded
    ``seed``. The weights, the BatchNorm buffers and the dropout generator
    are put back after, so the training run that follows is unchanged."""
    import numpy as np

    idx, bvalid = tr._pad_indices(rows, tr.cfg.batch_size,
                                  np.random.default_rng(seed))
    idx, bvalid = tr._device_indices(idx[:1], bvalid[:1])
    drop = state.dropout_generator.get_state()
    loss, grads = tr.loss_and_grads(state,
                                    tr._gather_batch(data, idx[0], bvalid[0]))
    names = [n for n, _ in state.model.named_parameters()]
    out = {n: g.detach().float().clone() for n, g in zip(names, grads)}
    state.model.load_state_dict(weights0)
    state.dropout_generator.set_state(drop)
    return float(loss), out


def _rel_gaps(a, b, names):
    """``{name: ||a - b|| / ||b||}`` over the tensors ``names`` of two
    gradients (by parameter name)."""
    return {n: float((a[n] - b[n]).norm()) / max(float(b[n].norm()), 1e-30)
            for n in names}


def _grad_gap(a, b, names):
    """``(worst, name)``: the largest ||a - b|| / ||b|| over ``names``."""
    gaps = _rel_gaps(a, b, names)
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def _grad_gap_whole(a, b):
    """||a - b|| / ||b|| over every parameter's gradient at once."""
    num = sum(float((a[n] - b[n]).norm()) ** 2 for n in b)
    return math.sqrt(num / max(sum(float(g.norm()) ** 2
                                   for g in b.values()), 1e-60))


def phase_train(table, paths, rna_dim, device="cuda", image_shape=(64, 64, 32),
                block_config=None, epochs=2, expect_launches=True,
                dtype=None, f32=None):
    """Train full-width partial_modality with fused_bn1=True, then the same
    seeds unfused, then fused again (its own spread). Before each of the
    first two, step 1's loss and gradients on the first batch. ``dtype``:
    the models' compute dtype (bf16: the bf16 kernels launch, no float32
    one may; the limits are BF16_TRAIN_LIMITS on the losses of steps 1
    and 2 and BF16_GRAD_RATIO on the fused stages' step-1 gradients
    against ``f32``, the float32 run's summary; the later losses, hazards
    and C-index are reported and not held). Returns the fused kernels'
    launch counts and the train summary."""
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
    bf16 = dtype is not None
    count, other = (("launches_bf16", "launches") if bf16
                    else ("launches", "launches_bf16"))
    first_tol, drift_tol = (BF16_TRAIN_LIMITS if bf16
                            else (FIRST_LOSS_RTOL, LOSS_DRIFT_RTOL))
    tag = " bf16" if bf16 else ""
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    runs = {}
    for label, fused in (("fused", True), ("unfused", False),
                         ("fused again", True)):
        t_run = time.perf_counter()
        tr = Trainer(lambda gen, fused=fused: PartialModalityNet(
            rna_dim=rna_dim, fused_bn1=fused, generator=gen, dtype=dtype,
            **kw), b2i, haa, cfg, device=device)
        state = tr.init_state(fold=1)
        stages = sum(state.model.ct_encoder.block_config) + \
            len(state.model.ct_encoder.block_config) - 1
        weights0 = {k: v.clone() for k, v in state.model.state_dict().items()}
        walls = {"init": time.perf_counter() - t_run}
        probe = None
        if label != "fused again":  # outside the counted window
            t0 = time.perf_counter()
            probe = _first_step_grads(tr, state, data, rows, CFG.seed + 1,
                                      weights0)
            sync()
            walls["step-1 gradients"] = time.perf_counter() - t0
        shuffle = np.random.default_rng(CFG.seed + 1)
        losses, epoch_ms = [], []
        sync()
        t0 = time.perf_counter()
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
        launches = {k: getattr(fd.KERNELS[i], count)
                    for i, k in enumerate(FUSED_NAMES)}  # ... and read here
        others = [getattr(k, other) for k in fd.KERNELS]
        walls["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cindex, eval_loss, hazards = tr.evaluate(state, data, rows)
        sync()
        walls["eval"] = time.perf_counter() - t0
        eval_launches = {k: getattr(fd.KERNELS[i], count)
                         for i, k in enumerate(FUSED_NAMES)}
        steps = state.step
        runs[label] = dict(weights0=weights0, losses=losses, cindex=cindex,
                           eval_loss=eval_loss, hazards=hazards,
                           launches=launches, steps=steps, stages=stages,
                           epoch_ms=epoch_ms, probe=probe)
        per_step = [round(ms / (steps // epochs), 3) for ms in epoch_ms]
        log(f"train{tag} {label} (fused_bn1={fused}): {steps} steps over "
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
        check(others == [0] * len(others),
              f"the{tag} training path launched the other dtype's fused "
              f"kernels: {others}")
        check(eval_launches == launches,
              f"evaluation launched fused kernels: {eval_launches}")
        if device != "cpu" and label != "fused again":
            t0 = time.perf_counter()
            runs[label]["profile"] = _profile_step(tr, state, data, rows,
                                                   f"{label}{tag}", bf16=bf16)
            walls["profile"] = time.perf_counter() - t0
        log(f"  walls s {({k: round(v, 2) for k, v in walls.items()})}")

    def rel(x, y):
        return [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(x, y)]

    a, b, again = runs["fused"], runs["unfused"], runs["fused again"]
    for run in (b, again):
        for k, v in a["weights0"].items():
            check(torch.equal(v, run["weights0"][k]),
                  f"the training runs started from other weights ({k})")
    drift = rel(a["losses"], b["losses"])
    repeat = rel(a["losses"], again["losses"])
    check(drift[0] <= first_tol,
          f"first-step loss fused {a['losses'][0]} vs unfused "
          f"{b['losses'][0]}: rel {drift[0]:.3e} > {first_tol}")
    held = drift[1:2] if bf16 else drift[1:]  # bf16: the loss after step 1
    check(all(d <= drift_tol for d in held),
          f"per-step losses fused {a['losses']} vs unfused {b['losses']}: "
          f"rel {drift} > {drift_tol}")
    # step 1's gradients, from the same weights, batch and dropout masks
    ga, gb = a["probe"][1], b["probe"][1]
    stage_names = [n for n in ga if _fused_stage_param(n)]
    check(len(stage_names) == 3 * a["stages"],
          f"{len(stage_names)} fused-stage parameters, expected "
          f"3 x {a['stages']}")
    grad_gap = _grad_gap(ga, gb, stage_names)
    grad_gap_all = _grad_gap_whole(ga, gb)
    ratio = None
    if bf16:
        for k, v in a["weights0"].items():
            check(torch.equal(v, f32["weights0"][k]),
                  f"the bf16 and float32 runs started from other weights "
                  f"({k})")
        ref = f32["grads"]["unfused"]
        gf, gu = _rel_gaps(ga, ref, stage_names), _rel_gaps(gb, ref,
                                                            stage_names)
        over = {n: (gf[n] - BF16_ULP / 2) / gu[n] for n in stage_names}
        worst = max(over, key=over.get)
        ratio = dict(worst=over[worst], at=worst,
                     median=float(np.median(list(over.values()))),
                     fused_f32=max(gf.values()), unfused_f32=max(gu.values()))
        check(gf[worst] <= BF16_GRAD_RATIO * gu[worst] + BF16_ULP / 2,
              f"step-1 gradient of {worst}: the fused bf16 path lies "
              f"{gf[worst]:.3e} from float32, the unfused bf16 autograd "
              f"{gu[worst]:.3e} (limit {BF16_GRAD_RATIO} x that + "
              f"{BF16_ULP / 2})")
    dh = float(np.abs(a["hazards"] - b["hazards"]).max())
    dh_repeat = float(np.abs(a["hazards"] - again["hazards"]).max())
    spread = float(b["hazards"].max() - b["hazards"].min())
    h_tol = HAZARD_SPREAD_TOL * spread
    pairs, fragile = _comparable_pairs(
        arrays.arrays["time"], arrays.arrays["event"],
        arrays.arrays["svalid"], b["hazards"], 2 * dh)
    c_tol = fragile / max(pairs, 1) + 1e-6
    dc = abs(a["cindex"] - b["cindex"])
    if not bf16:
        check(dh <= h_tol,
              f"hazards fused vs unfused max |d| {dh:.3e} > {h_tol:.3e} "
              f"({HAZARD_SPREAD_TOL} x their range {spread:.3e})")
        check(dc <= c_tol, f"C-index fused {a['cindex']} vs unfused "
              f"{b['cindex']}: |d| {dc:.3e} > {c_tol:.3e}")
    log(f"fused vs unfused{tag} per-step loss rel "
        f"{['%.2e' % x for x in drift]} (step 1 tol {first_tol}, "
        + (f"step 2 {drift_tol}, later not held" if bf16
           else f"later {drift_tol}")
        + f"); fused vs fused again {['%.2e' % x for x in repeat]}; "
        f"step-1 gradients ||d|| / ||unfused||: fused stages' dW, dgamma, "
        f"dbeta at most {grad_gap[0]:.3e} ({grad_gap[1]}), the whole "
        f"gradient {grad_gap_all:.3e} (not held)"
        + (f"; each against float32 (phase 8's unfused): fused bf16 at most "
           f"{ratio['fused_f32']:.3e}, unfused bf16 {ratio['unfused_f32']:.3e}"
           f", (fused - ulp/2) / unfused at most {ratio['worst']:.3f} "
           f"({ratio['at']}; median {ratio['median']:.3f}; limit "
           f"{BF16_GRAD_RATIO})" if bf16 else "")
        + "; "
        f"hazards max |d| {dh:.3e} (fused vs fused again {dh_repeat:.3e}, "
        f"range {spread:.3e}"
        + (f"; not held in bf16)" if bf16 else
           f"; tol {h_tol:.3e}: {HAZARD_SPREAD_TOL} x range)")
        + f"; C-index |d| {dc:.3e} ({fragile} of {pairs} comparable pairs "
        f"within 2 x max |d hazard|"
        + ("; not held in bf16)" if bf16 else f"; tol {c_tol:.3e})"))
    gaps16 = None
    if bf16:
        # the bf16 paths against phase 8's float32 ones, from the same
        # weights, batches and dropout masks: each path's own rounding
        gaps16 = {}
        for k in ("fused", "unfused"):
            gaps16[k] = dict(
                loss=rel(runs[k]["losses"], f32["losses"][k]),
                grad=_grad_gap(runs[k]["probe"][1], f32["grads"][k],
                               stage_names),
                grad_all=_grad_gap_whole(runs[k]["probe"][1],
                                         f32["grads"][k]),
                hazard=float(np.abs(runs[k]["hazards"]
                                    - f32["hazards"][k]).max()))
            g = gaps16[k]
            log(f"  bf16 {k} vs float32 {k}: per-step loss rel "
                f"{['%.2e' % x for x in g['loss']]}; step-1 gradients "
                f"fused stages at most {g['grad'][0]:.3e} ({g['grad'][1]}), "
                f"the whole gradient {g['grad_all']:.3e}; hazards max |d| "
                f"{g['hazard']:.3e}")
    steady = {k: (r["epoch_ms"][-1] / (r["steps"] // epochs)
                  if r["epoch_ms"] else None) for k, r in runs.items()}
    return a["launches"], dict(
        steps=a["steps"], stages=a["stages"], loss_drift=drift,
        loss_repeat=repeat, hazard_diff=dh, hazard_repeat=dh_repeat,
        grad_gap=grad_gap, grad_gap_all=grad_gap_all, grad_ratio=ratio,
        gaps_bf16_f32=gaps16, weights0=a["weights0"],
        cindex_diff=dc, hazards={k: r["hazards"] for k, r in runs.items()},
        losses={k: r["losses"] for k, r in runs.items()},
        grads={k: runs[k]["probe"][1] for k in ("fused", "unfused")},
        ms_per_step_fused=steady["fused"],
        ms_per_step_unfused=steady["unfused"],
        profile_fused=a.get("profile"), profile_unfused=b.get("profile"))


# --------------------------------------------------------------------------
# 9: the CV slice (training CLI -> fold checkpoints -> predict_risk)
# --------------------------------------------------------------------------

CV_STANDARD_KEYS = {"model", "n_folds", "num_epochs", "dataset_size",
                    "c_index_mean", "c_index_std", "fold_results",
                    "hyperparameters"}
CV_HAZARD_MARGIN = 1e-5  # a pair this close may count either way


def _drive_cli(main, argv, device):
    """Run a training CLI's ``main(argv)`` in-process. The W-pass and fused
    launch counts are reset just before it and read just after; the W-pass
    count is read again right after the ingest (``prepare_cv_data``).
    Returns the payload, the walls, the counts (the fused kernels' per
    dtype), the driver's outcomes, the prepared arrays and splits, each
    train epoch's (ms by CUDA events, steps), each evaluation's (hazards,
    rows), and the messages the train package logged."""
    import logging

    import torch

    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train import cli, cv, engine

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    kept, epochs, messages, evals = {}, [], [], []
    prepare, run = cv.prepare_cv_data, cli.run_cross_validation
    train_epoch, evaluate = engine.Trainer.train_epoch, engine.Trainer.evaluate

    def prepare_and_keep(*a, **k):  # the ingest's wall and launches
        t = time.perf_counter()
        kept["arrays"], kept["splits"] = out = prepare(*a, **k)
        sync()
        kept["ingest_s"] = time.perf_counter() - t
        kept["ingest_launches"] = rs.wpass.launches
        return out

    def run_and_keep(*a, **k):
        payload, kept["outcomes"] = out = run(*a, **k)
        return out

    def timed_epoch(self, *a, **k):  # each epoch's ms by CUDA events
        if device != "cpu":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = train_epoch(self, *a, **k)
        ms = None
        if device != "cpu":
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        epochs.append((ms, len(self.step_losses)))
        return out

    def kept_evaluation(self, state, data, indices):
        out = evaluate(self, state, data, indices)
        evals.append((out[2], list(indices)))
        return out

    class _Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    logger = logging.getLogger(cli.__name__.rsplit(".", 1)[0])
    handler, level = _Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    cv.prepare_cv_data, cli.run_cross_validation = prepare_and_keep, \
        run_and_keep
    engine.Trainer.train_epoch = timed_epoch
    engine.Trainer.evaluate = kept_evaluation
    try:
        rs.wpass.launches = 0  # the CLI's counts start here
        fd.reset_launches()
        t0 = time.perf_counter()
        payload = main(argv)
        sync()
        wall = time.perf_counter() - t0
        fused = [k.launches for k in fd.KERNELS]  # ... and are read here
        fused_bf16 = [k.launches_bf16 for k in fd.KERNELS]
    finally:
        cv.prepare_cv_data, cli.run_cross_validation = prepare, run
        engine.Trainer.train_epoch = train_epoch
        engine.Trainer.evaluate = evaluate
        logger.removeHandler(handler)
        logger.setLevel(level)
    return dict(kept, payload=payload, wall_s=wall, fused=fused,
                fused_bf16=fused_bf16, epochs=epochs, evals=evals,
                messages=messages)


def _per_fold(outcomes, epochs, stage1_epochs=0):
    """Each fold's wall, epochs' ms (CUDA events; stage 1's first) and its
    last epoch's steps and ms/step, from ``_drive_cli``'s epoch list."""
    per_fold, i = [], 0
    for o in outcomes:
        n = stage1_epochs + o.epochs_run
        fold_epochs, i = epochs[i:i + n], i + n
        ms, steps = fold_epochs[-1]
        per_fold.append(dict(fold=o.fold, wall_s=o.wall_s, steps=steps,
                             epoch_ms=[e[0] for e in fold_epochs],
                             ms_per_step_last_epoch=(
                                 ms / steps if ms is not None else None),
                             best_epoch=o.best_epoch,
                             best_c_index=o.best_c_index))
    return per_fold


def _fold_c_index(pred, arrays, val_rows):
    """The C-index of ``pred``'s risks on a fold's validation rows, and the
    tolerance against the fold's best_c_index: the share of comparable
    pairs whose hazards lie within CV_HAZARD_MARGIN (their order may swap
    between the trainer's padded batches and predict_risk's), + 1e-6.
    Returns ``(c, tol, pairs, fragile)``."""
    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.ops.cindex import (
        concordance_index,
    )

    h = pred["risk_score"][val_rows].astype(np.float64)
    t = arrays.arrays["time"][val_rows]
    e = arrays.arrays["event"][val_rows]
    v = arrays.arrays["svalid"][val_rows]
    c = float(concordance_index(torch.from_numpy(h).float(), t, e, valid=v))
    pairs, fragile = _comparable_pairs(t, e, v, h, CV_HAZARD_MARGIN)
    return c, fragile / max(pairs, 1) + 1e-6, pairs, fragile


def phase_cv(work, table, paths, n_img, smi="", device="cuda", extra_argv=(),
             expect_launches=True):
    """The partial_modality training CLI's ``main(argv)`` in-process on the
    phase-4 cohort: ingest through the W-pass kernel, 2 folds x 2 epochs,
    fold checkpoints, cv_results.json; then ``predict_risk`` on each fold
    checkpoint and on the fold ensemble. The W-pass launch count is reset
    just before the CLI runs and read just after its ingest, again around
    each predict_risk. Returns the phase's numbers."""
    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY as CFG,
    )
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.io.results import (
        load_cv_results,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train import (
        partial_modality_training as pmt,
    )
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        fold_checkpoints,
        predict_risk,
    )

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    results, models = work / "cv_results", work / "cv_models"
    argv = ["--data-root", str(paths["root"]), "--results-dir", str(results),
            "--models-dir", str(models), "--pallas-resample", "--n-folds",
            "2", "--epochs", "2", "--device", device, *extra_argv]
    run = _drive_cli(pmt.main, argv, device)
    payload, wall, fused = run["payload"], run["wall_s"], run["fused"]
    arrays, splits = run["arrays"], run["splits"]
    ingest = run["ingest_launches"]
    per_fold = _per_fold(run["outcomes"], run["epochs"])
    tf32 = [m for m in run["messages"] if "allow_tf32" in m]
    log(f"CV (train/partial_modality_training.py main, {smi}): wall "
        f"{wall:.2f} s, ingest {run['ingest_s']:.2f} s with "
        f"{ingest} W-pass launches for {n_img} imaging patients; fused "
        f"kernel launches {fused}; TF32 log {tf32}")
    for f in per_fold:
        log(f"  fold {f['fold']}: wall {f['wall_s']:.2f} s; epoch ms "
            f"{f['epoch_ms']}; epoch 2: {f['steps']} steps, "
            f"{f['ms_per_step_last_epoch']} ms/step; best C-index "
            f"{f['best_c_index']:.6f} @ epoch {f['best_epoch']}")
    check(ingest == (n_img if expect_launches else 0),
          f"the CV ingest launched the W-pass kernel {ingest} times, "
          f"expected one per imaging patient ({n_img})")
    check(fused == [0] * len(fused),
          f"the CV driver's unfused model launched fused kernels: {fused}")
    check(len(tf32) == 1 and "matmul.allow_tf32=False" in tf32[0]
          and "cudnn.allow_tf32=False" in tf32[0],
          f"the CLI did not log both TF32 flags off: {tf32}")
    loaded = load_cv_results(results / CFG.name)
    check(set(loaded["raw"]) == CV_STANDARD_KEYS and loaded["raw"] == payload
          and len(payload["fold_results"]) == 2,
          f"cv_results.json does not carry the standard schema: "
          f"{sorted(loaded['raw'])}")
    ckpts = fold_checkpoints(models, CFG.name)
    check([c.name for c in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"],
          f"fold checkpoints {ckpts}")

    scored = []
    for ckpt, fold, (_, val_rows, _) in zip(ckpts, per_fold, splits):
        meta = load_fold_meta(ckpt)
        check(meta is not None and meta["use_pallas_resample"] is True
              and meta["resample_mode"] == "device",
              f"{ckpt.name}.meta.json: {meta}")
        rs.wpass.launches = 0
        pred = predict_risk(CFG, ckpt, table, rnaseq_csv=paths["rnaseq_csv"],
                            labeled_only=False, device=device)
        sync()
        launches = rs.wpass.launches
        check(launches == (n_img if expect_launches else 0),
              f"predict_risk on {ckpt.name} launched the W-pass kernel "
              f"{launches} times, expected {n_img}")
        check(list(pred["patient_id"]) == list(arrays.patient_ids),
              "predict_risk's patients are not the CV cohort's")
        c, tol, pairs, fragile = _fold_c_index(pred, arrays, val_rows)
        dc = abs(c - fold["best_c_index"])
        log(f"predict_risk on {ckpt.name}: {launches} W-pass launches; "
            f"C-index on the fold's {len(val_rows)} validation patients "
            f"{c:.6f} vs the fold's best_c_index {fold['best_c_index']:.6f}"
            f" (|d| {dc:.3e}, tol {tol:.3e}: {fragile} of {pairs} "
            f"comparable pairs within {CV_HAZARD_MARGIN})")
        check(dc <= tol, f"predict_risk on {ckpt.name} gives C-index {c} on "
              f"the fold's validation patients, the fold's best_c_index is "
              f"{fold['best_c_index']}")
        scored.append(launches)
    rs.wpass.launches = 0
    ensemble = predict_risk(CFG, ckpts, table, rnaseq_csv=paths["rnaseq_csv"],
                            labeled_only=False, device=device)
    sync()
    scored.append(rs.wpass.launches)
    check(np.all(np.isfinite(ensemble["risk_score"]))
          and ensemble["risk_score"].shape == (len(table),),
          f"fold-ensemble risks not finite: {ensemble['risk_score']}")
    log(f"fold ensemble over {len(ckpts)} checkpoints: {scored[-1]} W-pass "
        f"launches; risks {np.round(ensemble['risk_score'], 4).tolist()}")
    return dict(wall_s=wall, ingest_s=run["ingest_s"],
                ingest_launches=ingest, predict_launches=scored,
                fused_launches=dict(zip(FUSED_NAMES, fused)),
                folds=per_fold, c_index_mean=payload["c_index_mean"])


# --------------------------------------------------------------------------
# 9b: the --bf16 training CLI (bf16 compute, float32 checkpoints)
# --------------------------------------------------------------------------

BF16_CLI_ENTRIES = (("partial_modality", "partial_modality_training"),
                    ("rnaseq_only", "train_rnaseq_only"))


def phase_cli_bf16(work, table, paths, n_img, smi="", device="cuda",
                   extra_argv=(), expect_launches=True):
    """``partial_modality_training --bf16`` and ``train_rnaseq_only --bf16``
    in-process on the phase-4 cohort, ``--pallas-resample --n-folds 2
    --epochs 1``: the W-pass kernel in the ingest (one launch per imaging
    patient; none for rnaseq_only), no fused kernel of either dtype (the
    driver trains unfused, as JAX's); cv_results.json and both fold
    checkpoints, float32, whose .meta.json names no dtype. Then
    ``predict_risk`` (float32, as JAX scores them) on each fold checkpoint:
    its C-index on the fold's validation patients equals the fold's
    best_c_index except for the comparable pairs whose float32 hazards lie
    within twice the fold's bf16-vs-f32 hazard gap (the largest |d| between
    the bf16 hazards the driver evaluated and predict_risk's, each side of
    a pair moving by at most that gap). Returns each entry's numbers."""
    import importlib

    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_checkpoint,
        load_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.io.results import (
        load_cv_results,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        fold_checkpoints,
        predict_risk,
    )

    t_phase = time.perf_counter()
    out = {}
    for name, entry in BF16_CLI_ENTRIES:
        cfg = ALL_CONFIGS[name]
        main = importlib.import_module(
            f"multimodal_survival_prediction_tpu_torch.train.{entry}").main
        results, models = work / "bf16_results", work / "bf16_models"
        argv = ["--data-root", str(paths["root"]), "--results-dir",
                str(results), "--models-dir", str(models),
                "--pallas-resample", "--n-folds", "2", "--epochs", "1",
                "--bf16", "--device", device, *extra_argv]
        run = _drive_cli(main, argv, device)
        payload, arrays, splits = run["payload"], run["arrays"], run["splits"]
        want_ingest = (n_img if "image" in cfg.modalities
                       and expect_launches else 0)
        tf32 = [m for m in run["messages"] if "allow_tf32" in m]
        log(f"CLI {entry} --bf16 ({smi}): wall {run['wall_s']:.2f} s, "
            f"ingest {run['ingest_s']:.2f} s with {run['ingest_launches']} "
            f"W-pass launches; fused launches float32 {run['fused']}, bf16 "
            f"{run['fused_bf16']}; epoch ms {[e[0] for e in run['epochs']]}")
        check(run["ingest_launches"] == want_ingest,
              f"{entry} --bf16: {run['ingest_launches']} W-pass launches in "
              f"the ingest, expected {want_ingest}")
        check(run["fused"] == [0] * 4 and run["fused_bf16"] == [0] * 4,
              f"{entry} --bf16: the unfused driver launched fused kernels "
              f"{run['fused']} / {run['fused_bf16']}")
        check(len(tf32) == 1 and "matmul.allow_tf32=False" in tf32[0]
              and "cudnn.allow_tf32=False" in tf32[0],
              f"{entry} --bf16 did not log both TF32 flags off: {tf32}")
        loaded = load_cv_results(results / name)
        check(loaded["raw"] == payload and len(payload["fold_results"]) == 2
              and all(math.isfinite(f["best_c_index"])
                      for f in payload["fold_results"]),
              f"{entry} --bf16: cv_results.json {loaded['raw']}")
        ckpts = fold_checkpoints(models, name)
        check([c.name for c in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"],
              f"{entry} --bf16: fold checkpoints {ckpts}")
        check(len(run["evals"]) == 2, f"{entry} --bf16: evaluations "
              f"{len(run['evals'])}, expected one per fold")
        folds = []
        for ckpt, fold, (_, val_rows, _), (h16, rows) in zip(
                ckpts, payload["fold_results"], splits, run["evals"]):
            weights = load_checkpoint(ckpt)
            meta = load_fold_meta(ckpt)
            check(all(t.dtype == torch.float32 for t in weights.values()
                      if t.is_floating_point()) and "dtype" not in meta,
                  f"{ckpt}: not a float32 checkpoint ({meta})")
            rs.wpass.launches = 0
            pred = predict_risk(cfg, ckpt, table,
                                rnaseq_csv=paths["rnaseq_csv"],
                                labeled_only=False, device=device)
            check(rows == list(val_rows), f"{entry}: evaluated rows {rows}")
            ids = list(arrays.patient_ids)
            at = [list(pred["patient_id"]).index(ids[r]) for r in val_rows]
            h32 = pred["risk_score"][at].astype(np.float64)
            gap = float(np.abs(h32 - np.asarray(h16, np.float64)).max())
            t = arrays.arrays["time"][val_rows]
            e = arrays.arrays["event"][val_rows]
            v = arrays.arrays["svalid"][val_rows]
            from multimodal_survival_prediction_tpu_torch.ops.cindex import (
                concordance_index,
            )
            c = float(concordance_index(torch.from_numpy(h32).float(), t, e,
                                        valid=v))
            pairs, fragile = _comparable_pairs(t, e, v, h32, 2 * gap)
            tol = fragile / max(pairs, 1) + 1e-6
            dc = abs(c - fold["best_c_index"])
            log(f"  {entry} --bf16 {ckpt.name}: predict_risk (float32) "
                f"C-index {c:.6f} vs best_c_index {fold['best_c_index']:.6f} "
                f"(|d| {dc:.3e}, tol {tol:.3e}: {fragile} of {pairs} "
                f"comparable pairs within 2 x the bf16-vs-f32 hazard gap "
                f"{gap:.3e}); {rs.wpass.launches} W-pass launches")
            check(dc <= tol, f"{entry} --bf16 {ckpt.name}: C-index {c} from "
                  f"the checkpoint, best_c_index {fold['best_c_index']}")
            folds.append(dict(fold=fold["fold"], c_index=c,
                              best_c_index=fold["best_c_index"],
                              hazard_gap=gap, pairs=pairs, fragile=fragile))
        out[name] = dict(wall_s=run["wall_s"], ingest_s=run["ingest_s"],
                         ingest_launches=run["ingest_launches"],
                         fused_bf16=run["fused_bf16"],
                         epoch_ms=[e[0] for e in run["epochs"]],
                         folds=folds)
    log(f"--bf16 CLIs ({smi}): the phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    return out


# --------------------------------------------------------------------------
# 10: the seven other families (training CLIs -> fold checkpoints ->
#     predict_risk and RiskScorer)
# --------------------------------------------------------------------------

# family -> its entry point under multimodal_survival_prediction_tpu_torch/train
FAMILY_ENTRIES = {
    "rnaseq_only": "train_rnaseq_only", "image_only": "image_only",
    "simple_fusion": "simple_fusion",
    "flexible_multimodal": "flexible_multimodal",
    "final": "final_multimodal", "simmim": "simmlm", "mmsurv": "mmsurv",
}
# 32 patients; seed 15 gives every family comparable pairs in both folds
# and one labeled patient with no CT, no RNA and no age (mmsurv's check)
FAMILY_COHORT = dict(n_patients=32, seed=15, p_imaging=0.75, p_rnaseq=0.9,
                     p_dead=0.75, image_dtype="int16", compress=False)
FAMILY_CT_SHAPES = ((64, 256, 256), (48, 256, 256), (56, 256, 256))
# RiskScorer scores, one at a time, the first patients of each modality
# pattern (which of CT, RNA and age a patient has) in the family's cohort
FAMILY_SCORED_PER_PATTERN = 4


def phase_families(work, smi="", device="cuda", image_shapes=FAMILY_CT_SHAPES,
                   extra_argv=(), expect_launches=True):
    """Each of the seven other families' training CLI ``main(argv)``
    in-process on one 32-patient cohort at full width (5,005 genes),
    2 folds x 1 epoch (simmlm after one stage-1 epoch), then
    ``predict_risk`` on each fold checkpoint and on the ensemble, and
    ``RiskScorer`` on the fold checkpoints, one patient at a time. Returns
    each family's numbers."""
    import importlib

    from multimodal_survival_prediction_tpu_torch.data.synthetic import (
        SyntheticCohortSpec,
        generate_synthetic_cohort,
    )

    t0 = time.perf_counter()
    table, paths = generate_synthetic_cohort(
        work / "families", SyntheticCohortSpec(
            rna_dim=5005, image_shapes=image_shapes, **FAMILY_COHORT))
    log(f"families cohort: {len(table)} patients, "
        f"{sum(bool(r['has_imaging']) for r in table)} int16 CTs "
        f"{list(image_shapes)}, rna_dim 5005, "
        f"{sum(bool(r['has_survival']) for r in table)} labeled "
        f"({time.perf_counter() - t0:.1f} s)")
    out = {}
    for name, entry in FAMILY_ENTRIES.items():
        main = importlib.import_module(
            f"multimodal_survival_prediction_tpu_torch.train.{entry}").main
        out[name] = _one_family(name, entry, main, work, table, paths, smi,
                                device, extra_argv, expect_launches)
    walls = {k: round(v["wall_s"], 2) for k, v in out.items()}
    log(f"families ({smi}): CLI walls s {walls}, together "
        f"{sum(walls.values()):.2f} s; the phase (cohort, CLIs, scoring) "
        f"{time.perf_counter() - t0:.2f} s")
    return out


def _one_family(name, entry, main, work, table, paths, smi, device,
                extra_argv, expect_launches):
    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.data.datasets import (
        load_rnaseq_matrix,
        select_cohort,
    )
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.io.results import (
        load_cv_results,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.serving import RiskScorer
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        fold_checkpoints,
        predict_risk,
    )

    cfg = ALL_CONFIGS[name]
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    has_image = "image" in cfg.modalities
    n_img = (sum(bool(r["has_imaging"]) and bool(r["nifti_path"])
                 for r in select_cohort(table, name)) if has_image else 0)
    want = n_img if expect_launches else 0
    results, models = work / "families_results", work / "families_models"
    stage1 = ["--stage1-epochs", "1"] if cfg.stage1_epochs else []
    argv = ["--data-root", str(paths["root"]), "--results-dir", str(results),
            "--models-dir", str(models), "--pallas-resample", "--n-folds",
            "2", "--epochs", "1", "--device", device, *stage1, *extra_argv]
    run = _drive_cli(main, argv, device)
    payload, arrays, splits = run["payload"], run["arrays"], run["splits"]
    per_fold = _per_fold(run["outcomes"], run["epochs"], len(stage1) // 2)
    check(run["ingest_launches"] == want,
          f"{name}: the ingest launched the W-pass kernel "
          f"{run['ingest_launches']} times, expected {want} (one per imaging "
          f"patient of its cohort)")
    check(run["fused"] == [0] * len(run["fused"]),
          f"{name}: the driver launched fused kernels: {run['fused']}")
    keys = (CV_STANDARD_KEYS if name != "image_only"  # the reference's
            else CV_STANDARD_KEYS - {"model", "hyperparameters"})  # legacy
    loaded = load_cv_results(results / name)
    check(set(loaded["raw"]) == keys and loaded["raw"] == payload
          and len(payload["fold_results"]) == 2,
          f"{name}: cv_results.json keys {sorted(loaded['raw'])}")
    ckpts = fold_checkpoints(models, name)
    check([c.name for c in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"]
          and all(load_fold_meta(c) is not None for c in ckpts),
          f"{name}: fold checkpoints {ckpts}")
    if cfg.stage1_epochs:
        msgs = run["messages"]
        for fold in (1, 2):
            s1 = [j for j, m in enumerate(msgs)
                  if m.startswith(f"[{name} fold {fold}] stage1 epoch 1 ")]
            s2 = [j for j, m in enumerate(msgs)
                  if m.startswith(f"[{name} fold {fold}] epoch 1 ")]
            check(s1 and s2 and s1[0] < s2[0],
                  f"{name} fold {fold}: no stage-1 epoch logged before the "
                  f"main epoch: {msgs}")

    walls = {}
    t0 = time.perf_counter()
    fold_c, raw = [], []
    for ckpt, fold, (_, val_rows, _) in zip(ckpts, per_fold, splits):
        rs.wpass.launches = 0
        pred = predict_risk(cfg, ckpt, table, rnaseq_csv=paths["rnaseq_csv"],
                            labeled_only=False, device=device)
        sync()
        check(rs.wpass.launches == want,
              f"{name}: predict_risk on {ckpt.name} launched the W-pass "
              f"kernel {rs.wpass.launches} times, expected {want}")
        check(list(pred["patient_id"]) == list(arrays.patient_ids),
              f"{name}: predict_risk's patients are not the CV cohort's")
        c, tol, pairs, fragile = _fold_c_index(pred, arrays, val_rows)
        dc = abs(c - fold["best_c_index"])
        check(pairs > 0, f"{name} fold {fold['fold']}: no comparable pair")
        check(dc <= tol, f"{name}: predict_risk on {ckpt.name} gives "
              f"C-index {c}, the fold's best_c_index is "
              f"{fold['best_c_index']} (tol {tol})")
        fold_c.append((c, fold["best_c_index"], pairs, fragile))
        raw.append(pred["risk_score"])

    walls["predict_risk x2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred, stats = predict_risk(cfg, ckpts, table,
                               rnaseq_csv=paths["rnaseq_csv"],
                               labeled_only=False, return_fold_stats=True,
                               device=device)
    walls["ensemble"] = time.perf_counter() - t0
    risk = pred["risk_score"]
    check(np.all(np.isfinite(risk)), f"{name}: ensemble risks {risk}")
    none = np.nonzero(arrays.arrays["mask"].sum(1) == 0)[0]
    if name == "mmsurv":
        check(len(none) > 0 and np.all(np.isfinite(risk[none])),
              f"{name}: patients with no modality {none.tolist()}, risks "
              f"{risk[none].tolist()}")

    # RiskScorer, one patient at a time, on up to FAMILY_SCORED_PER_PATTERN
    # patients of each modality pattern of the cohort (every pattern with a
    # modality), against the ensemble. The two ingests differ in the
    # last bits (the server's plain bucketed resample, the kernel's), and
    # the fold z-score divides each fold's log-hazard by its spread over
    # this 2-fold cohort, which one epoch can leave small: the limit is
    # RISK_TOL on the log-hazard, carried through that z-score.
    t0 = time.perf_counter()
    scorer = RiskScorer(name, ckpts, fold_calibration=stats, device=device)
    rows = {r["patient_id"]: r for r in table}
    rna = load_rnaseq_matrix(paths["rnaseq_csv"])
    mask = arrays.arrays["mask"]
    by_pattern = {}
    for i in np.nonzero(mask.sum(1) > 0)[0]:
        by_pattern.setdefault(tuple(mask[i] > 0), []).append(i)
    idx = np.sort(np.concatenate([v[:FAMILY_SCORED_PER_PATTERN]
                                  for v in by_pattern.values()]))
    patients = []
    for i in idx:
        row = rows[pred["patient_id"][i]]
        patient = {}
        if mask[i, 0]:
            patient["nifti_path"] = row["nifti_path"]
        if mask[i, 1]:
            patient["rnaseq"] = rna.row(row["patient_id"])
        if mask[i, 2]:
            patient["age"] = row["age"]
        patients.append(patient)
    scored = np.asarray([r["risk_score"] for r in scorer.score_many(patients)])
    walls["RiskScorer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_z = np.abs(scored - risk[idx])
    sds = np.asarray([sd for _, sd in stats]) + 1e-8
    per_raw = float(np.mean(1.0 / sds))  # d(z-scored risk) / d(log-hazard)
    limit = RISK_TOL * per_raw
    worst = int(np.argmax(d_z))
    check(d_z[worst] <= limit,
          f"{name}: RiskScorer {scored[worst]} vs predict_risk ensemble "
          f"{risk[idx[worst]]} for {pred['patient_id'][idx[worst]]}: |d| "
          f"{d_z[worst]} over the limit {limit} (RISK_TOL {RISK_TOL} on the "
          f"log-hazard, fold sds {sds.tolist()})")
    # the per-fold log-hazards themselves, without the z-score
    raw_scorer = RiskScorer(name, ckpts[:1], device=device)
    d_raw = np.abs(np.asarray([r["risk_score"] for r in
                               raw_scorer.score_many(patients)])
                   - raw[0][idx])
    check(float(d_raw.max()) <= RISK_TOL,
          f"{name}: RiskScorer's fold-1 log-hazards differ from "
          f"predict_risk's by up to {d_raw.max()} (RISK_TOL {RISK_TOL})")
    walls["RiskScorer fold 1"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in scorer.models[0].parameters())

    log(f"{name} (train/{entry}.py main, {smi}): {n_params} parameters; "
        f"CLI wall {run['wall_s']:.2f} s, ingest {run['ingest_s']:.2f} s "
        f"with {run['ingest_launches']} W-pass launches for {n_img} imaging "
        f"patients of {arrays.n}; no fused launch")
    for f, (c, best, pairs, fragile) in zip(per_fold, fold_c):
        log(f"  fold {f['fold']} ({smi}): wall {f['wall_s']:.2f} s; epoch ms "
            f"{f['epoch_ms']} (CUDA events{', stage 1 first' if stage1 else ''}"
            f"); last epoch {f['steps']} steps, "
            f"{f['ms_per_step_last_epoch']} ms/step; C-index from the "
            f"checkpoint {c:.6f} vs best_c_index {best:.6f} ({pairs} "
            f"comparable pairs, {fragile} within {CV_HAZARD_MARGIN})")
    log(f"  RiskScorer on both folds, {len(idx)} patients one at a time "
        f"(up to {FAMILY_SCORED_PER_PATTERN} of each of the "
        f"{len(by_pattern)} modality patterns of "
        f"{sum(len(v) for v in by_pattern.values())} patients with a "
        f"modality) ({smi}): max |d| against the ensemble "
        f"{d_z[worst]:.3e} z-scored "
        f"({d_z[worst] / per_raw:.3e} on the log-hazard, "
        f"{100 * d_z[worst] / limit:.1f} % of the limit {limit:.3e} = "
        f"RISK_TOL {RISK_TOL} x mean(1/sd), fold sds "
        f"{[round(float(v), 6) for v in sds]}); fold 1 alone, no z-score: "
        f"max |d| {d_raw.max():.3e} (tol {RISK_TOL}); {len(none)} patients "
        f"with no modality, risks {np.round(risk[none], 4).tolist()}; "
        f"scoring walls s {({k: round(v, 2) for k, v in walls.items()})}")
    return dict(n_params=n_params, wall_s=run["wall_s"],
                ingest_s=run["ingest_s"], scorer_max_d=float(d_z[worst]),
                scorer_max_d_logh=float(d_z[worst] / per_raw),
                scorer_raw_max_d=float(d_raw.max()),
                ingest_launches=run["ingest_launches"], folds=per_fold,
                c_index_mean=payload["c_index_mean"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    walls = {}

    def timed(label, fn, *a, **k):  # each phase's wall, logged at the end
        t0 = time.perf_counter()
        out = fn(*a, **k)
        walls[label] = round(time.perf_counter() - t0, 2)
        return out

    smi = timed("1 device", phase_device)
    timed("2 build", phase_build)
    max_err, timing = timed("3 kernel vs plain", phase_kernel_vs_plain)
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        table, paths, ckpt, n_img = timed(
            "4 cohort", phase_cohort, work,
            ((96, 512, 512), (128, 512, 512), (97, 500, 500)), 5005)
        pred, launches = timed("5 predict", phase_predict, table, paths,
                               ckpt, n_img)
        timed("6 server", phase_server, table, paths, ckpt, pred)
        fused_err, fused_timing = timed("7 fused", phase_fused_vs_plain)
        bf16_err, bf16_timing = timed("7b fused bf16",
                                      phase_fused_bf16_vs_plain)
        fused_launches, train = timed("8 train", phase_train, table, paths,
                                      5005)
        bf16_launches, train_bf16 = timed(
            "8b train bf16", phase_train, table, paths, 5005,
            dtype=torch.bfloat16, f32=train)
        cv_run = timed("9 cv", phase_cv, work, table, paths, n_img, smi=smi)
        cli_bf16 = timed("9b cli bf16", phase_cli_bf16, work, table, paths,
                         n_img, smi=smi)
        families = timed("10 families", phase_families, work, smi=smi)
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
        "launches_by_path": {
            "predict_risk": launches,
            "cv_ingest": cv_run["ingest_launches"],
            "cv_predict_risk": cv_run["predict_launches"],
            "families_ingest": {k: v["ingest_launches"]
                                for k, v in families.items()}},
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
            "launches_by_path": {
                "train": fused_launches[name],
                "cv": cv_run["fused_launches"][name]},
            "call_ms": t["call_ms"],
            "timed_shape": t["shape"],
            "bound_cuda_core_ms": t["bound_cuda_core_ms"],
            "by_shape": t["by_shape"],
            "train_step": dict(train["profile_fused"]["fused"][name],
                               whole_trace=train["profile_fused"]["whole"]),
        })
    for name in FUSED_NAMES:
        t = bf16_timing[name]
        kernels.append({
            "name": f"fused_dense_{name}_bf16",
            "route": "cuda",
            "source": "multimodal_survival_prediction_tpu_torch/ops/csrc/"
                      "fused_dense.cu",
            "replaces": FUSED_REPLACES[name],
            "launches": bf16_launches[name],
            "max_abs_err": bf16_err[name],
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": FUSED_BF16_LIBRARY[name],
            "launches_by_path": {
                "train_bf16": bf16_launches[name],
                "cli_bf16": sum(v["fused_bf16"][FUSED_NAMES.index(name)]
                                for v in cli_bf16.values())},
            "call_ms": t["call_ms"],
            "timed_shape": t["shape"],
            "by_shape": t["by_shape"],
            "train_step": dict(
                train_bf16["profile_fused"]["fused"][name],
                whole_trace=train_bf16["profile_fused"]["whole"]),
        })
    log(f"bf16 training: ms/step fused {train_bf16['ms_per_step_fused']}, "
        f"unfused {train_bf16['ms_per_step_unfused']} (float32: "
        f"{train['ms_per_step_fused']}, {train['ms_per_step_unfused']}); "
        f"--bf16 CLI walls s "
        f"{ {k: round(v['wall_s'], 2) for k, v in cli_bf16.items()} }")
    log(f"phase walls s {walls}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
