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
  9c. fold-parallel, streaming, sweep (run right after phase 9, on its
     cohort and arguments): the partial_modality CLI's main([...,
     "--fold-parallel", "1", "--epochs", "2"]) trains both folds in one
     vmapped step (train/cv_parallel.py); W-pass launches in the ingest =
     imaging patients, no fused launch, cv_results.json in the standard
     schema, both .pt folds with a .meta.json pinning use_pallas_resample,
     each fold's learning rates equal to phase 9's, its per-step losses
     held to phase 9's by phase 8's rule (step 1 within 1e-5 relative,
     later steps within 2e-2), and predict_risk on each .pt reproducing
     its best_c_index. Then the sequential CLI with --streaming for one
     epoch (losses held to phase 9's epoch 1; every batch copied on the
     prefetcher's side stream), the fold-parallel CLI with --streaming for
     one epoch (losses held to the device-resident vmapped run's epoch 1;
     every stacked train and eval batch copied on the side stream) and the
     sweep CLI (seeds 42, 43 x lrs base,
     3 x base, one epoch on fold 1; 4 candidates in sweep_results.json,
     the (42, base) one held to phase 9's fold-1 epoch 1). Prints the
     walls, each vmapped epoch's ms by CUDA events beside the sum of phase
     9's two folds', fold-steps per second of both drivers, and a profile
     (device busy, launches, top kernels) of one vmapped two-fold step
     beside one sequential step.
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
  11. checkpoints: phase 9's two partial_modality folds and fold 1 of each
     of phase 10's seven families, each written as .msgpack by the port's
     writer (its .meta.json copied), exported to a reference .pth with
     tools/export_torch_checkpoint (not mmsurv, which has no reference
     layout) and converted back to .pt with tools/convert_torch_checkpoint;
     predict_risk on every format (use_pallas=True for the converted one,
     whose meta says false as JAX's tool writes it): log-hazards within
     1e-6 of the .pt's, W-pass launches a call equal to the imaging
     patients. Then tools/calibrate on the two-fold .msgpack ensemble and
     RiskScorer with that calibration, one patient at a time, against
     predict_risk's ensemble as phase 10 holds it; a freshly built server
     (it warms itself in its constructor) and its first three /score
     calls, timed and printed; analysis.generate_km_curves then
     analysis.evaluate_model on phase 9's cohort: evaluation_summary.json
     with JAX's keys, its c_index equal to concordance_index_np on the
     predictions CSV within 1e-12, numbers finite or null exactly where
     JAX writes null. Prints the phase's wall.
  12. host ingest engine and both ends of the pipeline: builds the host
     C++ engine (csrc/msp_native.cpp, g++ -O3 -march=native; prints the
     compiler, whether zlib was found and the build seconds; a failed
     build ends the run). The phase-4 CTs through resample='host' (0
     W-pass launches), 'device' with the kernel (one a CT) and 'auto'
     (the link probe's MB/s, the host and link ms for the probe volume,
     the mode it chose; its cohort bit-equal to that mode's run): host vs
     kernel within 2e-5 per volume; read_nifti_fast under MSP_NATIVE_IO=1
     bit-equal to read_nifti on the .nii files and a .nii.gz slab. Phase
     9's fold 1 copied with a .meta.json pinning resample_mode "host":
     predict_risk makes 0 W-pass launches and agrees with the
     device-ingest scoring within 1e-4, RiskScorer.score (decoded by
     read_nifti_fast) with it within 1e-4. Then raw to report: a 16-slice
     DICOM series at 512x512 for each imaging patient and STAR TSVs for
     all 12, the two preprocessing entry points, the matching table, and
     run_all --models rnaseq_only,partial_modality --n-folds 2 --epochs 1
     --pallas-resample --profile-dir (full width): W-pass launches = the
     imaging patients, no fused launch, both cv_results.json with 2 folds,
     SUMMARY.md and results.json with the payloads' means, a trace per
     family (partial_modality's naming wpass_kernel); each step's wall.
  13. multi-device on one card: a torch.distributed process group of one
     rank under NCCL (init_method file:// under build/, device_id cuda:0),
     then phase 9's CLI with --mesh 1 --sharded-risk-set in-process (the
     group exists, so it runs there on a (1, 1) DeviceMesh: BatchNorm sums,
     the gathered outputs and labels, the sharded Cox scan and the
     gradients' all-reduce all go through NCCL collectives): per-step
     losses held to phase 9's (step 1 within 1e-5 relative, later ones
     within LOSS_DRIFT_RTOL), W-pass launches = imaging patients in the
     ingest, no fused launch, collectives counted on every step (the count
     reset just before the CLI), cv_results.json written once, each fold
     checkpoint loaded strictly into the single-device model and the
     ensemble's risks finite; then parallel/dryrun.py's
     dryrun_multichip(1) on that group against the single-device
     Trainer's step (loss within 1e-5 relative). Prints the phase's wall,
     epoch-2 ms/step by CUDA events beside phase 9's, epoch 2's host
     ms/step and garbage-collector pauses beside phase 9's, the
     collectives a step, the host microseconds of one all-reduce of a
     BatchNorm's sums, and a profile (wall, device busy, launches, top
     kernels; then the ops with the most self host time) of one step on
     the mesh of one beside one step on one device. More than one rank
     needs more than one GPU (NCCL puts no two ranks on one): the
     multi-rank arithmetic is held on the CPU under gloo by
     tests/test_torch_{cox_distributed,parallel,tensor_parallel,
     multidevice_cli}.py.
  14. the fold mesh and remat. (a) The partial_modality CLI with phase 9's
     arguments and --fold-parallel 2 --remat, then --fold-parallel 4
     --fold-dp 2 --remat, its ranks a gloo group on this one card (NCCL
     puts no two ranks on one GPU; gloo copies CUDA tensors through the
     host), each rank running main(argv) in its own process: each fold's
     step-1 loss within 1e-6 of phase 9c's vmapped run and alike across
     its data group, the W-pass kernel in every rank's ingest, no fused
     kernel, cv_results.json written once (rank 0), two folds loaded
     strictly and scored by predict_risk; prints each rank's collectives
     and each fold's ms per step. (b) The flagship Trainer at full width,
     unfused and fused_bn1, without remat, with it and without again, at
     batch 8 and 32: step 1's loss bit-equal with and without remat, the
     step-1 gradient no further from the plain one than twice the plain
     step's own repeat (||d|| / ||g|| over every parameter: cuDNN's
     backward does not repeat bit for bit); three steps' ms and peak
     torch.cuda.max_memory_allocated each; the fused kernels' launches a
     step with remat = the JAX jaxpr's pallas_call count (moments and
     apply at 61 + 58, bwd_reduce and bwd_dx at 61).
  14c. fused_bn1 with dropout: DenseNet121-3D(fused_bn1=True, dropout=0.2)
     at full width (batch 8, 64x64x32), fused against unfused from the
     same weights, input and dropout uniforms: step 1's loss within 1e-5
     relative (phase 8's limit), each fused kernel once a stage on the
     fused side and never on the unfused one, the whole gradient's gap
     printed beside phase 8's; then two folds in one vmap(grad_and_value)
     step, each fold's loss held alike and the kernels launched once a
     stage and a fold.
  15. the serving demo: python -m ...demo_e2e --device cuda at full width
     (DenseNet121-3D 64x64x32, 5,005 genes, 2 folds x 1 epoch, requests
     of 8) on the phase-4 cohort in a fresh process: its artifacts
     (serving_summary.json with JAX's keys), each served risk against
     predict_risk's per-fold log-hazards z-scored by calibration.json
     (RISK_TOL on the log-hazard), the figure-skip line where matplotlib
     is missing; prints the demo's walls (train, calibrate, serve,
     evaluate). It reaches no hand-written kernel (plain ingest, as JAX's).
  16. the kernel-build cache (io/aot_cache.py): two fresh processes
     (python3 chip_smoke.py --cache-worker ...) share one empty cache
     directory; each loads the seven nvcc libraries through it, launches
     each kernel once against its plain version and runs the CV CLI with
     --aot-cache --pallas-resample for one epoch of two folds. The first
     reports compile (seven nvcc), the second cache (no nvcc); ingest
     arrays, step-1 losses and kernel outputs bit-equal between the two;
     the miss's and the hit's seconds.
  17. summary: one JSON line of per-kernel numbers, then the final line
     {"ok": true, "device": {...}}.

Everything it writes goes under build/ in this checkout (kernel build,
temporary cohort); the cohort is removed at the end.
"""

from __future__ import annotations

import gc
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

# --------------------------------------------------------------------------
# 13: multi-device on one card (NCCL at world size 1)
# --------------------------------------------------------------------------

MESH_LOSS_RTOL = 1e-5  # the dry run's step on a mesh of one vs one device


def _collective_host_us(group, device, calls=200):
    """Host microseconds a call of ``collectives.all_reduce_tensor`` on a
    BatchNorm's (2C + 1,) sums (C = 128) takes in ``group``: ``calls``
    back to back after 10 outside the window, one synchronize at the
    end."""
    import torch

    from multimodal_survival_prediction_tpu_torch.parallel import (
        collectives,
    )

    x = torch.ones(257, device=device)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    for _ in range(10):
        collectives.all_reduce_tensor(x, group)
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        collectives.all_reduce_tensor(x, group)
    sync()
    return (time.perf_counter() - t0) / calls * 1e6


def _host_top(fn, label, top=6):
    """One call of ``fn`` (after one outside the window) under
    torch.profiler's CPU activity: the ops with the most self host time,
    logged. Returns ``[(op, self host ms, calls), ...]``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:top]
    rows = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in ops]
    log(f"host profile {label}: " + "; ".join(
        f"{k} {ms:.1f} ms x{n}" for k, ms, n in rows))
    return rows


def _profile_mesh_step(arrays, splits, device):
    """One train step (lr 0) of the CV driver's model on the phase-4
    cohort's first batch with the mesh of one and the sharded risk set,
    then without a mesh, each profiled as phase 9c profiles its steps, and
    the ops with the most self host time in each."""
    import numpy as np

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY as CFG,
    )
    from multimodal_survival_prediction_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from multimodal_survival_prediction_tpu_torch.train.cv import (
        make_trainers,
    )

    rna_dim = arrays.arrays["rnaseq"].shape[1]
    data = arrays.to_device(device)
    out = {}
    for label, kw in (("mesh of one", dict(mesh=make_mesh(1, device=device),
                                          sharded_risk_set=True)),
                      ("one device", {})):
        tr = make_trainers(CFG, rna_dim, "densenet121", None, device, **kw)[0]
        perm, bvalid = tr._pad_indices(splits[0][0], CFG.batch_size,
                                       np.random.default_rng(0))
        batch = next(tr._device_batches(data, perm, bvalid))
        state = tr.init_state(fold=1)
        out[label] = _profile_once(lambda: tr.train_step(state, batch, 0.0),
                                   f"step on the {label}")
        out[label]["host_top"] = _host_top(
            lambda: tr.train_step(state, batch, 0.0), f"step on the {label}")
    return out


def phase_multidevice(work, table, paths, n_img, cv_run, smi="",
                      device="cuda", extra_argv=(), expect_launches=True):
    """Phase 13: a process group of one rank (NCCL on the card, gloo on the
    CPU) over a file store under build/; phase 9's CLI with ``--mesh 1
    --sharded-risk-set`` in-process, held to phase 9's run (per-step
    losses by phase 8's rule, W-pass launches, no fused launch, collectives
    on every step, cv_results.json written once, fold checkpoints that load
    strictly into the single-device model and score finite risks), then
    ``parallel/dryrun.py``'s ``dryrun_multichip(1)`` on that group
    against the single-device Trainer's step. The collective count is
    reset just before the CLI and read just after. Returns the phase's
    numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY as CFG,
    )
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_checkpoint,
        load_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.models import (
        PartialModalityNet,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.parallel import (
        collectives,
        dryrun,
        multihost,
    )
    from multimodal_survival_prediction_tpu_torch.train import cv, engine
    from multimodal_survival_prediction_tpu_torch.train import (
        partial_modality_training as pmt,
    )
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        fold_checkpoints,
        predict_risk,
    )

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    want_img = n_img if expect_launches else 0
    store = work / "mesh_store"
    store.unlink(missing_ok=True)
    multihost.initialize_distributed(init_method=f"file://{store}",
                                     num_processes=1, process_id=0,
                                     device=device)
    backend = dist.get_backend()
    per_step, writes = [], []
    train_step, write = engine.Trainer.train_step, cv.write_cv_results

    def counted_step(self, *a, **k):  # the collectives each step launches
        before = collectives.counter.calls
        out = train_step(self, *a, **k)
        per_step.append(collectives.counter.calls - before)
        return out

    def counted_write(*a, **k):
        writes.append(a[0])
        return write(*a, **k)

    results, models = work / "mesh_results", work / "mesh_models"
    argv = ["--data-root", str(paths["root"]), "--results-dir", str(results),
            "--models-dir", str(models), "--pallas-resample", "--n-folds",
            "2", "--epochs", "2", "--device", device, "--mesh", "1",
            "--sharded-risk-set", *extra_argv]
    try:
        engine.Trainer.train_step, cv.write_cv_results = counted_step, \
            counted_write
        try:
            collectives.counter.calls = 0  # the CLI's count starts here
            run = _drive_cli(pmt.main, argv, device)
            calls = collectives.counter.calls  # ... and is read here
        finally:
            engine.Trainer.train_step, cv.write_cv_results = train_step, \
                write
        per_fold = _per_fold(run["outcomes"], run["epochs"],
                             host=run["epoch_host"])
        on_mesh = dryrun.dryrun_multichip(1, device=device)
        one = dryrun.dryrun_step(None, device=device,
                                 batch=on_mesh["global_batch"])
        host_us = _collective_host_us(dist.group.WORLD, device)
        profile = (_profile_mesh_step(run["arrays"], run["splits"], device)
                   if device != "cpu" else None)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)

    fused = run["fused"] + run["fused_bf16"]
    check(run["ingest_launches"] == want_img,
          f"--mesh 1: the ingest launched the W-pass kernel "
          f"{run['ingest_launches']} times, expected {want_img}")
    check(fused == [0] * len(fused),
          f"--mesh 1: the unfused model launched fused kernels {fused}")
    steps = sum(len(e[2]) for e in run["epochs"])
    check(len(per_step) == steps and min(per_step, default=0) > 0,
          f"--mesh 1: collectives a step {per_step} over {steps} steps")
    check(len(writes) == 1, f"cv_results.json written {len(writes)} times")
    gaps = []
    for f, want in zip(per_fold, cv_run["folds"]):
        gaps.append(_losses_held(
            f"--mesh 1 fold {f['fold']}",
            [x for e in f["step_losses"] for x in e],
            [x for e in want["step_losses"] for x in e]))
    ckpts = fold_checkpoints(models, CFG.name)
    check([c.name for c in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"],
          f"--mesh 1 fold checkpoints {ckpts}")
    rna_dim = run["arrays"].arrays["rnaseq"].shape[1]
    for ckpt in ckpts:
        PartialModalityNet(rna_dim=rna_dim,
                           backbone=load_fold_meta(ckpt)["backbone"]
                           ).load_state_dict(load_checkpoint(ckpt),
                                             strict=True)
    rs.wpass.launches = 0
    pred = predict_risk(CFG, ckpts, table, rnaseq_csv=paths["rnaseq_csv"],
                        labeled_only=False, device=device)
    sync()
    check(np.all(np.isfinite(pred["risk_score"]))
          and rs.wpass.launches == want_img,
          f"--mesh 1 ensemble: risks {pred['risk_score']}, "
          f"{rs.wpass.launches} W-pass launches")
    gap = abs(on_mesh["loss"] - one["loss"]) / max(abs(one["loss"]), 1e-12)
    check(gap <= MESH_LOSS_RTOL and on_mesh["loss_sharded"] is not None,
          f"dry run: the mesh-of-one step's loss {on_mesh['loss']} against "
          f"the single-device step's {one['loss']} (gap {gap:.2e})")
    wall = time.perf_counter() - t0
    ms = [f["ms_per_step_last_epoch"] for f in per_fold]
    ms9 = [f["ms_per_step_last_epoch"] for f in cv_run["folds"]]
    host = [(round(f["host_ms_per_step_last_epoch"], 2),
             round(f["gc_ms_last_epoch"], 2), f["gc_n_last_epoch"])
            for f in per_fold]
    host9 = [(round(f["host_ms_per_step_last_epoch"], 2),
              round(f["gc_ms_last_epoch"], 2), f["gc_n_last_epoch"])
             for f in cv_run["folds"]]
    log(f"multi-device on one card ({smi}; {backend}, world size 1): phase "
        f"wall {wall:.2f} s, CLI --mesh 1 --sharded-risk-set wall "
        f"{run['wall_s']:.2f} s (phase 9: {cv_run['wall_s']:.2f} s); epoch-2"
        f" ms/step {ms} (phase 9: {ms9}); epoch 2's host ms/step, GC ms "
        f"and GC pauses {host} (phase 9: {host9}); collectives a step "
        f"{per_step} "
        f"({calls} in the CLI); W-pass launches {run['ingest_launches']}; "
        f"step losses held to phase 9's (gaps step 1, later) {gaps}; dry run"
        f" loss {on_mesh['loss']:.6f} (sharded risk set "
        f"{on_mesh['loss_sharded']:.6f}) vs one device {one['loss']:.6f}; "
        f"one all-reduce of a BatchNorm's sums {host_us:.1f} us of host "
        f"time")
    return dict(wall_s=wall, cli_wall_s=run["wall_s"], ms_per_step=ms,
                host_gc=host, phase9_host_gc=host9,
                collective_host_us=host_us, profile=profile,
                phase9_ms_per_step=ms9, collectives_per_step=per_step,
                collectives=calls, ingest_launches=run["ingest_launches"],
                loss_gaps=gaps, dryrun=dict(mesh=on_mesh, one=one),
                backend=backend)


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
    """Run a training CLI's ``main(argv)`` in-process (the sweep CLI's
    too). The W-pass and fused launch counts are reset just before it and
    read just after; the W-pass count is read again right after the ingest
    (``prepare_cv_data``). Returns the payload, the walls, the counts (the
    fused kernels' per dtype), the driver's outcomes, the prepared arrays
    and splits, each sequential train epoch's (ms by CUDA events, steps,
    step losses; streaming epochs too), each vmapped epoch's dict (ms,
    (steps, K) losses, step validity), each evaluation's (hazards, rows),
    and the messages the train package logged."""
    import logging

    import torch

    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train import (
        cli,
        cv,
        cv_parallel,
        engine,
        sweep,
    )

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    kept, epochs, messages, evals, par_epochs = {}, [], [], [], []
    epoch_host = []
    pauses = _gc_pauses()
    prepare, run = cv.prepare_cv_data, cli.run_cross_validation
    run_par = cli.run_cross_validation_parallel
    train_epoch, evaluate = engine.Trainer.train_epoch, engine.Trainer.evaluate
    train_streaming = engine.Trainer.train_epoch_streaming
    build_epoch = cv_parallel._build_parallel_train_epoch

    def events():
        if device == "cpu":
            return None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        return start, end

    def elapsed(ev):
        if ev is None:
            return None
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

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

    def run_par_and_keep(*a, **k):
        payload, kept["outcomes"] = out = run_par(*a, **k)
        return out

    def timed(fn):  # each epoch's ms by CUDA events, and its step losses
        def epoch(self, *a, **k):
            gc_s, gc_n, t = pauses.s, pauses.n, time.perf_counter()
            ev = events()
            out = fn(self, *a, **k)
            epochs.append((elapsed(ev), len(self.step_losses),
                           self.step_losses.float().tolist()))
            epoch_host.append(dict(
                host_ms=(time.perf_counter() - t) * 1e3,
                gc_ms=(pauses.s - gc_s) * 1e3, gc_n=pauses.n - gc_n))
            return out
        return epoch

    def timed_build(trainer):  # each vmapped epoch's ms and losses
        epoch = build_epoch(trainer)

        def timed_epoch(state, batches, step_valid, lrs):
            ev = events()
            losses, mean = epoch(state, batches, step_valid, lrs)
            par_epochs.append(dict(ms=elapsed(ev),
                                   losses=losses.float().cpu().tolist(),
                                   valid=step_valid.tolist()))
            return losses, mean

        return timed_epoch

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
    cv_parallel.prepare_cv_data = sweep.prepare_cv_data = prepare_and_keep
    cli.run_cross_validation_parallel = run_par_and_keep
    cv_parallel._build_parallel_train_epoch = timed_build
    engine.Trainer.train_epoch = timed(train_epoch)
    engine.Trainer.train_epoch_streaming = timed(train_streaming)
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
        cv_parallel.prepare_cv_data = sweep.prepare_cv_data = prepare
        cli.run_cross_validation_parallel = run_par
        cv_parallel._build_parallel_train_epoch = build_epoch
        engine.Trainer.train_epoch = train_epoch
        engine.Trainer.train_epoch_streaming = train_streaming
        engine.Trainer.evaluate = evaluate
        logger.removeHandler(handler)
        logger.setLevel(level)
    return dict(kept, payload=payload, wall_s=wall, fused=fused,
                fused_bf16=fused_bf16, epochs=epochs, epoch_host=epoch_host,
                par_epochs=par_epochs, evals=evals, messages=messages)


class _GCPauses:
    """The seconds and the number of Python's garbage-collector pauses
    since it was made (``gc.callbacks``)."""

    def __init__(self):
        self.s, self.n, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._pause)

    def _pause(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.n += 1


_PAUSES = []


def _gc_pauses() -> _GCPauses:
    """The one ``_GCPauses`` of this process."""
    if not _PAUSES:
        _PAUSES.append(_GCPauses())
    return _PAUSES[0]


def _per_fold(outcomes, epochs, stage1_epochs=0, host=None):
    """Each fold's wall, epochs' ms (CUDA events; stage 1's first) and step
    losses, and its last epoch's steps and ms/step, from ``_drive_cli``'s
    epoch list; with ``host`` (``_drive_cli``'s ``epoch_host``), its last
    epoch's host ms/step and garbage-collector pauses too."""
    per_fold, i = [], 0
    for o in outcomes:
        n = stage1_epochs + o.epochs_run
        fold_epochs, i = epochs[i:i + n], i + n
        ms, steps, _ = fold_epochs[-1]
        per_fold.append(dict(fold=o.fold, wall_s=o.wall_s, steps=steps,
                             epoch_ms=[e[0] for e in fold_epochs],
                             step_losses=[e[2] for e in fold_epochs],
                             lrs=[h["lr"] for h in o.history],
                             ms_per_step_last_epoch=(
                                 ms / steps if ms is not None else None),
                             best_epoch=o.best_epoch,
                             best_c_index=o.best_c_index))
        if host is not None:
            last = host[i - 1]
            per_fold[-1].update(
                host_ms_per_step_last_epoch=last["host_ms"] / steps,
                gc_ms_last_epoch=last["gc_ms"], gc_n_last_epoch=last["gc_n"])
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
    per_fold = _per_fold(run["outcomes"], run["epochs"],
                         host=run["epoch_host"])
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
                folds=per_fold, c_index_mean=payload["c_index_mean"],
                ckpts=ckpts, arrays=arrays)


# --------------------------------------------------------------------------
# 9c: fold-parallel CV, streaming epochs and the sweep (vmapped folds)
# --------------------------------------------------------------------------

def _losses_held(label, got, want):
    """Phase 8's rule on two runs' per-step losses from the same weights,
    batches and dropout masks: the first step within FIRST_LOSS_RTOL
    relative, later steps within LOSS_DRIFT_RTOL. Returns the largest
    relative gap of each."""
    check(len(got) == len(want) and got,
          f"{label}: {len(got)} steps against {len(want)}")
    gaps = [abs(g - w) / max(abs(w), 1e-12) for g, w in zip(got, want)]
    first, later = gaps[0], max(gaps[1:], default=0.0)
    check(first <= FIRST_LOSS_RTOL and later <= LOSS_DRIFT_RTOL,
          f"{label}: step losses {got} against {want} (gaps {gaps})")
    return first, later


def _profile_once(fn, label, top=6):
    """One call of ``fn`` (after one outside the window) under
    torch.profiler: its device busy time and device launches, and the top
    kernels by device time, logged."""
    import torch

    fn()
    torch.cuda.synchronize()
    with _profiled() as window:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(window.events, key=lambda e: e.self_device_time_total,
                     reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"profile {label}: wall {wall_ms:.1f} ms (under the profiler), "
        f"device busy {busy:.2f} ms, {launches} device launches; top:")
    for e in kernels[:top]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return dict(device_busy_ms=busy, device_launches=launches,
                wall_ms=wall_ms)


def _profile_steps(arrays, splits, device):
    """One train step of two stacked folds (the vmapped step) and one of a
    single fold (the sequential step) of the CV driver's model on the
    phase-4 cohort's first batch, each profiled (lr 0)."""
    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY as CFG,
    )
    from multimodal_survival_prediction_tpu_torch.train import cv_parallel
    from multimodal_survival_prediction_tpu_torch.train.cv import (
        make_trainers,
    )

    rna_dim = arrays.arrays["rnaseq"].shape[1]
    tr = make_trainers(CFG, rna_dim, "densenet121", None, device)[0]
    data = arrays.to_device(device)
    rows = [s[0] for s in splits]
    idx, bv = cv_parallel._stack_fold_indices(rows, CFG.batch_size,
                                              [None] * len(rows))
    batch = next(iter(cv_parallel.stacked_batches(tr, data, idx[:, :1],
                                                  bv[:, :1])))
    stacked = cv_parallel.StackedState(
        [tr.init_state(fold=f) for f in range(1, len(rows) + 1)])
    step = cv_parallel._build_parallel_train_step(tr)
    zero = torch.zeros(len(rows), 1, device=device)
    valid = np.ones(len(rows), bool)
    par = _profile_once(lambda: step(stacked, batch, zero, valid),
                        f"vmapped step, {len(rows)} folds")
    del stacked
    state = tr.init_state(fold=1)
    one = {k: v[0] for k, v in batch.items()}
    seq = _profile_once(lambda: tr.train_step(state, one, 0.0),
                        "sequential step, one fold")
    return par, seq


def phase_cv_parallel(work, table, paths, n_img, cv_run, smi="",
                      device="cuda", extra_argv=(), expect_launches=True,
                      profile=True):
    """9c: the partial_modality CLI's ``main([... "--fold-parallel", "1"])``
    with phase 9's arguments (both folds in one vmapped step), the
    sequential CLI with ``--streaming`` for one epoch, and the sweep CLI
    (seeds 42, 43 x lrs base, 3 x base, one epoch, fold 1), each on the
    phase-4 cohort at full width. Each is held to phase 9's sequential run
    (``cv_run``) by phase 8's rule on the per-step losses; W-pass launches
    in each ingest, no fused launch, the artifacts' schema, each fold's
    best_c_index from its .pt. Prints the walls, the vmapped epochs' ms
    beside phase 9's, fold-steps per second of both drivers and a profile
    of one vmapped step beside a sequential one."""
    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY as CFG,
    )
    from multimodal_survival_prediction_tpu_torch.data.pipeline import (
        BatchPrefetcher,
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
    from multimodal_survival_prediction_tpu_torch.train import sweep
    from multimodal_survival_prediction_tpu_torch.train.engine import (
        TrainConfig,
    )
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        fold_checkpoints,
        predict_risk,
    )

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    t_phase = time.perf_counter()
    seq_folds = cv_run["folds"]
    want_img = n_img if expect_launches else 0

    def argv(tag, *extra):
        return ["--data-root", str(paths["root"]), "--results-dir",
                str(work / f"{tag}_results"), "--models-dir",
                str(work / f"{tag}_models"), "--pallas-resample",
                "--n-folds", "2", "--device", device, *extra_argv, *extra]

    def common_checks(label, run):
        fused = run["fused"] + run["fused_bf16"]
        check(run["ingest_launches"] == want_img,
              f"{label}: the ingest launched the W-pass kernel "
              f"{run['ingest_launches']} times, expected {want_img}")
        check(fused == [0] * len(fused),
              f"{label}: the unfused model launched fused kernels {fused}")

    # ---- fold-parallel: both folds in one vmapped step ----
    results, models = work / "cvp_results", work / "cvp_models"
    run = _drive_cli(pmt.main, argv("cvp", "--epochs", "2",
                                    "--fold-parallel", "1"), device)
    common_checks("fold-parallel CLI", run)
    payload, outcomes, arrays = run["payload"], run["outcomes"], run["arrays"]
    par_epochs = run["par_epochs"]
    check(len(par_epochs) == 2 and not run["epochs"],
          f"the fold-parallel CLI ran {len(par_epochs)} vmapped epochs and "
          f"{len(run['epochs'])} sequential ones")
    loaded = load_cv_results(results / CFG.name)
    check(set(loaded["raw"]) == CV_STANDARD_KEYS and loaded["raw"] == payload
          and len(payload["fold_results"]) == 2,
          f"fold-parallel cv_results.json: {sorted(loaded['raw'])}")
    ckpts = fold_checkpoints(models, CFG.name)
    check([c.name for c in ckpts] == ["fold_1_best.pt", "fold_2_best.pt"],
          f"fold-parallel checkpoints {ckpts}")
    gaps, scored = [], []
    for k, (o, sf, ckpt) in enumerate(zip(outcomes, seq_folds, ckpts)):
        check([h["lr"] for h in o.history] == sf["lrs"],
              f"fold {o.fold}: learning rates {[h['lr'] for h in o.history]}"
              f" against phase 9's {sf['lrs']}")
        got = [l[k] for e in par_epochs
               for l, ok in zip(e["losses"], e["valid"][k]) if ok]
        gaps.append(_losses_held(f"fold-parallel fold {o.fold}", got,
                                 [x for e in sf["step_losses"] for x in e]))
        meta = load_fold_meta(ckpt)
        check(meta is not None and meta["use_pallas_resample"] is True
              and meta["resample_mode"] == "device",
              f"fold-parallel {ckpt.name}.meta.json: {meta}")
        rs.wpass.launches = 0
        pred = predict_risk(CFG, ckpt, table, rnaseq_csv=paths["rnaseq_csv"],
                            labeled_only=False, device=device)
        sync()
        scored.append(rs.wpass.launches)
        check(scored[-1] == want_img,
              f"predict_risk on the fold-parallel {ckpt.name} launched the "
              f"W-pass kernel {scored[-1]} times, expected {want_img}")
        c, tol, pairs, fragile = _fold_c_index(pred, arrays,
                                               run["splits"][k][1])
        log(f"fold-parallel {ckpt.name}: C-index from predict_risk {c:.6f} "
            f"vs best_c_index {o.best_c_index:.6f} (tol {tol:.3e}); step "
            f"losses {got} vs phase 9's {sf['step_losses']} (gaps step 1 "
            f"{gaps[-1][0]:.2e}, later {gaps[-1][1]:.2e})")
        check(abs(c - o.best_c_index) <= tol,
              f"predict_risk on the fold-parallel {ckpt.name}: C-index {c},"
              f" best_c_index {o.best_c_index}")
    fold_steps = [sum(sum(v) for v in e["valid"]) for e in par_epochs]
    par_ms = [e["ms"] for e in par_epochs]
    seq_ms = [None if device == "cpu" else
              sum(f["epoch_ms"][i] for f in seq_folds) for i in range(2)]
    seq_steps = [sum(len(f["step_losses"][i]) for f in seq_folds)
                 for i in range(2)]

    def rate(steps, ms):
        return steps / ms * 1e3 if ms else None

    log(f"fold-parallel CLI ({smi}): wall {run['wall_s']:.2f} s, ingest "
        f"{run['ingest_s']:.2f} s ({run['ingest_launches']} W-pass "
        f"launches); vmapped epoch ms {par_ms} for {fold_steps} fold-steps "
        f"vs phase 9's two folds' epoch ms summed {seq_ms} for {seq_steps}; "
        f"fold-steps/s epoch 2: vmapped {rate(fold_steps[1], par_ms[1])}, "
        f"sequential {rate(seq_steps[1], seq_ms[1])}")

    # ---- streaming: the sequential driver from a host-resident cohort ----
    BatchPrefetcher.side_stream_copies = 0
    srun = _drive_cli(pmt.main, argv("stream", "--epochs", "1",
                                     "--streaming"), device)
    common_checks("streaming CLI", srun)
    copies = BatchPrefetcher.side_stream_copies
    eval_batch = TrainConfig().eval_batch_size
    eval_steps = sum(-(-len(v) // eval_batch) for _, v, _ in srun["splits"])
    train_steps = sum(e[1] for e in srun["epochs"])
    check(copies == ((train_steps + eval_steps) if device != "cpu" else 0),
          f"streaming: {copies} batches copied on a side stream, expected "
          f"{train_steps} train + {eval_steps} eval batches")
    for f, sf in zip(_per_fold(srun["outcomes"], srun["epochs"]),
                     seq_folds):
        _losses_held(f"streaming fold {f['fold']}", f["step_losses"][0],
                     sf["step_losses"][0])
    log(f"streaming CLI ({smi}): wall {srun['wall_s']:.2f} s, "
        f"{copies} batches copied on the prefetcher's side stream, epoch ms "
        f"{[e[0] for e in srun['epochs']]}")

    # ---- fold-parallel from a host-resident cohort: each step's stacked
    # (K, B, ...) batch gathered on the host and prefetched ----
    BatchPrefetcher.side_stream_copies = 0
    prun = _drive_cli(pmt.main, argv("cvps", "--epochs", "1",
                                     "--fold-parallel", "1", "--streaming"),
                      device)
    common_checks("fold-parallel streaming CLI", prun)
    pcopies = BatchPrefetcher.side_stream_copies
    (pepoch,) = prun["par_epochs"]
    stacked_steps = len(pepoch["valid"][0]) + max(
        -(-len(v) // eval_batch) for _, v, _ in prun["splits"])
    check(pcopies == (stacked_steps if device != "cpu" else 0),
          f"fold-parallel streaming: {pcopies} stacked batches copied on a "
          f"side stream, expected {stacked_steps} (train + eval steps)")
    # each fold's losses held to the device-resident vmapped run's epoch 1
    pgaps = [_losses_held(
        f"fold-parallel streaming fold {k + 1}",
        [l[k] for l, ok in zip(pepoch["losses"], pepoch["valid"][k]) if ok],
        [l[k] for l, ok in zip(par_epochs[0]["losses"],
                               par_epochs[0]["valid"][k]) if ok])
        for k in range(len(seq_folds))]
    log(f"fold-parallel streaming CLI ({smi}): wall {prun['wall_s']:.2f} s, "
        f"{pcopies} stacked batches copied on the prefetcher's side stream, "
        f"vmapped epoch {pepoch['ms']} ms against {par_ms[0]} ms "
        f"device-resident; loss gaps to it {pgaps}")

    # ---- the sweep: 4 candidates on fold 1 ----
    lr = CFG.learning_rate
    wrun = _drive_cli(sweep.main, argv(
        "sweep", "--epochs", "1", "--model", CFG.name, "--seeds", "42,43",
        "--lrs", f"{lr!r},{3 * lr!r}", "--fold", "1"), device)
    common_checks("sweep CLI", wrun)
    board = json.loads((work / "sweep_results" / CFG.name
                        / "sweep_results.json").read_text())
    check(len(board["candidates"]) == 4
          and board["fold"] == 1 and board["num_epochs"] == 1,
          f"sweep_results.json: {board}")
    (sweep_epoch,) = wrun["par_epochs"]
    points = [(s, x) for s in (42, 43) for x in (lr, 3 * lr)]
    anchor = points.index((42, lr))
    _losses_held("sweep candidate (42, base lr)",
                 [l[anchor] for l in sweep_epoch["losses"]],
                 seq_folds[0]["step_losses"][0])
    log(f"sweep CLI ({smi}): wall {wrun['wall_s']:.2f} s, one vmapped epoch "
        f"of 4 candidates {sweep_epoch['ms']} ms; leaderboard "
        f"{[(c['seed'], c['learning_rate'], round(c['best_c_index'], 4)) for c in board['candidates']]}")

    prof = _profile_steps(arrays, run["splits"], device) if profile else None
    wall = time.perf_counter() - t_phase
    log(f"phase 9c ({smi}): wall {wall:.2f} s")
    return dict(wall_s=wall, ingest_launches=run["ingest_launches"],
                predict_launches=scored,
                streaming_ingest_launches=srun["ingest_launches"],
                sweep_ingest_launches=wrun["ingest_launches"],
                fused_launches=run["fused"], epoch_ms=par_ms,
                seq_epoch_ms=seq_ms, fold_steps=fold_steps,
                seq_fold_steps=seq_steps, sweep_wall_s=wrun["wall_s"],
                streaming_wall_s=srun["wall_s"], cli_wall_s=run["wall_s"],
                side_stream_copies=copies, loss_gaps=gaps, profile=prof,
                par_streaming_ingest_launches=prun["ingest_launches"],
                par_streaming_wall_s=prun["wall_s"],
                par_streaming_copies=pcopies,
                par_streaming_loss_gaps=pgaps,
                par_step1=[par_epochs[0]["losses"][0][k]
                           for k in range(len(seq_folds))])


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
    each family's numbers, and the cohort (its table and paths)."""
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
    return out, table, paths


def _one_family(name, entry, main, work, table, paths, smi, device,
                extra_argv, expect_launches):
    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.data.datasets import (
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
    mask = arrays.arrays["mask"]
    by_pattern = {}
    for i in np.nonzero(mask.sum(1) > 0)[0]:
        by_pattern.setdefault(tuple(mask[i] > 0), []).append(i)
    idx = np.sort(np.concatenate([v[:FAMILY_SCORED_PER_PATTERN]
                                  for v in by_pattern.values()]))
    patients = _requests(table, paths, pred["patient_id"], mask, idx)
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
                c_index_mean=payload["c_index_mean"], ckpts=ckpts,
                n_img=n_img)


def _requests(table, paths, patient_ids, mask, idx):
    """The /score bodies (as RiskScorer.score_many takes them) of patients
    ``idx`` of a scored cohort: the CT, RNA and age its mask row holds."""
    from multimodal_survival_prediction_tpu_torch.data.datasets import (
        load_rnaseq_matrix,
    )

    rows = {r["patient_id"]: r for r in table}
    rna = load_rnaseq_matrix(paths["rnaseq_csv"])
    patients = []
    for i in idx:
        row = rows[patient_ids[i]]
        patient = {}
        if mask[i, 0]:
            patient["nifti_path"] = row["nifti_path"]
        if mask[i, 1]:
            patient["rnaseq"] = rna.row(row["patient_id"])
        if mask[i, 2]:
            patient["age"] = row["age"]
        patients.append(patient)
    return patients


# --------------------------------------------------------------------------
# 11: fold checkpoints in every format, the server's warm start, and the
#     evaluation tools (io/checkpoint.py, tools/, analysis/)
# --------------------------------------------------------------------------

FORMAT_TOL = 1e-6  # max |d log-hazard| of a format against the .pt
# evaluation_summary.json as the JAX package writes it (its keys, nested)
EVAL_SUMMARY_KEYS = {
    "n_patients": None, "n_events": None, "c_index": None,
    "median_risk_score": None,
    "risk_groups": {g: {"n": None, "events": None, "median_survival": None}
                    for g in ("high", "low")},
    "logrank": {"statistic": None, "p_value": None},
    "risk_score_stats": {"mean": None, "std": None, "min": None,
                         "max": None}}


def _key_tree(d):
    return ({k: _key_tree(v) for k, v in d.items()} if isinstance(d, dict)
            else None)


def _leaves(d, path=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, d


def _scored(cfg, ckpt, table, paths, device, **kw):
    """predict_risk's log-hazards (every patient) and the W-pass launches
    of that one call (the count is set to 0 just before it)."""
    import torch

    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        predict_risk,
    )

    rs.wpass.launches = 0
    pred = predict_risk(cfg, ckpt, table, rnaseq_csv=paths["rnaseq_csv"],
                        labeled_only=False, device=device, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    return pred, rs.wpass.launches


def _formats(name, fold_ckpt, table, paths, n_img, out, device,
             expect_launches):
    """One fold in every format: .msgpack (the port's writer), .pth
    (tools/export_torch_checkpoint) and back (tools/convert_torch_checkpoint,
    to .pt); predict_risk on each against the .pt. Returns
    ``(per-format launches, per-format max |d|, the .msgpack path)``."""
    import numpy as np

    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_checkpoint,
        load_fold_meta,
        save_checkpoint,
        save_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.io.torch_import import (
        REFERENCE_FAMILIES,
    )
    from multimodal_survival_prediction_tpu_torch.tools import (
        convert_torch_checkpoint,
        export_torch_checkpoint,
    )

    cfg = ALL_CONFIGS[name]
    meta = load_fold_meta(fold_ckpt)
    check(meta["use_pallas_resample"] is True,
          f"{name} {fold_ckpt.name}: the meta does not pin the kernel: {meta}")
    stem = fold_ckpt.name[:-len(".pt")]
    mpk = out / "msgpack" / name / f"{stem}.msgpack"
    save_checkpoint(mpk, load_checkpoint(fold_ckpt, model_name=name),
                    model_name=name)
    save_fold_meta(mpk, **meta)
    files = {"pt": (fold_ckpt, {}), "msgpack": (mpk, {})}
    if name in REFERENCE_FAMILIES:
        pth = out / "pth" / name / f"{stem}.pth"
        check(export_torch_checkpoint.main([
            "--checkpoint", str(mpk), "--out", str(pth)]) == 0,
            f"{name}: export failed")
        back = out / "converted" / name / f"{stem}.pt"
        check(convert_torch_checkpoint.main([
            "--model", name, "--torch-checkpoint", str(pth), "--out",
            str(back), "--image-shape",
            ",".join(str(x) for x in meta["image_shape"]),
            "--device", device]) == 0, f"{name}: convert failed")
        check(load_fold_meta(back)["use_pallas_resample"] is False,
              f"{name}: the converter's meta should say false, as JAX's")
        files["pth"] = (pth, {})
        # the converter's meta says false, as JAX's tool writes it: ask
        files["converted"] = (back, {"use_pallas": True})
    launches, diffs, ref = {}, {}, None
    want = n_img if expect_launches else 0
    for fmt, (path, kw) in files.items():
        pred, launches[fmt] = _scored(cfg, path, table, paths, device, **kw)
        risk = pred["risk_score"]
        check(np.all(np.isfinite(risk)), f"{name} {fmt}: risks {risk}")
        check(launches[fmt] == want,
              f"{name} {fmt}: predict_risk launched the W-pass kernel "
              f"{launches[fmt]} times, expected {want} (its imaging "
              f"patients)")
        if ref is None:
            ref = pred
            continue
        check(list(pred["patient_id"]) == list(ref["patient_id"]),
              f"{name} {fmt}: patients differ from the .pt's")
        diffs[fmt] = float(np.abs(risk - ref["risk_score"]).max())
        check(diffs[fmt] <= FORMAT_TOL,
              f"{name} {fmt}: log-hazards differ from the .pt's by "
              f"{diffs[fmt]} > {FORMAT_TOL}")
    return launches, diffs, mpk


def phase_checkpoints(work, cv_run, cv_table, cv_paths, cv_n_img,
                      families, fam_table, fam_paths, smi="", device="cuda",
                      expect_launches=True):
    """Phase 9's two partial_modality folds and fold 1 of each phase-10
    family, each written as .msgpack, exported to .pth and converted back,
    scored in every format; the .msgpack ensemble calibrated
    (tools/calibrate) and served one patient at a time; a fresh server's
    first three /score calls timed; generate_km_curves then evaluate_model
    on phase 9's cohort. Returns the phase's numbers."""
    import numpy as np

    from multimodal_survival_prediction_tpu_torch.analysis import (
        evaluate,
        evaluate_model,
        generate_km_curves,
    )
    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.ops.cindex import (
        concordance_index_np,
    )
    from multimodal_survival_prediction_tpu_torch.serving import (
        RiskScorer,
        make_server,
    )
    from multimodal_survival_prediction_tpu_torch.tools import calibrate
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        fold_checkpoints,
    )

    t_phase = time.perf_counter()
    out = work / "checkpoints"
    name = "partial_modality"
    cfg = ALL_CONFIGS[name]
    folds = [(name, c, cv_table, cv_paths, cv_n_img) for c in cv_run["ckpts"]]
    folds += [(fam, r["ckpts"][0], fam_table, fam_paths, r["n_img"])
              for fam, r in families.items()]
    launches, diffs = {}, {}
    for fam, ckpt, table, paths, n_img in folds:
        t0 = time.perf_counter()
        key = f"{fam} {ckpt.name[:-len('_best.pt')]}"
        launches[key], diffs[key], _ = _formats(
            fam, ckpt, table, paths, n_img, out, device, expect_launches)
        log(f"checkpoints {key}: W-pass launches a predict_risk "
            f"{launches[key]} for {n_img} imaging patients; max |d| against "
            f"the .pt {({k: f'{v:.1e}' for k, v in diffs[key].items()})} "
            f"(tol {FORMAT_TOL}); {time.perf_counter() - t0:.2f} s ({smi})")

    # the two-fold .msgpack ensemble: calibrate, then one patient at a time
    models = out / "msgpack"
    ckpts = fold_checkpoints(models, name)
    check([c.suffix for c in ckpts] == [".msgpack"] * 2,
          f"the .msgpack ensemble: {ckpts}")
    cal_path = out / "calibration.json"
    rs.wpass.launches = 0
    cal = calibrate.main(["--model", name, "--models-dir", str(models),
                          "--data-root", str(cv_paths["root"]), "--out",
                          str(cal_path), "--device", device])
    launches["calibrate"] = rs.wpass.launches
    stats = [tuple(s) for s in json.loads(cal_path.read_text())["stats"]]
    check(stats == [tuple(s) for s in cal["stats"]] and len(stats) == 2,
          f"calibration.json stats {stats}")
    pred, launches["ensemble"] = _scored(cfg, ckpts, cv_table, cv_paths,
                                         device)
    arrays = cv_run["arrays"]
    check(list(pred["patient_id"]) == list(arrays.patient_ids),
          "the ensemble's patients are not phase 9's")
    mask = arrays.arrays["mask"]
    idx = np.nonzero(mask.sum(1) > 0)[0]
    patients = _requests(cv_table, cv_paths, pred["patient_id"], mask, idx)
    scorer = RiskScorer(name, ckpts, fold_calibration=stats, device=device)
    scored = np.asarray([r["risk_score"] for r in scorer.score_many(patients)])
    d_z = np.abs(scored - pred["risk_score"][idx])
    sds = np.asarray([sd for _, sd in stats]) + 1e-8
    per_raw = float(np.mean(1.0 / sds))
    limit = RISK_TOL * per_raw
    check(float(d_z.max()) <= limit,
          f"RiskScorer on the .msgpack ensemble vs predict_risk: |d| "
          f"{d_z.max()} over {limit} (RISK_TOL on the log-hazard, fold sds "
          f"{sds.tolist()})")
    log(f"RiskScorer on the calibrated .msgpack ensemble, {len(idx)} "
        f"patients one at a time: max |d| against predict_risk "
        f"{d_z.max():.3e} z-scored ({d_z.max() / per_raw:.3e} on the "
        f"log-hazard; limit {limit:.3e}); calibration {stats}")

    # a fresh server: it warms itself in the constructor; the first three
    # /score calls timed (printed, not held: cuDNN's first calls in this
    # process were paid in phase 5)
    full = [i for i in idx if mask[i].all()]
    check(full, "phase 9's cohort has no patient with all three modalities")
    body = dict(_requests(cv_table, cv_paths, pred["patient_id"], mask,
                          full[:1])[0])
    body["rnaseq"] = body["rnaseq"].tolist()
    t0 = time.perf_counter()
    fresh = RiskScorer(name, ckpts, fold_calibration=stats, device=device)
    build_s = time.perf_counter() - t0
    server = make_server(fresh, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://%s:%d" % server.server_address
        first3 = []
        for _ in range(3):
            code, reply, ms = _post(base, "/score", body)
            check(code == 200, f"/score answered {code}: {reply}")
            first3.append(ms)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    d_first = abs(reply["risk_score"] - float(pred["risk_score"][full[0]]))
    check(d_first <= limit, f"/score vs the ensemble |d| {d_first}")
    log(f"fresh server on the .msgpack ensemble ({smi}): built and warmed "
        f"in {build_s:.2f} s; first three /score ms "
        f"{[round(x, 2) for x in first3]} (CT + RNA + age)")

    # generate_km_curves -> evaluate_model on phase 9's cohort
    results = out / "results"
    rs.wpass.launches = 0
    km = generate_km_curves.main([
        "--model", name, "--models-dir", str(models), "--data-root",
        str(cv_paths["root"]), "--results-root", str(results), "--ensemble",
        "--device", device])
    launches["km_curves"] = rs.wpass.launches
    summary = evaluate_model.main([
        "--predictions", str(results / "test_predictions.csv"),
        "--results-root", str(results)])
    written = json.loads((results / "evaluation" /
                          "evaluation_summary.json").read_text())
    check(_key_tree(written) == EVAL_SUMMARY_KEYS,
          f"evaluation_summary.json keys {_key_tree(written)}")
    csv = evaluate.read_predictions_csv(km["predictions"])
    c = concordance_index_np(csv["risk_score"], csv["survival_time"],
                             csv["event"])
    check(abs(written["c_index"] - c) <= 1e-12,
          f"c_index {written['c_index']} vs the CSV's {c}")
    for (path, got), (_, raw) in zip(_leaves(written), _leaves(summary)):
        finite = isinstance(raw, (int, float)) and math.isfinite(raw)
        check((got is None) == (not finite) and (got is None or got == raw),
              f"evaluation_summary.json{path}: {got} for {raw}")
    log(f"generate_km_curves + evaluate_model on phase 9's cohort: "
        f"{written['n_patients']} labelled patients, C-index "
        f"{written['c_index']:.6f} (= the CSV's), log-rank "
        f"{written['logrank']}, median survival high/low "
        f"{written['risk_groups']['high']['median_survival']}/"
        f"{written['risk_groups']['low']['median_survival']}; W-pass "
        f"launches calibrate {launches['calibrate']}, ensemble "
        f"{launches['ensemble']}, km_curves {launches['km_curves']}")
    want = cv_n_img if expect_launches else 0  # one ingest for both folds
    for k in ("calibrate", "ensemble", "km_curves"):
        check(launches[k] == want, f"{k}: {launches[k]} W-pass launches, "
              f"expected {want}")
    wall = time.perf_counter() - t_phase
    log(f"checkpoints phase ({smi}): {len(folds)} folds, wall {wall:.2f} s")
    return dict(wall_s=wall, launches=launches, max_d=diffs,
                scorer_max_d=float(d_z.max()), first_score_ms=first3,
                scorer_build_s=build_s, c_index=written["c_index"])


# --------------------------------------------------------------------------
# 12: the host ingest engine and both ends of the pipeline (data/native.py,
#     data/pipeline.py, preprocess/, run_all + analysis/comparison.py)
# --------------------------------------------------------------------------

HOST_TOL = 2e-5  # host engine vs the W-pass kernel (JAX's host-vs-device)
DICOM_SLICES = 16  # slices a phase-4 CT keeps as a DICOM series
STAR_GENES = 5100  # genes a STAR TSV lists; 5,005 of them are selected


def _engine_build(device):
    """12a: build the host engine from this checkout (a failed build raises
    here with g++'s stderr) and report the toolchain."""
    from multimodal_survival_prediction_tpu_torch.data import native

    t0 = time.perf_counter()
    _, info = native.build_native()
    wall = time.perf_counter() - t0
    log(f"host engine: {info['compiler']}, machine {info['machine']}, "
        f"-march=native = {info['march']}, zlib "
        f"{'found' if info['zlib'] else 'NOT found (-DMSP_NO_ZLIB)'}; "
        f"g++ {info['build_sec']:.2f} s (fresh={info['built']}), "
        f"{wall:.2f} s with the toolchain probe; {info['library']}")
    check(native.native_available(), "native_available() is False after "
          "the engine built")
    return dict(info, wall_s=wall)


def _ingest_paths(work, table, device, expect_launches):
    """12b: the phase-4 CTs through 'host', 'device' + the kernel, and
    'auto'; read_nifti_fast against read_nifti."""
    import os

    import numpy as np
    import torch

    from multimodal_survival_prediction_tpu_torch.data import native
    from multimodal_survival_prediction_tpu_torch.data import pipeline
    from multimodal_survival_prediction_tpu_torch.data.nifti import (
        read_nifti,
        write_nifti,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    jobs = [(i, r["nifti_path"]) for i, r in enumerate(table)
            if r["has_imaging"]]
    out = (64, 64, 32)
    pf = pipeline.VolumePrefetcher(device=device)
    runs, walls, launches = {}, {}, {}
    for label, kw in (("host", dict(resample="host")),
                      ("kernel", dict(resample="device", use_pallas=True)),
                      ("auto", dict(resample="auto")),
                      ("device", dict(resample="device"))):
        rs.wpass.launches = 0
        t0 = time.perf_counter()
        runs[label] = dict(pf.run(jobs, out, **kw))
        sync()
        walls[label] = time.perf_counter() - t0
        launches[label] = rs.wpass.launches
        runs[label + "_mode"] = pf.last_mode
        if label == "auto":
            probe = dict(pf.last_probe)
    n = len(jobs)
    check(runs["host_mode"] == "host" and launches["host"] == 0,
          f"resample='host' ran {runs['host_mode']} with "
          f"{launches['host']} W-pass launches, expected host and 0")
    want = n if expect_launches else 0
    check(runs["kernel_mode"] == "device" and launches["kernel"] == want,
          f"resample='device' + use_pallas: {launches['kernel']} W-pass "
          f"launches, expected {want}")
    diffs = [float(np.abs(runs["host"][i] - runs["kernel"][i]).max())
             for i, _ in jobs]
    check(max(diffs) <= HOST_TOL, f"host vs kernel max |d| {max(diffs)} > "
          f"{HOST_TOL}")
    mode = runs["auto_mode"]
    same = runs["host"] if mode == "host" else runs["device"]
    check(all(np.array_equal(runs["auto"][i], same[i]) for i, _ in jobs),
          f"'auto' chose {mode} but its cohort is not that path's alone")
    log(f"ingest of the {n} phase-4 CTs (-> {out}): host "
        f"{walls['host']:.3f} s (0 launches), kernel {walls['kernel']:.3f} s"
        f" ({launches['kernel']} launches), plain device "
        f"{walls['device']:.3f} s; host vs kernel max |d| per volume "
        f"{[f'{d:.2e}' for d in diffs]} (tol {HOST_TOL})")
    log(f"'auto': link probe {probe['link_mb_s']:.1f} MB/s, host "
        f"{probe['host_ms']:.2f} ms/vol vs link {probe['link_ms']:.2f} ms/vol"
        f" for the probe volume -> {mode}; cohort single-path (bit-equal to "
        f"resample='{mode}'); wall {walls['auto']:.3f} s")

    # read_nifti_fast (the engine under MSP_NATIVE_IO=1) against read_nifti
    first = read_nifti(jobs[0][1]).data
    gz = work / "ct_slab.nii.gz"
    write_nifti(gz, first[:DICOM_SLICES])
    paths = [p for _, p in jobs] + [str(gz)]
    old = os.environ.get("MSP_NATIVE_IO")
    os.environ["MSP_NATIVE_IO"] = "1"
    try:
        t0 = time.perf_counter()
        fast = [native.read_nifti_fast(p).data for p in paths]
        fast_s = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("MSP_NATIVE_IO")
        else:
            os.environ["MSP_NATIVE_IO"] = old
    t0 = time.perf_counter()
    slow = [read_nifti(p).data for p in paths]
    slow_s = time.perf_counter() - t0
    for p, a, b in zip(paths, fast, slow):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"read_nifti_fast vs read_nifti differ on {p}")
    log(f"read_nifti_fast (engine) vs read_nifti on {len(jobs)} .nii + 1 "
        f".nii.gz ({first[:DICOM_SLICES].shape}): bit-equal; "
        f"{fast_s:.3f} s vs {slow_s:.3f} s")
    return dict(launches=launches, walls=walls, max_d=max(diffs),
                probe=probe, auto_mode=mode)


def _host_pinned_fold(work, table, paths, cv_run, device, expect_launches):
    """12c: phase 9's fold 1 with its .meta.json pinning the host engine,
    scored by predict_risk (no W-pass launch) and by RiskScorer's /score
    path (decoded through read_nifti_fast)."""
    import os

    import numpy as np

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY as CFG,
    )
    from multimodal_survival_prediction_tpu_torch.data import native
    from multimodal_survival_prediction_tpu_torch.data.datasets import (
        load_rnaseq_matrix,
    )
    from multimodal_survival_prediction_tpu_torch.io.checkpoint import (
        load_fold_meta,
        save_fold_meta,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.serving import RiskScorer
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        predict_risk,
    )

    src = cv_run["ckpts"][0]
    ckpt = work / "host_fold" / CFG.name / src.name
    ckpt.parent.mkdir(parents=True)
    shutil.copyfile(src, ckpt)
    meta = dict(load_fold_meta(src), resample_mode="host",
                use_pallas_resample=False)
    save_fold_meta(ckpt, **meta)
    rs.wpass.launches = 0
    t0 = time.perf_counter()
    host = predict_risk(CFG, ckpt, table, rnaseq_csv=paths["rnaseq_csv"],
                        labeled_only=False, device=device)
    host_s = time.perf_counter() - t0
    launches = rs.wpass.launches
    check(launches == 0, f"predict_risk on a host-pinned fold launched the "
          f"W-pass kernel {launches} times")
    rs.wpass.launches = 0
    dev = predict_risk(CFG, src, table, rnaseq_csv=paths["rnaseq_csv"],
                       labeled_only=False, device=device)
    dev_launches = rs.wpass.launches
    check(list(host["patient_id"]) == list(dev["patient_id"]),
          "host- and device-ingest scoring ordered patients differently")
    d = float(np.abs(host["risk_score"] - dev["risk_score"]).max())
    check(d <= RISK_TOL, f"host-pinned vs device-ingest log-hazards max |d| "
          f"{d} > {RISK_TOL}")

    full = [r for r in table if r["has_imaging"] and r["has_rnaseq"]
            and r["has_clinical"]]
    p = full[0]
    calls = []
    fast = native.read_nifti_fast

    def counted(path):
        calls.append(path)
        return fast(path)

    scorer = RiskScorer(CFG.name, ckpt, device=device)
    rna = load_rnaseq_matrix(paths["rnaseq_csv"])
    old = os.environ.get("MSP_NATIVE_IO")
    os.environ["MSP_NATIVE_IO"] = "1"
    native.read_nifti_fast = counted
    try:
        t0 = time.perf_counter()
        out = scorer.score(rnaseq=rna.row(p["patient_id"]), age=p["age"],
                           nifti_path=p["nifti_path"])
        score_ms = (time.perf_counter() - t0) * 1e3
    finally:
        native.read_nifti_fast = fast
        if old is None:
            os.environ.pop("MSP_NATIVE_IO")
        else:
            os.environ["MSP_NATIVE_IO"] = old
    i = list(host["patient_id"]).index(p["patient_id"])
    ds = abs(out["risk_score"] - float(host["risk_score"][i]))
    check(calls == [p["nifti_path"]], f"RiskScorer decoded {calls}, not "
          "through read_nifti_fast once")
    check(ds <= RISK_TOL, f"/score vs host-pinned predict_risk |d| {ds}")
    log(f"host-pinned fold ({ckpt.name}, resample_mode host): predict_risk "
        f"{host_s:.2f} s with {launches} W-pass launches (device-ingest "
        f"scoring: {dev_launches}); log-hazards vs device ingest max |d| "
        f"{d:.3e} (tol {RISK_TOL}); RiskScorer.score({p['patient_id']}, "
        f"decoded by read_nifti_fast) {out['risk_score']:.6f} vs "
        f"{float(host['risk_score'][i]):.6f}, |d| {ds:.3e}, {score_ms:.1f} ms")
    want = cv_run["ingest_launches"] if expect_launches else 0
    check(dev_launches == want, f"device-ingest scoring launched "
          f"{dev_launches}, expected {want}")
    return dict(launches=launches, max_d=d, score_d=ds)


def _write_raw_tree(raw, table, paths, seed=12):
    """12d's raw inputs: a DICOM series of DICOM_SLICES slices at full
    in-plane size for each imaging patient (a slab of its phase-4 CT),
    STAR TSVs (STAR_GENES genes) for every patient, and phase 4's clinical
    CSV."""
    import numpy as np

    from multimodal_survival_prediction_tpu_torch.data.nifti import (
        read_nifti,
    )
    from multimodal_survival_prediction_tpu_torch.preprocess.dicom import (
        write_dicom_slice,
    )

    rng = np.random.default_rng(seed)
    data = raw / "data"
    n_slices = 0
    for r in table:
        if not r["has_imaging"]:
            continue
        vol = read_nifti(r["nifti_path"]).data
        z0 = (vol.shape[0] - DICOM_SLICES) // 2
        sdir = data / "imaging" / "dicom" / r["patient_id"] / "s1"
        sdir.mkdir(parents=True)
        for z in range(DICOM_SLICES):
            write_dicom_slice(sdir / f"{z:03d}.dcm", vol[z0 + z], instance=z,
                              position=(0.0, 0.0, 2.5 * z),
                              spacing=(0.7, 0.7), thickness=2.5)
            n_slices += 1
    genes = [f"ENSG{j:011d}.{j % 5 + 1}" for j in range(STAR_GENES)]
    for r in table:
        d = data / "genomic" / "rnaseq" / r["patient_id"]
        d.mkdir(parents=True)
        counts = rng.negative_binomial(5, 0.01, size=STAR_GENES)
        tpm = rng.gamma(1.0, 20.0, size=STAR_GENES)
        lines = ["# gene-model: GENCODE v36",
                 "gene_id\tgene_name\tunstranded\ttpm_unstranded",
                 "N_unmapped\t\t1234\t", "N_multimapping\t\t567\t"]
        lines += [f"{g}\tG{j}\t{c}\t{t:.4f}"
                  for j, (g, c, t) in enumerate(zip(genes, counts, tpm))]
        (d / "counts.tsv").write_text("\n".join(lines) + "\n")
    (data / "clinical").mkdir(parents=True)
    shutil.copyfile(paths["clinical_csv"], data / "clinical" / "clinical.csv")
    return n_slices


def _raw_to_report(work, table, paths, n_img, device, extra_argv,
                   expect_launches):
    """12d: raw DICOM + STAR files -> the two preprocessing entry points ->
    matching table -> run_all (two families, --profile-dir) ->
    SUMMARY.md / results.json."""
    import contextlib
    import io

    import torch

    from multimodal_survival_prediction_tpu_torch import run_all
    from multimodal_survival_prediction_tpu_torch.data.matching_table import (
        build_full_matching_table,
    )
    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.preprocess import (
        convert_dicom_to_nifti,
        preprocess_genomic,
    )

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    raw = work / "raw"
    walls = {}
    t0 = time.perf_counter()
    n_slices = _write_raw_tree(raw, table, paths)
    walls["write raw"] = time.perf_counter() - t0
    log_out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log_out):
        convert_dicom_to_nifti.main(["--data-root", str(raw)])
    walls["convert_dicom_to_nifti"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log_out):
        preprocess_genomic.main(["--data-root", str(raw), "--top-k", "5005"])
    walls["preprocess_genomic"] = time.perf_counter() - t0
    proc = raw / "data" / "processed"
    converted = log_out.getvalue()
    check(f"converted {n_img}/{n_img} series" in converted,
          f"DICOM conversion: {converted[-500:]}")
    genes = (proc / "selected_genes.txt").read_text().split()
    check(len(genes) == 5005, f"{len(genes)} selected genes, expected 5005")
    # the STAR directories carry the patient ids: the GDC UUID mapping
    # (scripts/preprocessing/map_rnaseq_via_gdc_api.py) is the identity
    mapped = proc / "rnaseq_normalized_mapped.csv"
    shutil.copyfile(proc / "rnaseq_normalized.csv", mapped)
    t0 = time.perf_counter()
    new_table = build_full_matching_table(
        raw / "data" / "clinical" / "clinical.csv",
        raw / "data" / "imaging" / "nifti", mapped,
        out_csv=proc / "full_matching_table.csv")
    walls["matching table"] = time.perf_counter() - t0
    img = sum(bool(r["has_imaging"]) for r in new_table)
    check(img == n_img and all(r["has_rnaseq"] for r in new_table),
          f"matching table: {img} with imaging (expected {n_img}), RNA "
          f"{sum(bool(r['has_rnaseq']) for r in new_table)}")

    results, models, prof = raw / "results", raw / "models", raw / "prof"
    argv = ["--models", "rnaseq_only,partial_modality", "--n-folds", "2",
            "--epochs", "1", "--pallas-resample", "--profile-dir", str(prof),
            "--data-root", str(raw), "--results-dir", str(results),
            "--models-dir", str(models), "--device", device, *extra_argv]
    rs.wpass.launches = 0  # run_all's counts start here
    fd.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log_out):
        failed = run_all.main(argv)
    sync()
    walls["run_all"] = time.perf_counter() - t0
    launches = rs.wpass.launches  # ... and are read here
    fused = [k.launches for k in fd.KERNELS]
    check(failed == [], f"run_all failed steps {failed}")
    want = n_img if expect_launches else 0
    check(launches == want, f"run_all's ingest launched the W-pass kernel "
          f"{launches} times, expected {want} (partial_modality's CTs)")
    check(fused == [0] * len(fused), f"run_all launched fused kernels "
          f"{fused}")
    means = {}
    for key in ("rnaseq_only", "partial_modality"):
        payload = json.loads((results / key / "cv_results.json").read_text())
        check(len(payload["fold_results"]) == 2,
              f"{key}: {len(payload['fold_results'])} folds")
        means[payload["model"]] = payload["c_index_mean"]
    summary = results / "final_comparison" / "SUMMARY.md"
    report = json.loads((results / "final_comparison" / "results.json")
                        .read_text())
    check(summary.exists(), "no SUMMARY.md")
    got = {m["model"]: m["c_index_mean"] for m in report["models"]}
    check(got == means, f"results.json means {got}, payloads {means}")
    md = summary.read_text()
    check(all(f"{m:.4f}" in md for m in means.values()),
          "SUMMARY.md lacks a payload's mean")
    traces = sorted(prof.glob("*.pt.trace.json"))
    check(len(traces) == 2, f"{len(traces)} traces under --profile-dir")
    named = [t.name for t in traces if b"wpass_kernel" in t.read_bytes()]
    if expect_launches:
        check(len(named) == 1, f"traces naming wpass_kernel: {named}")
    sizes = [round(t.stat().st_size / 1e6, 1) for t in traces]
    log(f"raw to report: {n_slices} DICOM slices ({img} series of "
        f"{DICOM_SLICES} x 512x512) + {len(table)} STAR TSVs "
        f"({STAR_GENES} genes) -> {len(genes)} genes, matching table of "
        f"{len(new_table)}; run_all rnaseq_only + partial_modality: "
        f"{launches} W-pass launches, C-index means {means}; traces MB "
        f"{sizes} ({len(named)} naming wpass_kernel); walls s "
        f"{ {k: round(v, 2) for k, v in walls.items()} }")
    return dict(walls=walls, launches=launches, means=means,
                trace_mb=sizes)


def phase_ingest_and_report(work, table, paths, n_img, cv_run, smi="",
                            device="cuda", extra_argv=(),
                            expect_launches=True):
    """Phase 12: the host engine (build, the three ingest modes against the
    kernel, read_nifti_fast), a fold pinned to the host engine scored, and
    raw files to SUMMARY.md. Returns the phase's numbers."""
    t0 = time.perf_counter()
    build = _engine_build(device)
    ingest = _ingest_paths(work, table, device, expect_launches)
    pinned = _host_pinned_fold(work, table, paths, cv_run, device,
                               expect_launches)
    report = _raw_to_report(work, table, paths, n_img, device, extra_argv,
                            expect_launches)
    wall = time.perf_counter() - t0
    log(f"ingest + report phase ({smi}): wall {wall:.2f} s")
    return dict(wall_s=wall, build=build, ingest=ingest, pinned=pinned,
                report=report)


# --------------------------------------------------------------------------
# 14: the fold mesh and remat
# --------------------------------------------------------------------------

# (ranks, --fold-dp) of phase 14's fold meshes: two fold rows of one rank,
# then two fold rows of two data ranks
FOLD_MESHES = ((2, 1), (4, 2))
# each fold's step-1 loss on a fold mesh against phase 9c's vmapped run
# (the same weights, batch and dropout masks; a fold on its own rank runs
# other grouped convolutions, and a data group sums BatchNorm's statistics
# in two halves)
FOLD_MESH_LOSS_ATOL = 1e-6
REMAT_BATCHES = (8, 32)


def _fold_mesh_rank(rank, world, store, argv, out, device):
    """One rank of phase 14's fold mesh: joins a gloo group of ``world``
    ranks (all on this one card: NCCL puts no two ranks on one GPU, gloo
    copies CUDA tensors through the host), runs the training CLI's
    ``main(argv)`` in-process and writes what the phase checks to
    ``out/rank<rank>.json``: the W-pass and fused launch counts, each
    vmapped epoch's ms and losses, the collectives this rank launched, and
    how often it wrote cv_results.json."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from multimodal_survival_prediction_tpu_torch.parallel import collectives
    from multimodal_survival_prediction_tpu_torch.train import cv
    from multimodal_survival_prediction_tpu_torch.train import (
        partial_modality_training as pmt,
    )

    if device != "cpu":
        torch.cuda.set_device(torch.device(device).index or 0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    write, writes = cv.write_cv_results, []

    def counted(*a, **k):
        writes.append(rank)
        return write(*a, **k)

    cv.write_cv_results = counted
    try:
        collectives.counter.calls = 0  # the run's count starts here
        run = _drive_cli(pmt.main, argv, device)
        calls = collectives.counter.calls  # ... and is read here
        Path(out, f"rank{rank}.json").write_text(json.dumps(dict(
            ingest_launches=run["ingest_launches"], fused=run["fused"],
            fused_bf16=run["fused_bf16"], par_epochs=run["par_epochs"],
            wall_s=run["wall_s"], ingest_s=run["ingest_s"], calls=calls,
            writes=len(writes), payload=run["payload"],
            outcomes=[dict(fold=o.fold, best_c_index=o.best_c_index,
                           best_epoch=o.best_epoch) for o in run["outcomes"]],
            splits=[[list(map(int, t)), list(map(int, v))]
                    for t, v, _ in run["splits"]],
            labels={k: run["arrays"].arrays[k].tolist()
                    for k in ("time", "event", "svalid")})))
    finally:
        cv.write_cv_results = write
        dist.destroy_process_group()


def phase_fold_mesh(work, table, paths, n_img, cv_par, smi="",
                    device="cuda", extra_argv=(), expect_launches=True,
                    meshes=FOLD_MESHES, epochs=2):
    """14a: the partial_modality CLI's ``main([... "--fold-parallel", N,
    "--fold-dp", M, "--remat"])`` with phase 9's arguments on each fold
    mesh of ``meshes``, its N ranks a gloo group on this one card (the
    phase always uses gloo: ROADMAP.md "Facts that bind"). Each fold's
    step-1 loss against phase 9c's vmapped run (``cv_par``), alike on
    every rank of the fold's data group; the W-pass kernel launched in
    every rank's ingest, no fused kernel; cv_results.json written once,
    by rank 0; two fold checkpoints, each loaded strictly and scored by
    predict_risk (its best_c_index again). Prints the collectives each
    rank launched and each fold's ms per step."""
    import types

    import numpy as np
    import torch.multiprocessing as mp

    from multimodal_survival_prediction_tpu_torch.config import (
        PARTIAL_MODALITY as CFG,
    )
    from multimodal_survival_prediction_tpu_torch.io.results import (
        load_cv_results,
    )
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        fold_checkpoints,
        predict_risk,
    )

    want_img = n_img if expect_launches else 0
    out = {}
    for world, dp in meshes:
        tag = f"fold_mesh_{world}x{dp}"
        ranks_dir = work / f"{tag}_ranks"
        ranks_dir.mkdir(parents=True, exist_ok=True)
        store = work / f"{tag}_store"
        store.unlink(missing_ok=True)
        argv = ["--data-root", str(paths["root"]), "--results-dir",
                str(work / f"{tag}_results"), "--models-dir",
                str(work / f"{tag}_models"), "--pallas-resample",
                "--n-folds", "2", "--device", device, *extra_argv,
                "--epochs", str(epochs), "--fold-parallel", str(world),
                "--fold-dp", str(dp), "--remat"]
        t0 = time.perf_counter()
        mp.start_processes(_fold_mesh_rank, nprocs=world, join=True,
                           args=(world, str(store), argv, str(ranks_dir),
                                 device), start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = [json.loads((ranks_dir / f"rank{r}.json").read_text())
                 for r in range(world)]
        label = f"fold mesh {world // dp}x{dp}"
        for r, got in enumerate(ranks):
            check(got["ingest_launches"] == want_img,
                  f"{label} rank {r}: the ingest launched the W-pass kernel "
                  f"{got['ingest_launches']} times, expected {want_img}")
            check(got["fused"] == [0] * 4 and got["fused_bf16"] == [0] * 4,
                  f"{label} rank {r}: the unfused model launched fused "
                  f"kernels {got['fused']} {got['fused_bf16']}")
            check(len(got["par_epochs"]) == epochs,
                  f"{label} rank {r}: {len(got['par_epochs'])} vmapped "
                  f"epochs, expected {epochs}")
        writers = [r for r, got in enumerate(ranks) if got["writes"]]
        check(writers == [0] and ranks[0]["writes"] == 1,
              f"{label}: cv_results.json written by ranks {writers} "
              f"({[g['writes'] for g in ranks]} times)")
        results = work / f"{tag}_results" / CFG.name
        loaded = load_cv_results(results)
        check(loaded["raw"] == ranks[0]["payload"]
              and len(loaded["raw"]["fold_results"]) == 2,
              f"{label}: cv_results.json {loaded['raw']}")
        models = work / f"{tag}_models" / CFG.name
        files = sorted(p.name for p in models.iterdir())
        check(files == ["fold_1_best.pt", "fold_1_best.pt.meta.json",
                        "fold_2_best.pt", "fold_2_best.pt.meta.json"],
              f"{label}: fold files {files}")
        # fold k lives on fold row k (k_pad = 2 = the fold axis), on ranks
        # k * dp ... k * dp + dp - 1, as the only state of their stack
        gaps, ms_step = [], []
        for k in range(2):
            row = [ranks[k * dp + d] for d in range(dp)]
            first = [g["par_epochs"][0]["losses"][0][0] for g in row]
            check(len(set(first)) == 1,
                  f"{label} fold {k + 1}: step-1 losses differ across its "
                  f"data group: {first}")
            want = cv_par["par_step1"][k]
            gaps.append(abs(first[0] - want))
            check(gaps[-1] <= FOLD_MESH_LOSS_ATOL,
                  f"{label} fold {k + 1}: step-1 loss {first[0]!r} against "
                  f"phase 9c's vmapped {want!r}")
            ms_step.append([round(e["ms"] / sum(e["valid"][0]), 3)
                            if e["ms"] else None
                            for e in row[0]["par_epochs"]])
        arrays = types.SimpleNamespace(arrays={
            k: np.asarray(v, np.float32)
            for k, v in ranks[0]["labels"].items()})
        scored = []
        for k, ckpt in enumerate(fold_checkpoints(models.parent, CFG.name)):
            rs.wpass.launches = 0
            pred = predict_risk(CFG, ckpt, table,
                                rnaseq_csv=paths["rnaseq_csv"],
                                labeled_only=False, device=device)
            scored.append(rs.wpass.launches)
            check(scored[-1] == want_img,
                  f"predict_risk on {label}'s {ckpt.name} launched the "
                  f"W-pass kernel {scored[-1]} times, expected {want_img}")
            o = ranks[0]["outcomes"][k]
            c, tol, _, _ = _fold_c_index(pred, arrays,
                                         ranks[0]["splits"][k][1])
            check(abs(c - o["best_c_index"]) <= tol,
                  f"predict_risk on {label}'s {ckpt.name}: C-index {c}, "
                  f"best_c_index {o['best_c_index']} (tol {tol})")
        out[label] = dict(
            wall_s=wall, ranks=world, data=dp, loss_gaps=gaps,
            ms_per_step=ms_step, calls=[g["calls"] for g in ranks],
            ingest_launches=[g["ingest_launches"] for g in ranks],
            rank_walls=[round(g["wall_s"], 2) for g in ranks],
            predict_launches=scored)
        log(f"{label} ({smi}): {world} gloo ranks on one card, wall "
            f"{wall:.2f} s (ranks' CLI walls {out[label]['rank_walls']}); "
            f"step-1 loss gaps to phase 9c {['%.2e' % g for g in gaps]}; "
            f"ms/step by fold and epoch {ms_step}; collectives by rank "
            f"{out[label]['calls']}; W-pass launches by rank "
            f"{out[label]['ingest_launches']}; folds scored with "
            f"{scored} W-pass launches")
    return out


def phase_remat(table, paths, rna_dim, smi="", device="cuda",
                image_shape=(64, 64, 32), block_config=None,
                batches=REMAT_BATCHES, steps=3, expect_launches=True):
    """14b: the flagship Trainer (PartialModalityNet at full width),
    unfused and fused_bn1, without remat, with it, and without again, at
    each batch size of ``batches``: step 1's loss on the same batch and
    dropout masks bit-equal with and without remat, and the step-1
    gradient no further from the plain step's than twice the plain step's
    own repeat (``||d|| / ||g||`` over every parameter); then ``steps``
    train steps, each
    step's ms (CUDA events) and peak ``torch.cuda.max_memory_allocated``,
    with the fused kernels' launches a step: ``moments`` and ``apply`` at
    stages + dense layers with remat (each dense layer's recompute; the
    JAX jaxpr's count, tests/test_torch_remat.py), ``bwd_reduce`` and
    ``bwd_dx`` at the stages."""
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
        make_adapters,
    )
    from multimodal_survival_prediction_tpu_torch.train.engine import (
        TrainConfig,
        Trainer,
    )

    t_phase = time.perf_counter()
    arrays = build_cohort_arrays(
        table, load_rnaseq_matrix(paths["rnaseq_csv"]), with_image=True,
        image_shape=image_shape, use_pallas=True, device=device)
    data = arrays.to_device(device)
    rows = np.arange(arrays.n)
    b2i, haa = make_adapters(CFG)
    kw = {} if block_config is None else {"block_config": block_config}
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    for batch in batches:
        cfg = TrainConfig(batch_size=batch, learning_rate=CFG.learning_rate,
                          weight_decay=CFG.weight_decay,
                          optimizer=CFG.optimizer, grad_clip=CFG.grad_clip,
                          ties=CFG.ties, seed=CFG.seed)
        for fused in (False, True):
            runs = {}
            for label, remat in (("plain", False), ("remat", True),
                                 ("plain again", False)):
                tr = Trainer(lambda gen, fused=fused, remat=remat:
                             PartialModalityNet(rna_dim=rna_dim,
                                                fused_bn1=fused, remat=remat,
                                                generator=gen, **kw),
                             b2i, haa, cfg, device=device)
                state = tr.init_state(fold=1)
                enc = state.model.ct_encoder
                layers = sum(enc.block_config)
                stages = layers + len(enc.block_config) - 1
                weights0 = {k: v.clone()
                            for k, v in state.model.state_dict().items()}
                loss1, grads = _first_step_grads(tr, state, data, rows,
                                                 CFG.seed + 1, weights0)
                shuffle = np.random.default_rng(CFG.seed + 2)
                ms, peak, losses = [], [], []
                fd.reset_launches()  # the timed steps' counts start here
                for _ in range(steps):
                    idx, bv = tr._pad_indices(rows, batch, shuffle)
                    (one,) = tr._device_batches(data, idx[:1], bv[:1])
                    sync()
                    if cuda:
                        torch.cuda.reset_peak_memory_stats()
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                    losses.append(float(tr.train_step(state, one,
                                                      CFG.learning_rate)))
                    if cuda:
                        end.record()
                        end.synchronize()
                        ms.append(round(start.elapsed_time(end), 3))
                        peak.append(round(
                            torch.cuda.max_memory_allocated() / 2**20, 1))
                launches = [k.launches for k in fd.KERNELS]  # ... read here
                runs[label] = dict(loss1=loss1, grads=grads, ms=ms,
                                   peak_mib=peak, losses=losses,
                                   launches=launches)
                per_step = ([layers + stages, layers + stages, stages,
                             stages] if remat else [stages] * 4)
                want = ([n * steps for n in per_step]
                        if fused and expect_launches else [0] * 4)
                check(launches == want,
                      f"remat={remat} fused_bn1={fused} batch {batch}: "
                      f"fused kernel launches {launches} over {steps} "
                      f"steps, expected {want}")
                check(all(math.isfinite(x) for x in losses),
                      f"remat={remat} fused_bn1={fused} batch {batch}: "
                      f"non-finite losses {losses}")
                del tr, state, grads
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
            a, b, c = runs["plain"], runs["remat"], runs["plain again"]
            check(b["loss1"] == a["loss1"],
                  f"fused_bn1={fused} batch {batch}: step-1 loss with remat "
                  f"{b['loss1']!r}, without {a['loss1']!r}")
            # the whole gradient: cuDNN's backward is not bit-repeatable,
            # and a tensor whose gradient cancels (norm0's) moves by 5-7 %
            # of itself between two plain steps, with remat or without
            names = list(a["grads"])
            gap = _grad_gap_whole(b["grads"], a["grads"])
            spread = _grad_gap_whole(c["grads"], a["grads"])
            check(gap <= 2 * spread,
                  f"fused_bn1={fused} batch {batch}: the step-1 gradient "
                  f"with remat lies {gap:.3e} from the plain one, whose own "
                  f"repeat lies {spread:.3e}")
            worst = _grad_gap(b["grads"], a["grads"], names)
            worst_again = _grad_gap(c["grads"], a["grads"], names)
            key = f"{'fused' if fused else 'unfused'} batch {batch}"
            out[key] = dict(
                stages=stages, layers=layers,
                ms_plain=a["ms"], ms_remat=b["ms"], ms_plain_again=c["ms"],
                peak_mib_plain=a["peak_mib"], peak_mib_remat=b["peak_mib"],
                launches_remat=b["launches"], launches_plain=a["launches"],
                grad_gap=gap, grad_spread=spread, loss1=a["loss1"])
            log(f"remat {key} ({smi}): step-1 loss {a['loss1']!r} with and "
                f"without; step-1 gradient ||d|| / ||g|| with remat "
                f"{gap:.3e} from plain, plain again {spread:.3e} (one "
                f"tensor at most: {worst[0]:.3e} {worst[1]}, again "
                f"{worst_again[0]:.3e} {worst_again[1]}); ms/step plain "
                f"{a['ms']}, "
                f"remat {b['ms']}, plain again {c['ms']}; peak MiB a step "
                f"plain {a['peak_mib']}, remat {b['peak_mib']}; fused "
                f"launches over {steps} steps plain {a['launches']}, remat "
                f"{b['launches']}")
    log(f"phase 14b ({smi}): wall {time.perf_counter() - t_phase:.2f} s")
    return out



# --------------------------------------------------------------------------
# 14c: fused_bn1 with dropout (the dense layer's dropout keeps the trunk's
#      memory layout), one step and the stacked vmap step
# --------------------------------------------------------------------------

DROPOUT_P = 0.2


def phase_dropout(smi="", device="cuda", image_shape=(64, 64, 32),
                  block_config=None, batch=8, phase8=None,
                  expect_launches=True):
    """14c: ``DenseNet121_3D(fused_bn1=True, dropout=0.2)`` at full width
    (it raised before: the dropout's output left the trunk out of
    channels_last_3d), fused against unfused from the same weights, input
    and dropout uniforms: step 1's loss within FIRST_LOSS_RTOL (phase 8's
    first-step limit), each fused kernel launched once a stage on the
    fused side and never on the unfused one; the whole gradient's
    ||fused - unfused|| / ||unfused|| printed beside phase 8's (dropout 0;
    not held there either). Then the same two folds (weights seeded 0 and
    1, half the batch each) in one ``vmap(grad_and_value)`` step, as the
    fold-parallel driver steps them: each fold's loss held alike, the fused
    kernels launched once a stage and a fold (the op's vmap rule runs each
    fold's rows on its own)."""
    import torch
    from torch.func import functional_call, grad_and_value, vmap

    from multimodal_survival_prediction_tpu_torch.models import (
        DenseNet121_3D,
    )
    from multimodal_survival_prediction_tpu_torch.models.layers import (
        dropout_uniforms,
    )
    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
    from multimodal_survival_prediction_tpu_torch.train.cv_parallel import (
        no_vmap_fallback,
    )

    kw = {} if block_config is None else {"block_config": block_config}
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)

    def make(fused, seed=0):
        return DenseNet121_3D(dropout=DROPOUT_P, fused_bn1=fused,
                              generator=torch.Generator().manual_seed(seed),
                              **kw).to(device).train()

    gen = torch.Generator().manual_seed(14)
    x = torch.randn((batch, *image_shape, 1), generator=gen).to(device)
    shapes = []  # the dropouts' uniforms: shapes from a forward that draws

    def record(t):  # nothing, then one seeded draw each
        shapes.append(tuple(t.shape))
        return torch.ones(t.shape, device=t.device)

    with torch.no_grad(), dropout_uniforms(record):
        make(False)(x)
    ugen = torch.Generator(device=device).manual_seed(15)
    uniforms = [torch.rand(s, generator=ugen, device=device) for s in shapes]
    blocks = make(False).block_config
    stages = sum(blocks) + len(blocks) - 1

    def step(fused):
        model = make(fused)
        feed = iter(uniforms)
        fd.reset_launches()  # this step's counts start here
        t0 = time.perf_counter()
        with dropout_uniforms(lambda t: next(feed)):
            # a loss of one sign, as phase 8's Cox loss, so that its
            # relative difference is not inflated by cancellation
            loss = (model(x).float() ** 2).mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        sync()
        launches = [k.launches for k in fd.KERNELS]  # ... and are read here
        names = [n for n, _ in model.named_parameters()]
        return (loss.item(), dict(zip(names, (g.float() for g in grads))),
                launches, time.perf_counter() - t0)

    (lf, gf, nf, wf), (lu, gu, nu, wu) = step(True), step(False)
    rel = abs(lf - lu) / max(abs(lu), 1e-12)
    gap = _grad_gap_whole(gf, gu)
    want = [stages] * 4 if expect_launches else [0] * 4
    check(rel <= FIRST_LOSS_RTOL,
          f"dropout {DROPOUT_P}: step-1 loss fused {lf} vs unfused {lu}: "
          f"rel {rel:.3e} > {FIRST_LOSS_RTOL}")
    check(nf == want and nu == [0] * 4,
          f"dropout {DROPOUT_P}: fused kernel launches {nf} (fused) and "
          f"{nu} (unfused), expected {want} and none")
    check(math.isfinite(gap), f"dropout {DROPOUT_P}: gradient gap {gap}")

    # the stacked step: fold k = weights seeded k, the batch's k-th half
    half = batch // 2
    xs = x.view(2, half, *x.shape[1:])
    us = [u.view(2, half, *u.shape[1:]) for u in uniforms]

    def stacked(fused):
        models = [make(fused, seed=k) for k in range(2)]
        template = models[0]
        params = {n: torch.stack([dict(m.named_parameters())[n].detach()
                                  for m in models])
                  for n, _ in template.named_parameters()}
        buffers = {n: torch.stack([dict(m.named_buffers())[n]
                                   for m in models])
                   for n, _ in template.named_buffers()}

        def fold_loss(p, b, xx, uu):
            feed = iter(uu)
            with dropout_uniforms(lambda t: next(feed)):
                return (functional_call(template, (p, b), (xx,)).float()
                        ** 2).mean()

        fd.reset_launches()  # this step's counts start here
        t0 = time.perf_counter()
        with no_vmap_fallback():
            _, loss = vmap(grad_and_value(fold_loss))(params, buffers, xs,
                                                      us)
        sync()
        return (loss.tolist(), [k.launches for k in fd.KERNELS],
                time.perf_counter() - t0)

    (vf, nvf, wvf), (vu, nvu, wvu) = stacked(True), stacked(False)
    vrel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(vf, vu)]
    vwant = [2 * stages] * 4 if expect_launches else [0] * 4
    check(all(r <= FIRST_LOSS_RTOL for r in vrel),
          f"dropout {DROPOUT_P}, vmapped folds: losses fused {vf} vs "
          f"unfused {vu}: rel {vrel} > {FIRST_LOSS_RTOL}")
    check(nvf == vwant and nvu == [0] * 4,
          f"dropout {DROPOUT_P}, vmapped folds: fused kernel launches "
          f"{nvf} (fused) and {nvu} (unfused), expected {vwant} and none")
    ref = "" if phase8 is None else (
        f" (phase 8, dropout 0: {phase8['grad_gap_all']:.3e})")
    log(f"fused_bn1 with dropout {DROPOUT_P} ({smi}): DenseNet121-3D "
        f"{tuple(image_shape)} batch {batch}, {stages} fused stages; step 1 "
        f"loss fused {lf:.7f} vs unfused {lu:.7f}, rel {rel:.3e} (tol "
        f"{FIRST_LOSS_RTOL}); whole gradient ||d|| / ||unfused|| "
        f"{gap:.3e}{ref}, not held; fused launches {nf}; walls s "
        f"{wf:.2f} / {wu:.2f}. vmapped 2 folds x {half}: losses rel "
        f"{['%.2e' % r for r in vrel]}, fused launches {nvf}; walls s "
        f"{wvf:.2f} / {wvu:.2f}")
    return dict(loss_rel=rel, grad_gap_all=gap, launches=nf,
                vmap_loss_rel=vrel, vmap_launches=nvf)


# --------------------------------------------------------------------------
# 15: the serving demo (demo_e2e.py) on the phase-4 cohort
# --------------------------------------------------------------------------

DEMO_ARGS = ("--backbone", "densenet121", "--image-shape", "64,64,32",
             "--n-folds", "2", "--epochs", "1", "--serve-batch", "8")
# JAX scripts/serving/demo_e2e.py's serving_summary.json keys
DEMO_SUMMARY_KEYS = ["model", "n_holdout", "n_http_requests",
                     "holdout_c_index", "logrank_p", "serve_seconds",
                     "folds", "backbone"]
FIGURES_SKIPPED = "skipped: matplotlib is not installed"


def phase_demo(work, paths, smi="", device="cuda", demo_args=DEMO_ARGS):
    """15: ``python -m multimodal_survival_prediction_tpu_torch.demo_e2e
    --device cuda`` at full width on the phase-4 cohort (5,005 genes;
    DenseNet121-3D at 64x64x32, 2 folds x 1 epoch, requests of 8): the
    CV driver trains, the training cohort calibrates, the holdout is
    served over HTTP. Its artifacts are checked (the predictions CSV, the
    calibration, evaluation_summary.json, serving_summary.json with JAX's
    keys); each served risk against predict_risk's per-fold log-hazards
    on the holdout, z-scored by calibration.json and averaged: within
    RISK_TOL on the log-hazard, carried through the z-score (phase 10's
    rule). Without matplotlib (this machine) the figure-skip line must be
    printed; with it, the three PNGs must exist. The demo reaches no
    hand-written kernel (its ingest is the plain resample, as JAX's).
    Returns the walls the demo printed and the check's numbers."""
    import dataclasses
    import importlib.util

    import numpy as np

    from multimodal_survival_prediction_tpu_torch.config import ALL_CONFIGS
    from multimodal_survival_prediction_tpu_torch.data.matching_table import (
        load_matching_table,
    )
    from multimodal_survival_prediction_tpu_torch.demo_e2e import (
        PREDICTION_COLUMNS,
        holdout_split,
    )
    from multimodal_survival_prediction_tpu_torch.preprocess.tables import (
        read_table,
    )
    from multimodal_survival_prediction_tpu_torch.train.predict import (
        predict_risk,
    )

    out, models = work / "demo_out", work / "demo_models"
    argv = [sys.executable, "-m",
            "multimodal_survival_prediction_tpu_torch.demo_e2e", "--device",
            device, "--data-root", str(paths["root"]), "--models-dir",
            str(models), "--out-dir", str(out), *demo_args]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=900, check=False)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"demo_e2e exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    walls = json.loads(next(ln for ln in lines if ln.startswith(
        "[demo] walls s "))[len("[demo] walls s "):])
    on_disk = json.loads((out / "serving_summary.json").read_text())
    check(list(on_disk) == DEMO_SUMMARY_KEYS and on_disk == summary,
          f"serving_summary.json {on_disk} (keys {DEMO_SUMMARY_KEYS})")
    ev = json.loads((out / "evaluation" / "evaluation_summary.json")
                    .read_text())
    check(ev["n_patients"] == summary["n_holdout"] >= 4,
          f"evaluation of {ev['n_patients']} patients, "
          f"{summary['n_holdout']} served")
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    pngs = sorted(p.name for p in (out / "evaluation").glob("*.png"))
    if has_mpl:
        check(len(pngs) == 3, f"figures {pngs}")
    else:
        check(FIGURES_SKIPPED in proc.stderr and not pngs,
              f"no matplotlib here: the figure-skip line is missing "
              f"({pngs})")

    pred = read_table(out / "serving_predictions.csv")
    check(pred.columns == list(PREDICTION_COLUMNS),
          f"serving_predictions.csv columns {pred.columns}")
    served = dict(zip(map(str, pred.column("patient_id")),
                      pred.column("risk_score")))
    cal = json.loads((out / "calibration.json").read_text())
    mu = np.asarray([m for m, _ in cal["stats"]])
    sd = np.asarray([s for _, s in cal["stats"]]) + 1e-8
    image_shape = tuple(int(v) for v in
                        demo_args[list(demo_args).index("--image-shape") + 1]
                        .split(","))
    cfg = dataclasses.replace(ALL_CONFIGS["partial_modality"], n_folds=2,
                              image_shape=image_shape)
    _, hold = holdout_split(load_matching_table(paths["matching_table"]),
                            0.25)
    per_fold = [predict_risk(cfg, c, hold, rnaseq_csv=paths["rnaseq_csv"],
                             device=device) for c in cal["checkpoints"]]
    ids = [str(p) for p in per_fold[0]["patient_id"]]
    raw = np.stack([p["risk_score"] for p in per_fold]).astype(np.float64)
    want = ((raw - mu[:, None]) / sd[:, None]).mean(axis=0)
    check(set(served) <= set(ids) and len(served) == summary["n_holdout"],
          f"served {sorted(served)} of the holdout {ids}")
    d = np.asarray([abs(served[p] - want[ids.index(p)]) for p in served])
    per_raw = float(np.mean(1.0 / sd))
    limit = RISK_TOL * per_raw
    check(np.all(np.isfinite(d)) and float(d.max()) <= limit,
          f"served risks vs predict_risk's calibrated ensemble: max |d| "
          f"{d.max()} > {limit} (RISK_TOL {RISK_TOL} x mean(1/sd), fold sds "
          f"{sd.tolist()})")
    log(f"demo_e2e ({smi}): wall {wall:.2f} s in a fresh process "
        f"(train {walls['train']:.2f}, calibrate {walls['calibrate']:.2f}, "
        f"serve {walls['serve']:.2f}, evaluate {walls['evaluate']:.2f}); "
        f"{summary['n_holdout']} holdout patients in "
        f"{summary['n_http_requests']} /score_batch requests, holdout "
        f"C-index {summary['holdout_c_index']:.4f}; served vs predict_risk "
        f"calibrated ensemble max |d| {d.max():.3e} ({d.max() / per_raw:.3e} "
        f"on the log-hazard, limit {limit:.3e}); figures "
        + (f"{pngs}" if has_mpl else "skipped (no matplotlib), line printed"))
    return dict(wall_s=wall, walls=walls, summary=summary,
                max_d=float(d.max()), limit=limit)


# --------------------------------------------------------------------------
# 16: the kernel-build cache (io/aot_cache.py): two fresh processes, one
#     cache directory
# --------------------------------------------------------------------------

CACHE_VOLUME = (40, 48, 56)  # the W-pass's volume, int16
CACHE_FUSED = (2048, 96, 64)  # the fused kernels' (N, C, F)


def _each_kernel_once(device="cuda"):
    """Every kernel of the port launched once against its plain version:
    the CT resample through the W-pass on a ``CACHE_VOLUME`` int16 volume
    (RESAMPLE_TOL), the four fused kernels at ``CACHE_FUSED`` in float32
    (phase 7's limits) and in bf16 (phase 7b's). Returns the kernels'
    outputs (CPU tensors, by kernel) and the max |d| by kernel."""
    import torch

    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs

    gen = torch.Generator(device=device).manual_seed(16)
    vol = _volume(CACHE_VOLUME, torch.int16, gen, device)
    got = rs.resample_normalize_cuda(vol, (64, 64, OUT_W), device=device)
    want = rs.resample_normalize(vol, (64, 64, OUT_W), device=device)
    errs = {"resample_wpass": float((got - want).abs().max())}
    check(errs["resample_wpass"] <= RESAMPLE_TOL,
          f"W-pass resample max |d| {errs['resample_wpass']}")
    outputs = {"resample_wpass": [got.cpu()]}
    x, gamma, beta, w, g = _fused_inputs(*CACHE_FUSED, device, gen)
    n = CACHE_FUSED[0]
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        xc, wc, gc_ = x.to(dtype), w.to(dtype), g.to(dtype)
        held = _held_bf16 if tag else (lambda name, a, b: _held(
            name, a, b, FUSED_FWD_RTOL if "apply" in name else
            FUSED_GRAD_RTOL))
        s, sq = fd.moments(xc)
        ps, psq = fd.moments_plain(xc)
        # fd._stats from these moments (it would launch moments again)
        mean = s / n
        rstd = torch.rsqrt((sq / n - mean * mean).clamp_min(0.0) + 1e-5)
        mul = rstd * gamma
        add = beta - mean * mul
        out = fd.apply(xc, mul, add, wc)
        red = fd.bwd_reduce(xc, gc_, wc, mul, add, mean, rstd)
        pred = fd.bwd_reduce_plain(xc, gc_, wc, mul, add, mean, rstd)
        c1, c2 = pred[2] / n, pred[1] / n
        dx = fd.bwd_dx(xc, gc_, wc, mul, add, mean, rstd, c1, c2)
        errs[f"moments{tag}"] = max(
            _held(f"moments{tag}", s, ps, FUSED_FWD_RTOL),
            _held(f"moments{tag} sumsq", sq, psq, FUSED_FWD_RTOL))
        errs[f"apply{tag}"] = held(f"apply{tag}", out,
                                   fd.apply_plain(xc, mul, add, wc))
        errs[f"bwd_reduce{tag}"] = max(
            _held(f"bwd_reduce{tag} {part}", a, b, FUSED_GRAD_RTOL)
            for part, a, b in zip(("dW", "dgamma", "dbeta"), red, pred))
        errs[f"bwd_dx{tag}"] = held(
            f"bwd_dx{tag}", dx,
            fd.bwd_dx_plain(xc, gc_, wc, mul, add, mean, rstd, c1, c2))
        outputs[f"fused{tag}"] = [t.cpu() for t in (s, sq, out, *red, dx)]
    return outputs, errs


def cache_worker(cache_dir, data_root, work, out_path):
    """One fresh process of phase 16 (``python3 chip_smoke.py
    --cache-worker CACHE DATA_ROOT WORK OUT``): every nvcc library loaded
    through the cache in CACHE (built where it is missing), each kernel
    launched once against its plain version, then the partial_modality
    CLI with ``--aot-cache CACHE --pallas-resample`` for one epoch of two
    folds on DATA_ROOT. Every nvcc this process runs is recorded. Writes
    the cache's report, the nvcc runs, the kernels' outputs and launches,
    the ingest arrays and each fold's step-1 loss to OUT
    (``torch.save``)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from multimodal_survival_prediction_tpu_torch.io import aot_cache
    from multimodal_survival_prediction_tpu_torch.ops import _build
    from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd
    from multimodal_survival_prediction_tpu_torch.ops import resample as rs
    from multimodal_survival_prediction_tpu_torch.train import (
        partial_modality_training as pmt,
    )

    phase_device()
    compiles, real = [], subprocess.run

    def spy(cmd, *a, **k):  # every process the build module starts
        compiles.append(str(cmd[0]))
        return real(cmd, *a, **k)

    _build.subprocess.run = spy
    aot_cache.use(cache_dir)
    builds = (("resample_wpass.cu", ()), *fd.BUILDS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        infos = list(pool.map(lambda b: _build.build(*b)[1], builds))
    load_s = time.perf_counter() - t0
    rs.wpass.launches = 0  # the kernels' counts start here
    fd.reset_launches()
    outputs, errs = _each_kernel_once()
    torch.cuda.synchronize()
    launches = {"resample_wpass": rs.wpass.launches,
                **{f"fused_dense_{n}": k.launches
                   for n, k in zip(FUSED_NAMES, fd.KERNELS)},
                **{f"fused_dense_{n}_bf16": k.launches_bf16
                   for n, k in zip(FUSED_NAMES, fd.KERNELS)}}  # ... read
    argv = ["--data-root", str(data_root), "--results-dir",
            str(Path(work) / "results"), "--models-dir",
            str(Path(work) / "models"), "--pallas-resample", "--n-folds", "2",
            "--epochs", "1", "--device", "cuda", "--aot-cache",
            str(cache_dir)]
    run = _drive_cli(pmt.main, argv, "cuda")
    torch.save(dict(
        report=aot_cache.report(), libraries=[i["path"] for i in infos],
        nvcc=[c for c in compiles if Path(c).name == "nvcc"], load_s=load_s,
        outputs=outputs, errs=errs, launches=launches,
        arrays={k: np.asarray(v) for k, v in run["arrays"].arrays.items()},
        step1=[e[2][0] for e in run["epochs"]],
        ingest_launches=run["ingest_launches"], cli_wall_s=run["wall_s"]),
        out_path)
    return 0


def phase_cache(work, paths, smi="", device="cuda"):
    """16: two fresh processes (``cache_worker``) share one empty cache
    directory. The first must report every library as ``compile`` and run
    nvcc once for each; the second ``cache`` for each, under the same keys
    and paths, with no nvcc run. Each launches every kernel once against
    its plain version and runs the CV CLI with ``--aot-cache
    --pallas-resample`` (W-pass launches = imaging patients); the ingest
    arrays, each fold's step-1 loss and the kernels' outputs must be
    bit-equal between the two. Returns both processes' numbers."""
    import numpy as np
    import torch

    cache = work / "aot_cache"
    runs = []
    for i in (1, 2):
        out = work / f"cache_worker_{i}.pt"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--cache-worker",
             str(cache), str(paths["root"]), str(work / f"cache_run_{i}"),
             str(out)], cwd=ROOT, capture_output=True, text=True,
            timeout=900, check=False)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"cache worker {i} exited "
              f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        runs.append(dict(torch.load(out, weights_only=False), wall_s=wall))
    a, b = runs
    libs = sorted(a["report"])
    check(len(libs) == 7 and sorted(b["report"]) == libs,
          f"libraries through the cache: {libs} and {sorted(b['report'])}")
    for lib in libs:
        ra, rb = a["report"][lib], b["report"][lib]
        check(ra["source"] == "compile" and rb["source"] == "cache"
              and ra["key"] == rb["key"] and ra["path"] == rb["path"]
              and Path(ra["path"]).parent == cache / ra["key"],
              f"{lib}: first process {ra}, second {rb}")
    check(len(a["nvcc"]) == 7 and b["nvcc"] == [],
          f"nvcc runs: first process {len(a['nvcc'])}, second "
          f"{len(b['nvcc'])}")
    check(a["launches"] == b["launches"] and all(
        v == 1 for v in a["launches"].values()),
          f"each kernel once: {a['launches']} and {b['launches']}")
    check(a["arrays"].keys() == b["arrays"].keys() and all(
        np.array_equal(a["arrays"][k], b["arrays"][k], equal_nan=True)
        for k in a["arrays"]), "the two processes' ingest arrays differ")
    check(a["step1"] == b["step1"] and len(a["step1"]) == 2,
          f"step-1 losses {a['step1']} and {b['step1']}")
    for k in a["outputs"]:
        check(all(torch.equal(x, y) for x, y in zip(a["outputs"][k],
                                                     b["outputs"][k])),
              f"{k}: the two processes' kernel outputs differ")
    check(a["ingest_launches"] == b["ingest_launches"] > 0,
          f"W-pass launches in the ingests {a['ingest_launches']} and "
          f"{b['ingest_launches']}")
    log(f"kernel-build cache ({smi}): 7 libraries; first process "
        f"{a['wall_s']:.2f} s (libraries built in {a['load_s']:.2f} s, "
        f"{len(a['nvcc'])} nvcc), second {b['wall_s']:.2f} s (loaded in "
        f"{b['load_s']:.2f} s, no nvcc); CV CLI walls {a['cli_wall_s']:.2f} "
        f"/ {b['cli_wall_s']:.2f} s with {a['ingest_launches']} W-pass "
        f"launches each; ingest arrays, step-1 losses {a['step1']} and "
        f"every kernel's output bit-equal; kernels vs plain max |d| "
        f"{ {k: float('%.3e' % v) for k, v in a['errs'].items()} }")
    return dict(miss_s=a["wall_s"], hit_s=b["wall_s"], build_s=a["load_s"],
                load_s=b["load_s"], launches=a["launches"],
                ingest_launches=[a["ingest_launches"], b["ingest_launches"]],
                errs=a["errs"])


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
        cv_par = timed("9c cv parallel", phase_cv_parallel, work, table,
                       paths, n_img, cv_run, smi=smi)
        cli_bf16 = timed("9b cli bf16", phase_cli_bf16, work, table, paths,
                         n_img, smi=smi)
        families, fam_table, fam_paths = timed(
            "10 families", phase_families, work, smi=smi)
        checkpoints = timed("11 checkpoints", phase_checkpoints, work, cv_run,
                            table, paths, n_img, families, fam_table,
                            fam_paths, smi=smi)
        report = timed("12 ingest + report", phase_ingest_and_report, work,
                       table, paths, n_img, cv_run, smi=smi)
        multi = timed("13 multi-device", phase_multidevice, work, table,
                      paths, n_img, cv_run, smi=smi)
        meshes = timed("14a fold mesh", phase_fold_mesh, work, table, paths,
                       n_img, cv_par, smi=smi)
        remat = timed("14b remat", phase_remat, table, paths, 5005, smi=smi)
        dropout = timed("14c dropout", phase_dropout, smi=smi, phase8=train)
        demo = timed("15 demo", phase_demo, work, paths, smi=smi)
        cache = timed("16 cache", phase_cache, work, paths, smi=smi)
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
            "cv_parallel_ingest": cv_par["ingest_launches"],
            "cv_parallel_predict_risk": cv_par["predict_launches"],
            "streaming_ingest": cv_par["streaming_ingest_launches"],
            "cv_parallel_streaming_ingest":
                cv_par["par_streaming_ingest_launches"],
            "sweep_ingest": cv_par["sweep_ingest_launches"],
            "families_ingest": {k: v["ingest_launches"]
                                for k, v in families.items()},
            "checkpoints": checkpoints["launches"],
            "host_ingest": report["ingest"]["launches"]["host"],
            "kernel_ingest": report["ingest"]["launches"]["kernel"],
            "auto_ingest": report["ingest"]["launches"]["auto"],
            "host_pinned_predict_risk": report["pinned"]["launches"],
            "run_all": report["report"]["launches"],
            "multidevice_ingest": multi["ingest_launches"],
            "fold_mesh_ingest_by_rank": {
                k: v["ingest_launches"] for k, v in meshes.items()},
            "fold_mesh_predict_risk": {
                k: v["predict_launches"] for k, v in meshes.items()},
            "aot_cache_workers": [cache["launches"]["resample_wpass"]] * 2,
            "aot_cache_cv_ingest": cache["ingest_launches"]},
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
                "cv": cv_run["fused_launches"][name],
                "cv_parallel": dict(zip(FUSED_NAMES,
                                        cv_par["fused_launches"]))[name],
                "remat_train": {
                    k: dict(zip(FUSED_NAMES, v["launches_remat"]))[name]
                    for k, v in remat.items() if k.startswith("fused")},
                "remat_train_steps": 3,
                "dropout_step": dict(zip(FUSED_NAMES,
                                         dropout["launches"]))[name],
                "dropout_vmapped_step": dict(zip(
                    FUSED_NAMES, dropout["vmap_launches"]))[name],
                "aot_cache_workers":
                    [cache["launches"][f"fused_dense_{name}"]] * 2},
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
                                for v in cli_bf16.values()),
                "aot_cache_workers":
                    [cache["launches"][f"fused_dense_{name}_bf16"]] * 2},
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
    prof = cv_par["profile"]
    log(f"fold-parallel ({smi}): vmapped epoch ms {cv_par['epoch_ms']} "
        f"(fold-steps {cv_par['fold_steps']}) vs sequential "
        f"{cv_par['seq_epoch_ms']} (fold-steps {cv_par['seq_fold_steps']});"
        f" one vmapped step of 2 folds: device busy "
        f"{prof[0]['device_busy_ms']:.2f} ms, {prof[0]['device_launches']} "
        f"launches; one sequential step: {prof[1]['device_busy_ms']:.2f} "
        f"ms, {prof[1]['device_launches']} launches; sweep wall "
        f"{cv_par['sweep_wall_s']:.2f} s")
    build, probe = report["build"], report["ingest"]["probe"]
    log(f"host engine ({smi}): {build['compiler']}, zlib {build['zlib']}, "
        f"build {build['build_sec']:.2f} s; 'auto' chose "
        f"{report['ingest']['auto_mode']} (link {probe['link_mb_s']:.1f} "
        f"MB/s, host {probe['host_ms']:.2f} ms/vol, link "
        f"{probe['link_ms']:.2f} ms/vol); host vs kernel max |d| "
        f"{report['ingest']['max_d']:.2e}; run_all wall "
        f"{report['report']['walls']['run_all']:.2f} s")
    mprof = multi["profile"]
    log(f"multi-device ({smi}): {multi['backend']} at world size 1, phase "
        f"wall {multi['wall_s']:.2f} s, epoch-2 ms/step "
        f"{multi['ms_per_step']} vs phase 9's "
        f"{multi['phase9_ms_per_step']}, collectives a step "
        f"{min(multi['collectives_per_step'])}-"
        f"{max(multi['collectives_per_step'])}, "
        f"{multi['collective_host_us']:.1f} us of host time each; one "
        f"profiled step on the mesh of one: wall "
        f"{mprof['mesh of one']['wall_ms']:.1f} ms, device busy "
        f"{mprof['mesh of one']['device_busy_ms']:.2f} ms, "
        f"{mprof['mesh of one']['device_launches']} launches; on one "
        f"device: {mprof['one device']['wall_ms']:.1f} ms, "
        f"{mprof['one device']['device_busy_ms']:.2f} ms, "
        f"{mprof['one device']['device_launches']}")
    for label, m in meshes.items():
        log(f"{label} ({smi}): ms/step by fold and epoch "
            f"{m['ms_per_step']}, collectives by rank {m['calls']}, step-1 "
            f"loss gaps {['%.2e' % g for g in m['loss_gaps']]}")
    for key, r in remat.items():
        log(f"remat {key} ({smi}): ms/step plain {r['ms_plain']} remat "
            f"{r['ms_remat']}; peak MiB plain {r['peak_mib_plain']} remat "
            f"{r['peak_mib_remat']}")
    log(f"demo ({smi}): wall {demo['wall_s']:.2f} s, its split s "
        f"{ {k: round(v, 2) for k, v in demo['walls'].items()} }; served vs "
        f"predict_risk max |d| {demo['max_d']:.3e} (limit "
        f"{demo['limit']:.3e})")
    log(f"kernel-build cache ({smi}): miss {cache['miss_s']:.2f} s "
        f"(libraries {cache['build_s']:.2f} s), hit {cache['hit_s']:.2f} s "
        f"(libraries {cache['load_s']:.2f} s)")
    log(f"phase walls s {walls}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cache-worker"]:  # phase 16's fresh processes
        sys.exit(cache_worker(*sys.argv[2:]))
    sys.exit(main())
