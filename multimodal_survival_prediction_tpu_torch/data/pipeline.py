"""CT ingest: NIfTI decode on a host thread pool, resample on the device.

Port of ``VolumePrefetcher`` in
``multimodal_survival_prediction_tpu/data/pipeline.py``, with the same duck
type (``run(jobs, out_shape, use_pallas, hu_window=, resample=)`` plus
``last_mode``). Each volume is decoded once on a worker thread while the
device resamples the previous one; every launch stays on the consuming
thread.

``resample`` placement:
  * 'device' — ship the raw volume in its native dtype and resample on the
    device: the fused CUDA kernel when ``use_pallas`` is set, else the plain
    bucketed torch path.
  * 'auto' (default) — resolves to 'device' and records that in
    ``last_mode``: the host C++ resample engine is not ported, and 'auto'
    resolves the same way in JAX when that engine is absent.
  * 'host' — the host C++ engine (``data/native.py`` + ``csrc/`` in the JAX
    package); not ported, raises (ROADMAP.md Queue 1 item 7).

``BatchPrefetcher`` and ``probe_link_bandwidth`` are not ported yet.
"""

from __future__ import annotations

import logging
import struct
from collections import deque
from concurrent.futures import ThreadPoolExecutor

log = logging.getLogger(__name__)


class VolumePrefetcher:
    """Decode NIfTIs on a host thread pool, resample on ``device``.

    ``run(jobs, out_shape)`` yields ``(job_id, volume_np)``; order follows
    the jobs. Failed decodes yield ``(job_id, None)`` after logging (the
    reference's failure->missing-modality semantics)."""

    def __init__(self, num_workers: int = 4, depth: int = 2,
                 resample: str = "auto", device="cuda"):
        self.num_workers = num_workers
        self.depth = max(1, depth)
        self.resample = resample
        self.device = device
        self.last_mode: str | None = None

    def run(self, jobs, out_shape, use_pallas: bool = False,
            hu_window=None, resample: str | None = None):
        from ..ops.resample import (
            resample_normalize_bucketed,
            resample_normalize_cuda,
        )
        from ..utils.device import resolve_device
        from .nifti import read_nifti

        mode = resample or self.resample
        if mode == "host":
            raise NotImplementedError(
                "resample='host' needs the host C++ resample engine, which "
                "is not ported yet (ROADMAP.md Queue 1 item 7); use "
                "'device' or 'auto'")
        if mode not in ("auto", "device"):
            raise ValueError(f"unknown resample mode {mode!r}")
        mode = "device"  # 'auto' has no host engine to choose
        dev = resolve_device(self.device)
        out_shape = tuple(out_shape)
        self.last_mode = mode

        def preprocess(vol):
            # use_pallas = the fused single-pass kernel (exact shape);
            # otherwise the plain bucketed path
            if use_pallas:
                return resample_normalize_cuda(vol, out_shape,
                                               hu_window=hu_window, device=dev)
            return resample_normalize_bucketed(vol, out_shape,
                                               hu_window=hu_window, device=dev)

        def decode(job):
            i, path = job
            try:
                return i, read_nifti(path).data
            except (OSError, EOFError, ValueError, TypeError,
                    struct.error) as e:  # unreadable/corrupt -> missing
                log.warning("decode failed for %s: %s", path, e)
                return i, None

        with ThreadPoolExecutor(self.num_workers) as pool:
            # depth-limited on both sides: at most `depth` resamples in
            # flight on the device, at most num_workers + depth decodes
            # outstanding on the host (raw CTs are ~80 MB each)
            job_iter = iter(list(jobs))
            futures: deque = deque()

            def submit_more():
                while len(futures) < self.num_workers + self.depth:
                    job = next(job_iter, None)
                    if job is None:
                        break
                    futures.append(pool.submit(decode, job))

            submit_more()
            inflight: deque = deque()
            while futures:
                i, vol = futures.popleft().result()
                submit_more()
                if vol is None:
                    while inflight:  # keep the yield order = job order
                        j, o = inflight.popleft()
                        yield j, o.cpu().numpy()
                    yield i, None
                    continue
                inflight.append((i, preprocess(vol)))
                if len(inflight) >= self.depth:
                    j, o = inflight.popleft()
                    yield j, o.cpu().numpy()  # waits for the device
            for j, o in inflight:
                yield j, o.cpu().numpy()
