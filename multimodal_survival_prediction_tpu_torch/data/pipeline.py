"""Host-to-device pipelines: CT ingest (NIfTI decode on a host thread pool,
resample on the device) and the batch prefetcher of streaming epochs.

Port of ``VolumePrefetcher`` and ``BatchPrefetcher`` in
``multimodal_survival_prediction_tpu/data/pipeline.py``.
``VolumePrefetcher`` has the same duck type (``run(jobs, out_shape,
use_pallas, hu_window=, resample=)`` plus ``last_mode``). Each volume is decoded once on a worker thread while the
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

``BatchPrefetcher`` keeps ``depth`` host batches in flight to the device:
a background thread copies each one into pinned host memory and enqueues its
host-to-device copies on a side CUDA stream; the consumer's stream waits on
that batch's event. ``probe_link_bandwidth`` is not ported yet (ROADMAP.md
Queue 1 item 7, which needs it for ``resample='auto'``).
"""

from __future__ import annotations

import logging
import queue
import struct
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

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


class BatchPrefetcher:
    """Wrap an iterator of host batches (dicts of numpy arrays) with a
    ``depth``-deep queue of batches on ``device``.

    A background thread pulls a batch, copies each array into pinned host
    memory and enqueues its copy to the device with ``non_blocking=True`` on
    a side CUDA stream, then records an event there. ``__next__`` makes the
    consumer's current stream wait on that event and marks the tensors as
    used on it (``record_stream``), so the copy of batch i+1 overlaps the
    step on batch i. At most ``depth`` batches are pulled from the iterator
    and not yet handed to the consumer. An exception in the iterator or in
    a copy is raised by the consumer's ``__next__``. With ``device="cpu"``
    it is a plain queue of tensors that share the batches' memory.

    ``side_stream_copies`` counts the batches copied on a side stream, over
    every instance (a check that streaming epochs used the pipeline)."""

    side_stream_copies = 0

    def __init__(self, iterator, depth: int = 2, device="cuda"):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.depth = max(1, depth)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._slots = threading.Semaphore(self.depth)
        self._q: queue.Queue = queue.Queue()
        self._done = object()
        self._closed = False
        self._err: list = []
        self._thread = threading.Thread(target=self._fill,
                                        args=(iter(iterator),), daemon=True)
        self._thread.start()

    def _to_device(self, batch: dict):
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
        if self.stream is None:
            return tensors, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in tensors.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        BatchPrefetcher.side_stream_copies += 1
        return out, event

    def _fill(self, it):
        try:
            while True:
                self._slots.acquire()
                if self._closed:
                    break
                batch = next(it, self._done)
                if batch is self._done:
                    break
                self._q.put(self._to_device(batch))
        except Exception as e:  # surfaced by the consumer's __next__
            self._err.append(e)
        finally:
            self._q.put((self._done, None))

    def __iter__(self):
        return self

    def __next__(self):
        item, event = self._q.get()
        if item is self._done:
            self._q.put((self._done, None))  # a later __next__ stops too
            if self._err:
                raise self._err[0]
            raise StopIteration
        self._slots.release()
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in item.values():
                t.record_stream(stream)
        return item

    def close(self):
        """Stop pulling batches (the thread ends at its next slot); safe to
        call after the iterator is exhausted."""
        self._closed = True
        self._slots.release()
