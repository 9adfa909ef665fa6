"""Host-to-device pipelines: CT ingest (NIfTI decode on a host thread pool,
resample on the host or the device), the link probe that chooses between
them, and the batch prefetcher of streaming epochs.

Port of ``probe_link_bandwidth``, ``VolumePrefetcher`` and
``BatchPrefetcher`` in ``multimodal_survival_prediction_tpu/data/pipeline.py``.
``VolumePrefetcher`` has the same duck type (``run(jobs, out_shape,
use_pallas, hu_window=, resample=)`` plus ``last_mode``). Each volume is
decoded once (``data.native.read_nifti_fast``) on a worker thread; every
device launch stays on the consuming thread.

``resample`` placement, as in JAX:
  * 'device' — ship the raw volume in its native dtype and resample on the
    device: the fused CUDA kernel when ``use_pallas`` is set, else the plain
    bucketed torch path.
  * 'host' — the host C++ engine (``data/native.py``) resamples inside the
    decode workers and nothing crosses to the device. Without the engine a
    'host' pin logs a warning and takes 'device'.
  * 'auto' (default) — times one host resample of the first decoded volume
    against that volume's crossing of the measured link
    (:func:`probe_link_bandwidth`) and picks one path for the whole cohort;
    ``use_pallas`` pins 'device' without probing.

``BatchPrefetcher`` keeps ``depth`` host batches in flight to the device:
a background thread copies each one into pinned host memory and enqueues its
host-to-device copies on a side CUDA stream; the consumer's stream waits on
that batch's event.
"""

from __future__ import annotations

import logging
import queue
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

log = logging.getLogger(__name__)

_BW_CACHE: dict = {}  # device string -> bytes/s
_BW_PENDING: dict = {}  # device string -> (done event, result dict, nbytes)


def _round_trip(buf: np.ndarray, dev: torch.device):
    """One host -> device -> host copy of ``buf`` (pageable memory, as JAX's
    ``device_put`` takes it), fenced on the device. On the CPU there is no
    link and no copy."""
    back = torch.from_numpy(buf).to(dev).cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return back


def probe_link_bandwidth(nbytes: int = 8 << 20, timeout_sec: float = 15.0,
                         device="cuda") -> float:
    """Measured host <-> device link bandwidth (bytes/s), cached per device.

    Times one round trip of an ``nbytes`` ``uint8`` buffer (two transfers)
    after a warm one, which pays for the CUDA context in a fresh process.
    The round trip runs in a watchdog thread: when it has not finished
    within ``timeout_sec`` the probe returns the pessimistic
    ``2 * nbytes / timeout_sec`` (which makes 'auto' prefer the host path on
    exactly such a link) and leaves the thread to finish; a later call then
    caches its real measurement, as the JAX probe does."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    key = str(dev)
    if key in _BW_CACHE:
        return _BW_CACHE[key]

    pending = _BW_PENDING.get(key)
    if pending is not None:
        done, result, pn = pending
        if not done.is_set():
            return 2 * pn / timeout_sec  # still stalled: pessimistic bound
        del _BW_PENDING[key]
        if "dt" in result:  # the stall ended; the timed round trip stands
            bw = 2 * pn / max(result["dt"], 1e-9)
            _BW_CACHE[key] = bw
            log.info("link bandwidth probe (late): %.1f MB/s", bw / 1e6)
            return bw
        # the probe thread failed: measure again below

    buf = np.ones(nbytes, np.uint8)
    done = threading.Event()
    result: dict = {}

    def roundtrip():
        try:
            _round_trip(buf, dev)  # warm: the CUDA context, first copies
            t0 = time.perf_counter()
            _round_trip(buf, dev)
            result["dt"] = time.perf_counter() - t0
        except Exception as e:  # re-raised by the caller below
            result["err"] = e
        finally:
            done.set()

    threading.Thread(target=roundtrip, daemon=True,
                     name="msp-link-probe").start()
    if not done.wait(timeout_sec):
        _BW_PENDING[key] = (done, result, nbytes)
        bw = 2 * nbytes / timeout_sec
        log.warning("link bandwidth probe stalled > %.0f s; assuming < %.1f "
                    "MB/s until it completes", timeout_sec, bw / 1e6)
        return bw
    if "err" in result:
        raise result["err"]
    bw = 2 * nbytes / max(result["dt"], 1e-9)
    _BW_CACHE[key] = bw
    log.info("link bandwidth probe: %.1f MB/s", bw / 1e6)
    return bw


class VolumePrefetcher:
    """Decode NIfTIs on a host thread pool, resample on the host or on
    ``device``.

    ``run(jobs, out_shape)`` yields ``(job_id, volume_np)`` in job order,
    except that in 'auto' mode the failed decodes before the first good
    volume come first. Failed decodes yield ``(job_id, None)`` after logging
    (the reference's failure->missing-modality semantics). ``last_mode``
    records the path the last run took ('host' or 'device'), and
    ``last_probe`` what the last 'auto' choice measured (mode, host ms and
    link ms for the probe volume, link MB/s)."""

    def __init__(self, num_workers: int = 4, depth: int = 2,
                 resample: str = "auto", device="cuda"):
        self.num_workers = num_workers
        self.depth = max(1, depth)
        self.resample = resample
        self.device = device
        self.last_mode: str | None = None
        self.last_probe: dict | None = None

    def run(self, jobs, out_shape, use_pallas: bool = False,
            hu_window=None, resample: str | None = None):
        from ..ops.resample import (
            resample_normalize_bucketed,
            resample_normalize_cuda,
        )
        from ..utils.device import resolve_device
        from . import native

        mode = resample or self.resample
        self.last_probe = None
        if mode not in ("auto", "device", "host"):
            raise ValueError(f"unknown resample mode {mode!r}")
        if mode == "auto" and use_pallas:
            # an explicit device-kernel request (a checkpoint's .meta.json
            # pin) is not rerouted: host and device agree only to float
            # tolerance, and scoring-time ingest must match training-time
            mode = "device"
        if mode == "host" and not native.native_available():
            log.warning(
                "resample='host' requested but the host C++ engine did not "
                "build; using the bucketed device resample instead (the two "
                "agree within 2e-5)")
            mode = "device"
        dev = resolve_device(self.device)
        out_shape = tuple(out_shape)

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
                return i, native.read_nifti_fast(path).data
            except (OSError, EOFError, ValueError, TypeError,
                    struct.error) as e:  # unreadable/corrupt -> missing
                log.warning("decode failed for %s: %s", path, e)
                return i, None

        def decode_and_host_resample(job):
            i, vol = decode(job)
            if vol is None:
                return i, None
            try:
                return i, native.resample_normalize_host(
                    vol, out_shape, hu_window=hu_window)
            except ValueError as e:
                log.warning("host resample failed for job %s: %s", i, e)
                return i, None

        jobs = list(jobs)
        first = None  # (job_id, volume) of the probe volume
        if mode == "auto":
            if not native.native_available():
                mode = "device"  # no engine: the host path has none
            else:
                head = None
                for j, job in enumerate(jobs):
                    i, vol = decode(job)
                    if vol is not None:
                        head, jobs = (i, vol), jobs[j + 1:]
                        break
                    yield i, None  # failed decodes before the probe volume
                if head is None:
                    self.last_mode = "device"
                    return
                mode, first = self._choose(head, out_shape, hu_window, dev,
                                           preprocess)
        self.last_mode = mode
        if first is not None:
            yield first

        with ThreadPoolExecutor(self.num_workers) as pool:
            if mode == "host":
                # resample inside the GIL-free decode workers; nothing
                # crosses to the device
                yield from pool.map(decode_and_host_resample, jobs)
                return
            # depth-limited on both sides: at most `depth` resamples in
            # flight on the device, at most num_workers + depth decodes
            # outstanding on the host (raw CTs are ~80 MB each)
            job_iter = iter(jobs)
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

    def _choose(self, head, out_shape, hu_window, dev, preprocess):
        """'auto': time one host resample of the decoded probe volume
        against its crossing of the measured link. Returns the mode and the
        probe volume's result from that mode's path, so the cohort is
        single-path (host and device agree only to float tolerance)."""
        from . import native

        i, vol = head
        try:
            t0 = time.perf_counter()
            host_out = native.resample_normalize_host(vol, out_shape,
                                                      hu_window=hu_window)
            host_sec = time.perf_counter() - t0
        except ValueError as e:
            # the volume decoded fine: the device path keeps it
            log.warning("host resample failed for probe job %s: %s (device "
                        "path keeps the volume)", i, e)
            return "device", (i, preprocess(vol).cpu().numpy())
        try:
            bw = probe_link_bandwidth(device=dev)
        except Exception:  # a failed probe must not abort the ingest
            log.warning("link bandwidth probe failed; using device "
                        "resample", exc_info=True)
            return "device", (i, preprocess(vol).cpu().numpy())
        transfer_sec = vol.nbytes / bw
        mode = "host" if host_sec < transfer_sec else "device"
        log.info("resample auto-select: %s (host %.1f ms/vol vs link "
                 "transfer %.1f ms/vol at %.1f MB/s)", mode, host_sec * 1e3,
                 transfer_sec * 1e3, bw / 1e6)
        self.last_probe = dict(mode=mode, host_ms=host_sec * 1e3,
                               link_ms=transfer_sec * 1e3,
                               link_mb_s=bw / 1e6)
        if mode == "host":
            return mode, (i, host_out)
        return mode, (i, preprocess(vol).cpu().numpy())


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
