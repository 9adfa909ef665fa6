"""Kernel-build cache: build once, load in any later process (the port's
counterpart of ``multimodal_survival_prediction_tpu/io/aot_cache.py``).

What the port compiles: its model runs eagerly, so there is no program to
compile ahead of time. What a process compiles on first use is the
hand-written code: the nvcc libraries of ``ops/csrc/`` (``ops/_build.py:
build``: the W-pass and the six ``fused_dense`` libraries) and the host
C++ engine (``build_host``). Those builds are what a fleet of scorer or
trainer processes would each pay; with a shared cache directory the first
process pays them and the rest load its libraries.

:func:`use` routes every later build of the process through the cache at
``cache_dir``: each library goes into ``<cache_dir>/<key>/lib<name>.so``
beside a ``meta.json``. The entry points that take ``aot_cache_dir`` in
the JAX package call it (``RiskScorer``, ``Trainer``,
``run_cross_validation``, ``run_cross_validation_parallel``, and
``--aot-cache`` of the training, sweep and serving CLIs); without it
everything builds into ``build/kernels/`` as before.

Safety model (JAX's):
  * The key is a sha256 over the source bytes, the flags, the compiler's
    identity (its path and the sha256 of its binary: nvcc, or g++ for the
    host engine), torch's version and CUDA version, and the device: the
    card's name and compute capability for nvcc libraries, the machine and
    the CPU (``/proc/cpuinfo``'s model and flags, what ``-march=native``
    reads) for the host engine. A hit can never hand over a library built
    for another source, toolchain or card. Computing it runs no compiler.
  * ANY failure to load an entry (missing files, a ``meta.json`` that
    disagrees with the key, a library whose sha256 is not the one its
    ``meta.json`` recorded, a ``dlopen`` that fails) logs a warning,
    builds afresh and rewrites the entry. It never falls back to another
    kernel or to a plain version.
  * Writes are atomic (the library and ``meta.json`` are written to
    temporary files and renamed), so a reader never sees half an entry.
  * The cache can only save time, never change results: a hit loads the
    bytes of the same compile that a miss runs, so every number is
    bit-identical with and without it.

:func:`report` is each entry point's ``aot_info``: ``{library: {"source":
"cache" | "compile", "key", "path"}}`` for every library this process
loaded through a cache, as JAX's ``cached_compile`` reports each program.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import tempfile
import time
from pathlib import Path

from ..utils.profiling import span

log = logging.getLogger(__name__)

_FORMAT_VERSION = 1
CACHE_DIR: Path | None = None  # the process's cache (``use``), or None
_REPORT: dict = {}  # library name -> {"source", "key", "path"}


def use(cache_dir) -> Path:
    """Build and load every library that this process builds from now on
    through the cache at ``cache_dir`` (created on first store). Libraries
    loaded before keep their place."""
    global CACHE_DIR
    CACHE_DIR = Path(cache_dir)
    return CACHE_DIR


def report() -> dict:
    """``{library: {"source", "key", "path"}}`` of the libraries this
    process loaded through a cache (a copy)."""
    return {k: dict(v) for k, v in _REPORT.items()}


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def library_key(source: bytes, fingerprint: dict) -> str:
    """sha256 over the source bytes and the fingerprint (flags, compiler,
    torch, CUDA, device), 32 hex digits."""
    h = hashlib.sha256(source)
    h.update(json.dumps({"format": _FORMAT_VERSION, **fingerprint},
                        sort_keys=True).encode())
    return h.hexdigest()[:32]


def _write_atomic(path: Path, data: bytes):
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.chmod(tmp, 0o644)  # a shared cache: readable by every process
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def _load(name: str, lib_path: Path, meta_path: Path, key: str,
          fingerprint: dict):
    """``(lib, meta)`` of a complete entry, or None: silently where there
    is no entry, with a warning where one fails to load."""
    if not lib_path.exists() and not meta_path.exists():
        return None
    try:
        meta = json.loads(meta_path.read_text())
        want = json.loads(json.dumps(fingerprint))
        if meta.get("key") != key or any(meta.get(k) != v
                                         for k, v in want.items()):
            raise ValueError("meta.json disagrees with the key")
        if sha256_file(lib_path) != meta.get("library_sha256"):
            raise ValueError("the library's sha256 is not meta.json's")
        return ctypes.CDLL(str(lib_path)), meta
    except Exception as e:  # missing half, corrupt, drift, dlopen refusal
        log.warning("kernel cache %s (%s): load failed (%s: %s), "
                    "rebuilding", name, lib_path.parent, type(e).__name__, e)
        return None


def load_or_build(name: str, source: bytes, fingerprint: dict, compile_fn,
                  cache_dir: Path | None, default_root: Path):
    """The library ``lib<name>.so`` of its entry, ``<cache_dir>/<key>/``
    (or ``<default_root>/<name>-<key[:16]>/`` without a cache), loaded
    where the entry holds it for this key, else built by
    ``compile_fn(out_path, entry_dir)`` (which returns a dict of facts to
    keep, or raises) and stored. Returns ``(lib, info)``: info holds
    ``meta.json``'s fields, ``library``, ``built``, ``build_sec`` and
    ``source`` / ``key`` / ``path``; a cache's entries are also listed in
    :func:`report`. Recorded as one ``setup.kernel_library`` span."""
    with span("setup.kernel_library"):
        key = library_key(source, fingerprint)
        entry_dir = (Path(cache_dir) / key if cache_dir is not None
                     else default_root / f"{name}-{key[:16]}")
        lib_path = entry_dir / f"lib{name}.so"
        meta_path = entry_dir / "meta.json"
        hit = _load(name, lib_path, meta_path, key, fingerprint)
        if hit is not None:
            lib, meta = hit
            built, sec = False, 0.0
        else:
            entry_dir.mkdir(parents=True, exist_ok=True)
            tmp = entry_dir / f".lib{name}.{os.getpid()}.so"
            t0 = time.perf_counter()
            try:
                extra = compile_fn(tmp, entry_dir)
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
            sec = time.perf_counter() - t0
            meta = {"key": key, **fingerprint, **extra,
                    "library_sha256": sha256_file(tmp), "build_sec": sec,
                    "created": time.time()}
            os.replace(tmp, lib_path)  # atomic: a reader never sees half
            _write_atomic(meta_path, json.dumps(meta, indent=2).encode())
            lib, built = ctypes.CDLL(str(lib_path)), True
        info = dict(meta, library=str(lib_path), built=built, build_sec=sec,
                    source="compile" if built else "cache", key=key,
                    path=str(lib_path))
        if cache_dir is not None:
            _REPORT[name] = {k: info[k] for k in ("source", "key", "path")}
            log.info("kernel cache %s %s (%s)", "store" if built else "hit",
                     name, lib_path)
        return lib, info
