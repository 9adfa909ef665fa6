"""Build a hand-written CUDA source into a shared library and load it.

Each kernel source under ``ops/csrc/`` has a plain C interface, so it builds
with ``nvcc`` alone (seconds; no PyTorch headers, no ninja) and loads with
``ctypes``. The library lands in ``<repo>/build/kernels/<name>-<hash>/``
(``.gitignore``d), keyed by the hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads the cached file.

Nothing here runs at import time: a kernel is built on its wrapper's first
launch (or by :func:`build`, which ``chip_smoke.py`` calls to time it).
Each source has its own lock, so threads building different sources run
their ``nvcc`` processes side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()  # guards _source_locks
_source_locks: dict = {}  # source name -> threading.Lock
_loaded: dict = {}  # source name -> (ctypes.CDLL, build info dict)


def _source_lock(source: str) -> threading.Lock:
    with _lock:
        return _source_locks.setdefault(source, threading.Lock())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (CUDA toolkit missing); the port's "
                       "kernels build only on a machine with the toolkit")


def build(source: str):
    """Compile ``ops/csrc/<source>`` (once per source hash) and load it.

    Returns ``(lib, info)``: the ``ctypes.CDLL`` and a dict with the library
    path, whether it was built now, the build seconds and nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills)."""
    with _source_lock(source):
        if source in _loaded:
            return _loaded[source]
        src = CSRC / source
        flags = ARCH_FLAGS + NVCC_FLAGS
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        out_dir = BUILD_ROOT / f"{src.stem}-{digest}"
        lib_path = out_dir / f"lib{src.stem}.so"
        log_path = out_dir / "nvcc.log"
        info = {"library": str(lib_path), "built": False, "build_sec": 0.0}
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                capture_output=True, text=True, check=False)
            info["build_sec"] = time.perf_counter() - t0
            log_path.write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (rc {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, lib_path)  # atomic: a reader never sees half
            info["built"] = True
        info["ptxas"] = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        _loaded[source] = (lib, info)
        return lib, info
