"""Build a hand-written CUDA source (or the host C++ engine) into a shared
library and load it.

Each kernel source under ``ops/csrc/`` has a plain C interface, so it builds
with ``nvcc`` alone (seconds; no PyTorch headers, no ninja) and loads with
``ctypes``. The library lands in ``<repo>/build/kernels/<name>-<hash>/``
(``.gitignore``d), keyed by the hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads the cached file. A
source may build into several libraries, one for each set of ``-D``
macros (``fused_dense.cu``: the float32 and, with ``MSP_FUSED_BF16``, the
bf16 entry points of each of its three parts), each its own nvcc.

The host C++ engine (``csrc/msp_native.cpp``, ``data/native.py``) builds
through :func:`build_host` with the host compiler and the JAX package's
``csrc/Makefile`` flags (``-O3 -march=native``). Its hash also covers the
compiler's version, the machine and the CPU that ``-march=native`` resolves
to, so a library built for one CPU is never loaded on another.

Nothing here runs at import time: a kernel is built on its wrapper's first
launch (or by :func:`build`, which ``chip_smoke.py`` calls to time it).
Each (source, macros) has its own lock, so threads building different
libraries run their compilers side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
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
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
              "-shared")
_ZLIB_PROBE = "#include <zlib.h>\nint main() { return zlibVersion() == 0; }\n"

_lock = threading.Lock()  # guards _source_locks
_source_locks: dict = {}  # (source, macros) -> threading.Lock
_loaded: dict = {}  # (source, macros) -> (ctypes.CDLL, build info dict)


def _source_lock(key) -> threading.Lock:
    with _lock:
        return _source_locks.setdefault(key, threading.Lock())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (CUDA toolkit missing); the port's "
                       "kernels build only on a machine with the toolkit")


def build(source: str, macros: tuple = ()):
    """Compile ``ops/csrc/<source>`` with ``-D<macro>`` for each of
    ``macros`` (once per source hash and flags) and load it.

    Returns ``(lib, info)``: the ``ctypes.CDLL`` and a dict with the library
    path, whether it was built now, the build seconds and nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills)."""
    key = (source, tuple(macros))
    with _source_lock(key):
        if key in _loaded:
            return _loaded[key]
        src = CSRC / source
        flags = ARCH_FLAGS + NVCC_FLAGS + tuple(f"-D{m}" for m in macros)
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        name = "-".join([src.stem, *(m.lower() for m in macros)])
        out_dir = BUILD_ROOT / f"{name}-{digest}"
        lib_path = out_dir / f"lib{name}.so"
        log_path = out_dir / "nvcc.log"
        info = {"library": str(lib_path), "built": False, "build_sec": 0.0}
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
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
        _loaded[key] = (lib, info)
        return lib, info


def _host_compiler() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host C++ engine builds with the "
                       "host compiler")


def _run(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, text=True, check=False,
                          **kw)


def host_toolchain(cxx: str, scratch: Path) -> dict:
    """What a ``-march=native`` library depends on: the compiler's version,
    the machine, the CPU that ``-march=native`` resolves to, and whether
    zlib's header and library link (a small program built in
    ``scratch``)."""
    version = _run([cxx, "--version"]).stdout.splitlines()[0]
    target = _run([cxx, "-march=native", "-Q", "--help=target"]).stdout
    march = next((ln.split()[-1] for ln in target.splitlines()
                  if ln.strip().startswith("-march=")), "unknown")
    scratch.mkdir(parents=True, exist_ok=True)
    probe = scratch / f"zlib_probe.{os.getpid()}.{threading.get_ident()}"
    src = probe.with_suffix(".cpp")
    src.write_text(_ZLIB_PROBE)
    try:
        zlib = _run([cxx, str(src), "-o", str(probe), "-lz"]).returncode == 0
    finally:
        src.unlink(missing_ok=True)
        probe.unlink(missing_ok=True)
    return {"compiler": version, "machine": platform.machine(),
            "march": march, "zlib": zlib}


def build_host(source: Path, name: str):
    """Compile the C++ file ``source`` with the host compiler into
    ``build/kernels/<name>-<hash>/lib<name>.so`` (once per source hash,
    flags and toolchain) and load it.

    Links zlib where it links; elsewhere builds with ``-DMSP_NO_ZLIB``.
    Returns ``(lib, info)``: the ``ctypes.CDLL`` and a dict with the library
    path, whether it was built now, the build seconds, the compiler, the
    machine, the ``-march=native`` CPU and ``zlib``. A failed compile
    raises ``RuntimeError`` carrying the compiler's stderr."""
    source = Path(source)
    key = ("host", str(source), name)
    with _source_lock(key):
        if key in _loaded:
            return _loaded[key]
        cxx = _host_compiler()
        tool = host_toolchain(cxx, BUILD_ROOT / "probe")
        link = ("-lz",) if tool["zlib"] else ()
        defines = () if tool["zlib"] else ("-DMSP_NO_ZLIB",)
        flags = HOST_FLAGS + defines
        digest = hashlib.sha256(
            source.read_bytes() + " ".join(flags + link).encode()
            + repr(sorted(tool.items())).encode()).hexdigest()[:16]
        out_dir = BUILD_ROOT / f"{name}-{digest}"
        lib_path = out_dir / f"lib{name}.so"
        info = dict(tool, library=str(lib_path), built=False, build_sec=0.0)
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            t0 = time.perf_counter()
            proc = _run([cxx, *flags, str(source), "-o", str(tmp), *link])
            info["build_sec"] = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{cxx} failed for {source} (rc {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, lib_path)  # atomic: a reader never sees half
            info["built"] = True
        lib = ctypes.CDLL(str(lib_path))
        _loaded[key] = (lib, info)
        return lib, info
