"""Build a hand-written CUDA source (or the host C++ engine) into a shared
library and load it.

Each kernel source under ``ops/csrc/`` has a plain C interface, so it builds
with ``nvcc`` alone (seconds; no PyTorch headers, no ninja) and loads with
``ctypes``. The library lands in ``<repo>/build/kernels/<name>-<hash>/``
(``.gitignore``d) beside a ``meta.json``, keyed by the hash of the source,
the flags, the compiler (its path and the sha256 of its binary), torch's
and CUDA's versions and the device (the card's name and compute
capability), so an edited source, another toolkit or another card
rebuilds and an unchanged one loads the stored file. A source may build
into several libraries, one for each set of ``-D`` macros
(``fused_dense.cu``: the float32 and, with ``MSP_FUSED_BF16``, the bf16
entry points of each of its three parts), each its own nvcc.

The host C++ engine (``csrc/msp_native.cpp``, ``data/native.py``) builds
through :func:`build_host` with the host compiler and the JAX package's
``csrc/Makefile`` flags (``-O3 -march=native``). Its key covers the host
compiler and the CPU that ``-march=native`` resolves to (``/proc/cpuinfo``'s
model and flags) in place of the card, so a library built for one CPU is
never loaded on another.

With a cache directory set (``io/aot_cache.py:use``, the entry points'
``aot_cache_dir``) every library goes into ``<cache_dir>/<key>/`` instead,
under the same key; ``io/aot_cache.py:load_or_build`` loads, checks and
stores both kinds of entry. Working out a key runs no compiler.

Nothing here runs at import time: a kernel is built on its wrapper's first
launch (or by :func:`build`, which ``chip_smoke.py`` calls to time it).
Each (source, macros, cache directory) has its own lock, so threads
building different libraries run their compilers side by side.
"""

from __future__ import annotations

import functools
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..io import aot_cache

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
              "-shared")
_ZLIB_PROBE = "#include <zlib.h>\nint main() { return zlibVersion() == 0; }\n"

_lock = threading.Lock()  # guards _source_locks
_source_locks: dict = {}  # (source, macros, cache dir) -> threading.Lock
_loaded: dict = {}  # (source, macros, cache dir) -> (ctypes.CDLL, info)


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


@functools.lru_cache(maxsize=None)
def _binary_sha256(path: str) -> str:
    return aot_cache.sha256_file(os.path.realpath(path))


def _torch_fields() -> dict:
    return {"torch": torch.__version__, "cuda": torch.version.cuda}


def card_fields() -> dict:
    """The current card's name and compute capability (None without
    CUDA): what an sm_90a library is built for."""
    if not torch.cuda.is_available():
        return {"device": None, "capability": None}
    i = torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(i),
            "capability": "%d.%d" % torch.cuda.get_device_capability(i)}


@functools.lru_cache(maxsize=None)
def cpu_fields() -> dict:
    """The machine and the CPU that ``-march=native`` resolves to: the
    first processor's model and flags in ``/proc/cpuinfo`` (the CPUID
    bits g++ reads), or ``platform.processor()`` without it."""
    fields = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            k, _, v = line.partition(":")
            k = k.strip()
            if k in ("model name", "flags") and k not in fields:
                fields[k] = " ".join(v.split())
            if not line.strip() and fields:
                break
    except OSError:
        pass
    return {"machine": platform.machine(),
            "cpu": fields.get("model name") or platform.processor(),
            "cpu_flags": fields.get("flags", "")}


def build(source: str, macros: tuple = ()):
    """Compile ``ops/csrc/<source>`` with ``-D<macro>`` for each of
    ``macros`` (once per key: source, flags, nvcc, torch, CUDA, card) and
    load it.

    Returns ``(lib, info)``: the ``ctypes.CDLL`` and a dict with the library
    path, whether it was built now, the build seconds, nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills) and the
    cache's ``source`` / ``key`` / ``path``."""
    cache = aot_cache.CACHE_DIR
    key = (source, tuple(macros), cache)
    with _source_lock(key):
        if key in _loaded:
            return _loaded[key]
        src = CSRC / source
        flags = ARCH_FLAGS + NVCC_FLAGS + tuple(f"-D{m}" for m in macros)
        name = "-".join([src.stem, *(m.lower() for m in macros)])
        nvcc = _nvcc()
        fingerprint = {"name": name, "flags": list(flags),
                       "compiler_path": nvcc,
                       "compiler_sha256": _binary_sha256(nvcc),
                       **_torch_fields(), **card_fields()}
        code = src.read_bytes()

        def compile_(out: Path, entry_dir: Path) -> dict:
            proc = subprocess.run([nvcc, *flags, "-o", str(out), str(src)],
                                  capture_output=True, text=True,
                                  check=False)
            (entry_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (rc {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}")
            return {}

        lib, info = aot_cache.load_or_build(name, code, fingerprint,
                                            compile_, cache, BUILD_ROOT)
        log_path = Path(info["path"]).parent / "nvcc.log"
        info["ptxas"] = log_path.read_text() if log_path.exists() else ""
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
    ``build/kernels/<name>-<hash>/lib<name>.so`` (or the cache's entry;
    once per key: source, flags, compiler, torch, CUDA, machine and CPU)
    and load it.

    Links zlib where it links; elsewhere builds with ``-DMSP_NO_ZLIB``.
    Returns ``(lib, info)``: the ``ctypes.CDLL`` and a dict with the library
    path, whether it was built now, the build seconds, the compiler's
    version, the machine, the ``-march=native`` CPU, ``zlib`` and the
    cache's ``source`` / ``key`` / ``path`` (the toolchain facts are those
    of the build, kept in ``meta.json``). A failed compile raises
    ``RuntimeError`` carrying the compiler's stderr."""
    source = Path(source)
    cache = aot_cache.CACHE_DIR
    key = ("host", str(source), name, cache)
    with _source_lock(key):
        if key in _loaded:
            return _loaded[key]
        cxx = _host_compiler()
        fingerprint = {"name": name, "flags": list(HOST_FLAGS),
                       "compiler_path": cxx,
                       "compiler_sha256": _binary_sha256(cxx),
                       **_torch_fields(), **cpu_fields()}
        code = source.read_bytes()

        def compile_(out: Path, entry_dir: Path) -> dict:
            tool = host_toolchain(cxx, BUILD_ROOT / "probe")
            link = ("-lz",) if tool["zlib"] else ()
            defines = () if tool["zlib"] else ("-DMSP_NO_ZLIB",)
            proc = _run([cxx, *HOST_FLAGS, *defines, str(source), "-o",
                         str(out), *link])
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{cxx} failed for {source} (rc {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}")
            return {"compiler": tool["compiler"],
                    "march": tool["march"], "zlib": tool["zlib"],
                    "build_flags": [*HOST_FLAGS, *defines, *link]}

        lib, info = aot_cache.load_or_build(name, code, fingerprint,
                                            compile_, cache, BUILD_ROOT)
        _loaded[key] = (lib, info)
        return lib, info
