"""The kernel-build cache (``io/aot_cache.py``) on the CPU, through
``ops/_build.py:build_host`` (the host compiler stands in for nvcc, which
this machine lacks; ``build`` shares the same entry logic):

* a miss then a hit in two fresh processes sharing one cache directory:
  the first compiles and stores, the second loads without running the
  compiler at all;
* a corrupt library, a ``meta.json`` that disagrees and a half entry each
  log a warning, are rebuilt and rewritten;
* a changed source, or another CPU or compiler, gives another key (the
  default ``build/kernels/`` entries are keyed alike);
* ``aot_cache_dir`` / ``--aot-cache`` is taken by every entry point that
  takes it in the JAX package (and by the sweep CLI).
"""

import hashlib
import inspect
import json
import logging
import subprocess
import sys
from pathlib import Path

import pytest

from multimodal_survival_prediction_tpu_torch import serving
from multimodal_survival_prediction_tpu_torch.data import native
from multimodal_survival_prediction_tpu_torch.io import aot_cache
from multimodal_survival_prediction_tpu_torch.ops import _build
from multimodal_survival_prediction_tpu_torch.train import (
    cli,
    cv,
    cv_parallel,
    engine,
    sweep,
)

ROOT = Path(__file__).resolve().parents[1]
TINY = 'extern "C" int msp_cache_probe() { return %d; }\n'

# a fresh process: the engine through the cache in argv[1], every
# subprocess the build module starts recorded
WORKER = """
import json, subprocess, sys
from multimodal_survival_prediction_tpu_torch.data import native
from multimodal_survival_prediction_tpu_torch.io import aot_cache
from multimodal_survival_prediction_tpu_torch.ops import _build
calls = []
real = subprocess.run
def spy(cmd, *a, **k):
    calls.append(list(map(str, cmd)))
    return real(cmd, *a, **k)
_build.subprocess.run = spy
aot_cache.use(sys.argv[1])
lib, info = native.build_native()
print(json.dumps({"report": aot_cache.report(), "calls": calls,
                  "zlib": info["zlib"], "probe": native.native_available()}))
"""


@pytest.fixture
def fresh(monkeypatch):
    """This process's build state put back after the test."""
    monkeypatch.setattr(aot_cache, "CACHE_DIR", None)
    monkeypatch.setattr(_build, "_loaded", dict(_build._loaded))
    monkeypatch.setattr(aot_cache, "_REPORT", {})


def _worker(cache):
    proc = subprocess.run([sys.executable, "-c", WORKER, str(cache)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


def test_a_second_process_loads_without_compiling(tmp_path):
    first, _ = _worker(tmp_path / "cache")
    second, log = _worker(tmp_path / "cache")
    a, b = (r["report"][native.LIB_NAME] for r in (first, second))
    assert a["source"] == "compile" and b["source"] == "cache"
    assert a["key"] == b["key"] and a["path"] == b["path"]
    assert Path(a["path"]).parent == tmp_path / "cache" / a["key"]
    cxx = _build._host_compiler()
    assert sum(c[0] == cxx and "-o" in c and str(native.SOURCE) in c
               for c in first["calls"]) == 1
    assert second["calls"] == []  # no compiler run at all, not even probes
    assert second["zlib"] == first["zlib"] and second["probe"] is True
    assert "load failed" not in log
    meta = json.loads((Path(a["path"]).parent / "meta.json").read_text())
    assert meta["key"] == a["key"]
    assert meta["library_sha256"] == aot_cache.sha256_file(a["path"])
    for k in ("compiler_path", "compiler_sha256", "torch", "cuda",
              "machine", "cpu", "cpu_flags", "flags", "compiler", "zlib"):
        assert k in meta, k


def _tiny(tmp_path, value=1):
    src = tmp_path / f"tiny{value}.cpp"
    src.write_text(TINY % value)
    return src


def _garbage(entry):
    (entry / "next.so").write_bytes(b"\x7fELF not a library")
    (entry / "next.so").replace(entry / "libmsp_cache_probe.so")


def _other_key(entry):
    meta = json.loads((entry / "meta.json").read_text())
    (entry / "meta.json").write_text(json.dumps(dict(meta, key="0" * 32)))


def _no_meta(entry):
    (entry / "meta.json").unlink()


def _truncated(entry):
    """A cut library whose meta.json agrees with it: dlopen refuses."""
    lib = entry / "libmsp_cache_probe.so"
    data = lib.read_bytes()[:64]
    (entry / "next.so").write_bytes(data)
    (entry / "next.so").replace(lib)
    meta = json.loads((entry / "meta.json").read_text())
    (entry / "meta.json").write_text(json.dumps(dict(
        meta, library_sha256=hashlib.sha256(data).hexdigest())))


@pytest.mark.parametrize("break_it,why", [
    (_garbage, "sha256"), (_other_key, "disagrees"),
    (_no_meta, "meta.json"), (_truncated, "OSError")],
    ids=["corrupt", "other-key", "half", "dlopen"])
def test_a_broken_entry_is_rebuilt_with_a_warning(break_it, why, tmp_path,
                                                  fresh, caplog):
    """A good entry copied into a fresh cache (a path this process never
    loaded) and broken: the build logs the failed load, compiles afresh
    and rewrites the entry, whose library loads and runs; never the
    plain path."""
    import shutil

    src = _tiny(tmp_path)
    aot_cache.use(tmp_path / "good")
    _, info = _build.build_host(src, "msp_cache_probe")
    entry = tmp_path / "broken" / info["key"]
    shutil.copytree(Path(info["path"]).parent, entry)
    break_it(entry)
    aot_cache.use(tmp_path / "broken")
    with caplog.at_level(logging.WARNING, logger=aot_cache.__name__):
        lib, again = _build.build_host(src, "msp_cache_probe")
    assert again["source"] == "compile" and again["key"] == info["key"]
    assert Path(again["path"]).parent == entry
    assert lib.msp_cache_probe() == 1
    assert any("load failed" in r.message and why in r.message
               for r in caplog.records), caplog.text
    meta = json.loads((entry / "meta.json").read_text())
    assert meta["key"] == info["key"]
    assert meta["library_sha256"] == aot_cache.sha256_file(again["path"])


def test_the_key_covers_source_toolchain_and_cpu(tmp_path, fresh,
                                                 monkeypatch):
    """A changed source is another entry; another CPU or another compiler
    binary too, in the cache and in build/kernels alike; the same inputs
    hit."""
    cache = tmp_path / "cache"
    aot_cache.use(cache)
    src = _tiny(tmp_path)
    _, one = _build.build_host(src, "msp_cache_probe")
    src.write_text(TINY % 2)
    _build._loaded.clear()
    lib, two = _build.build_host(src, "msp_cache_probe")
    assert two["key"] != one["key"] and lib.msp_cache_probe() == 2
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [one["key"], two["key"]])

    here = _build.cpu_fields()
    monkeypatch.setattr(_build, "cpu_fields",
                        lambda: dict(here, cpu="another CPU"))
    _build._loaded.clear()
    _, three = _build.build_host(src, "msp_cache_probe")
    assert three["key"] not in (one["key"], two["key"])

    monkeypatch.setattr(_build, "_binary_sha256", lambda path: "f" * 64)
    _build._loaded.clear()
    _, four = _build.build_host(src, "msp_cache_probe")
    assert four["key"] not in (one["key"], two["key"], three["key"])
    _build._loaded.clear()
    _, hit = _build.build_host(src, "msp_cache_probe")
    assert hit["source"] == "cache" and hit["key"] == four["key"]

    # without a cache: build/kernels/<name>-<key[:16]>, keyed alike
    monkeypatch.setattr(aot_cache, "CACHE_DIR", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    _build._loaded.clear()
    _, default = _build.build_host(src, "msp_cache_probe")
    assert Path(default["path"]).parent == \
        tmp_path / "kernels" / f"msp_cache_probe-{four['key'][:16]}"
    assert (Path(default["path"]).parent / "meta.json").exists()
    assert aot_cache.report()["msp_cache_probe"]["key"] == four["key"]


@pytest.mark.parametrize("entry", [
    "RiskScorer", "Trainer", "run_cross_validation",
    "run_cross_validation_parallel", "run_hyperparameter_sweep"])
def test_every_entry_point_takes_the_cache_dir(entry):
    fn = {"RiskScorer": serving.RiskScorer, "Trainer": engine.Trainer,
          "run_cross_validation": cv.run_cross_validation,
          "run_cross_validation_parallel":
              cv_parallel.run_cross_validation_parallel,
          "run_hyperparameter_sweep": sweep.run_hyperparameter_sweep}[entry]
    params = inspect.signature(fn).parameters
    assert params["aot_cache_dir"].default is None
    for mod in (cv, cv_parallel, engine, serving, sweep):
        assert "NotImplementedError" not in inspect.getsource(mod)


@pytest.mark.parametrize("parser", ["training", "serving"])
def test_the_clis_take_aot_cache(parser, monkeypatch):
    if parser == "training":
        args = cli.base_parser("x").parse_args(["--aot-cache", "d"])
        assert args.aot_cache == "d"
        return
    seen = {}

    class _Scorer:
        cfg = serving.ALL_CONFIGS["rnaseq_only"]
        aot_info = {"lib": {"source": "cache"}}

        def __init__(self, *a, **k):
            seen.update(k)

    class _Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    monkeypatch.setattr(serving, "RiskScorer", _Scorer)
    monkeypatch.setattr(serving, "make_server", lambda *a, **k: _Server())
    serving.main(["--model", "rnaseq_only", "--checkpoint", "a.pt",
                  "--aot-cache", "d", "--device", "cpu"])
    assert seen["aot_cache_dir"] == "d"
