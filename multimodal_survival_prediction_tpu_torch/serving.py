"""Risk-scoring service layer (port of
``multimodal_survival_prediction_tpu/serving.py``).

``RiskScorer`` loads fold checkpoints once and scores single patients or
micro-batches, with CT preprocessing on the device; ``make_server`` wraps
it in the same HTTP contract as the JAX package (/healthz, /score,
/score_batch; 400 for bad input, 500 for faults, 404 elsewhere).

Serve from the command line (fold checkpoints in any format of
``io/checkpoint.py``; ``--calibration`` takes the ``calibration.json`` of
``python -m multimodal_survival_prediction_tpu_torch.tools.calibrate``):

    python -m multimodal_survival_prediction_tpu_torch.serving \\
        --checkpoint models/partial_modality/fold_1_best.pt --port 8080

The constructor warms every fold model (:meth:`RiskScorer.warmup`), so the
first request does not pay cuDNN's first calls.

Scoring runs under ``torch.inference_mode()`` with the models in eval mode
(read-only), and every request allocates its own tensors, so handler
threads share no mutable state.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from .config import ALL_CONFIGS, ModelRunConfig
from .io import aot_cache
from .io.checkpoint import load_checkpoint, load_fold_meta
from .ops.resample import resample_normalize_bucketed
from .train.adapters import make_model_and_adapters
from .utils.device import pin_fp32_policy, resolve_device

log = logging.getLogger(__name__)


class RiskScorer:
    """One set of loaded fold models, scoring forever.

    Args:
      model_name: config key (e.g. 'partial_modality').
      checkpoint_path: models/<name>/fold_K_best.{pt,msgpack,pth} — or a
        SEQUENCE of fold checkpoints for a fold ensemble (per-fold hazards,
        then averaged); formats may mix.
      batch_size: patients per forward pass in ``score_many``.
      fold_calibration: optional per-fold (mu, sd) pairs (e.g. from
        ``train.predict.predict_risk(..., return_fold_stats=True)``): each
        fold's hazard is z-scored before averaging, matching predict_risk's
        ensemble; without it the raw per-fold hazards are averaged.
      hu_window: CT Hounsfield window — must match training ingest.
      no_image_variant: also warm the image-less route at construction
        (:meth:`warmup_no_image`): image-less requests then build their
        zero image plane on the device instead of shipping it from the host
        (the same result); image-free families always do.
      aot_cache_dir: the kernel-build cache's directory
        (``io/aot_cache.py``): every library this process builds from
        here on goes through it, and the host engine that decodes the
        requests' CTs (image families) is loaded through it at
        construction; ``self.aot_info`` reports each library's
        provenance, as JAX's per program.
      device: where the models run and CTs are resampled (default 'cuda').

    Ingest decodes with ``data.native.read_nifti_fast`` and resamples
    with the plain bucketed resample, as in the JAX server.
    """

    def __init__(self, model_name: str, checkpoint_path,
                 backbone: str | None = None, batch_size: int = 1,
                 rna_dim: int | None = None, image_shape=None,
                 hu_window=None, fold_calibration=None,
                 no_image_variant: bool = False, aot_cache_dir=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg: ModelRunConfig = ALL_CONFIGS[model_name]
        self.aot_cache_dir = aot_cache_dir
        if aot_cache_dir is not None:
            aot_cache.use(aot_cache_dir)
            if "image" in self.cfg.modalities:
                from .data import native

                try:  # the engine that decodes the requests' CTs
                    native.build_native()
                except (RuntimeError, OSError) as e:
                    # read_nifti_fast then reads through Python, as JAX's
                    log.warning("host C++ engine unavailable: %s", e)
        paths = ([checkpoint_path]
                 if isinstance(checkpoint_path, (str, Path))
                 else list(checkpoint_path))
        if not paths:
            raise ValueError("checkpoint_path is empty")
        meta = load_fold_meta(paths[0]) or {}
        backbone = backbone or meta.get("backbone") or "densenet121"
        self.image_shape = tuple(
            image_shape if image_shape is not None
            else meta.get("image_shape") or (64, 64, 32))
        self.rna_dim = int(rna_dim if rna_dim is not None
                           else meta.get("rna_dim") or 5005)
        self.batch_size = batch_size
        if hu_window is None and meta.get("hu_window"):
            hu_window = meta["hu_window"]
        self.hu_window = tuple(hu_window) if hu_window is not None else None

        self.models = []
        for p in paths:
            model, self._batch_to_inputs, hazard_and_aux = \
                make_model_and_adapters(self.cfg, rna_dim=self.rna_dim,
                                        backbone=backbone)
            model = model.to(self.device).eval()
            model.load_state_dict(load_checkpoint(
                p, self.device, model_name=self.cfg.name), strict=True)
            self.models.append(model)
        self._hazard_and_aux = hazard_and_aux or (lambda out, b: (out, 0.0))
        self.n_folds = len(paths)

        if fold_calibration is not None:
            if len(fold_calibration) != self.n_folds:
                raise ValueError(
                    f"fold_calibration has {len(fold_calibration)} entries "
                    f"for {self.n_folds} checkpoints")
            self._cal_mu = np.asarray([m for m, _ in fold_calibration],
                                      np.float32)
            self._cal_sd = np.asarray([s for _, s in fold_calibration],
                                      np.float32) + 1e-8
        else:
            self._cal_mu = self._cal_sd = None
        self._has_image_modality = "image" in self.cfg.modalities
        self._no_image_ready = False
        self.warmup(no_image_variant=no_image_variant)

    @property
    def aot_info(self) -> dict:
        """``{library: {"source": "cache" | "compile", "key", "path"}}`` of
        the libraries loaded through the cache; empty without
        ``aot_cache_dir``."""
        return aot_cache.report() if self.aot_cache_dir is not None else {}

    def _empty_host(self, b, with_image):
        """Host zeros of one request batch, the arrays ``_fill_row`` fills
        (the image plane only ``with_image``)."""
        host = {
            "rnaseq": np.zeros((b, self.rna_dim), np.float32),
            "clinical": np.zeros((b, 1), np.float32),
            "mask": np.zeros((b, 3), np.float32),
        }
        if with_image:
            host["image"] = np.zeros((b, *self.image_shape, 1), np.float32)
        return host

    def _per_fold(self, host) -> np.ndarray:
        """(folds, B) log-hazards of one host batch; without an image plane
        in ``host`` the zero plane is made on the device."""
        b = len(host["mask"])
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in host.items()}
            if "image" not in host:
                batch["image"] = torch.zeros(
                    (b, *self.image_shape, 1), device=self.device)
            zeros = torch.zeros(b, device=self.device)
            batch.update(time=zeros, event=zeros, svalid=zeros,
                         valid=torch.ones(b, device=self.device))
            return torch.stack([
                self._hazard_and_aux(
                    m(*self._batch_to_inputs(batch)), batch)[0]
                for m in self.models]).float().cpu().numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, no_image_variant: bool = False):
        """Run one zero batch of ``batch_size`` patients (image plane
        included) through every fold model and synchronise, so the first
        request does not pay cuDNN's first calls; image-free families warm
        the image-less route (:meth:`warmup_no_image`) instead. Idempotent;
        changes no later risk."""
        if not self._has_image_modality:
            self.warmup_no_image()
            return
        self._per_fold(self._empty_host(self.batch_size, with_image=True))
        self._sync()
        if no_image_variant:
            self.warmup_no_image()

    def warmup_no_image(self):
        """Warm the image-less route (the zero image plane made on the
        device); from then on image-less requests take it. Idempotent."""
        self._per_fold(self._empty_host(self.batch_size, with_image=False))
        self._sync()
        self._no_image_ready = True

    def _fill_row(self, host, i, rnaseq=None, age=None, volume=None,
                  nifti_path=None):
        """Fill row ``i`` of the request's host arrays; returns the
        modality mask."""
        mask = np.zeros(3, np.float32)
        if nifti_path is not None and volume is None:
            from .data.native import read_nifti_fast

            volume = read_nifti_fast(nifti_path).data
        if volume is not None:
            host["image"][i, ..., 0] = resample_normalize_bucketed(
                volume, self.image_shape, hu_window=self.hu_window,
                device=self.device).cpu().numpy()
            mask[0] = 1.0
        if rnaseq is not None:
            rna = np.asarray(rnaseq, np.float32)
            if rna.shape[-1] != self.rna_dim:
                raise ValueError(
                    f"expected {self.rna_dim} genes, got {rna.shape[-1]}")
            host["rnaseq"][i] = rna
            mask[1] = 1.0
        if age is not None:
            host["clinical"][i, 0] = float(age) / 100.0
            mask[2] = 1.0
        if not mask.any():
            raise ValueError("at least one modality is required")
        host["mask"][i] = mask
        return mask

    def score(self, rnaseq=None, age=None, volume=None,
              nifti_path=None) -> dict:
        """Score one patient. Missing modalities are zero-filled with the
        matching mask bit cleared. ``volume`` is a raw (D,H,W) array;
        ``nifti_path`` loads one."""
        return self.score_many([dict(rnaseq=rnaseq, age=age, volume=volume,
                                     nifti_path=nifti_path)])[0]

    def score_many(self, patients) -> list[dict]:
        """Score a sequence of patient dicts (keys: rnaseq/age/volume/
        nifti_path), ``batch_size`` patients per forward pass."""
        results: list[dict] = []
        for start in range(0, len(patients), self.batch_size):
            chunk = patients[start:start + self.batch_size]
            b = len(chunk)
            wants_image = any(p.get("volume") is not None
                              or p.get("nifti_path") is not None
                              for p in chunk)
            if wants_image and not self._has_image_modality:
                raise ValueError(
                    f"model '{self.cfg.name}' has no image modality")
            device_zero_image = not wants_image and self._no_image_ready
            host = self._empty_host(b, with_image=not device_zero_image)
            masks = [self._fill_row(host, i, **p) for i, p in enumerate(chunk)]
            per_fold = self._per_fold(host)  # (F, B)
            if self._cal_mu is not None:
                per_fold = ((per_fold - self._cal_mu[:, None])
                            / self._cal_sd[:, None])
            risks = per_fold.mean(axis=0)
            for i, mask in enumerate(masks):
                result = {
                    "risk_score": float(risks[i]),
                    "modalities_used": {
                        "image": bool(mask[0]), "rnaseq": bool(mask[1]),
                        "clinical": bool(mask[2]),
                    },
                    "model": self.cfg.display_name,
                }
                if self.n_folds > 1:
                    result["ensemble_folds"] = self.n_folds
                results.append(result)
        return results


def make_server(scorer: RiskScorer, host: str = "127.0.0.1", port: int = 0):
    """Build the HTTP risk-scoring server around a RiskScorer.

    Endpoints (the JAX package's contract):
      GET  /healthz      -> {"status": "ok", "model": ...}
      POST /score        -> body {"rnaseq": [...]?, "age": float?,
                                  "nifti_path": "..."?} -> scorer.score(...)
      POST /score_batch  -> body {"patients": [<score bodies>...]} ->
                            {"results": scorer.score_many(...)}

    Returns a ThreadingHTTPServer (port 0 = OS-assigned, read
    ``server.server_address``); call serve_forever() / shutdown() yourself.
    """
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "model": scorer.cfg.display_name})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/score", "/score_batch"):
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                # well-formed JSON of the wrong SHAPE is a client error
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                if self.path == "/score_batch":
                    patients = req.get("patients", [])
                    if not isinstance(patients, list) or not all(
                            isinstance(p, dict) for p in patients):
                        raise ValueError(
                            "'patients' must be a list of objects")
                    results = scorer.score_many([
                        dict(rnaseq=p.get("rnaseq"), age=p.get("age"),
                             nifti_path=p.get("nifti_path"))
                        for p in patients])
                    self._reply(200, {"results": results})
                    return
                result = scorer.score(
                    rnaseq=req.get("rnaseq"),
                    age=req.get("age"),
                    nifti_path=req.get("nifti_path"),
                )
                self._reply(200, result)
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # operational guard: report, keep serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):
            print(f"[serve] {fmt % a}")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    """Serve fold checkpoints over HTTP until interrupted."""
    import argparse
    import json

    from .utils import parse_hu_window

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="partial_modality",
                    choices=sorted(ALL_CONFIGS))
    ap.add_argument("--checkpoint", nargs="+", required=True,
                    help="fold checkpoint(s) (.pt, .msgpack or .pth); "
                         "several = fold ensemble")
    ap.add_argument("--backbone", default=None,
                    choices=["densenet121", "simple_cnn", "swin_vit"],
                    help="default: the checkpoint's .meta.json, else "
                         "densenet121")
    ap.add_argument("--rna-dim", type=int, default=None,
                    help="default: the checkpoint's .meta.json, else 5005")
    ap.add_argument("--image-shape", default=None,
                    help="D,H,W; default: the checkpoint's .meta.json, else "
                         "64,64,32")
    ap.add_argument("--calibration", default=None,
                    help="calibration.json from python -m "
                         "multimodal_survival_prediction_tpu_torch.tools."
                         "calibrate: per-fold (mu, sd) applied before the "
                         "ensemble average, as predict_risk combines folds")
    ap.add_argument("--warm-no-image", action="store_true",
                    help="also warm the image-less route at start-up; "
                         "image-less requests then make their zero CT "
                         "plane on the device")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--hu-window", default=None,
                    help="CT Hounsfield window 'lo,hi', as the checkpoint "
                         "was trained (the = form for negative bounds: "
                         "--hu-window=-150,250)")
    ap.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="kernel-build cache directory (io/aot_cache.py): "
                         "the first server process builds the libraries, "
                         "later ones load them; results unchanged")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"[serve] {pin_fp32_policy()}", flush=True)
    fold_calibration = None
    if args.calibration:
        cal = json.loads(Path(args.calibration).read_text())
        fold_calibration = [tuple(s) for s in cal["stats"]]
    scorer = RiskScorer(
        args.model, args.checkpoint, backbone=args.backbone,
        batch_size=args.batch_size, rna_dim=args.rna_dim,
        image_shape=(tuple(int(x) for x in args.image_shape.split(","))
                     if args.image_shape else None),
        hu_window=parse_hu_window(args.hu_window),
        fold_calibration=fold_calibration,
        no_image_variant=args.warm_no_image, aot_cache_dir=args.aot_cache,
        device=args.device)
    server = make_server(scorer, host=args.host, port=args.port)
    aot = args.aot_cache and ", ".join(
        f"{k}: {v['source']}" for k, v in scorer.aot_info.items())
    print(f"[serve] {scorer.cfg.display_name} loaded and warmed"
          + (f" (aot-cache {aot})" if aot else "")
          + f" on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
