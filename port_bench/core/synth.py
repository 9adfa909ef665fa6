"""The benchmark's inputs, made from ``--seed`` on the device in a few large
calls: the synthetic cohort (availability by fixed pattern counts, so that
every seed has the same sizes and only values and order change), its folds,
and the model weights under the reference's state_dict keys."""

from __future__ import annotations

import numpy as np
import torch


def seeds(seed: int, n: int) -> list:
    """``n`` independent 31-bit seeds from the run's ``--seed`` (any whole
    number; negative ones too)."""
    ss = np.random.SeedSequence(abs(int(seed)) * 2 + (int(seed) < 0))
    return [int(s) for s in ss.generate_state(n, np.uint32) >> 1]


def make_cohort(spec: dict, image_shape, rna_dim: int, seed: int, device):
    """The cohort as the trainer's dict of device tensors (``image`` (N, D,
    H, W, 1), ``rnaseq``, ``clinical``, ``mask``, ``time``, ``event``,
    ``svalid``). ``spec["patterns"]`` lists ``[ct, rna, age, labelled,
    count]``; a missing modality is zeros with its mask bit cleared, an
    unlabelled patient has time 0, event 0 and ``svalid`` 0."""
    pats = np.asarray(spec["patterns"], np.int64)
    counts = pats[:, 4]
    n = int(counts.sum())
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)  # pattern of each row, shuffled
    kind = np.repeat(np.arange(len(pats)), counts)[order]
    flags = torch.from_numpy(pats[kind, :4].astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, h, w = image_shape
    image = torch.rand((n, d, h, w, 1), generator=gen, device=device)
    image *= flags[:, 0].view(-1, 1, 1, 1, 1)
    rnaseq = torch.randn((n, rna_dim), generator=gen, device=device)
    rnaseq *= flags[:, 1:2]
    u = torch.rand((n, 4), generator=gen, device=device)
    clinical = (0.35 + 0.5 * u[:, 0:1]) * flags[:, 2:3]
    labelled = flags[:, 3]
    # survival days: exponential with a 1,000-day mean, continuous (no
    # ties), events at the published cohort's ~60 %
    time = -1000.0 * torch.log1p(-u[:, 1].clamp_max(0.999)) + u[:, 2]
    data = {
        "image": image,
        "rnaseq": rnaseq,
        "clinical": clinical,
        "mask": flags[:, :3].contiguous(),
        "time": time * labelled,
        "event": (u[:, 3] < spec.get("event_rate", 0.6)).float() * labelled,
        "svalid": labelled.contiguous(),
    }
    return data


COLUMNS = {"ct": 0, "rna": 1, "age": 2}


def select_rows(data: dict, requires) -> np.ndarray:
    """The rows a family's cohort keeps (the published scripts' filters):
    those that have every column of ``requires`` (``ct``, ``rna``, ``age``,
    ``labelled``); all rows where it is empty."""
    mask = data["mask"].cpu().numpy() > 0
    keep = np.ones(len(mask), bool)
    for col in requires:
        keep &= (data["svalid"].cpu().numpy() > 0 if col == "labelled"
                 else mask[:, COLUMNS[col]])
    return np.nonzero(keep)[0]


def fold_rows(svalid: np.ndarray, n_folds: int, fold: int, seed: int,
              unlabelled_in_train: bool):
    """``(train rows, val rows)`` of ``fold``: the labelled rows split in
    ``n_folds`` by a seeded permutation; with ``unlabelled_in_train`` every
    unlabelled row is appended to the train rows (the partial-modality
    recipe), otherwise the folds run over every row."""
    lab = np.nonzero(svalid > 0)[0]
    universe = lab if unlabelled_in_train else np.arange(len(svalid))
    parts = np.array_split(np.random.default_rng(seed).permutation(universe),
                           n_folds)
    val = np.sort(parts[fold])
    train = np.sort(np.concatenate([p for i, p in enumerate(parts)
                                    if i != fold]))
    if unlabelled_in_train:
        train = np.concatenate([train, np.nonzero(svalid <= 0)[0]])
    return train, val


def make_weights(spec: list, seed: int, device) -> dict:
    """Weights for ``spec`` (``reference.model.param_spec``) from ``seed``:
    one normal and one uniform draw on the device for all leaves, cut and
    scaled per leaf."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(int(np.prod(s)) for _, s, i in spec if i[0] == "normal")
    n_unif = sum(int(np.prod(s)) for _, s, i in spec if i[0] == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device).mul_(2).sub_(1)
    out, a, b = {}, 0, 0
    for key, shape, init in spec:
        size = int(np.prod(shape))
        if init[0] == "normal":
            out[key] = normal[a:a + size].view(shape) * init[1]
            a += size
        elif init[0] == "uniform":
            out[key] = unif[b:b + size].view(shape) * init[1]
            b += size
        elif init[0] in ("ones", "buffer_ones"):
            out[key] = torch.ones(shape, device=device)
        elif init[0] in ("zeros", "buffer_zeros"):
            out[key] = torch.zeros(shape, device=device)
        elif init[0] == "count":
            out[key] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {key}")
    return out
