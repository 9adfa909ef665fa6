"""Figure generation (matplotlib/Agg): comparison bars, fold-wise bars,
significance heatmap, KM curves, modality availability, CT slice galleries,
risk distributions (port of
``multimodal_survival_prediction_tpu/analysis/figures.py``).

Each function makes the JAX module's matplotlib calls in the same order,
on the port's tables instead of DataFrames:

  * ``rows``: the comparison rows of ``analysis.comparison.collect_results``
    (a list of dicts with ``key``, ``model``, ``c_index_mean``,
    ``c_index_std``, ``fold_scores``, ``n_folds``, ``raw``);
  * ``pmat``: ``(models, (n, n) p-values)``, as
    ``analysis.comparison.pairwise_significance`` returns it;
  * ``table``: the matching table's row dicts
    (``data.matching_table.load_matching_table``);
  * ``pred``: a predictions table of numpy columns (``risk_score``,
    ``survival_time``, ``event``);
  * ``curves``: ``{label: ops.km.KaplanMeier}``.

This is the port's one module that imports matplotlib, which the card's
machine lacks: the entry points import it inside :func:`load`, which names
the missing package where the import fails.
"""

from __future__ import annotations

import logging
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

log = logging.getLogger(__name__)


def _save(fig, out_path):
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _column(rows: list, name: str) -> np.ndarray:
    return np.asarray([r[name] for r in rows])


def model_comparison_main(rows: list, out_path):
    """3-panel main figure (reference final_comparison.py:121-202): ranked
    bars with error bars, per-fold scatter, fold-count/dataset context."""
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    names = [r["model"] for r in rows]
    means = _column(rows, "c_index_mean")
    stds = _column(rows, "c_index_std")

    ax = axes[0]
    y = np.arange(len(names))[::-1]
    ax.barh(y, means, xerr=stds, color="#4878d0", alpha=0.85)
    ax.set_yticks(y, names)
    ax.axvline(0.5, color="gray", ls="--", lw=1, label="random (0.5)")
    ax.set_xlabel("C-index")
    ax.set_title("Model comparison (mean ± std)")
    ax.legend()

    ax = axes[1]
    for i, r in enumerate(rows):
        fs = np.asarray(r["fold_scores"])
        ax.scatter([i] * len(fs), fs, alpha=0.8)
        ax.plot([i - 0.2, i + 0.2], [fs.mean()] * 2, color="k")
    ax.set_xticks(range(len(names)), names, rotation=30, ha="right")
    ax.axhline(0.5, color="gray", ls="--", lw=1)
    ax.set_ylabel("fold C-index")
    ax.set_title("Per-fold scores")

    ax = axes[2]
    ax.bar(range(len(names)), _column(rows, "n_folds"), color="#ee854a",
           alpha=0.85)
    ax.set_xticks(range(len(names)), names, rotation=30, ha="right")
    ax.set_ylabel("folds")
    ax.set_title("CV folds per model")
    return _save(fig, out_path)


ABLATION_GROUPS = {
    "single-modality": ("rnaseq_only", "image_only"),
    "static fusion": ("simple_fusion", "flexible_multimodal", "final"),
    "adaptive fusion": ("partial_modality", "simmim", "mmsurv"),
}


def ablation_study(rows: list, out_path, groups=None):
    """Grouped ablation figure (reference final_comparison.py:204-255):
    single-modality vs static-fusion vs adaptive-fusion model groups."""
    groups = groups or ABLATION_GROUPS
    fig, ax = plt.subplots(figsize=(9, 5))
    x = 0
    ticks, labels = [], []
    colors = ["#4878d0", "#ee854a", "#6acc64"]
    for gi, (gname, keys) in enumerate(groups.items()):
        for r in (r for r in rows if r["key"] in keys):
            ax.bar(x, r["c_index_mean"], yerr=r["c_index_std"],
                   color=colors[gi % len(colors)], alpha=0.85,
                   label=gname if x == 0 or ticks and labels[-1] != gname
                   else None)
            ticks.append(x)
            labels.append(r["model"])
            x += 1
        x += 0.6  # gap between groups
    ax.set_xticks(ticks, labels, rotation=30, ha="right")
    ax.axhline(0.5, color="gray", ls="--", lw=1)
    ax.set_ylabel("C-index")
    ax.set_title("Ablation: modality groups")
    handles = [plt.Rectangle((0, 0), 1, 1, color=c)
               for c in colors[: len(groups)]]
    ax.legend(handles, groups.keys(), fontsize=9)
    return _save(fig, out_path)


def significance_heatmap(pmat, out_path):
    models, mat = pmat
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(mat, cmap="RdYlGn", vmin=0, vmax=0.2)
    ax.set_xticks(range(len(models)), models, rotation=45, ha="right")
    ax.set_yticks(range(len(models)), models)
    for i in range(len(models)):
        for j in range(len(models)):
            v = mat[i, j]
            if np.isfinite(v):
                ax.text(j, i, f"{v:.2f}", ha="center", va="center",
                        fontsize=8)
    fig.colorbar(im, label="p-value")
    ax.set_title("Pairwise significance (t-test)")
    return _save(fig, out_path)


def foldwise_bars(rows: list, out_path):
    fig, ax = plt.subplots(figsize=(10, 5))
    width = 0.8 / max(max(r["n_folds"] for r in rows), 1)
    for i, r in enumerate(rows):
        fs = np.asarray(r["fold_scores"])
        for k, v in enumerate(fs):
            ax.bar(i + (k - len(fs) / 2) * width, v, width * 0.9,
                   color=plt.cm.tab10(k),
                   label=f"fold {k+1}" if i == 0 else None)
    ax.set_xticks(range(len(rows)), [r["model"] for r in rows], rotation=30,
                  ha="right")
    ax.axhline(0.5, color="gray", ls="--", lw=1)
    ax.set_ylabel("C-index")
    ax.set_title("Fold-wise C-index")
    ax.legend(fontsize=8)
    return _save(fig, out_path)


# Architectural complexity on a 1-5 scale (the reference hand-assigns these,
# reference comprehensive_analysis.py:317-325); keyed by results-dir name.
COMPLEXITY_SCORES = {
    "image_only": 1, "rnaseq_only": 1, "simple_fusion": 2,
    "flexible_multimodal": 3, "final": 3, "partial_modality": 4,
    "simmim": 5, "mmsurv": 5,
}


def violin_scatter(rows: list, out_path):
    """Violin of fold scores with overlaid per-fold scatter (reference
    comprehensive_analysis violin+scatter panel)."""
    fig, ax = plt.subplots(figsize=(10, 5))
    data = [np.asarray(r["fold_scores"]) for r in rows]
    pos = np.arange(1, len(data) + 1)
    parts = ax.violinplot(data, positions=pos, showmeans=True)
    for pc in parts["bodies"]:
        pc.set_facecolor("#4878d0")
        pc.set_alpha(0.4)
    for i, fs in enumerate(data, 1):
        ax.scatter(np.full(len(fs), i) + np.linspace(-0.06, 0.06, len(fs)),
                   fs, color="#d65f5f", zorder=3, s=18)
    ax.set_xticks(pos, [r["model"] for r in rows], rotation=30, ha="right")
    ax.axhline(0.5, color="gray", ls="--", lw=1)
    ax.set_ylabel("C-index")
    ax.set_title("Score distribution per model")
    return _save(fig, out_path)


def performance_vs_dataset_size(rows: list, out_path):
    """C-index vs training-cohort size, annotated with complexity scores
    (reference comprehensive_analysis performance-vs-size + complexity)."""
    fig, ax = plt.subplots(figsize=(8, 5))
    for r in rows:
        raw = r.get("raw") or {}
        n = raw.get("dataset_size") if isinstance(raw, dict) else None
        if not n:
            continue
        cx = COMPLEXITY_SCORES.get(r["key"], 3)
        ax.errorbar(n, r["c_index_mean"], yerr=r["c_index_std"], fmt="o",
                    ms=5 + 2 * cx, capsize=3, alpha=0.8)
        ax.annotate(f"{r['model']} (cx={cx})", (n, r["c_index_mean"]),
                    textcoords="offset points", xytext=(6, 4), fontsize=8)
    ax.axhline(0.5, color="gray", ls="--", lw=1)
    ax.set_xlabel("dataset size (patients)")
    ax.set_ylabel("C-index")
    ax.set_title("Performance vs dataset size (marker size = complexity)")
    return _save(fig, out_path)


def model_comparison_analysis(rows: list, out_path,
                              baseline_key: str = "image_only"):
    """6-panel comparison figure (reference
    scripts/analysis/analyze_all_results.py:157-330,
    results/model_comparison_analysis.png): box plot, mean±std bars,
    fold-wise lines, violin, %-improvement over the Image-Only baseline,
    and a statistical summary table."""
    names = [r["model"] for r in rows]
    scores = [np.asarray(r["fold_scores"], float) for r in rows]
    means = _column(rows, "c_index_mean")
    stds = _column(rows, "c_index_std")
    colors = [plt.cm.Set2(i % 8) for i in range(len(names))]

    fig = plt.figure(figsize=(16, 12))

    def _refs(ax, axis="y"):
        line = ax.axhline if axis == "y" else ax.axvline
        line(0.5, color="red", ls="--", lw=1, alpha=0.5)
        line(0.6, color="green", ls="--", lw=1, alpha=0.5)

    # 1: box plot (notch needs >=2 points; reference sets notch=True always)
    ax = fig.add_subplot(2, 3, 1)
    bp = ax.boxplot(scores, tick_labels=names, patch_artist=True,
                    showmeans=True,
                    meanprops=dict(marker="D", markerfacecolor="red"))
    for patch, c in zip(bp["boxes"], colors):
        patch.set_facecolor(c)
    _refs(ax)
    ax.set_ylabel("C-index")
    ax.set_title("Model Performance Distribution")
    plt.setp(ax.xaxis.get_majorticklabels(), rotation=15, ha="right")

    # 2: mean±std bars with value labels
    ax = fig.add_subplot(2, 3, 2)
    x = np.arange(len(names))
    bars = ax.bar(x, means, yerr=stds, capsize=5, alpha=0.8, color=colors,
                  edgecolor="black")
    for b, m, s in zip(bars, means, stds):
        ax.text(b.get_x() + b.get_width() / 2, b.get_height() + s + 0.01,
                f"{m:.4f}\n±{s:.4f}", ha="center", va="bottom", fontsize=8)
    ax.set_xticks(x, names)
    _refs(ax)
    ax.set_ylabel("C-index")
    ax.set_title("Mean C-index with Std Dev")
    plt.setp(ax.xaxis.get_majorticklabels(), rotation=15, ha="right")

    # 3: fold-wise line plot
    ax = fig.add_subplot(2, 3, 3)
    for i, (name, fs) in enumerate(zip(names, scores)):
        ax.plot(range(1, len(fs) + 1), fs, marker="o", label=name,
                color=plt.cm.tab10(i))
    _refs(ax)
    ax.set_xlabel("Fold")
    ax.set_ylabel("C-index")
    ax.set_title("C-index Across Folds")
    ax.legend(fontsize=8)

    # 4: violin
    ax = fig.add_subplot(2, 3, 4)
    parts = ax.violinplot(scores, positions=np.arange(1, len(scores) + 1),
                          showmeans=True)
    for pc, c in zip(parts["bodies"], colors):
        pc.set_facecolor(c)
        pc.set_alpha(0.6)
    ax.set_xticks(range(1, len(names) + 1), names)
    _refs(ax)
    ax.set_ylabel("C-index")
    ax.set_title("Distribution Comparison (Violin)")
    plt.setp(ax.xaxis.get_majorticklabels(), rotation=15, ha="right")

    # 5: improvement over baseline (horizontal bars)
    ax = fig.add_subplot(2, 3, 5)
    base_rows = [r for r in rows if r["key"] == baseline_key]
    if base_rows:
        b = float(base_rows[0]["c_index_mean"])
        labels, imps = [], []
        for r in rows:
            if r["key"] == baseline_key:
                continue
            labels.append(r["model"])
            imps.append(100.0 * (r["c_index_mean"] - b) / b)
        bars = ax.barh(labels, imps,
                       color=["green" if v > 0 else "red" for v in imps],
                       alpha=0.7, edgecolor="black")
        for bar, v in zip(bars, imps):
            ax.text(bar.get_width(), bar.get_y() + bar.get_height() / 2,
                    f"{v:+.2f}%", va="center", fontsize=9,
                    ha="left" if v > 0 else "right")
        ax.axvline(0, color="black", lw=2)
        ax.set_xlabel("Improvement over Baseline (%)")
        ax.set_title(f"Relative Improvement over {base_rows[0]['model']}")
    else:
        ax.axis("off")
        ax.set_title("(no Image-Only baseline found)")

    # 6: statistical summary table
    ax = fig.add_subplot(2, 3, 6)
    ax.axis("off")
    cells = []
    for name, fs, m, s in zip(names, scores, means, stds):
        cv = 100.0 * s / m if m else float("nan")
        cells.append([name, f"{m:.4f}", f"{s:.4f}",
                      f"[{fs.min():.3f}, {fs.max():.3f}]", f"{cv:.2f}%"])
    tbl = ax.table(cellText=cells,
                   colLabels=["Model", "Mean", "Std", "Range", "CV"],
                   cellLoc="center", loc="center", bbox=[0, 0, 1, 1])
    tbl.auto_set_font_size(False)
    tbl.set_fontsize(9)
    for i in range(5):
        tbl[(0, i)].set_facecolor("#4CAF50")
        tbl[(0, i)].set_text_props(weight="bold", color="white")
    for i in range(1, len(cells) + 1):
        for j in range(5):
            tbl[(i, j)].set_facecolor(colors[(i - 1) % len(colors)])
    ax.set_title("Statistical Summary", pad=20)

    fig.tight_layout()
    return _save(fig, out_path)


def km_plot(curves: dict, out_path, title="Kaplan-Meier", pvalue=None):
    """curves: {label: KaplanMeier}."""
    fig, ax = plt.subplots(figsize=(7, 5))
    for label, km in curves.items():
        ax.step(km.timeline, km.survival, where="post", label=label)
        ax.fill_between(km.timeline, km.ci_lower, km.ci_upper, step="post",
                        alpha=0.15)
    ax.set_xlabel("time (days)")
    ax.set_ylabel("survival probability")
    ax.set_ylim(0, 1.02)
    t = title if pvalue is None else f"{title} (log-rank p={pvalue:.3g})"
    ax.set_title(t)
    ax.legend()
    return _save(fig, out_path)


def kaplan_meier_panels(group_curves: dict, event_curves: dict, out_path,
                        pvalue=None):
    """2-panel KM figure (reference evaluate_model.py:74-118,
    results/kaplan_meier_curves.png): left = survival by risk group
    (with log-rank p), right = survival by event type."""
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    for ax, curves, title in (
        (axes[0], group_curves, "Kaplan-Meier Survival Curves by Risk Group"),
        (axes[1], event_curves, "Kaplan-Meier Survival Curves by Event Type"),
    ):
        for label, km in curves.items():
            ax.step(km.timeline, km.survival, where="post", label=label)
            ax.fill_between(km.timeline, km.ci_lower, km.ci_upper,
                            step="post", alpha=0.15)
        ax.set_xlabel("Time (days)")
        ax.set_ylabel("Survival Probability")
        ax.set_ylim(0, 1.02)
        ax.grid(True, alpha=0.3)
        ax.legend(loc="best")
        ax.set_title(title)
    if pvalue is not None:
        axes[0].set_title(
            f"Kaplan-Meier Survival Curves by Risk Group "
            f"(log-rank p={pvalue:.3g})")
    fig.tight_layout()
    return _save(fig, out_path)


def modality_availability(table: list, out_path):
    """Availability bars + survival-status pie (reference
    create_report_figures.py:70-117)."""
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))

    def count(col):
        return int(sum(bool(r[col]) for r in table))

    counts = {
        "CT imaging": count("has_imaging"),
        "RNA-seq": count("has_rnaseq"),
        "Clinical": count("has_clinical"),
        "Survival": count("has_survival"),
    }
    axes[0].bar(counts.keys(), counts.values(), color="#4878d0")
    axes[0].set_ylabel("patients")
    axes[0].set_title(f"Modality availability (n={len(table)})")
    dead = int(sum(r["survival_status"] == 1 for r in table))
    axes[1].pie([dead, len(table) - dead],
                labels=["event (dead)", "censored/alive"],
                autopct="%1.0f%%", colors=["#d65f5f", "#6acc64"])
    axes[1].set_title("Survival status")
    return _save(fig, out_path)


def ct_slice_gallery(volumes: list, out_path, labels=None):
    """Mid-slices of sample CT volumes (reference
    create_report_figures.py:32-64)."""
    n = len(volumes)
    fig, axes = plt.subplots(1, max(n, 1), figsize=(4 * max(n, 1), 4))
    if n == 1:
        axes = [axes]
    for ax, vol, lab in zip(axes, volumes,
                            labels or [f"patient {i}" for i in range(n)]):
        ax.imshow(np.asarray(vol)[vol.shape[0] // 2], cmap="gray")
        ax.set_title(lab)
        ax.axis("off")
    return _save(fig, out_path)


def risk_distributions(pred: dict, out_path):
    """Risk histogram / boxplot by event / risk-vs-time scatter (reference
    evaluate_model.py:127-188)."""
    risk = np.asarray(pred["risk_score"])
    event = np.asarray(pred["event"])
    fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
    axes[0].hist(risk, bins=30, color="#4878d0", alpha=0.85)
    axes[0].set_title("Risk score distribution")
    groups = [risk[event == e] for e in (0, 1)]
    axes[1].boxplot(groups, tick_labels=["censored", "event"])
    axes[1].set_title("Risk by outcome")
    sc = axes[2].scatter(np.asarray(pred["survival_time"]), risk,
                         c=event, cmap="coolwarm", alpha=0.7)
    axes[2].set_xlabel("survival time")
    axes[2].set_ylabel("risk score")
    axes[2].set_title("Risk vs time")
    fig.colorbar(sc, label="event")
    return _save(fig, out_path)
