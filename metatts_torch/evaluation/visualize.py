"""t-SNE visualization of speaker d-vectors (reference
``evaluation/visualize.py:18``), similarity density plots
(``evaluation/similarity_plot.py:19``), DET / ROC curves and the MOS and
similarity step figures.  matplotlib and sklearn are imported inside the
plotting functions, so the module imports without them."""

import os
from statistics import NormalDist

import numpy as np


def _probit(p):
    """The standard normal quantile of each entry of ``p`` (the DET axis)."""
    inv = NormalDist().inv_cdf
    return np.array([inv(float(x)) for x in np.ravel(p)]).reshape(np.shape(p))


def tsne_plot(dvecs_by_group, out_path, perplexity=30, seed=0):
    """dvecs_by_group: dict label -> (N, D). Writes a scatter PNG."""
    from sklearn.manifold import TSNE
    labels, vecs = [], []
    for g, v in sorted(dvecs_by_group.items()):
        labels += [g] * len(v)
        vecs.append(np.asarray(v))
    x = np.concatenate(vecs)
    if len(x) < 4:
        return None  # t-SNE is meaningless (and sklearn errors) below this
    # sklearn requires perplexity < n_samples; (n-1)/3 is its own guideline
    perplexity = max(1, min(perplexity, (len(x) - 1) // 3))
    emb = TSNE(n_components=2, perplexity=perplexity, init="pca",
               random_state=seed).fit_transform(x)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6))
    uniq = sorted(set(labels))
    for g in uniq:
        idx = [i for i, l in enumerate(labels) if l == g]
        ax.scatter(emb[idx, 0], emb[idx, 1], s=8, label=str(g), alpha=0.7)
    if len(uniq) <= 12:
        ax.legend(fontsize=7)
    ax.set_title("d-vector t-SNE")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return emb


def tsne_mode_plot(groups_by_mode, out_path, speakers=None,
                   n_per_speaker=16, perplexity=40, seed=0):
    """Cross-mode t-SNE (reference ``visualize.py``'s headline figure):
    d-vectors from several modes (real / recon / <mode>_step<k>) embedded
    JOINTLY, then plotted with hue = mode ("Approach") and marker =
    speaker, for a small speaker subset (reference
    ``tsne_pseudo_speaker_list`` picks 3).

    groups_by_mode: {mode: {speaker_key: (N, D)}}.  Speaker keys may be
    bare ids (enrollment dirs) or full episode labels
    ('<corpus>_<lang>-spk_<id>') — matched by the '-spk_' suffix like the
    similarity metrics.  Returns the output path or None when degenerate.
    """
    from sklearn.manifold import TSNE

    def bare(key):
        return str(key).split("-spk_", 1)[-1]

    by_mode = {m: {bare(k): np.asarray(v) for k, v in g.items()}
               for m, g in groups_by_mode.items() if g}
    if len(by_mode) < 2:
        return None
    common = sorted(set.intersection(*[set(g) for g in by_mode.values()]))
    speakers = [bare(s) for s in (speakers or common[:3]) if bare(s)
                in common]
    if not speakers:
        return None
    vecs, mode_lab, spk_lab = [], [], []
    for mode, g in by_mode.items():
        for s in speakers:
            v = g[s][:n_per_speaker]
            vecs.append(v)
            mode_lab += [mode] * len(v)
            spk_lab += [s] * len(v)
    x = np.concatenate(vecs)
    if len(x) < 8:
        return None
    perplexity = max(1, min(perplexity, (len(x) - 1) // 3))
    emb = TSNE(n_components=2, perplexity=perplexity, init="pca",
               random_state=seed).fit_transform(x)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4.5))
    markers = ["o", "^", "x", "s", "D", "v"]
    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    modes = list(by_mode)
    off = 0
    for mi, mode in enumerate(modes):
        n = sum(1 for l in mode_lab if l == mode)
        seg = slice(off, off + n)
        segspk = spk_lab[off:off + n]
        for si, s in enumerate(speakers):
            idx = [off + i for i, l in enumerate(segspk) if l == s]
            ax.scatter(emb[idx, 0], emb[idx, 1], s=18,
                       marker=markers[si % len(markers)],
                       color=colors[mi % len(colors)],
                       label=mode if si == 0 else None,
                       alpha=0.75, linewidths=0.5)
        off += n
    ax.legend(fontsize=7, title="Approach")
    ax.set_xlabel("dim-1")
    ax.set_ylabel("dim-2")
    ax.set_title("d-vector t-SNE by approach (marker = speaker)")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def similarity_density_plot(same_scores, diff_scores, out_path):
    """Overlaid histograms of same/different-speaker cosine scores."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(np.asarray(same_scores), bins=40, alpha=0.6, density=True,
            label="same speaker")
    ax.hist(np.asarray(diff_scores), bins=40, alpha=0.6, density=True,
            label="different speaker")
    ax.set_xlabel("cosine similarity")
    ax.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def det_plot(results_by_label, out_path):
    """DET curve figure (reference ``evaluation/speaker_verification.py:20``
    emits DET plots per mode): FPR vs FNR on normal-deviate-scaled axes.

    ``results_by_label``: dict label -> result dict from
    ``speaker_verification_eer`` (consumes its fpr/fnr arrays).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.5, 5.5))
    ticks = np.array([0.001, 0.01, 0.05, 0.2, 0.5, 0.8, 0.95])
    for label, res in sorted(results_by_label.items()):
        if len(res["fpr"]) == 0:     # degenerate (NaN-metric) result
            continue
        fpr = np.clip(np.asarray(res["fpr"]), 1e-6, 1 - 1e-6)
        fnr = np.clip(np.asarray(res["fnr"]), 1e-6, 1 - 1e-6)
        ax.plot(_probit(fpr), _probit(fnr),
                label=f"{label} (EER {res['eer']:.3f})")
    ax.set_xticks(_probit(ticks))
    ax.set_xticklabels([f"{t:g}" for t in ticks], fontsize=7)
    ax.set_yticks(_probit(ticks))
    ax.set_yticklabels([f"{t:g}" for t in ticks], fontsize=7)
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("false negative rate")
    ax.set_title("DET")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=7)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def mos_step_plot(step_scores, bands, out_path):
    """MOS vs adaptation-step figure (reference
    ``evaluation/compute_mos.py:241-315`` ``plot``): one line per scorer
    over the fine-tuning steps, with horizontal mean±CI bands for the
    step-independent modes (real / reconstructed).

    ``step_scores``: dict scorer -> list of (ft_step, mean, ci).
    ``bands``: dict label -> dict scorer -> (mean, ci).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4.8, 4.2))
    band_styles = {"real": ("k", "-"), "recon": ("gray", "--")}
    for label, per_scorer in sorted(bands.items()):
        color, ls = band_styles.get(label, ("tab:blue", ":"))
        for scorer, (m, ci) in sorted(per_scorer.items()):
            ax.axhline(m, color=color, linestyle=ls, alpha=0.7,
                       label=f"{label} ({scorer})")
            if ci:
                ax.axhspan(m - ci, m + ci, color=color, alpha=0.12)
    for scorer, pts in sorted(step_scores.items()):
        if not pts:
            continue
        pts = sorted(pts)
        xs = [p[0] for p in pts]
        ms = np.array([p[1] for p in pts])
        cis = np.array([p[2] for p in pts])
        ax.plot(xs, ms, marker="o", label=f"synth ({scorer})")
        ax.fill_between(xs, ms - cis, ms + cis, alpha=0.2)
    ax.set_xlabel("adaptation steps")
    ax.set_ylabel("pseudo-MOS")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=7)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def mos_bar_plot(summary, out_path):
    """Grouped MOS bar chart across modes (reference
    ``evaluation/compute_mos.py:196-237`` ``bar_plot``): one group per
    mode/step tick on the x-axis, one bar per scorer, 95%-CI whiskers.

    ``summary``: dict tick -> dict scorer -> (mean, ci), in tick order.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ticks = [t for t in summary if summary[t]]
    if not ticks:
        return None
    scorers = sorted({s for d in summary.values() for s in d})
    n = max(len(scorers), 1)
    width = 0.8 / n
    fig, ax = plt.subplots(figsize=(max(6.0, 0.9 * len(ticks) + 2), 3.4))
    for k, scorer in enumerate(scorers):
        xs, ms, cis = [], [], []
        for i, t in enumerate(ticks):
            if scorer in summary[t]:
                m, ci = summary[t][scorer]
                xs.append(i + (k - (n - 1) / 2) * width)
                ms.append(m)
                cis.append(ci)
        ax.bar(xs, ms, width=width, yerr=cis, capsize=2, label=scorer)
    ax.set_xticks(np.arange(len(ticks)))
    ax.set_xticklabels(ticks, rotation=45, ha="right", fontsize=7)
    ax.set_ylabel("pseudo-MOS")
    ax.grid(True, axis="y", alpha=0.3)
    ax.legend(fontsize=7)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def similarity_step_plot(step_sims, bands, out_path):
    """Centroid-similarity vs adaptation-step errorbar figure (reference
    ``evaluation/similarity_plot.py`` ``errorbar_plot``): one errorbar line
    per mode over the fine-tuning steps, with horizontal mean±CI bands for
    the step-independent modes (real enrollment self-similarity /
    reconstruction).

    ``step_sims``: dict mode -> list of (ft_step, mean, ci).
    ``bands``: dict label -> (mean, ci).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4.8, 4.2))
    band_styles = {"real": ("k", "-"), "recon": ("gray", "--")}
    for label, (m, ci) in sorted(bands.items()):
        color, ls = band_styles.get(label, ("tab:green", ":"))
        ax.axhline(m, color=color, linestyle=ls, alpha=0.7, label=label)
        if ci:
            ax.axhspan(m - ci, m + ci, color=color, alpha=0.12)
    for mode, pts in sorted(step_sims.items()):
        if not pts:
            continue
        pts = sorted(pts)
        xs = [p[0] for p in pts]
        ms = np.array([p[1] for p in pts])
        cis = np.array([p[2] for p in pts])
        ax.errorbar(xs, ms, yerr=cis, marker="o", capsize=3, label=mode)
    ax.set_xlabel("adaptation steps")
    ax.set_ylabel("cosine similarity to enrollment centroid")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=7)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def roc_plot(results_by_label, out_path):
    """ROC curve figure (reference speaker_verification.py ROC/AUC plots)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.5, 5.5))
    for label, res in sorted(results_by_label.items()):
        if len(res["fpr"]) == 0:     # degenerate (NaN-metric) result
            continue
        fpr = np.asarray(res["fpr"])
        tpr = 1.0 - np.asarray(res["fnr"])
        ax.plot(fpr, tpr, label=f"{label} (AUC {res['auc']:.3f})")
    ax.plot([0, 1], [0, 1], "k--", alpha=0.4)
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.set_title("ROC")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=7)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path
