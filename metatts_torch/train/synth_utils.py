"""Synthesis utilities (reference ``lightning/callbacks/utils.py`` +
``utils/tools.py:102-267``): de-normalize pitch/energy with corpus stats,
expand phoneme-level tracks to frame level by durations, and the dual-axis
mel + pitch/energy figure.  matplotlib is imported only by the plotting
functions.
"""

import os

import numpy as np
import torch


def _host(x):
    """A tensor (any device or dtype) or array -> numpy on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def expand_by_duration(values, durations):
    """Phoneme-level (L,) values -> frame-level via per-phone repeat
    (reference ``utils/tools.py:102-106``)."""
    out = []
    for v, d in zip(values, durations):
        out += [float(v)] * int(d)
    return np.asarray(out, np.float32)


def denormalize(values, mean, std):
    return np.asarray(values) * std + mean


def prepare_tracks(output, stats, preprocess_cfg, index=0):
    """FS2Output sample -> (mel (T,80), pitch (T,), energy (T,)) frame-level
    real-unit tracks for plotting."""
    mel_len = int(_host(output.mel_lens)[index])
    mel = _host(output.postnet_mel)[index, :mel_len]
    d = _host(output.d_rounded)[index]
    pitch = _host(output.p_pred)[index]
    energy = _host(output.e_pred)[index]
    if preprocess_cfg["preprocessing"]["pitch"]["feature"] == "phoneme_level":
        pitch = expand_by_duration(pitch, d)[:mel_len]
    else:
        pitch = pitch[:mel_len]
    if preprocess_cfg["preprocessing"]["energy"]["feature"] == "phoneme_level":
        energy = expand_by_duration(energy, d)[:mel_len]
    else:
        energy = energy[:mel_len]
    pitch = denormalize(pitch, stats["pitch"][2], stats["pitch"][3])
    energy = denormalize(energy, stats["energy"][2], stats["energy"][3])
    return mel, pitch, energy


def plot_mel_panels(panels, out_path, titles=None):
    """Stacked dual-axis spectrogram figure -- one row per
    ``(mel (T,80), pitch (T,), energy (T,))`` panel, like the reference
    ``plot_mel`` (``utils/tools.py:217-267``), whose validation figure
    shows the synthesized and ground-truth spectrograms together."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    n = len(panels)
    titles = titles or ["synthesized"] * n
    fig, axes = plt.subplots(n, 1, figsize=(10, 3.2 * n), squeeze=False)
    for ax, (mel, pitch, energy), title in zip(axes[:, 0], panels, titles):
        ax.imshow(np.asarray(mel).T, origin="lower", aspect="auto",
                  interpolation="none")
        ax.set_ylabel("mel bins")
        ax.set_xlabel("frames")
        ax.set_title(title)
        ax2 = ax.twinx()
        t = np.arange(len(pitch))
        ax2.plot(t, pitch, color="tomato", linewidth=0.8, label="pitch (Hz)")
        ax2.plot(t, energy, color="darkviolet", linewidth=0.8, label="energy")
        ax2.legend(fontsize=7, loc="upper right")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path


def plot_mel_with_tracks(mel, pitch, energy, out_path, title="synthesized"):
    """Dual-axis spectrogram figure (reference ``utils/tools.py:217-267``)."""
    return plot_mel_panels([(mel, pitch, energy)], out_path, [title])
