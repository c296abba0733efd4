"""Scratch-trained GE2E speaker verifier.

The reference never trains its verifier: it loads resemblyzer's pretrained
GE2E VoiceEncoder (``evaluation/wavs_to_dvector.py:18``).  Pretrained
weights are not in the repository, so this module trains the SAME
architecture (``models.speaker_encoder.GE2E``: stacked LSTM -> linear ->
ReLU -> L2 norm) from scratch with the GE2E softmax contrastive loss (Wan
et al. 2018, the loss resemblyzer's weights were trained with), giving a
self-consistent verifier for EER-space evaluation.

Parameters are a dict of named tensors: the network's state-dict names
under ``net.`` (resemblyzer's layout) and the loss's learned similarity
scale ``sim_w`` / ``sim_b``.  The trained weights export to resemblyzer's
npz layout, so ``evaluation.dvector.DVectorEncoder`` (and therefore
``python -m metatts_torch.evaluate``) loads them as it loads converted
official weights.
"""

import warnings

import numpy as np
import torch

from ..models import nn as L
from ..models.speaker_encoder import GE2E, GE2E_LAYERS
from ..preprocess.refmel import (preprocess_ref_wav, wav_to_mel40,
                                 tile_to_min_length,
                                 PARTIALS_N_FRAMES, MEL_N_CHANNELS)
from ..utils.tools import resolve_device

NET = "net."


def ge2e_init(seed=0, mel_channels=MEL_N_CHANNELS, hidden=256, embed=256,
              layers=3, device="cuda"):
    """GE2E net (random init from a ``torch.Generator`` seeded with
    ``seed``) + the loss's learned similarity scale (w, b); resemblyzer
    initializes w=10, b=-5 (Wan et al. §2.1)."""
    net = GE2E(mel_channels, hidden, embed, layers)
    L.reset_parameters(net, torch.Generator().manual_seed(seed))
    device = resolve_device(device)
    params = {NET + k: v.detach().to(device) for k, v in net.state_dict().items()}
    params["sim_w"] = torch.tensor(10.0, device=device)
    params["sim_b"] = torch.tensor(-5.0, device=device)
    return params


def ge2e_embed(params, mels):
    """(N, T, C) mels -> (N, embed) unit d-vectors through the ``net.``
    tensors of ``params``."""
    net = {k[len(NET):]: v for k, v in params.items() if k.startswith(NET)}
    w0 = net["lstm.weight_ih_l0"]
    layers = sum(1 for k in net if k.startswith("lstm.weight_ih_l"))
    with torch.device("meta"):
        skeleton = GE2E(w0.shape[1], w0.shape[0] // 4, net["linear.weight"].shape[0], layers)
    return torch.func.functional_call(skeleton, net, (mels,))


def ge2e_softmax_loss(params, batch):
    """GE2E softmax loss over a (N speakers, M utterances, T, C) mel batch.

    sim[j, i, k] = w * cos(e_ji, c_k) + b, with the own-speaker entry using
    the leave-one-out centroid (Wan et al. eq. 8-9); loss = mean over (j, i)
    of -log softmax_k sim[j, i, :] at k = j.
    """
    N, M, T, C = batch.shape
    e = ge2e_embed(params, batch.reshape(N * M, T, C)).reshape(N, M, -1)

    # sqrt(sum + eps), not a norm: a norm's gradient at an exact-zero
    # vector is NaN (see models.speaker_encoder.GE2E)
    def unit(v):
        return v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-12)
    cent = unit(e.mean(dim=1))                               # (N, D) inclusive
    # leave-one-out centroid for the own-speaker similarity
    excl = unit((e.sum(dim=1, keepdim=True) - e) / (M - 1))  # (N, M, D)
    w = torch.clamp(params["sim_w"], min=1e-6)               # keep scale positive
    sim = w * torch.einsum("jid,kd->jik", e, cent) + params["sim_b"]
    own = w * torch.einsum("jid,jid->ji", e, excl) + params["sim_b"]
    eye = torch.eye(N, device=e.device)[:, None, :]          # (N, 1, N)
    sim = sim * (1 - eye) + own[..., None] * eye
    logp = torch.log_softmax(sim, dim=-1)
    own_logp = (logp * eye).sum(dim=-1)                      # (N, M)
    return -own_logp.mean()


def utterance_partial(wav, sr, frames=PARTIALS_N_FRAMES):
    """One (frames, 40) mel partial per utterance: resemblyzer frontend
    (resample/normalize/VAD-trim, LOOP short audio to one full partial ->
    40-mel), the middle ``frames`` frames, so train-time features match
    what ``DVectorEncoder.embed_utterance`` feeds the net at eval time.
    Looping replaces zero-padding because a silent tail collapses the
    LSTM's final-hidden readout to an input-independent fixed point
    (``refmel.tile_to_min_length``)."""
    wav = preprocess_ref_wav(np.asarray(wav, np.float32), sr)
    wav = tile_to_min_length(wav)
    mel = wav_to_mel40(wav)
    if mel.shape[0] >= frames:
        start = (mel.shape[0] - frames) // 2
        return mel[start:start + frames].astype(np.float32)
    return np.pad(mel, ((0, frames - mel.shape[0]), (0, 0))).astype(
        np.float32)


def _input_norm_stats(partials_by_speaker):
    """Per-channel (mean, scale) standardizing the training features.

    Raw resemblyzer-convention features are LINEAR mel magnitudes of
    -30 dBFS audio, std ~1e-2, which parks a fresh GE2E net on the
    uniform-softmax plateau (all embeddings identical, loss pinned at
    ln(N), gradients cancel).  Per-channel scales are floored at 10% of the
    median channel std so near-silent high-mel channels don't amplify
    noise.
    """
    flat = np.concatenate([p.reshape(-1, p.shape[-1])
                           for p in partials_by_speaker.values()])
    mu = flat.mean(axis=0)
    std = flat.std(axis=0)
    floor = max(1e-4, 0.1 * float(np.median(std)))
    return mu.astype(np.float32), (1.0 / np.maximum(std, floor)).astype(
        np.float32)


def fold_input_norm(params, mu, scale):
    """Fold ``x -> (x - mu) * scale`` into the layer-0 LSTM weights, so the
    returned params compute the trained function directly on RAW features:
    gates = ((x-mu)*s) @ W + b  ==  x @ (s[:,None]*W) + (b - (mu*s) @ W),
    with W the (in, 4H) kernel.  The products are numpy's in float32, as
    the TPU package computes them, so both packages fold to the same bits."""
    w_key, b_key = NET + "lstm.weight_ih_l0", NET + "lstm.bias_ih_l0"
    w_t = params[w_key]
    w = np.ascontiguousarray(w_t.detach().cpu().numpy().T)      # (in, 4H)
    out = dict(params)
    out[w_key] = torch.from_numpy(np.ascontiguousarray((scale[:, None] * w).T)).to(w_t.device)
    out[b_key] = params[b_key] - torch.from_numpy((mu * scale) @ w).to(w_t.device)
    return out


class _ClipAdam:
    """optax's ``chain(clip_by_global_norm(clip), adam(lr))`` over a dict of
    tensors: the global-norm clip, then Adam with eps outside the square
    root and bias corrections in fp32 (``train/optim.py`` computes its
    Adam the same way)."""

    def __init__(self, params, lr, clip=3.0, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if not bool(g_norm < self.clip):
            grads = {n: g / g_norm * self.clip for n, g in grads.items()}
        self.count += 1
        k = torch.tensor(float(self.count))
        c1 = (1.0 - torch.tensor(self.b1) ** k).item()
        c2 = (1.0 - torch.tensor(self.b2) ** k).item()
        for n, p in params.items():
            g, mu, nu = grads[n], self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            p.add_(-self.lr * ((mu / c1) / (torch.sqrt(nu / c2) + self.eps)))


def train_ge2e(partials_by_speaker, *, hidden=256, embed=256, layers=3,
               steps=300, lr=1e-3, n_speakers_per_batch=8,
               m_utts_per_speaker=4, seed=0, log_every=50, verbose=False,
               normalize=True, device="cuda"):
    """Train a scratch GE2E verifier.

    partials_by_speaker: dict speaker -> (n_utt, frames, 40) float32; use
    :func:`utterance_partial` to build it from wavs.  Returns
    ``(params, trace)`` where trace is the per-step loss list.  With
    ``normalize`` (default) training runs on standardized features and the
    normalization is FOLDED into the returned layer-0 weights
    (:func:`fold_input_norm`), so the returned/exported net consumes raw
    resemblyzer-convention features.  Batches are drawn from
    ``np.random.RandomState(seed + 1)``, as the TPU package draws them.
    """
    speakers = sorted(partials_by_speaker)
    if len(speakers) < n_speakers_per_batch:
        raise ValueError(f"need >= {n_speakers_per_batch} speakers, got {len(speakers)}")
    device = resolve_device(device)
    mel_c = next(iter(partials_by_speaker.values())).shape[-1]
    if normalize:
        mu, scale = _input_norm_stats(partials_by_speaker)
        partials_by_speaker = {
            s: ((p - mu) * scale).astype(np.float32)
            for s, p in partials_by_speaker.items()}
    params = ge2e_init(seed, mel_channels=mel_c, hidden=hidden, embed=embed,
                       layers=layers, device=device)
    opt = _ClipAdam(params, lr)

    rng = np.random.RandomState(seed + 1)
    trace = []
    # return the best-loss params, not the last: a VERIFIER wants the
    # best contrastive optimum, and late GE2E training wobbles; also stop
    # if the loss ever goes non-finite instead of training on garbage
    best_loss, best_params = np.inf, {k: v.clone() for k, v in params.items()}
    for it in range(steps):
        spk = rng.choice(len(speakers), size=n_speakers_per_batch,
                         replace=False)
        batch = np.stack([
            partials_by_speaker[speakers[j]][
                rng.choice(len(partials_by_speaker[speakers[j]]),
                           size=m_utts_per_speaker,
                           replace=len(partials_by_speaker[speakers[j]])
                           < m_utts_per_speaker)]
            for j in spk])
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = ge2e_softmax_loss(live, torch.from_numpy(batch).to(device))
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        opt.step(params, grads)
        trace.append(loss.item())
        if not np.isfinite(trace[-1]):
            warnings.warn(f"GE2E loss went non-finite at step {it}; "
                          "stopping and returning the best params so far")
            break
        if trace[-1] < best_loss:
            best_loss = trace[-1]
            best_params = {k: v.clone() for k, v in params.items()}
        if verbose and (it % log_every == 0 or it == steps - 1):
            print(f"[ge2e] step {it:4d} loss {trace[-1]:.4f}", flush=True)
    params = best_params
    if normalize:
        params = fold_input_norm(params, mu, scale)
    return params, trace


def save_ge2e_npz(params, path):
    """Export to resemblyzer's state-dict npz layout (``lstm.weight_ih_l{k}``
    (4H, in) etc.), which ``DVectorEncoder`` loads as it loads converted
    official weights.  The TPU package's encoder reads exactly
    ``GE2E_LAYERS`` stacked LSTMs, so an npz of another depth is refused."""
    arrs = {k[len(NET):]: v.detach().cpu().numpy() for k, v in params.items()
            if k.startswith(NET)}
    layers = sum(1 for k in arrs if k.startswith("lstm.weight_ih_l"))
    if layers != GE2E_LAYERS:
        raise ValueError(f"DVectorEncoder loads exactly GE2E_LAYERS stacked LSTMs "
                         f"({GE2E_LAYERS}); train with layers={GE2E_LAYERS}, not {layers}")
    np.savez(path, **arrs)
    return path
