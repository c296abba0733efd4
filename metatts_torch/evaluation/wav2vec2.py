"""wav2vec2 encoder + MOS regression head on the card.

The reference's evaluation scores synthesized audio with a wav2vec2-based
pseudo-MOS predictor beside MOSNet and MBNet (reference
``evaluation/compute_mos.py:205,320``; published rows in
``evaluation/txt/LibriTTS/wav2vec2.txt``): wav2vec2-base features,
mean-pooled, through a small regression head.  This module runs the
wav2vec2-base architecture (conv feature encoder + post-LN transformer
encoder) plus an optional linear head in PyTorch, on weights converted from
the HuggingFace layout by ``tools/convert_torch_weights.py wav2vec2`` (the
config stored as a JSON entry of the npz; linear kernels (in, out), conv
kernels WIO, the positional conv's weight norm folded):

  raw wav (B, S) 16 kHz
  -> feature encoder: 7 temporal convs, dims 512, kernels (10,3,3,3,3,2,2),
     strides (5,2,2,2,2,2,2), no bias; layer 0 followed by GroupNorm(512)
     (num_groups == channels: per-channel norm over time); exact-erf GELU
  -> feature projection: LayerNorm(512) -> Linear(512->768)
  -> + positional conv embedding (grouped Conv1d k=128 g=16, padding 64,
     one trailing frame trimmed for even kernels, GELU)
  -> LayerNorm -> 12 post-LN transformer layers (12 heads, FFN 3072, GELU)
  -> mean-pool over time -> head Linear(768->1) = utterance score

Without head weights in the npz the embedding-norm proxy is the score and
the scorer stays marked uncalibrated.  Attention is plain torch products.
"""

import json

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tools import resolve_device

SR = 16000


def _layer_norm(x, p, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def _gelu(x):
    return F.gelu(x, approximate="none")


def feature_encoder(params, wav, cfg):
    """wav (B, S) -> (B, T, conv_dim[-1])."""
    x = wav[:, None, :]
    for i, c in enumerate(params["conv_layers"]):
        x = F.conv1d(x, c["kernel"], c.get("bias"), stride=cfg["conv_stride"][i])
        if i == 0 and "gn" in c:
            # GroupNorm(C, C): each channel normalized over time
            x = F.group_norm(x, x.shape[1], c["gn"]["scale"], c["gn"]["bias"], 1e-5)
        x = _gelu(x)
    return x.transpose(1, 2)


def _pos_conv(params, x, cfg):
    """Grouped weight-normed positional conv (the norm already folded by
    the converter).  x: (B, T, H)."""
    k = cfg["num_conv_pos_embeddings"]
    y = F.conv1d(x.transpose(1, 2), params["kernel"], params["bias"], padding=k // 2,
                 groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        y = y[:, :, :-1]                    # torch SamePadLayer: trim 1
    return _gelu(y).transpose(1, 2)


def _attention(p, x, n_heads):
    B, T, H = x.shape
    d = H // n_heads

    def split(h):
        return h.reshape(B, T, n_heads, d).transpose(1, 2)

    q = split(x @ p["q"]["kernel"] + p["q"]["bias"]) * (d ** -0.5)
    k = split(x @ p["k"]["kernel"] + p["k"]["bias"])
    v = split(x @ p["v"]["kernel"] + p["v"]["bias"])
    att = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    out = (att @ v).transpose(1, 2).reshape(B, T, H)
    return out @ p["out"]["kernel"] + p["out"]["bias"]


def encode(params, wav):
    """Full wav2vec2 forward: wav (B, S) -> last hidden states (B, T, H)."""
    cfg = params["config"]
    x = feature_encoder(params, wav, cfg)
    x = _layer_norm(x, params["fp_ln"])
    x = x @ params["proj"]["kernel"] + params["proj"]["bias"]
    x = x + _pos_conv(params["pos_conv"], x, cfg)
    x = _layer_norm(x, params["enc_ln"])
    for lp in params["layers"]:
        a = _attention(lp["attn"], x, cfg["num_attention_heads"])
        x = _layer_norm(x + a, lp["ln"])
        f = _gelu(x @ lp["ff_in"]["kernel"] + lp["ff_in"]["bias"])
        f = f @ lp["ff_out"]["kernel"] + lp["ff_out"]["bias"]
        x = _layer_norm(x + f, lp["final_ln"])
    return x


def load_params(npz_path, device="cuda"):
    """Weights converted by ``convert_wav2vec2_pt`` -> tensors on ``device``
    (conv kernels as torch's (out, in / groups, k)) and the config dict."""
    device = resolve_device(device)

    def t(a, conv=False):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 1, 0) if conv
                                                     else a)).to(device)

    def affine(z, key, kind):
        names = ("kernel", "bias") if kind == "linear" else ("scale", "bias")
        return {n: t(z[f"{key}.{n}"]) for n in names}
    with np.load(npz_path) as z:
        cfg = json.loads(str(z["config"]))
        p = {"config": cfg, "conv_layers": [], "layers": []}
        for i in range(len(cfg["conv_stride"])):
            c = {"kernel": t(z[f"conv{i}.kernel"], conv=True)}
            if f"conv{i}.bias" in z:
                c["bias"] = t(z[f"conv{i}.bias"])
            if i == 0 and "conv0.gn.scale" in z:
                c["gn"] = affine(z, "conv0.gn", "norm")
            p["conv_layers"].append(c)
        p["fp_ln"], p["enc_ln"] = affine(z, "fp_ln", "norm"), affine(z, "enc_ln", "norm")
        p["proj"] = affine(z, "proj", "linear")
        p["pos_conv"] = {"kernel": t(z["pos_conv.kernel"], conv=True),
                         "bias": t(z["pos_conv.bias"])}
        for i in range(cfg["num_hidden_layers"]):
            lp = {"attn": {nm: affine(z, f"layer{i}.attn.{nm}", "linear")
                           for nm in ("q", "k", "v", "out")}}
            for nm in ("ln", "final_ln"):
                lp[nm] = affine(z, f"layer{i}.{nm}", "norm")
            for nm in ("ff_in", "ff_out"):
                lp[nm] = affine(z, f"layer{i}.{nm}", "linear")
            p["layers"].append(lp)
        if "head.kernel" in z:
            p["head"] = affine(z, "head", "linear")
    return p


def utterance_score(params, wav, n_valid_frames=None):
    """Mean-pooled hidden states -> regression head (or the documented
    norm proxy when no head was converted).

    ``n_valid_frames`` restricts the pooling to the frames produced by the
    un-padded part of a length-bucketed waveform; None pools every frame."""
    h = encode(params, wav)
    T = h.shape[1]
    if n_valid_frames is None:
        w = h.new_ones(T)
    else:
        w = (torch.arange(T, device=h.device) < n_valid_frames).to(h.dtype)
    denom = torch.clamp(w.sum(), min=1.0)
    pooled = (h * w[None, :, None]).sum(dim=1) / denom     # (B, H)
    if "head" in params:
        return (pooled @ params["head"]["kernel"] + params["head"]["bias"])[..., 0]
    # proxy (the transformers-hook fallback's formula): embedding norm
    # squashed into [1, 5]; labelled uncalibrated upstream
    norm = (torch.linalg.vector_norm(h, dim=-1) * w[None]).sum(dim=-1) / denom
    return 1.0 + 4.0 * torch.sigmoid(norm - 5.0)


def n_conv_frames(params, n_samples):
    """Feature-encoder output length for ``n_samples`` input samples
    (kernel widths from the conv kernels, strides from the config)."""
    n = int(n_samples)
    strides = params["config"]["conv_stride"]
    for c, stride in zip(params["conv_layers"], strides):
        n = (n - int(c["kernel"].shape[-1])) // int(stride) + 1
    return max(n, 0)


class Wav2Vec2Scorer:
    """Utterance scorer over converted weights.

    ``bucket=True`` (default) pads each waveform up to a small geometric
    ladder of lengths (x1.5 steps from 1 s) and mean-pools only the valid
    frames, as the TPU package does to compile few programs; its scores
    are then the TPU package's default scores.  The zero-pad still enters
    the conv GroupNorm and the unmasked attention (wav2vec2-base has no
    attention mask), so bucketed scores drift slightly from exact ones;
    ``bucket=False`` scores the waveform at its own length."""

    BUCKET_BASE = SR          # 1 s floor
    BUCKET_GROWTH = 1.5

    def __init__(self, npz_path, bucket=True, device="cuda"):
        self.device = resolve_device(device)
        self.params = load_params(npz_path, self.device)
        self.calibrated = "head" in self.params
        self.bucket = bucket

    def _bucket_len(self, n):
        b = self.BUCKET_BASE
        while b < n:
            b = int(b * self.BUCKET_GROWTH)
        return b

    def score(self, wav, sr):
        from ..preprocess.audio_io import resample
        wav = np.asarray(wav, np.float32)
        if sr != SR:
            wav = resample(wav, sr, SR)
        # zero-mean / unit-var per utterance (HF Wav2Vec2FeatureExtractor
        # do_normalize=True convention)
        wav = (wav - wav.mean()) / (wav.std() + 1e-7)
        min_len = int(np.prod(self.params["config"]["conv_stride"])) * 4
        if len(wav) < min_len:
            wav = np.pad(wav, (0, min_len - len(wav)))
        n_valid = None
        if self.bucket:
            n_valid = n_conv_frames(self.params, len(wav))
            wav = np.pad(wav, (0, self._bucket_len(len(wav)) - len(wav)))
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(wav[None])).to(self.device)
            return float(utterance_score(self.params, x, n_valid)[0])
