"""MOSNet (CNN-BLSTM) pseudo-MOS scorer on the card.

The reference scores synthesized audio with MOSNet through the
``speechmetrics`` package (reference ``evaluation/compute_mos.py:25``),
which loads the official Keras checkpoint ``cnn_blstm.h5`` (MOSNet, Lo et
al. 2019).  This module runs that architecture in PyTorch on weights
converted by ``tools/convert_torch_weights.py mosnet`` (Keras layouts:
conv kernels HWIO, LSTM kernels (D, 4H)):

  input  (B, T, 257) magnitude STFT (sr 16 kHz, n_fft 512, hop 256, hann;
         host numpy)
  -> (B, 1, T, 257)
  -> 4 conv blocks, channels [16, 32, 64, 128]; each block is three
     Conv2D(3x3, relu, 'same'), strides (1,1), (1,1), (1,3)
  -> (B, 128, T, 4) -> (B, T, 4, 128) -> (B, T, 512): Keras flattens NHWC
     as (freq, channel)
  -> Bidirectional LSTM(128), concat -> (B, T, 256)
  -> TimeDistributed Dense(128, relu) -> Dense(1) frame scores
  -> utterance score = mean over frames

Keras' 'same' padding is asymmetric where a stride does not divide the
axis: on the 257-bin axis at stride 3 the (left, right) padding is (0, 1)
for 257 -> 86, 86 -> 29 and 29 -> 10, and (1, 1) for 10 -> 4, so each
conv pads explicitly (``_same_pad``) instead of ``Conv2d(padding=1)``.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tools import resolve_device

SR = 16000
N_FFT = 512
HOP = 256
STRIDES = ((1, 1), (1, 1), (1, 3))


def magnitude_spectrogram(wav, sr, hop=HOP):
    """|STFT| feature the official MOSNet computes (librosa defaults:
    centered, reflect-padded, hann window) -> (T, 257) float32."""
    from ..preprocess.audio_io import resample
    wav = np.asarray(wav, np.float32)
    if sr != SR:
        wav = resample(wav, sr, SR)
    pad = N_FFT // 2
    if len(wav) < 1:
        wav = np.zeros(1, np.float32)
    wav = np.pad(wav, pad, mode="reflect" if len(wav) > pad else "constant")
    n_frames = 1 + (len(wav) - N_FFT) // hop
    if n_frames < 1:
        return np.zeros((1, N_FFT // 2 + 1), np.float32)
    idx = np.arange(N_FFT)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(N_FFT + 1)[:-1]
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


def load_params(npz_path, device="cuda"):
    """Converted MOSNet / MBNet weights -> tensors on ``device``: conv
    kernels as (out, in, kh, kw), the BLSTM and dense layers in Keras'
    layout."""
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    with np.load(npz_path) as z:
        p = {"convs": [{"kernel": t(z[f"conv{i}.kernel"].transpose(3, 2, 0, 1)),
                        "bias": t(z[f"conv{i}.bias"])} for i in range(12)]}
        p["blstm"] = {d: {n: t(z[f"blstm.{d}.{n}"])
                          for n in ("kernel", "recurrent", "bias")}
                      for d in ("fwd", "bwd")}
        for name in ("dense1", "frame"):
            p[name] = {"kernel": t(z[f"{name}.kernel"]), "bias": t(z[f"{name}.bias"])}
    return p


def _keras_lstm(p, x):
    """Keras-layout LSTM over (B, T, D): kernel (D, 4H), recurrent (H, 4H),
    bias (4H,); gate order i, f, c (= g), o, as torch's."""
    H = p["recurrent"].shape[0]
    xw = x @ p["kernel"] + p["bias"]
    h = c = x.new_zeros(x.shape[0], H)
    hs = []
    for t in range(x.shape[1]):
        i, f, g, o = (xw[:, t] + h @ p["recurrent"]).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1)


def _same_pad(n, k, s):
    """(before, after) padding of Keras' 'same' along an axis of ``n``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _head(params, x):
    """(B, C, T, F) conv features -> (utterance scores (B,), frames (B, T))."""
    B, _, T, _ = x.shape
    x = x.permute(0, 2, 3, 1).reshape(B, T, -1)      # (B, T, F * C), F-major
    fwd = _keras_lstm(params["blstm"]["fwd"], x)
    bwd = _keras_lstm(params["blstm"]["bwd"], x.flip(1)).flip(1)
    x = torch.cat([fwd, bwd], dim=-1)                # (B, T, 256)
    x = torch.relu(x @ params["dense1"]["kernel"] + params["dense1"]["bias"])
    frames = (x @ params["frame"]["kernel"] + params["frame"]["bias"])[..., 0]
    return frames.mean(dim=1), frames


def forward(params, mag):
    """mag: (B, T, 257) magnitude spectrogram -> (avg (B,), frames (B, T))."""
    x = mag[:, None]                                 # (B, 1, T, 257)
    for k, c in enumerate(params["convs"]):
        stride = STRIDES[k % 3]
        kh, kw = c["kernel"].shape[2:]
        pt, pf = (_same_pad(n, kk, s) for n, kk, s in
                  zip(x.shape[2:], (kh, kw), stride))
        x = F.conv2d(F.pad(x, (*pf, *pt)), c["kernel"], c["bias"], stride=stride)
        x = torch.relu(x)
    return _head(params, x)


class MOSNet:
    """Scorer over converted weights: host features, the network on
    ``device``."""

    def __init__(self, npz_path, device="cuda"):
        self.device = resolve_device(device)
        self.params = load_params(npz_path, self.device)

    def score(self, wav, sr):
        mag = magnitude_spectrogram(wav, sr)
        with torch.no_grad():
            avg, _ = forward(self.params, torch.from_numpy(mag[None]).to(self.device))
        return float(avg[0])
