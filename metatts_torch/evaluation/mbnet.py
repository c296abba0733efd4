"""MBNet mean-net pseudo-MOS scorer on the card.

The reference scores synthesized audio with MBNet (reference
``evaluation/compute_mos.py:144-166``): it builds
``Pytorch_MBNet.model.MBNet(num_judges=5000)``, loads the pretrained
``model-50000.pt`` checkpoint, and calls ``only_mean_inference`` on the
16 kHz magnitude STFT (``n_fft=512``, librosa defaults -> hop 128).  Only
the MEAN subnet takes part in that call (the bias subnet and judge
embedding exist for training against per-judge scores; MBNet, Leng et al.
2021).  The mean net has MOSNet's CNN-BLSTM structure, with torch's
padding:

  input  (B, T, 257) magnitude STFT (sr 16 kHz, n_fft 512, hop 128, hann;
         host numpy)
  -> (B, 1, T, 257)
  -> 4 conv blocks, channels [16, 32, 64, 128]; each block is three
     Conv2d(3x3, relu, padding=1), the third with stride (1,3)
     (floor-mode shapes: 257 -> 86 -> 29 -> 10 -> 4 freq bins)
  -> permute/reshape to (B, T, 4*128), freq-major within a frame
  -> Bidirectional LSTM(128), concat -> (B, T, 256)
  -> Linear(256,128) + ReLU (+ dropout, an inference no-op) -> Linear(128,1)
  -> utterance score = mean over frame scores

Weights come from ``tools/convert_torch_weights.py mbnet`` (the same npz
layout as MOSNet's).  Unlike MOSNet's Keras 'same', ``padding=1`` is
symmetric at every stride.
"""

import torch
import torch.nn.functional as F

from .mosnet import STRIDES, _head, load_params, magnitude_spectrogram as _magnitude
from ..utils.tools import resolve_device

HOP = 128          # librosa.stft default: win_length // 4


def magnitude_spectrogram(wav, sr):
    """|STFT| feature of the reference's ``MBNetDataset.__getitem__``
    (librosa defaults: centered, reflect-padded, hann, hop 128)
    -> (T, 257) float32."""
    return _magnitude(wav, sr, hop=HOP)


def forward(params, mag):
    """mag: (B, T, 257) -> (utterance scores (B,), frame scores (B, T))."""
    x = mag[:, None]                                 # (B, 1, T, 257)
    for k, c in enumerate(params["convs"]):
        x = torch.relu(F.conv2d(x, c["kernel"], c["bias"], stride=STRIDES[k % 3],
                                padding=1))
    return _head(params, x)


class MBNetMean:
    """``only_mean_inference`` over converted weights: host features, the
    network on ``device``."""

    def __init__(self, npz_path, device="cuda"):
        self.device = resolve_device(device)
        self.params = load_params(npz_path, self.device)

    def score(self, wav, sr):
        mag = magnitude_spectrogram(wav, sr)
        with torch.no_grad():
            avg, _ = forward(self.params, torch.from_numpy(mag[None]).to(self.device))
        return float(avg[0])
