"""Speaker conditioning (reference ``lightning/model/speaker_encoder.py``).

Modes (``algorithm.adapt.speaker_emb``):

* ``table`` -- one embedding row per speaker; ``shared`` -- a single row;
* ``encoder`` / ``scratch_encoder`` -- a trainable GE2E d-vector network
  over reference-mel slices (resemblyzer's architecture: 3 x LSTM-256 over
  40-mel partials -> linear -> ReLU -> L2 norm, then the mean over an
  utterance's valid slices and its L2 norm);
* ``dvec`` -- the same network, frozen: no gradient reaches it.

Pretrained resemblyzer weights are not part of the repository, so every
mode starts from a random init, as in the JAX package.
"""

import torch
from torch import nn

from . import nn as L

GE2E_MEL_CHANNELS = 40
GE2E_HIDDEN = 256
GE2E_EMBED = 256
GE2E_LAYERS = 3
GE2E_MODES = ("encoder", "dvec", "scratch_encoder")


def ge2e_dims(model_cfg):
    """(mel_channels, hidden, embed, layers): resemblyzer's layout unless
    ``model.ge2e`` overrides them (small tests; embed must equal the
    transformer's hidden width, as 256 does at the base config)."""
    g = model_cfg.get("ge2e", {})
    return (g.get("mel_channels", GE2E_MEL_CHANNELS), g.get("hidden", GE2E_HIDDEN),
            g.get("embed", GE2E_EMBED), g.get("layers", GE2E_LAYERS))


class GE2E(nn.Module):
    """The d-vector network: ``lstm`` and ``linear`` as resemblyzer names them."""

    def __init__(self, mel_channels, hidden, embed, layers):
        super().__init__()
        self.lstm = L.LSTM(mel_channels, hidden, layers)
        self.linear = L.Linear(hidden, embed)

    def forward(self, mels, cdtype=torch.float32):
        """(N, T, 40) partial-slice mels -> (N, embed) L2-normalised
        d-vectors, from the last layer's final h."""
        _, finals = self.lstm(mels, cdtype)
        e = torch.relu(self.linear(finals[-1], cdtype))
        # sqrt(sum + eps), not a norm: its gradient at e = 0 (every unit
        # cut by the ReLU) is 0 where a norm's is NaN
        return e / torch.sqrt((e * e).sum(-1, keepdim=True) + 1e-12)


class SpeakerEncoder(nn.Module):
    def __init__(self, emb_type, n_speakers, d, model_cfg):
        super().__init__()
        self.emb_type = emb_type
        if emb_type in GE2E_MODES:
            self.model = GE2E(*ge2e_dims(model_cfg))
        elif emb_type in ("table", "shared"):
            self.model = L.Embedding(n_speakers if emb_type == "table" else 1, d)
        else:
            raise ValueError(f"unknown speaker_emb {emb_type!r}")

    def forward(self, speaker_args, cdtype=torch.float32):
        """(B, H) speaker embeddings from (B,) int speaker ids, or in the
        d-vector modes from ``(ref_mels (B, S, T, 40), slice_valid (B, S))``:
        the mean of each utterance's valid slices' d-vectors, L2-normalised."""
        if self.emb_type == "table":
            return self.model(speaker_args)
        if self.emb_type == "shared":
            w = self.model.weight[0]
            return w.expand(speaker_args.shape[0], w.shape[0])
        ref, valid = speaker_args
        B, S, T, C = ref.shape
        # dvec: a frozen network, no gradient reaches it (the slices are data)
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.emb_type != "dvec"):
            partial = self.model(ref.reshape(B * S, T, C), cdtype).reshape(B, S, -1)
        wt = valid.float()[..., None]
        mean = (partial * wt).sum(1) / torch.clamp(wt.sum(1), min=1e-8)
        return mean / torch.clamp(torch.linalg.vector_norm(mean, dim=-1, keepdim=True),
                                  min=1e-8)


def make_speaker_encoder(model_cfg, algorithm_cfg, n_speakers):
    if not model_cfg["multi_speaker"]:
        return None
    return SpeakerEncoder(algorithm_cfg["adapt"]["speaker_emb"], n_speakers,
                          model_cfg["transformer"]["encoder_hidden"], model_cfg)
