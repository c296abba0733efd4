"""Speaker d-vector encoder for evaluation (resemblyzer equivalent).

The reference evaluation pipeline embeds real / reconstructed / synthesized
wavs with resemblyzer's pretrained GE2E VoiceEncoder
(``evaluation/wavs_to_dvector.py:18``).  Here the same architecture (the
port's ``models.speaker_encoder.GE2E``: stacked LSTM -> linear -> ReLU ->
L2 norm) runs on the card; pretrained weights load from an npz in
resemblyzer's state-dict layout (``lstm.weight_ih_l{k}`` (4H, in),
``lstm.weight_hh_l{k}``, ``lstm.bias_ih_l{k}``, ``lstm.bias_hh_l{k}``,
``linear.weight``, ``linear.bias``), with the widths read from the arrays
(``examples/meta_advantage_eer/ge2e_scratch.npz`` is hidden 128, embed 128).
Without weights it is a deterministic random-init encoder: useful for
pipeline tests, not for absolute EER.  Features (16 kHz 40-mel partials)
stay host numpy, as in the TPU package.
"""

import os
import warnings

import numpy as np
import torch

from ..models import nn as L
from ..models.speaker_encoder import GE2E, GE2E_HIDDEN, GE2E_LAYERS, GE2E_MEL_CHANNELS
from ..preprocess.refmel import (preprocess_ref_wav, wav_to_mel40,
                                 compute_partial_slices, tile_to_min_length,
                                 PARTIALS_N_FRAMES)
from ..utils.tools import resolve_device


def ge2e_from_state_dict(sd):
    """A ``GE2E`` module holding ``sd`` (name -> tensor or array, resemblyzer's
    layout), its widths and depth read from the arrays."""
    layers = sum(1 for k in sd if k.startswith("lstm.weight_ih_l"))
    w0 = sd["lstm.weight_ih_l0"]
    net = GE2E(w0.shape[1], w0.shape[0] // 4, sd["linear.weight"].shape[0], layers)
    net.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                         for k, v in sd.items()}, strict=True)
    return net


class DVectorEncoder:
    def __init__(self, weights_npz=None, seed=0, require_weights=False, device="cuda"):
        """``calibrated`` is True only when pretrained GE2E weights loaded.

        Random-init d-vectors keep the pipeline runnable but make absolute
        EER meaningless; every consumer must surface that (the harness tags
        report rows UNCALIBRATED). ``require_weights=True`` refuses instead.
        The random init draws from a ``torch.Generator`` seeded with ``seed``.
        """
        self.device = resolve_device(device)
        if weights_npz and os.path.exists(weights_npz):
            with np.load(weights_npz) as z:
                net = ge2e_from_state_dict({k: z[k] for k in z.files})
            self.calibrated = True
        else:
            if require_weights:
                raise FileNotFoundError(
                    f"GE2E weights npz not found at {weights_npz!r}; "
                    "refusing to produce uncalibrated d-vectors "
                    "(pass require_weights=False for pipeline tests)")
            warnings.warn(
                "DVectorEncoder running with RANDOM-INIT weights: EER / "
                "similarity numbers are UNCALIBRATED and not comparable to "
                "the reference (export resemblyzer weights to npz to fix)",
                stacklevel=2)
            self.calibrated = False
            net = GE2E(GE2E_MEL_CHANNELS, GE2E_HIDDEN, GE2E_HIDDEN, GE2E_LAYERS)
            L.reset_parameters(net, torch.Generator().manual_seed(seed))
        self.net = net.to(self.device).eval()

    def embed_partials(self, parts):
        """(N, 160, 40) numpy partials -> (N, embed) numpy d-vectors."""
        with torch.no_grad():
            return self.net(torch.from_numpy(parts).to(self.device)).cpu().numpy()

    def embed_utterance(self, wav, sr):
        """wav -> (embed,) L2-normalized utterance d-vector (mean of partials)."""
        wav = preprocess_ref_wav(np.asarray(wav, np.float32), sr)
        # short utterances are looped to fill one partial, not zero-padded
        # (zero tails collapse the final-hidden readout; see refmel
        # .tile_to_min_length).  Must match ge2e_scratch.utterance_partial
        # exactly: the scratch verifier is trained on this frontend.
        wav = tile_to_min_length(wav)
        wav_slices, mel_slices = compute_partial_slices(len(wav))
        if wav_slices[-1].stop >= len(wav):
            wav = np.pad(wav, (0, wav_slices[-1].stop - len(wav)))
        mel = wav_to_mel40(wav)
        parts = np.stack([mel[s] for s in mel_slices]) if mel_slices else \
            np.zeros((1, PARTIALS_N_FRAMES, GE2E_MEL_CHANNELS), np.float32)
        mean = self.embed_partials(parts).mean(axis=0)
        return mean / max(np.linalg.norm(mean), 1e-8)
