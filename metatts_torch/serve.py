"""Serving: batched text -> waveform synthesis.

A ``SynthesisEngine`` owns an eval-mode FastSpeech2 and a vocoder on one
device and runs text batches through both.  Every FFT block of the
synthesis forward runs as one fused kernel (``ops/fftblock.py``) where the
width allows it: a CUDA kernel on the card, its plain PyTorch version on
the CPU.

Few-shot serving: ``adapt_speaker`` runs the test-time first-order
adaptation on a support batch and returns a new engine on a copy of the
model that holds the adapted weights.  ``from_checkpoint`` builds an engine
from a checkpoint of either package.

The engine runs on the card unless it is given ``device="cpu"``; without a
card it raises rather than falling back to the CPU.
"""

import copy

import numpy as np
import torch

from .data.collate import collate_batch
from .models.fastspeech2 import FastSpeech2
from .models.vocoder import Vocoder
from .text import text_to_sequence
from .utils.tools import resolve_device


class SynthesisEngine:
    def __init__(self, model, preprocess_cfg, model_cfg, algorithm_cfg,
                 vocoder=None, device="cuda"):
        """``model``: a ``FastSpeech2``; it is moved to ``device`` and put in
        eval mode.  ``vocoder``: a ``Vocoder`` (default: random-init MelGAN
        or HiFi-GAN per ``model_cfg["vocoder"]``, or its weights_npz)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.pcfg = preprocess_cfg
        self.mcfg = model_cfg
        self.acfg = algorithm_cfg
        self.vocoder = vocoder or Vocoder(
            model_cfg,
            n_mels=preprocess_cfg["preprocessing"]["mel"]["n_mel_channels"],
            device=self.device)
        self.hop = preprocess_cfg["preprocessing"]["stft"]["hop_length"]
        self.sr = preprocess_cfg["preprocessing"]["audio"]["sampling_rate"]

    @classmethod
    def from_jax_params(cls, params, state, preprocess_cfg, model_cfg,
                        algorithm_cfg, stats, n_speakers, vocoder_params=None,
                        device="cuda"):
        """Engine over JAX FastSpeech2 ``params`` / ``state`` (and optional
        vocoder) trees of numpy arrays."""
        from .convert import load_fs2_from_jax, load_vocoder_from_jax
        device = resolve_device(device)
        model = FastSpeech2(preprocess_cfg, model_cfg, algorithm_cfg, stats,
                            n_speakers)
        load_fs2_from_jax(model, params, state)
        vocoder = None
        if vocoder_params is not None:
            vocoder = Vocoder(
                model_cfg,
                n_mels=preprocess_cfg["preprocessing"]["mel"]["n_mel_channels"],
                device=device)
            load_vocoder_from_jax(vocoder, vocoder_params)
        return cls(model, preprocess_cfg, model_cfg, algorithm_cfg,
                   vocoder=vocoder, device=device)

    @torch.no_grad()
    def synthesize(self, texts, speakers=None, mel_cap=1000,
                   p_control=1.0, e_control=1.0, d_control=1.0):
        """texts: list of strings or pre-tokenized id arrays ->
        list of (int16 wav, mel np.ndarray)."""
        cleaners = self.pcfg["preprocessing"]["text"]["text_cleaners"]
        samples = []
        for i, t in enumerate(texts):
            ids = (np.asarray(t, np.int32) if not isinstance(t, str)
                   else np.asarray(text_to_sequence(t, cleaners), np.int32))
            samples.append({
                "id": f"synth_{i}",
                "speaker": 0 if speakers is None else speakers[i],
                "text": ids,
                "raw_text": t if isinstance(t, str) else "",
            })
        batch, _ = collate_batch(samples, with_mels=False)
        out = self.model(batch.to(self.device), teacher_forced=False,
                         max_mel_len=mel_cap, p_control=p_control,
                         e_control=e_control, d_control=d_control,
                         fused_infer=True)
        mels = out.postnet_mel
        mel_lens = out.mel_lens.cpu().numpy()
        wavs = self.vocoder.infer(mels, lengths=mel_lens * self.hop)
        mels = mels.cpu().numpy()
        return [(wavs[i], mels[i, : mel_lens[i]]) for i in range(len(texts))]

    # ---------------------------------------------------- few-shot serving

    def adapt_speaker(self, sup_batch, steps=None, lr=None):
        """First-order SGD on the support Batch (``steps`` and ``lr``
        default to the test stage's), without dropout and with BatchNorm's
        running statistics -> a new engine on a copy of the model with the
        adapted weights (its own fused-weight packs), sharing the vocoder."""
        from .algorithms.adapt import Adaptor
        test_cfg = self.acfg["adapt"]["test"]
        steps = steps or test_cfg["steps"]
        lr = lr or test_cfg["lr"]
        adapted = Adaptor(self.model, self.pcfg, self.mcfg, self.acfg).adapt_first_order(
            dict(self.model.named_parameters()), sup_batch.to(self.device),
            steps=steps, lr=lr, train=False)
        model = copy.deepcopy(self.model)
        model.load_state_dict({**model.state_dict(), **adapted}, strict=True)
        return SynthesisEngine(model, self.pcfg, self.mcfg, self.acfg,
                               vocoder=self.vocoder, device=self.device)

    @classmethod
    def from_checkpoint(cls, ckpt_path, preprocess_cfg, model_cfg,
                        algorithm_cfg, stats=None, n_speakers=8, device="cuda"):
        """An engine on a checkpoint of either package: the model is
        initialised from seed 0, then loaded under the checkpoint surgery
        rules, whose report lines are printed."""
        from .algorithms.base import DEFAULT_STATS
        from .train.checkpoint import load_checkpoint
        device = resolve_device(device)
        model = FastSpeech2(preprocess_cfg, model_cfg, algorithm_cfg,
                            stats or DEFAULT_STATS, n_speakers,
                            generator=torch.Generator().manual_seed(0))
        _, _, report = load_checkpoint(ckpt_path, model)
        for r in report:
            print(f"[ckpt surgery] {r}")
        return cls(model, preprocess_cfg, model_cfg, algorithm_cfg, device=device)
