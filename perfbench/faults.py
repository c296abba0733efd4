"""Faults planted in the timed path, to show that the check catches them:
each is a ``patch(cell)`` for ``harness.run_cell``, applied once the cell
has built its system or engine.  By entry point, the faults a cell of that
kind can have (one card: no exchange between chips to leave out)."""

import numpy as np


def state_unchanged(cell):
    """A training step that returns its state unchanged: the optimizer
    applies nothing."""
    cell.system.optimizer.step = lambda params, grads: None


def half_batch_train(cell):
    """Half of the batch left out, the mean taken over the rest."""
    step = cell.system.train_step

    def half(batch):
        from metatts_torch.data.collate import map_batch
        n = batch.texts.shape[0] // 2
        return step(map_batch(lambda t: t[:n], batch))
    cell.system.train_step = half


def half_batch_serve(cell):
    """Half of a request's sentences left out: the first half synthesized
    and served for all."""
    synth = cell.engine.synthesize

    def half(texts, speakers=None, **k):
        n = max(1, len(texts) // 2)
        out = synth(texts[:n], speakers=None if speakers is None else speakers[:n], **k)
        return [out[i % n] for i in range(len(texts))]
    cell.engine.synthesize = half


def answer_altered(cell):
    """One served answer altered where it is produced: a frame of the first
    sentence's mel takes the next frame's values."""
    synth = cell.engine.synthesize

    def altered(*a, **k):
        out = synth(*a, **k)
        wav, mel = out[0]
        if len(mel) > 1:
            mel = np.array(mel)
            mel[len(mel) // 2] = mel[len(mel) // 2 + 1]
            out[0] = (wav, mel)
        return out
    cell.engine.synthesize = altered


def durations_scaled(cell):
    """Durations decided wrongly where they are produced: every request's
    durations scaled by 1.5 (a phoneme of 6 frames takes 9)."""
    synth = cell.engine.synthesize
    cell.engine.synthesize = lambda *a, **k: synth(*a, **{**k, "d_control": 1.5})


def vocoder_bias_dropped(cell):
    """A vocoder that drops its bias adds: the served MelGAN's biases 0."""
    for n, p in cell.engine.vocoder.net.named_parameters():
        if n.endswith(".bias"):
            p.data.zero_()


BY_ENTRY = {
    "synthesize": {"half_batch": half_batch_serve, "answer_altered": answer_altered,
                   "durations_scaled": durations_scaled,
                   "vocoder_bias_dropped": vocoder_bias_dropped},
    "baseline_step": {"state_unchanged": state_unchanged, "half_batch": half_batch_train},
}
