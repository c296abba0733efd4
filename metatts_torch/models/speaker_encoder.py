"""Speaker conditioning (reference ``lightning/model/speaker_encoder.py``).

Modes (``algorithm.adapt.speaker_emb``): ``table`` -- one embedding row per
speaker; ``shared`` -- a single shared row.  The GE2E d-vector modes
(``encoder``, ``dvec``, ``scratch_encoder``) wait for ROADMAP Queue 1
item 11.
"""

from torch import nn

from . import nn as L

class SpeakerEncoder(nn.Module):
    def __init__(self, emb_type, n_speakers, d):
        super().__init__()
        if emb_type in ("encoder", "dvec", "scratch_encoder"):
            raise NotImplementedError(
                f"speaker_emb {emb_type!r} (GE2E LSTM) is not ported yet: "
                "ROADMAP Queue 1 item 11")
        if emb_type not in ("table", "shared"):
            raise ValueError(f"unknown speaker_emb {emb_type!r}")
        self.emb_type = emb_type
        self.model = L.Embedding(n_speakers if emb_type == "table" else 1, d)

    def forward(self, speaker_args):
        """(B,) int speaker ids -> (B, H) speaker embeddings."""
        if self.emb_type == "table":
            return self.model(speaker_args)
        w = self.model.weight[0]
        return w.expand(speaker_args.shape[0], w.shape[0])


def make_speaker_encoder(model_cfg, algorithm_cfg, n_speakers):
    if not model_cfg["multi_speaker"]:
        return None
    return SpeakerEncoder(algorithm_cfg["adapt"]["speaker_emb"], n_speakers,
                          model_cfg["transformer"]["encoder_hidden"])
