"""Offline preprocessing: raw wavs + MFA TextGrids -> per-utterance .npy
artifacts (``python -m metatts_torch.preprocess <yaml>... [--device]``)."""

from .textgrid import read_textgrid, IntervalTier  # noqa: F401

from .preprocessor import Preprocessor  # noqa: F401
