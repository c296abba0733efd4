"""Offline evaluation: d-vectors, speaker similarity, EER, pseudo-MOS and
figures (reference ``evaluation/``); ``python -m metatts_torch.evaluate``
is the CLI."""

from .dvector import DVectorEncoder  # noqa: F401
from .similarity import centroid_similarity, pair_similarity  # noqa: F401
from .verification import speaker_verification_eer  # noqa: F401
