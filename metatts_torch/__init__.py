"""metatts_torch: the PyTorch / CUDA (H100) port of the Meta-TTS system.

Runs on the card by default; entry points take ``device=`` and the tests
pass ``device="cpu"``.  Imports torch, numpy and the standard library only.
"""
