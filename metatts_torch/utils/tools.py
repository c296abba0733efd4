"""Small numeric utilities shared across layers.

Masks are True at *valid* positions (the reference's are True at padding).
"""

import math

import numpy as np
import torch


def resolve_device(device):
    """``device`` as a torch.device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def get_mask_from_lengths(lengths, max_len):
    """(B,) int lengths -> (B, max_len) bool, True where t < length (valid)."""
    ids = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return ids[None, :] < lengths[:, None]


def pad_1d(inputs, pad_to=None, pad_value=0.0):
    """Pad a list of 1-D numpy arrays to a common (or given) length."""
    max_len = pad_to if pad_to is not None else max(x.shape[0] for x in inputs)
    out = np.full((len(inputs), max_len), pad_value, dtype=inputs[0].dtype)
    for i, x in enumerate(inputs):
        out[i, : x.shape[0]] = x[:max_len]
    return out


def pad_2d(inputs, pad_to=None, pad_value=0.0):
    """Pad a list of (T_i, D) numpy arrays to (B, T_max, D)."""
    max_len = pad_to if pad_to is not None else max(x.shape[0] for x in inputs)
    d = inputs[0].shape[1]
    out = np.full((len(inputs), max_len, d), pad_value, dtype=inputs[0].dtype)
    for i, x in enumerate(inputs):
        out[i, : min(x.shape[0], max_len)] = x[:max_len]
    return out


def bucket_length(n, multiple=32, max_len=None):
    """Round n up to a multiple (one kernel shape per bucket); cap at max."""
    b = int(math.ceil(n / multiple) * multiple)
    if max_len is not None:
        b = min(b, max_len)
    return max(b, multiple)
