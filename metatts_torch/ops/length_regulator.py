"""Length regulator: expand phoneme-level features by integer durations.

Each output frame computes its source phoneme index in closed form and the
expansion is one batched gather at a static length:

    cum[l]  = cumsum(d)[l]
    idx[t]  = #{ l : cum[l] <= t }
    out[t]  = x[idx[t]]  if t < sum(d) else 0
"""

import torch


def _frame_to_phone_idx(durations, max_mel_len):
    """(B, L) int durations -> ((B, T) source index, (B, T) valid mask)."""
    cum = torch.cumsum(durations, dim=-1)                     # (B, L)
    t = torch.arange(max_mel_len, dtype=cum.dtype, device=cum.device)
    idx = (t[None, :, None] >= cum[:, None, :]).sum(-1)
    valid = t[None, :] < cum[:, -1:]
    idx = idx.clamp(0, durations.shape[-1] - 1)
    return idx, valid


def length_regulate(x, durations, max_mel_len):
    """Expand (B, L, H) by (B, L) int durations -> ((B, T, H), (B,) mel_len)."""
    idx, valid = _frame_to_phone_idx(durations, max_mel_len)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    out = torch.where(valid[..., None], out,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    mel_len = durations.sum(-1).clamp(max=max_mel_len).to(torch.int32)
    return out, mel_len
