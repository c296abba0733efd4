"""Codebook phoneme embedding for cross-lingual adaptation
(reference ``lightning/model/phoneme_embedding.py:18-141``).

For ``adapt.type == "lang"`` episodes the encoder's phoneme table is
regenerated per episode from the support set's per-phoneme
representations:

  hard attention: the cosine-nearest ``att_banks`` row picks (one-hot) a
                  row of ``emb_banks``;
  soft attention: scaled-dot attention with Q = W_q(ref),
                  K = W_k(att_banks), V = emb_banks.

``get_new_embedding`` returns the (vocab, d) table that replaces
``encoder.src_word_emb.weight`` before the inner loop (the reference's
``on_after_batch_transfer`` refresh, ``meta.py:24-33``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as L


class PhonemeEmbedding(nn.Module):
    """The codebook's parameters: ``emb_banks`` (size, d), ``att_banks``
    (size, d_feat) for hard attention or (size, d) for soft, and for soft
    attention the projections ``w_qs`` (d_feat -> d) and ``w_ks`` (d -> d)."""

    def __init__(self, model_cfg, algorithm_cfg):
        super().__init__()
        pe = algorithm_cfg["adapt"]["phoneme_emb"]
        d = model_cfg["transformer"]["encoder_hidden"]
        d_feat = pe.get("representation_dim", d)
        self.attention = pe.get("attention", {"type": "hard"})["type"]
        hard = self.attention == "hard"
        self.emb_banks = nn.Parameter(torch.empty(pe["size"], d))
        self.att_banks = nn.Parameter(torch.empty(pe["size"], d_feat if hard else d))
        if not hard:
            self.w_qs = L.Linear(d_feat, d)
            self.w_ks = L.Linear(d, d)

    def reset_parameters(self, generator):
        """N(0, 1) banks, projections as the port's linears (the JAX
        package's distributions)."""
        with torch.no_grad():
            for bank in (self.emb_banks, self.att_banks):
                bank.copy_(torch.randn(bank.shape, generator=generator))
        if self.attention != "hard":
            self.w_qs.reset_parameters(generator)
            self.w_ks.reset_parameters(generator)


def get_new_embedding(params, ref, attention_type="hard"):
    """``params``: name -> tensor of a ``PhonemeEmbedding`` (``emb_banks``,
    ``att_banks``, ``w_qs.weight`` ...); ``ref``: (vocab, d_feat)
    per-phoneme representations, zero rows for phonemes the support set
    lacks -> (vocab, d) fp32 table with the PAD row 0 zeroed.

    Hard attention takes the first index among equal similarities (as
    ``jnp.argmax`` does), and its gradient reaches ``emb_banks`` only, on
    the rows it picks for non-zero ``ref`` rows."""
    emb = params["emb_banks"]
    keep = torch.arange(ref.shape[0], device=ref.device) > 0     # the PAD row 0
    if attention_type == "hard":
        ref_norm = torch.linalg.vector_norm(ref, dim=1, keepdim=True)
        normed_ref = ref / ref_norm.clamp_min(1e-8)
        banks = params["att_banks"]
        normed_banks = banks / torch.linalg.vector_norm(
            banks, dim=1, keepdim=True).clamp_min(1e-8)
        pick = (normed_ref @ normed_banks.T).argmax(dim=1)  # (vocab,)
        one_hot = F.one_hot(pick, banks.shape[0]).to(emb.dtype).detach()
        keep = keep & (ref_norm[:, 0] > 0)
        table = one_hot @ emb
    else:
        q = ref @ params["w_qs.weight"].T + params["w_qs.bias"]         # (vocab, d)
        k = params["att_banks"] @ params["w_ks.weight"].T + params["w_ks.bias"]
        attn = torch.softmax((q @ k.T) / math.sqrt(emb.shape[1]), dim=-1)
        table = attn @ emb
    return torch.where(keep[:, None], table, torch.zeros_like(table))
