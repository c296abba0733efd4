#!/usr/bin/env python3
"""The error of the fused block's attention under two designs, on the CPU.

    python3 tools/attention_rounding.py

The TPU kernel rounds the *normalised* softmax P to bf16 before P.V.  The
port's CUDA kernel keeps that rounding with two passes over the keys (row
max and sum, then P.V).  A one-pass online softmax would instead round
exp(s - m_running) for each 64-key tile, rescale the running sum when the
max grows and divide by the row sum at the end.  This script puts both
roundings, in fp32 on the CPU, into the plain version of the block
(``ops/fftblock.fused_fft_block_plain``) at the chip smoke's base-width
input, B=8, T=1000 with lengths 1000, 777, 0, ..., and prints each one's
error against the plain version: max |out - plain| / max |plain|, the
measure the smoke holds the kernel to (rel < 5e-3).  It is a statement
about rounding, not a device measurement.
"""

import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TILE = 64


def bf(t):
    import torch
    return t.to(torch.bfloat16).float()


def one_pass(q, k, v, bias_row):
    """Online softmax over 64-key tiles, P rounded before it is normalised."""
    import torch
    B, T, _ = q.shape
    m = torch.full((B, T, 1), -math.inf)
    l = torch.zeros(B, T, 1)
    o = torch.zeros(B, T, v.shape[-1])
    for k0 in range(0, k.shape[1], TILE):
        s = q @ k[:, k0:k0 + TILE].transpose(1, 2) + bias_row[..., k0:k0 + TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + bf(p) @ v[:, k0:k0 + TILE]
        m = m_new
    return o / l


def main():
    import torch
    from metatts_torch.models import nn as L
    from metatts_torch.models.transformer import FFTBlock
    from metatts_torch.ops import fftblock as FB
    gen = torch.Generator().manual_seed(0)
    D, H, F, K, B, T = 256, 2, 1024, 9, 8, 1000
    blk = FFTBlock(D, H, F, [K, 1])
    L.reset_parameters(blk, gen)
    with torch.no_grad():
        for ln in (blk.slf_attn.layer_norm, blk.pos_ffn.layer_norm):
            ln.weight.copy_(1 + 0.1 * torch.randn(D, generator=gen))
            ln.bias.copy_(0.1 * torch.randn(D, generator=gen))
    p = blk.eval().fused_params()
    x = bf(torch.randn(B, T, D, generator=gen))
    lens = torch.tensor([1000, 777, 0, 1000, 500, 999, 1, 64])
    valid = torch.arange(T)[None, :] < lens[:, None]
    ref = FB.fused_fft_block_plain(p, x, valid, H)

    def block(attend):
        """the plain version with its per-head softmax and P.V replaced"""
        keep = valid[..., None]
        d_k = D // H
        qkv = bf(x) @ p["w_qkv"].float().T + p["b_qkv"]
        q = bf(qkv[..., :D] * (1.0 / math.sqrt(d_k)))
        k, v = bf(qkv[..., D:2 * D]), bf(qkv[..., 2 * D:])
        bias_row = (valid.float()[:, None, :] - 1.0) * -FB.NEG
        o = torch.cat([attend(*(t[..., h * d_k:(h + 1) * d_k] for t in (q, k, v)), bias_row)
                       for h in range(H)], -1)
        attn = bf(o) @ p["w_fc"].float().T + p["b_fc"]
        x1 = torch.where(keep, FB._ln(attn + x, p["ln1_w"], p["ln1_b"]), 0.0)
        pad = (K - 1) // 2
        xp = torch.nn.functional.pad(bf(x1), (0, 0, pad, pad))
        w1 = p["w1"][:F].float().view(F, K, D)
        hid = p["b1"][:F].expand(B, T, -1)
        for j in range(K):
            hid = hid + xp[:, j:j + T] @ w1[:, j].T
        y = bf(torch.relu(hid)) @ p["w2"][:, :F].float().T + p["b2"]
        return torch.where(keep, FB._ln(y + x1, p["ln2_w"], p["ln2_b"]), 0.0)

    def two_pass(q, k, v, bias_row):
        s = q @ k.transpose(1, 2) + bias_row
        s = torch.exp(s - s.amax(-1, keepdim=True))
        return bf(s / s.sum(-1, keepdim=True)) @ v

    scale = ref.abs().max().item()
    for name, attend in (("two passes (the kernel's; P rounded normalised)", two_pass),
                         ("one pass (P rounded before it is normalised)", one_pass)):
        with torch.no_grad():
            out = block(attend)
        print(f"[rounding] B={B} T={T} D={D} H={H}: {name}: rel "
              f"{(out - ref).abs().max().item() / scale:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
