"""Fused eval-mode FFT block: the CUDA kernel of ``csrc/fftblock.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``fused_fft_block`` (Pallas, ``ops/pallas/
fftblock.py`` of the JAX package): one whole post-LN FFT block in eval mode
-- Q/K/V projections, per-head masked softmax attention, output projection,
residual LayerNorm, valid mask, conv(k) FFN with ReLU, 1x1 conv, residual
LayerNorm, valid mask.  Products take bf16 inputs and accumulate in fp32;
softmax and LayerNorm statistics are fp32; the output is fp32.

On a CUDA tensor ``fused_fft_block`` launches the kernel (five launches in
one C call) or raises; on a CPU tensor it runs ``fused_fft_block_plain``,
which rounds to bf16 at the same places.  ``fused_fft_block.launches``
counts the calls that launched the kernel.
"""

import ctypes
import math

import torch

NEG = -1e9

_C = ctypes.c_void_p
_SIGNATURES = {
    "mtts_fft_block": (ctypes.c_int, [_C] * 20 + [ctypes.c_int] * 6 + [_C]),
    "mtts_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def fused_block_supported(d_model, d_k):
    """Widths that take the fused path: the TPU kernel's own gate."""
    return d_model % 128 == 0 and d_k <= 128


def kernel_shape_error(d_model, n_head, filter_size):
    """Why the CUDA kernel cannot run this block shape, or None.  Beyond
    the gate, the LayerNorm epilogue holds a whole row of at most 256
    channels in one tile, and tiles load rows in chunks of 8 channels."""
    if d_model % n_head:
        return f"D={d_model} is not a multiple of {n_head} heads"
    d_k = d_model // n_head
    if not fused_block_supported(d_model, d_k):
        return f"D={d_model}, d_k={d_k} fail the fused-block gate"
    if d_model > 256:
        return f"D={d_model} is wider than the LayerNorm epilogue's 256"
    if d_k % 8 or filter_size % 8:
        return f"d_k={d_k} and filter size {filter_size} must be multiples of 8"
    return None


def pack_block_params(attn, ffn):
    """Kernel layout of one FFT block's parameters, from the port's
    ``MultiHeadAttention`` and ``PositionwiseFeedForward`` modules:
    bf16 weights as (out, in) rows with the conv taps flattened into the
    reduction axis (``w1``: (F, K*D), tap-major), fp32 vectors."""
    bf = torch.bfloat16
    w = lambda t: t.detach().to(bf).contiguous()
    v = lambda t: t.detach().to(torch.float32, copy=True).contiguous()
    w1 = ffn.w_1.weight                                # (F, D, K)
    return {
        "w_qkv": w(torch.cat([attn.w_qs.weight, attn.w_ks.weight,
                              attn.w_vs.weight])),
        "b_qkv": v(torch.cat([attn.w_qs.bias, attn.w_ks.bias,
                              attn.w_vs.bias])),
        "w_fc": w(attn.fc.weight),
        "b_fc": v(attn.fc.bias),
        "ln1_w": v(attn.layer_norm.weight),
        "ln1_b": v(attn.layer_norm.bias),
        "w1": w(w1.permute(0, 2, 1).reshape(w1.shape[0], -1)),
        "b1": v(ffn.w_1.bias),
        "w2": w(ffn.w_2.weight[:, :, 0]),                 # (D, F)
        "b2": v(ffn.w_2.bias),
        "ln2_w": v(ffn.layer_norm.weight),
        "ln2_b": v(ffn.layer_norm.bias),
        "conv_k": int(w1.shape[2]),
    }


def _bf(t):
    return t.to(torch.bfloat16).float()


def _ln(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def fused_fft_block_plain(p, x, valid, n_head):
    """Plain PyTorch version of the kernel: the same bf16 rounding in the
    same places, fp32 arithmetic.  p: ``pack_block_params``; x: (B, T, D)
    any float dtype; valid: (B, T) bool.  Returns (B, T, D) fp32."""
    x = x.float()
    B, T, D = x.shape
    d_k = D // n_head
    keep = valid[..., None]
    qkv = _bf(x) @ p["w_qkv"].float().T + p["b_qkv"]
    q = _bf(qkv[..., :D] * (1.0 / math.sqrt(d_k)))
    k = _bf(qkv[..., D:2 * D])
    v = _bf(qkv[..., 2 * D:])
    bias_row = (valid.float()[:, None, :] - 1.0) * -NEG       # (B, 1, T)
    heads = []
    for h in range(n_head):
        sl = slice(h * d_k, (h + 1) * d_k)
        s = q[..., sl] @ k[..., sl].transpose(1, 2) + bias_row
        s = torch.exp(s - s.amax(-1, keepdim=True))
        s = s / s.sum(-1, keepdim=True)
        heads.append(_bf(s) @ v[..., sl])
    o = torch.cat(heads, -1)
    attn = _bf(o) @ p["w_fc"].float().T + p["b_fc"]
    x1 = torch.where(keep, _ln(attn + x, p["ln1_w"], p["ln1_b"]), 0.0)

    K = p["conv_k"]
    pad = (K - 1) // 2
    xp = torch.nn.functional.pad(_bf(x1), (0, 0, pad, pad))
    w1 = p["w1"].float().view(-1, K, D)                       # (F, K, D)
    hid = p["b1"].expand(B, T, -1)
    for j in range(K):
        hid = hid + xp[:, j:j + T] @ w1[:, j].T
    hid = torch.relu(hid)
    y = _bf(hid) @ p["w2"].float().T + p["b2"]
    return torch.where(keep, _ln(y + x1, p["ln2_w"], p["ln2_b"]), 0.0)


def _lib():
    from . import _build
    return _build.load("fftblock", _SIGNATURES)


def fused_fft_block(p, x, valid, n_head):
    """One eval-mode FFT block.  p: ``pack_block_params`` on x's device;
    x: (B, T, D) any float dtype; valid: (B, T) bool.  Returns fp32."""
    if x.device.type == "cpu":
        return fused_fft_block_plain(p, x, valid, n_head)
    if x.device.type != "cuda":
        raise ValueError(f"fused_fft_block: unsupported device {x.device}")
    B, T, D = x.shape
    F = p["w1"].shape[0]
    K = p["conv_k"]
    why = kernel_shape_error(D, n_head, F)
    if why:
        raise ValueError(f"fused_fft_block: the CUDA kernel does not take {why}")
    if tuple(valid.shape) != (B, T):
        raise ValueError(f"valid {tuple(valid.shape)} does not match x {(B, T)}")
    expect = {"w_qkv": (3 * D, D), "w_fc": (D, D), "w1": (F, K * D), "w2": (D, F)}
    for name, shape in expect.items():
        w = p[name]
        if (tuple(w.shape) != shape or w.dtype != torch.bfloat16
                or w.device != x.device or not w.is_contiguous()):
            raise ValueError(f"fused_fft_block: {name} must be a contiguous "
                             f"bf16 {shape} tensor on {x.device}")
    vecs = ("b_qkv", "b_fc", "ln1_w", "ln1_b", "b1", "b2", "ln2_w", "ln2_b")
    for name in vecs:
        if (p[name].dtype != torch.float32 or p[name].device != x.device
                or not p[name].is_contiguous()):
            raise ValueError(f"fused_fft_block: {name} must be contiguous fp32 "
                             f"on {x.device}")
    x = x.float().contiguous()
    out = torch.empty_like(x)
    if B * T == 0:
        return out
    mask = valid.float().contiguous()
    dev = x.device
    bf = torch.bfloat16
    qkv = torch.empty(B * T, 3 * D, dtype=bf, device=dev)
    o = torch.empty(B * T, D, dtype=bf, device=dev)
    x1 = torch.empty(B * T, D, dtype=torch.float32, device=dev)
    x1b = torch.empty(B * T, D, dtype=bf, device=dev)
    hid = torch.empty(B * T, F, dtype=bf, device=dev)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.mtts_fft_block(
        ptr(x), ptr(mask),
        ptr(p["w_qkv"]), ptr(p["b_qkv"]), ptr(p["w_fc"]), ptr(p["b_fc"]),
        ptr(p["ln1_w"]), ptr(p["ln1_b"]), ptr(p["w1"]), ptr(p["b1"]),
        ptr(p["w2"]), ptr(p["b2"]), ptr(p["ln2_w"]), ptr(p["ln2_b"]),
        ptr(qkv), ptr(o), ptr(x1), ptr(x1b), ptr(hid), ptr(out),
        B, T, D, n_head, F, K,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError("fused_fft_block: CUDA error "
                           f"{lib.mtts_error_string(err).decode()}")
    fused_fft_block.launches += 1
    return out


fused_fft_block.launches = 0
