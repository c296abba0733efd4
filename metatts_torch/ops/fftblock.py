"""Fused eval-mode FFT block: the CUDA kernel of ``csrc/fftblock.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``fused_fft_block`` (Pallas, ``ops/pallas/
fftblock.py`` of the JAX package): one whole post-LN FFT block in eval mode
-- Q/K/V projections, per-head masked softmax attention, output projection,
residual LayerNorm, valid mask, conv(k) FFN with ReLU, 1x1 conv, residual
LayerNorm, valid mask.  Products take bf16 inputs and accumulate in fp32;
softmax and LayerNorm statistics are fp32; the output is fp32 unless the
caller asks for bf16 (``out_dtype``), which is the fp32 result rounded.

On a CUDA tensor ``fused_fft_block`` launches the kernel (five launches in
one C call, six for an fp32 input) or raises; on a CPU tensor it runs
``fused_fft_block_plain``, which rounds to bf16 at the same places.
``fused_fft_block.launches`` counts the calls that launched the kernel.
The kernel's scratch is one workspace per device, grown to the largest
call and reused: calls on one device must run on one stream.
"""

import ctypes
import math

import torch

NEG = -1e9
# stages of one call, in order; ``fused_fft_block_stage`` launches one
STAGES = ("qkv", "attention", "out_proj_ln1", "conv_relu", "w2_ln2")
F_MULTIPLE = 128      # the packed filter size is padded to this, with zeros

_C = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mtts_fft_block": (_I, [_C, _I, _C, _C, _C, _C, _I] + [_I] * 7 + [_C]),
    "mtts_fft_block_workspace": (ctypes.c_size_t, [_I] * 6),
    "mtts_error_string": (ctypes.c_char_p, [_I]),
}


def fused_block_supported(d_model, d_k):
    """Widths that take the fused path: the TPU kernel's own gate."""
    return d_model % 128 == 0 and d_k <= 128


def kernel_shape_error(d_model, n_head, filter_size):
    """Why the CUDA kernel cannot run this block shape, or None.  It takes
    every width the gate admits: heads are zero-padded inside the kernel's
    tiles and the filter size is padded by ``pack_block_params``."""
    if d_model % n_head:
        return f"D={d_model} is not a multiple of {n_head} heads"
    d_k = d_model // n_head
    if not fused_block_supported(d_model, d_k):
        return f"D={d_model}, d_k={d_k} fail the fused-block gate"
    return None


def pack_block_params(attn, ffn):
    """Kernel layout of one FFT block's parameters, from the port's
    ``MultiHeadAttention`` and ``PositionwiseFeedForward`` modules:
    bf16 weights as (out, in) rows with the conv taps flattened into the
    reduction axis (``w1``: (Fp, K*D), tap-major), fp32 vectors.  The
    filter size F is padded to Fp, a multiple of ``F_MULTIPLE``, with zero
    rows of ``w1`` and ``b1`` and zero columns of ``w2``, so the kernel's
    rows of ``hid`` are 16-byte multiples and its padded columns are
    exactly 0; ``filter_size`` keeps F."""
    bf = torch.bfloat16
    w = lambda t: t.detach().to(bf).contiguous()
    v = lambda t: t.detach().to(torch.float32, copy=True).contiguous()
    w1 = ffn.w_1.weight                                # (F, D, K)
    F = int(w1.shape[0])
    extra = -F % F_MULTIPLE
    pad_rows = lambda t: torch.nn.functional.pad(t, (0, 0) * (t.dim() - 1)
                                                 + (0, extra))
    return {
        "w_qkv": w(torch.cat([attn.w_qs.weight, attn.w_ks.weight,
                              attn.w_vs.weight])),
        "b_qkv": v(torch.cat([attn.w_qs.bias, attn.w_ks.bias,
                              attn.w_vs.bias])),
        "w_fc": w(attn.fc.weight),
        "b_fc": v(attn.fc.bias),
        "ln1_w": v(attn.layer_norm.weight),
        "ln1_b": v(attn.layer_norm.bias),
        "w1": w(pad_rows(w1.detach().permute(0, 2, 1).reshape(F, -1))),
        "b1": v(pad_rows(ffn.w_1.bias.detach())),
        "w2": w(torch.nn.functional.pad(ffn.w_2.weight.detach()[:, :, 0],
                                        (0, extra))),      # (D, Fp)
        "b2": v(ffn.w_2.bias),
        "ln2_w": v(ffn.layer_norm.weight),
        "ln2_b": v(ffn.layer_norm.bias),
        "conv_k": int(w1.shape[2]),
        "filter_size": F,
    }


def _bf(t):
    return t.to(torch.bfloat16).float()


def _ln(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def fused_fft_block_plain(p, x, valid, n_head, out_dtype=torch.float32):
    """Plain PyTorch version of the kernel: the same bf16 rounding in the
    same places, fp32 arithmetic.  p: ``pack_block_params`` (its padding
    of the filter size is cut off here); x: (B, T, D) any float dtype;
    valid: (B, T) bool.  Returns (B, T, D) fp32, rounded to ``out_dtype``."""
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

    K, F = p["conv_k"], p["filter_size"]
    pad = (K - 1) // 2
    xp = torch.nn.functional.pad(_bf(x1), (0, 0, pad, pad))
    w1 = p["w1"][:F].float().view(F, K, D)
    hid = p["b1"][:F].expand(B, T, -1)
    for j in range(K):
        hid = hid + xp[:, j:j + T] @ w1[:, j].T
    hid = torch.relu(hid)
    y = _bf(hid) @ p["w2"][:, :F].float().T + p["b2"]
    out = torch.where(keep, _ln(y + x1, p["ln2_w"], p["ln2_b"]), 0.0)
    return out.to(out_dtype)


def _lib():
    from . import _build
    return _build.load("fftblock", _SIGNATURES)


_PARAMS = ("w_qkv", "b_qkv", "w_fc", "b_fc", "ln1_w", "ln1_b", "w1", "b1",
           "w2", "b2", "ln2_w", "ln2_b")
_workspaces = {}
_workspace_bytes = {}


def _workspace(lib, device, shape):
    """The kernel's scratch on ``device``: one buffer, grown when a call
    needs more (its layout is the C side's, per call)."""
    nbytes = _workspace_bytes.get(shape)
    if nbytes is None:
        nbytes = _workspace_bytes[shape] = lib.mtts_fft_block_workspace(*shape)
    ws = _workspaces.get(device)
    if ws is None or ws.numel() < nbytes:
        ws = torch.empty(nbytes, dtype=torch.uint8, device=device)
        _workspaces[device] = ws
    return ws


def _checked_params(p, device, D):
    """The C array of the 12 parameter pointers, after checking each
    tensor's shape, dtype, device and contiguity; kept in ``p`` and checked
    again only when one of its tensors is replaced or the call's device or
    width changes."""
    tensors = tuple(p[n] for n in _PARAMS)
    memo = p.get("_kernel_args")
    if (memo is not None and memo[0] == (device, D)
            and all(a is b for a, b in zip(memo[1], tensors))):
        return memo[2]
    Fp, K = p["w1"].shape[0], p["conv_k"]
    if Fp % F_MULTIPLE:
        raise ValueError(f"fused_fft_block: w1 has {Fp} rows, not a multiple of "
                         f"{F_MULTIPLE}: pack it with pack_block_params")
    expect = {"w_qkv": (3 * D, D), "w_fc": (D, D), "w1": (Fp, K * D),
              "w2": (D, Fp)}
    for name, shape in expect.items():
        w = p[name]
        if (tuple(w.shape) != shape or w.dtype != torch.bfloat16
                or w.device != device or not w.is_contiguous()):
            raise ValueError(f"fused_fft_block: {name} must be a contiguous "
                             f"bf16 {shape} tensor on {device}")
    for name in set(_PARAMS) - set(expect):
        v = p[name]
        if (v.dtype != torch.float32 or v.device != device
                or not v.is_contiguous()):
            raise ValueError(f"fused_fft_block: {name} must be contiguous fp32 "
                             f"on {device}")
    ptrs = (ctypes.c_void_p * len(_PARAMS))(*(t.data_ptr() for t in tensors))
    p["_kernel_args"] = ((device, D), tensors, ptrs)
    return ptrs


def _launch(p, x, valid, n_head, out_dtype, stage):
    if x.device.type != "cuda":
        raise ValueError(f"fused_fft_block: unsupported device {x.device}")
    B, T, D = x.shape
    why = kernel_shape_error(D, n_head, p["filter_size"])
    if why:
        raise ValueError(f"fused_fft_block: the CUDA kernel does not take {why}")
    if tuple(valid.shape) != (B, T) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be a bool {(B, T)} tensor, not "
                         f"{valid.dtype} {tuple(valid.shape)}")
    params = _checked_params(p, x.device, D)
    if x.dtype != torch.bfloat16:
        x = x.float()
    x = x.contiguous()
    if x.data_ptr() % 16:                  # tensor maps need 16-byte bases
        x = x.clone()
    valid = valid.contiguous()
    # the kernel writes fp32 or bf16; another dtype is the fp32 result cast
    kernel_dtype = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    out = torch.empty(B, T, D, dtype=kernel_dtype, device=x.device)
    if B * T == 0:
        return out.to(out_dtype), False
    x_bf16 = int(x.dtype == torch.bfloat16)
    Fp, K = p["w1"].shape[0], p["conv_k"]
    lib = _lib()
    ws = _workspace(lib, x.device, (B, T, D, n_head, Fp, x_bf16))
    err = lib.mtts_fft_block(
        x.data_ptr(), x_bf16, valid.data_ptr(), params, ws.data_ptr(),
        out.data_ptr(), int(kernel_dtype == torch.bfloat16),
        B, T, D, n_head, Fp, K, stage,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("fused_fft_block: CUDA error "
                           f"{lib.mtts_error_string(err).decode()}")
    return out.to(out_dtype), True


def fused_fft_block(p, x, valid, n_head, out_dtype=torch.float32):
    """One eval-mode FFT block.  p: ``pack_block_params`` on x's device;
    x: (B, T, D) any float dtype (bf16 is read as it is, fp32 rounded to
    bf16 for the products and kept for the residual); valid: (B, T) bool.
    Returns ``out_dtype``: fp32 by default, as the TPU kernel; the kernel
    writes bf16 itself (the fp32 result rounded), another dtype is cast."""
    if x.device.type == "cpu":
        return fused_fft_block_plain(p, x, valid, n_head, out_dtype)
    out, launched = _launch(p, x, valid, n_head, out_dtype, -1)
    fused_fft_block.launches += launched
    return out


fused_fft_block.launches = 0


def fused_fft_block_stage(p, x, valid, n_head, stage, out_dtype=torch.float32):
    """Launch one stage of the kernel (a name in ``STAGES``) on the scratch
    that a ``fused_fft_block`` call with the same arguments left, to time
    it alone; counted nowhere.  The card only."""
    out, _ = _launch(p, x, valid, n_head, out_dtype, STAGES.index(stage))
    return out
