"""Flash self-attention: the CUDA kernels of ``csrc/flash_attention.cu`` and
their plain PyTorch versions, joined into one once-differentiable op.

Replaces the TPU kernel ``flash_attention`` (Pallas, ``ops/pallas/
attention.py`` of the JAX package): bidirectional self-attention over
(BH, T, D) with a per-key validity mask in {0, 1}.  Invalid keys get a
-1e9 bias, so a row without a valid key averages v and gives no NaN.
Products take the input dtype (bf16 or fp32) and accumulate in fp32;
softmax statistics are fp32; the output and the log-sum-exp are fp32; the
gradients come back in the input dtype.

``flash_attention_fwd`` and ``flash_attention_bwd`` launch their kernel on a
CUDA tensor (or raise) and run the plain version on a CPU tensor; each
counts its launches in ``.launches``.  A call's host path is kept short: the
fp32 scale is cached per head width, the backward's scratch (delta and the
bf16 copy of the cotangent) is one allocation a call, and the C side sets its shared-memory attributes once and
encodes the tensor maps itself.  ``flash_attention`` is their
``torch.autograd.Function``: differentiable once, and a second
differentiation raises, as with the TPU kernel's ``custom_vjp``.
"""

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

NEG = -1e9
MAX_D = 128

_C = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "mtts_flash_fwd": (_I, [_C] * 6 + [_I] * 4 + [_F, _C]),
    "mtts_flash_bwd": (_I, [_C] * 12 + [_I] * 4 + [_F, _C]),
    "mtts_flash_error_string": (ctypes.c_char_p, [_I]),
}


def _scale(d):
    # the TPU kernel's 1 / sqrt(D), a double rounded once to fp32
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))


_scales = {}


def kernel_scale(d):
    """``_scale(d)``, computed once per head width (the kernels' argument)."""
    s = _scales.get(d)
    if s is None:
        s = _scales[d] = _scale(d)
    return s


def _bias(mask):
    return (mask.float() - 1.0) * -NEG                           # (BH, T)


def _dot(a, b):
    """a @ b of values in the contraction dtype, accumulated in fp32."""
    return a.float() @ b.float()


def flash_attention_fwd_plain(q, k, v, mask):
    """Plain PyTorch version of the forward kernel.  q, k, v: (BH, T, D)
    bf16 or fp32; mask: (BH, T) {0, 1}.  Returns (out, lse), fp32."""
    s = _dot(q, k.transpose(1, 2)) * _scale(q.shape[-1])
    s = s + _bias(mask)[:, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = _dot(p.to(v.dtype), v) / l
    return out, (m + torch.log(l))[..., 0]


def flash_attention_bwd_plain(q, k, v, mask, out, lse, dout):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) in the
    input dtype from the forward's (out, lse) and the fp32 cotangent."""
    cd = k.dtype
    scale = _scale(q.shape[-1])
    s = _dot(q, k.transpose(1, 2)) * scale + _bias(mask)[:, None, :]
    p = torch.exp(s - lse[..., None])
    dout = dout.float()
    do_c = dout.to(cd)
    dv = _dot(p.to(cd).transpose(1, 2), do_c)
    dp = _dot(do_c, v.transpose(1, 2))
    delta = (dout * out).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(cd)
    dq = _dot(ds, k)
    dk = _dot(ds.transpose(1, 2), q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_shape_error(q, k, v, mask):
    """Why the CUDA kernels cannot take these inputs, or None."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        return f"q, k, v must share one (BH, T, D) shape, got {tuple(q.shape)}, " \
               f"{tuple(k.shape)}, {tuple(v.shape)}"
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16,
                                                            torch.float32):
        return f"q, k, v must all be bf16 or all fp32, got {q.dtype}, {k.dtype}, {v.dtype}"
    BH, T, D = q.shape
    if tuple(mask.shape) != (BH, T):
        return f"mask {tuple(mask.shape)} does not match (BH, T) = {(BH, T)}"
    if D > MAX_D or (q.dtype == torch.bfloat16 and D % 8):
        return f"head width {D} (the kernels take D <= {MAX_D}, a multiple of 8 for bf16)"
    return None


def _lib():
    from . import _build
    return _build.load("flash_attention", _SIGNATURES)


def _ready(t, dtype=None):
    """Contiguous, 16-byte aligned, on the same device, in ``dtype``."""
    t = t.contiguous() if dtype is None else t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(name, err, lib):
    if err:
        raise RuntimeError(f"{name}: CUDA error {lib.mtts_flash_error_string(err).decode()}")


def _cuda_inputs(name, q, k, v, mask):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    why = kernel_shape_error(q, k, v, mask)
    if why:
        raise ValueError(f"{name}: the CUDA kernel does not take {why}")
    for t in (k, v, mask):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs lie on {q.device} and {t.device}")
    return _ready(q), _ready(k), _ready(v), _ready(mask, torch.float32)


def _stream(dev):
    """The current stream's handle on ``dev``, read without building a
    ``torch.cuda.Stream`` (which takes 7-8 us a call on an H100 machine's
    host; tools/flash_ablate.py)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def flash_attention_fwd(q, k, v, mask):
    """Forward: (out, lse), fp32.  The kernel on a CUDA tensor (or a
    ValueError for what it does not take), the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, mask)
    q, k, v, mask = _cuda_inputs("flash_attention_fwd", q, k, v, mask)
    BH, T, D = q.shape
    out = torch.empty(BH, T, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(BH, T, dtype=torch.float32, device=q.device)
    if BH * T == 0:
        return out, lse
    lib = _lib()
    err = lib.mtts_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                             out.data_ptr(), lse.data_ptr(), BH, T, D,
                             int(q.dtype == torch.bfloat16), kernel_scale(D),
                             _stream(q.device))
    _check("flash_attention_fwd", err, lib)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, mask, out, lse, dout):
    """Backward: (dq, dk, dv) in the input dtype.  The kernels (one C call)
    on a CUDA tensor, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, out, lse, dout)
    q, k, v, mask = _cuda_inputs("flash_attention_bwd", q, k, v, mask)
    BH, T, D = q.shape
    out, lse, dout = (_ready(t, torch.float32) for t in (out, lse, dout))
    if out.shape != q.shape or dout.shape != q.shape or tuple(lse.shape) != (BH, T):
        raise ValueError("flash_attention_bwd: out, dout must be (BH, T, D) and lse (BH, T)")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if BH * T == 0:
        return dq, dk, dv
    bf = q.dtype == torch.bfloat16
    # scratch: delta (BH, T) fp32, then dout_b (BH, T, D) bf16 for bf16 inputs
    at = (BH * T * 4 + 255) // 256 * 256
    scratch = torch.empty(at + (BH * T * D * 2 if bf else 0), dtype=torch.uint8,
                          device=q.device)
    ws = scratch.data_ptr()
    lib = _lib()
    err = lib.mtts_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                             out.data_ptr(), lse.data_ptr(), dout.data_ptr(), ws,
                             ws + at if bf else None, dq.data_ptr(), dk.data_ptr(),
                             dv.data_ptr(), BH, T, D, int(bf), kernel_scale(D),
                             _stream(q.device))
    _check("flash_attention_bwd", err, lib)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """out = flash_attention(q, k, v, mask); the gradient is the backward
    kernel, which is not itself differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, lse = flash_attention_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, dout)
        return dq, dk, dv, None


def flash_attention(q, k, v, mask):
    """q, k, v: (BH, T, D) bf16 or fp32; mask: (BH, T) {0, 1} ->
    (BH, T, D) fp32, differentiable once in q, k, v."""
    return FlashAttention.apply(q, k, v, mask)
