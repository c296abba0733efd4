"""Layers with the JAX package's precision policy, as ``nn.Module``s.

Parameters live in fp32.  A product "in the compute dtype" rounds its
inputs to that dtype:

* ``Linear`` returns fp32 (the JAX ``preferred_element_type=float32``), so
  it rounds the inputs and multiplies in fp32, which gives the same
  products of bf16 values, accumulated in fp32;
* ``Conv1d`` / ``ConvTranspose1d`` return the compute dtype's rounding,
  cast to fp32, as the JAX convs do, and add the bias in fp32.

Module and parameter names follow the reference's torch state dict
(``weight`` / ``bias``, conv kernels (out, in, k), transposed-conv kernels
(in, out, k), linear weights (out, in)).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import current_row_shard, global_sum

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype(name):
    """Config dtype name -> torch dtype."""
    return _DTYPES[name]


def round_to(x, cdtype):
    """x rounded to ``cdtype`` and back to fp32 (identity for fp32)."""
    return x.float() if cdtype == torch.float32 else x.to(cdtype).float()


def _uniform(t, scale, generator):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * scale) - scale)


class Linear(nn.Module):
    def __init__(self, d_in, d_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def reset_parameters(self, generator):
        s = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform(self.weight, s, generator)
        if self.bias is not None:
            _uniform(self.bias, s, generator)

    def forward(self, x, cdtype=torch.float32, out_dtype=torch.float32):
        y = round_to(x, cdtype) @ round_to(self.weight, cdtype).T
        if self.bias is not None:
            y = y + self.bias
        return y.to(out_dtype)


class Embedding(nn.Embedding):
    """Lookup table, N(0, 1) init with an optional zero padding row (the
    row is only zeroed at init, as in the JAX package).

    The lookup is a product of the ids' one-hot rows with the table: each
    output row is one table row times 1 plus zeros, the values of an index,
    and the table's gradient is a product summed in a fixed order, so a
    training step repeats itself on the card.  An index's backward there
    (``embedding_dense_backward``) gave two different results on the same
    inputs in the baseline step at batch 80 (80 x 128 symbols, on an NVIDIA
    H100 80GB HBM3 at 700.00 W)."""

    def __init__(self, n, d, padding_row=None):
        super().__init__(n, d)
        self.padding_row = padding_row

    def forward(self, ids):
        rows = torch.arange(self.weight.shape[0], device=ids.device)
        return (ids[..., None] == rows).to(self.weight.dtype) @ self.weight

    def reset_parameters(self, generator=None):
        if generator is None:        # nn.Embedding.__init__ calls this
            return
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator))
            if self.padding_row is not None:
                self.weight[self.padding_row] = 0.0


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics (population variance, eps 1e-5)."""

    def __init__(self, d):
        super().__init__(d, eps=1e-5)

    def forward(self, x, out_dtype=torch.float32):
        return super().forward(x.float()).to(out_dtype)


class BatchNorm(nn.Module):
    """BatchNorm over (B, T, C), reducing (B, T).  Eval uses the running
    state; training normalises with the batch's population variance and,
    unless ``update_state=False``, updates the running state with momentum
    0.1 (JAX package semantics: its ``batch_norm`` returns the new state and
    the meta step never keeps it).  On a rank's shard of a flat batch
    (``parallel.distributed.row_shard``) the statistics are the whole
    batch's, reduced over the ranks differentiably."""

    def __init__(self, d, momentum=0.1, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("running_mean", torch.zeros(d))
        self.register_buffer("running_var", torch.ones(d))

    def forward(self, x, train=None, update_state=True):
        """``train`` defaults to the module's mode."""
        x = x.float()
        if self.training if train is None else train:
            shard = current_row_shard()
            if shard is None:
                mean = x.mean((0, 1))
                var = x.var((0, 1), unbiased=False)
            else:
                n = shard.total * x.shape[1]
                mean = global_sum(x.sum((0, 1))) / n
                var = global_sum(((x - mean) ** 2).sum((0, 1))) / n
            if update_state:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class Conv1d(nn.Module):
    """1-D conv over (B, T, C) with SAME padding; kernel (out, in, k)."""

    def __init__(self, c_in, c_out, k, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def reset_parameters(self, generator):
        s = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[2])
        _uniform(self.weight, s, generator)
        if self.bias is not None:
            _uniform(self.bias, s, generator)

    def forward(self, x, cdtype=torch.float32, dilation=1,
                out_dtype=torch.float32):
        y = conv1d_nct(self, x.transpose(1, 2), cdtype, dilation,
                       padding=dilation * (self.weight.shape[-1] - 1) // 2)
        return y.transpose(1, 2).to(out_dtype)


def conv1d_nct(m, x, cdtype=torch.float32, dilation=1, padding=0):
    """Conv over (B, C, T) with explicit zero padding; fp32 out."""
    y = F.conv1d(x.to(cdtype), m.weight.to(cdtype), None, padding=padding,
                 dilation=dilation).float()
    if m.bias is not None:
        y = y + m.bias[:, None]
    return y


class ConvTranspose1d(Conv1d):
    """Transposed conv; kernel (in, out, k), torch-style int padding."""

    def __init__(self, c_in, c_out, k, bias=True):
        nn.Module.__init__(self)
        self.weight = nn.Parameter(torch.empty(c_in, c_out, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def reset_parameters(self, generator):
        s = 1.0 / math.sqrt(self.weight.shape[0] * self.weight.shape[2])
        _uniform(self.weight, s, generator)
        if self.bias is not None:
            _uniform(self.bias, s, generator)

    def forward(self, x, stride, cdtype=torch.float32, padding=0):
        """x: (B, C, T) -> (B, C_out, T') fp32."""
        y = F.conv_transpose1d(x.to(cdtype), self.weight.to(cdtype), None,
                               stride=stride, padding=padding).float()
        if self.bias is not None:
            y = y + self.bias[:, None]
        return y


class LSTM(nn.Module):
    """Multi-layer LSTM over (N, T, D) in torch's gate order i, f, g, o,
    written as per-step cell arithmetic: a speaker encoder adapted in the
    second-order inner loop is differentiated twice, which cuDNN's RNN
    cannot be.  Parameter names and shapes are ``torch.nn.LSTM``'s
    (``weight_ih_l{k}`` (4H, in), ``weight_hh_l{k}`` (4H, H), two biases),
    resemblyzer's layout.  Products round their inputs to ``cdtype`` and
    accumulate in fp32, as the JAX package's ``nn.lstm``."""

    def __init__(self, d_in, d_hidden, n_layers):
        super().__init__()
        self.n_layers, self.hidden = n_layers, d_hidden
        for k in range(n_layers):
            din = d_in if k == 0 else d_hidden
            self.register_parameter(f"weight_ih_l{k}",
                                    nn.Parameter(torch.empty(4 * d_hidden, din)))
            self.register_parameter(f"weight_hh_l{k}",
                                    nn.Parameter(torch.empty(4 * d_hidden, d_hidden)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(torch.empty(4 * d_hidden)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(torch.empty(4 * d_hidden)))

    def reset_parameters(self, generator):
        for p in self.parameters():
            _uniform(p, 1.0 / math.sqrt(self.hidden), generator)

    def forward(self, x, cdtype=torch.float32):
        """x (N, T, D) -> (outputs (N, T, H), each layer's final h
        (layers, N, H))."""
        N, T = x.shape[:2]
        finals = []
        for k in range(self.n_layers):
            w_ih, w_hh, b_ih, b_hh = (getattr(self, f"{n}_l{k}") for n in (
                "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            xw = round_to(x, cdtype) @ round_to(w_ih, cdtype).T + b_ih + b_hh
            w_hh = round_to(w_hh, cdtype).T
            h = c = x.new_zeros(N, self.hidden, dtype=torch.float32)
            hs = []
            for t in range(T):
                gates = xw[:, t] + round_to(h, cdtype) @ w_hh
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            x = torch.stack(hs, 1)
            finals.append(h)
        return x, torch.stack(finals)


# ------------------------------------------------------------------ dropout

_M64 = (1 << 64) - 1


def fold_in(seed, i):
    """A new 63-bit seed from ``seed`` and ``i`` (splitmix64), the port's
    counterpart of JAX's ``random.fold_in``: a forward's dropout streams
    derive from one seed as the JAX package's derive from one key."""
    z = (seed * 0x9E3779B97F4A7C15 + i + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def split(seed, n):
    """``n`` seeds from one, or ``n`` Nones from None."""
    return [None if seed is None else fold_in(seed, i) for i in range(n)]


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (None: None)."""
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def dropout(x, rate, train, generator):
    """Inverted dropout with the keep mask drawn from ``generator``
    (the JAX package's ``nn.dropout``: identity unless training with a
    generator and a non-zero rate).  The same generator state gives the same
    mask, so a forward can be replayed.  On a rank's shard of a flat batch
    (``parallel.distributed.row_shard``) the whole batch's mask is drawn and
    the shard's rows kept."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shard = current_row_shard()
    shape = x.shape if shard is None else (shard.total,) + tuple(x.shape[1:])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask[shard.lo:shard.hi]
    # the keep rate in x's dtype, as JAX's weak typing rounds it
    scale = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def reset_parameters(module, generator):
    """Random init of every layer in ``module`` from ``generator`` (CPU),
    with the JAX package's distributions: uniform(+-1/sqrt(fan_in)) for
    linears and convs, uniform(+-1/sqrt(H)) for LSTMs, N(0, 1) for
    embeddings, ones/zeros for norms."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv1d, Embedding, LSTM)):
            m.reset_parameters(generator)
        elif isinstance(m, (LayerNorm, BatchNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
