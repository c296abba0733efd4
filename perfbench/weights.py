"""Weights made on the device from ``--seed``, in two large draws.

Every float leaf of a parameter dict gets its value from one uniform and
one normal draw of a ``torch.Generator`` on the device, in the leaves'
order: linear and convolution weights and their biases uniform in
+-gain/sqrt(fan_in) (the port's own init distribution), embedding tables
N(0, 1) with a padding row of zeros, norms' weights 1 and biases 0.  The
benchmark hands the same dict to the program and to the reference.
"""

import math

import torch


def _kind(name, t, params):
    stem, leaf = name.rsplit(".", 1)
    if leaf == "bias":
        w = params.get(stem + ".weight")
        return "zeros" if w is None or w.dim() == 1 else "uniform"
    if t.dim() == 1:
        return "ones"
    if "emb" in stem.split(".")[-1] or stem.endswith("speaker_emb.model"):
        return "normal"
    return "uniform"


def fan_in(name, params):
    """The fan-in of a weight or of its bias: (out, in[, k]) for linears and
    convolutions, (in, out, k) for transposed convolutions."""
    stem = name.rsplit(".", 1)[0]
    w = params[stem + ".weight"]
    if stem.endswith("convt"):
        return w.shape[0] * w.shape[2]
    return w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)


def make(params, seed, device, gain=1.0, padding_rows=("encoder.src_word_emb.weight",)):
    """name -> fp32 tensor on ``device`` for every leaf of ``params`` (a
    name -> tensor dict giving the shapes), drawn from ``seed``."""
    kinds = {n: _kind(n, t, params) for n, t in params.items()}
    n_uni = sum(params[n].numel() for n, k in kinds.items() if k == "uniform")
    n_norm = sum(params[n].numel() for n, k in kinds.items() if k == "normal")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    uni = torch.rand(n_uni, generator=g, device=device) * 2.0 - 1.0
    nrm = torch.randn(n_norm, generator=g, device=device)
    out, iu, inn = {}, 0, 0
    for n, t in params.items():
        k, size = kinds[n], t.numel()
        if k == "uniform":
            s = gain / math.sqrt(fan_in(n, params))
            out[n] = (uni[iu:iu + size] * s).view(t.shape)
            iu += size
        elif k == "normal":
            out[n] = nrm[inn:inn + size].view(t.shape).clone()
            inn += size
            if n in padding_rows:
                out[n][0] = 0.0
        elif k == "ones":
            out[n] = torch.ones(t.shape, device=device)
        else:
            out[n] = torch.zeros(t.shape, device=device)
    return out


@torch.no_grad()
def load_into(module, weights):
    """Copy ``weights`` into ``module``'s parameters (every one of them)."""
    params = dict(module.named_parameters())
    missing = set(params) ^ set(weights)
    if missing:
        raise KeyError(f"weights and parameters differ: {sorted(missing)[:5]}")
    for n, p in params.items():
        p.copy_(weights[n])
