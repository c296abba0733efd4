"""NoamAdam's step over every leaf at once on the card: the CUDA kernel of
``csrc/adam.cu``.

Replaces no TPU kernel: the JAX package leaves its optax chain (clip by
global norm, Adam, decoupled weight decay, the learning rate) to XLA.  The
plain version is ``NoamAdam``'s per-leaf loop (``train/optim.py``), which
the optimizer runs on CPU tensors; given the kernel's norm it gives the
kernel's bits.

``LeafTable.build(params, mu, nu)`` is the kernel's view of the leaves:
their pointers and sizes, and the chunks of leaves that each launch takes
(the kernel's arguments hold at most ``NORM_LEAVES`` / ``UPDATE_LEAVES``);
None where the leaves lie on the CPU, and ValueError where they lie on a
card but one of them is not a contiguous fp32 tensor on the first one's
device.  ``fused_adam(table, grads, ...)`` runs one step: a norm pass, the
norm's sum and the update, ``table.launches`` launches on the current
stream, with no read of the card on the host.  It returns the global norm
as a 0-dim device tensor; ValueError, before any launch, where a gradient
lies on another device or has another shape than its leaf.
``fused_adam.launches`` counts the kernel launches.
"""

import ctypes
import operator

import numpy as np
import torch

# the kernel's fixed shapes (csrc/adam.cu)
THREADS = 256
BLOCKS = 528
NORM_LEAVES = 320
UPDATE_LEAVES = 108
MAX_ELEMENTS = 2 ** 31 - 1 - 2 * BLOCKS * THREADS     # a step's, in all

_C = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "mtts_adam_step": (_I, [_C, _C, _I, _C, _I, _C, _I, _C] + [_F] * 10 + [_C]),
    "mtts_adam_error_string": (ctypes.c_char_p, [_I]),
}

F32 = torch.float32


def chunk_bounds(n, per_launch):
    """Leaf indices ``[0, ..., n]`` that cut ``n`` leaves into the fewest
    chunks of at most ``per_launch``, as even as they go."""
    chunks = -(-n // per_launch)
    return [n * c // chunks for c in range(chunks + 1)]


def fits(t, device):
    """Whether the kernel takes ``t`` as a leaf, a moment or a gradient on
    CUDA device ``device`` (an index)."""
    return t.dtype is F32 and t.get_device() == device and t.is_contiguous()


class LeafTable:
    """The leaves of ``params`` with their Adam moments, as the kernel takes
    them; built by ``build``."""

    def __init__(self, names, params, mu, nu):
        self.names = names
        self.device = params[0].get_device()
        self.shapes = [p.shape for p in params]
        self._tensors = [t for leaf in zip(params, mu, nu) for t in leaf]
        self._static = [t.data_ptr() for t in self._tensors]
        # (g, p, mu, nu) a leaf; column 0 is written each step
        self.ptrs = np.zeros((len(names), 4), np.int64)
        self.ptrs[:, 1:] = np.array(self._static, np.int64).reshape(-1, 3)
        self.sizes = np.array([p.numel() for p in params], np.int32)
        self.norm_bounds = np.array(chunk_bounds(len(names), NORM_LEAVES), np.int32)
        self.update_bounds = np.array(chunk_bounds(len(names), UPDATE_LEAVES), np.int32)
        # a step's kernels: each norm chunk, the norm's sum, each update chunk
        self.launches = len(self.norm_bounds) + len(self.update_bounds) - 1
        # the norm (element 0) and each norm launch's block sums
        self.scratch = torch.empty(1 + (len(self.norm_bounds) - 1) * BLOCKS, dtype=F32,
                                   device=params[0].device)

    @classmethod
    def build(cls, params, mu, nu):
        """The table of ``params`` (name -> tensor) and ``mu`` / ``nu`` (the
        same names); None where every one of them lies on the CPU (the
        plain loop's).  Raises ValueError where they hold other names, a
        tensor that does not ``fit`` the first leaf's CUDA device, or more
        than ``MAX_ELEMENTS`` elements."""
        names = list(params)
        p, m, v = ([d.get(n) for n in names] for d in (params, mu, nu))
        if all(t is not None and t.device.type == "cpu" for t in (*p, *m, *v)):
            return None
        if params.keys() != mu.keys() or params.keys() != nu.keys():
            raise ValueError("NoamAdam's kernel: the moments' names differ from the leaves'")
        device = p[0].get_device()
        bad = [n for n, leaf in zip(names, zip(p, m, v))
               if device < 0 or not all(fits(t, device) for t in leaf)]
        if bad:
            raise ValueError(f"NoamAdam's kernel takes contiguous fp32 leaves and moments on "
                             f"one CUDA device; not so: {bad[:5]}")
        if sum(t.numel() for t in p) > MAX_ELEMENTS:
            raise ValueError(f"NoamAdam's kernel takes at most {MAX_ELEMENTS} parameters")
        return cls(names, p, m, v)

    def holds(self, params, mu, nu):
        """Whether ``params``, ``mu`` and ``nu`` are the tensors this table
        was built from, in its order and at the same addresses."""
        n = len(self.names)
        if not (len(params) == len(mu) == len(nu) == n):
            return False
        now = [t for leaf in zip(params.values(), mu.values(), nu.values()) for t in leaf]
        return (all(map(operator.is_, now, self._tensors))
                and list(map(torch.Tensor.data_ptr, now)) == self._static)

    def grad_pointers(self, grads):
        """(each leaf's gradient address, 0 where ``grads`` has none; the fp32
        contiguous copies made, to keep until the launch).  Raises ValueError
        where a gradient lies on another device or has another shape than
        its leaf."""
        ptrs, made = [], []
        for n, shape in zip(self.names, self.shapes):
            g = grads.get(n)
            if g is None:
                ptrs.append(0)
                continue
            if g.get_device() != self.device or g.shape != shape:
                raise ValueError(f"NoamAdam's kernel: the gradient of {n} is "
                                 f"{tuple(g.shape)} on {g.device}, its leaf "
                                 f"{tuple(shape)} on cuda:{self.device}")
            if g.dtype is not F32 or not g.is_contiguous():
                g = g.float().contiguous()
                made.append(g)
            ptrs.append(g.data_ptr())
        return ptrs, made


def _lib():
    from . import _build
    return _build.load("adam", _SIGNATURES)


def fused_adam(table, grads, *, clip, b1, b2, eps, weight_decay, lr, c1, c2):
    """One step of ``NoamAdam`` over ``table``'s leaves from ``grads`` (name
    -> tensor or None): clip by the global norm when it is not under
    ``clip``, Adam with bias corrections ``c1`` / ``c2`` (1 - beta^count, fp32
    values), decoupled ``weight_decay``, then ``lr`` (negated, an fp32 value).
    Returns the global norm (a 0-dim view of ``table.scratch``); raises
    ValueError, with nothing launched, where a gradient does not fit."""
    ptrs, made = table.grad_pointers(grads)     # ``made`` lives until the launch
    table.ptrs[:, 0] = ptrs
    # PyTorch divides a CUDA tensor by a Python scalar as a product with the
    # scalar's fp32 reciprocal, rounded on the host
    inv_c1 = float(np.float32(1.0) / np.float32(c1))
    inv_c2 = float(np.float32(1.0) / np.float32(c2))
    lib = _lib()
    stream = torch.cuda.current_stream(table.scratch.device).cuda_stream
    err = lib.mtts_adam_step(
        table.ptrs.ctypes.data, table.sizes.ctypes.data, len(table.names),
        table.norm_bounds.ctypes.data, len(table.norm_bounds) - 1,
        table.update_bounds.ctypes.data, len(table.update_bounds) - 1,
        table.scratch.data_ptr(), clip, b1, 1.0 - b1, b2, 1.0 - b2, inv_c1, inv_c2, eps,
        weight_decay, lr, stream)
    if err:
        raise RuntimeError(f"fused_adam: CUDA error {lib.mtts_adam_error_string(err).decode()}")
    fused_adam.launches += table.launches
    return table.scratch[0]


fused_adam.launches = 0
