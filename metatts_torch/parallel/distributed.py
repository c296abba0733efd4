"""Data parallelism over ``torch.distributed`` (the JAX package's
``parallel/mesh.py``): the episode axis of a meta step, or the flat batch of
a baseline step, is split into one contiguous shard a rank; every rank
holds the whole model and optimizer, draws the same global batch, keeps its
shard, and the gradients are summed over the ranks before the optimizer,
which then does the same on every rank.

* ``init_from_env`` joins the process group of a launcher
  (``torchrun`` / ``python -m torch.distributed.run`` set ``RANK``,
  ``WORLD_SIZE`` and ``LOCAL_RANK``) or of an explicit ``init_method``
  (e.g. a ``file://`` store); NCCL on the card, gloo on the CPU; each rank
  runs on ``cuda:LOCAL_RANK``.
* ``Shard`` is a rank's view of the group: its slice of a leading axis,
  the gradient all-reduce, the broadcast of rank 0's weights and the
  gather of rows.
* ``row_shard`` makes a forward on a flat-batch shard compute what the
  forward on the whole batch computes: inside it the masked losses divide
  by the whole batch's valid count, BatchNorm normalises with the whole
  batch's statistics (``models/loss.py``, ``models/nn.py``), and dropout
  draws the whole batch's mask and keeps the shard's rows, so the result
  does not depend on the world size.
"""

import contextlib
import contextvars
import os
from typing import NamedTuple

import torch
import torch.distributed as dist


def init_from_env(init_method=None, rank=None, world_size=None, device="cuda"):
    """Join the process group (unless already joined) and return the
    rank's device: ``cuda:LOCAL_RANK`` on the card, the CPU otherwise.
    ``rank`` / ``world_size`` default to the launcher's ``RANK`` /
    ``WORLD_SIZE``, ``init_method`` to its ``env://`` rendezvous.  Returns
    None at world size 1, where nothing is joined."""
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return None
    on_card = torch.device(device).type == "cuda"
    if on_card:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if on_card else "gloo", init_method=init_method or "env://",
            rank=int(rank if rank is not None else os.environ["RANK"]),
            world_size=world)
    return dev


def world_size():
    """The process group's size, 1 outside one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main():
    """True on rank 0, and outside a process group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class Shard:
    """One rank's part of a data-parallel step over the process group."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    def bounds(self, n, what="meta_batch_size"):
        """This rank's rows [lo, hi) of a leading axis of ``n``; raises
        where the world size does not divide ``n``."""
        if n % self.world:
            raise ValueError(
                f"{what}={n} must be a multiple of the {self.world}-device mesh "
                f"(reference recipe: 1 episode/device x grad_acc_step; "
                f"set optimizer.grad_acc_step to scale the effective batch)")
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k

    def divides(self, n):
        return n % self.world == 0

    def all_reduce_(self, tensors):
        """Sum each tensor over the ranks, in place (None entries stay
        None; every rank has them at the same places)."""
        live = [t for t in tensors if t is not None]
        if not live:
            return tensors
        flat = _all_reduce(torch.cat([t.reshape(-1).float() for t in live]))
        i = 0
        for t in live:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return tensors

    def broadcast_(self, module, src=0):
        """Every parameter and buffer of ``module`` set to rank ``src``'s."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=src)

    def gather_rows(self, t):
        """Every rank's ``t`` (equal shapes) concatenated on the leading
        axis in rank order, on ``t``'s device (through the card under NCCL,
        through the host under gloo)."""
        home = t.device
        t = t.to(torch.device("cuda", torch.cuda.current_device())
                 if dist.get_backend() == "nccl" else "cpu")
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts).to(home)


class RowShard(NamedTuple):
    """The rows [lo, hi) of a flat batch of ``total`` that this rank's
    forward sees."""
    lo: int
    hi: int
    total: int


_ROWS = contextvars.ContextVar("metatts_row_shard", default=None)


@contextlib.contextmanager
def row_shard(lo, hi, total):
    """Within the block, forwards on this rank's rows of a flat batch
    compute the whole batch's losses, BatchNorm statistics and dropout
    masks (see the module docstring)."""
    token = _ROWS.set(RowShard(lo, hi, total))
    try:
        yield
    finally:
        _ROWS.reset(token)


def current_row_shard():
    """The active ``RowShard``, or None."""
    return _ROWS.get()


def _all_reduce(t):
    """Sum ``t`` over the ranks, in place.  Under gloo a CUDA tensor is
    summed through a host copy, which waits for the card (ranks sharing
    one card run gloo, since NCCL refuses two ranks on one device)."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        return t.copy_(host)
    dist.all_reduce(t)
    return t


class _GlobalSum(torch.autograd.Function):
    """The sum over the ranks; its backward sums the incoming gradients over
    the ranks, so the gradient of every rank's loss reaches every rank's
    rows."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format))


def global_sum(t):
    """``t`` summed over the ranks, differentiably."""
    return _GlobalSum.apply(t)
