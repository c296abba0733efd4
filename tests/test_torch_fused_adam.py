"""Port: NoamAdam's multi-tensor kernel (``metatts_torch/ops/adam.py``,
``csrc/adam.cu``) without a card.

The kernel runs only on the card (``chip_smoke.py``'s ``adam`` phase holds it
to the per-leaf loop bit for bit).  Here: the leaf table and its chunks
(every leaf and element once, each launch within the 4 KB argument limit),
which tensors the kernel takes (the CPU's go to the plain loop, a card's
that do not fit raise), the optimizer's choice between the kernel and the
plain loop with the span's counts of each, and the ctypes signatures
against the C source.
"""

import copy
import ctypes
import os
import re

import pytest
import torch

from metatts_torch import config as C
from metatts_torch.ops import _build, adam
from metatts_torch.train import optim
from metatts_torch.train.optim import NoamAdam
from metatts_torch.utils import profiling

SOURCE = os.path.join(_build.CSRC, "adam.cu")
ARG_LIMIT = 4096                  # bytes of kernel arguments a launch
SHAPES = [(7, 5), (3,), (16, 4, 3), (1,), (0,), (33,)]


def _leaves(gen):
    names = [f"leaf{i}" for i in range(len(SHAPES))]
    params = {n: torch.randn(s, generator=gen) for n, s in zip(names, SHAPES)}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    return params, mu, nu


def _table(params, mu, nu):
    """A table over CPU tensors (``build`` takes CUDA tensors only)."""
    names = list(params)
    return adam.LeafTable(names, *([d[n] for n in names] for d in (params, mu, nu)))


def _optimizer(params):
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    tcfg["optimizer"]["warm_up_step"] = 10
    return NoamAdam(params, copy.deepcopy(C.MODEL_DEFAULTS), tcfg)


@pytest.mark.parametrize("per_launch", [adam.NORM_LEAVES, adam.UPDATE_LEAVES])
@pytest.mark.parametrize("n", [1, 107, 108, 109, 216, 320, 321, 1000])
def test_chunks_cover_every_leaf_once(n, per_launch):
    b = adam.chunk_bounds(n, per_launch)
    sizes = [hi - lo for lo, hi in zip(b, b[1:])]
    assert b[0] == 0 and b[-1] == n
    assert all(0 < k <= per_launch for k in sizes)
    assert len(sizes) == -(-n // per_launch)          # the fewest launches
    assert max(sizes) - min(sizes) <= 1               # as even as they go


def test_launch_arguments_fit_the_limit():
    """The structs of csrc/adam.cu passed by value, with the other arguments."""
    src = open(SOURCE).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["THREADS"], const["BLOCKS"], const["NORM_LEAVES"], const["UPDATE_LEAVES"]) == (
        adam.THREADS, adam.BLOCKS, adam.NORM_LEAVES, adam.UPDATE_LEAVES)
    norm = adam.NORM_LEAVES * (8 + 4) + 4 + 8               # pointers, sizes, count, partials
    update = adam.UPDATE_LEAVES * (4 * 8 + 4) + 4 + 8 + 10 * 4   # ..., the norm, the scalars
    assert norm <= ARG_LIMIT and update <= ARG_LIMIT
    # a baseline step's 216 leaves: one norm launch, its sum, two updates
    assert len(adam.chunk_bounds(216, adam.NORM_LEAVES)) - 1 == 1
    assert len(adam.chunk_bounds(216, adam.UPDATE_LEAVES)) - 1 == 2


def test_table_holds_every_leaf_and_element():
    params, mu, nu = _leaves(torch.Generator().manual_seed(0))
    t = _table(params, mu, nu)
    assert t.names == list(params)
    for i, n in enumerate(params):
        assert list(t.ptrs[i, 1:]) == [params[n].data_ptr(), mu[n].data_ptr(),
                                       nu[n].data_ptr()]
    assert list(t.sizes) == [p.numel() for p in params.values()]
    assert int(t.sizes.sum()) == sum(p.numel() for p in params.values())
    assert t.launches == 3 and t.scratch.numel() == 1 + adam.BLOCKS
    assert t.holds(dict(params), mu, nu)


def test_table_sees_replaced_leaves():
    params, mu, nu = _leaves(torch.Generator().manual_seed(1))
    t = _table(params, mu, nu)
    assert not t.holds(params, {**mu, "leaf0": mu["leaf0"].clone()}, nu)
    moved = dict(params)
    moved["leaf2"].data = moved["leaf2"].data.clone()     # same tensor, new storage
    assert not t.holds(moved, mu, nu)
    assert not t.holds({n: params[n] for n in list(params)[:-1]}, mu, nu)


def test_gradient_pointers():
    params, mu, nu = _leaves(torch.Generator().manual_seed(2))
    t = _table(params, mu, nu)
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    grads["leaf1"] = None
    grads["leaf2"] = torch.ones(16, 4, 3, dtype=torch.bfloat16)
    grads["leaf0"] = torch.ones(5, 7).t()                 # not contiguous
    ptrs, made = t.grad_pointers(grads)
    assert ptrs[1] == 0 and len(made) == 2
    assert all(m.dtype == torch.float32 and m.is_contiguous() for m in made)
    assert ptrs[0] == made[0].data_ptr() and ptrs[2] == made[1].data_ptr()
    assert ptrs[3] == grads["leaf3"].data_ptr()
    with pytest.raises(ValueError, match="leaf3"):                         # shape
        t.grad_pointers({**grads, "leaf3": torch.ones(2)})


def test_which_tensors_the_kernel_takes():
    x = torch.zeros(4, 6)
    assert adam.fits(x, -1)
    assert not adam.fits(x.to(torch.bfloat16), -1)
    assert not adam.fits(x.to(torch.float64), -1)
    assert not adam.fits(x.t(), -1)
    assert not adam.fits(x, 0)                            # another device
    params, mu, nu = _leaves(torch.Generator().manual_seed(3))
    assert adam.LeafTable.build(params, mu, nu) is None   # the CPU: the plain loop
    assert adam.LeafTable.build(params, {**mu, "extra": x}, nu) is None
    # leaves off the CPU that the kernel does not take raise: no plain loop
    # beside the kernel (a meta tensor stands for a card's here)
    off = {n: p.to("meta") for n, p in params.items()}
    with pytest.raises(ValueError, match="contiguous fp32"):
        adam.LeafTable.build(off, {n: p.to("meta") for n, p in mu.items()},
                             {n: p.to("meta") for n, p in nu.items()})
    with pytest.raises(ValueError, match="contiguous fp32"):
        adam.LeafTable.build({**params, "leaf0": off["leaf0"]}, mu, nu)
    with pytest.raises(ValueError, match="names"):
        adam.LeafTable.build(off, {**mu, "extra": x}, nu)


def _span_counts(opt, params, grads):
    profiling.start()
    try:
        opt.step(params, grads)
    finally:
        profiling.stop()
    recs = profiling.records()
    return ([r["counts"] for r in recs if r["name"] == "metatts.train.optimizer"],
            [r["name"] for r in recs])


def test_cpu_step_counts_plain_leaves():
    params, _, _ = _leaves(torch.Generator().manual_seed(4))
    opt = _optimizer(params)
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    counts, names = _span_counts(opt, params, grads)
    assert counts == [{"leaves_fused": 0, "leaves_plain": len(params), "launches": 0}]
    assert "metatts.wait.clip" in names and opt.count == 1 and opt._table is None


class _FakeTable:
    launches = 4

    def __init__(self, params):
        self.params = params

    def holds(self, params, mu, nu):
        return params is self.params


def test_step_counts_fused_leaves(monkeypatch):
    """The optimizer's choice, with the kernel replaced by a recorder: the
    kernel gets the step's count (c1, c2 and lr of step 1); where it refuses
    a gradient the step raises, and the plain loop does not run."""
    params, _, _ = _leaves(torch.Generator().manual_seed(5))
    before = {n: p.clone() for n, p in params.items()}
    calls = []

    def fake(table, grads, **kw):
        calls.append(kw)
        if len(calls) > 1:
            raise ValueError("the gradient does not fit")
        return torch.tensor(1.0)

    monkeypatch.setattr(optim.LeafTable, "build", classmethod(lambda cls, p, m, v: _FakeTable(p)))
    monkeypatch.setattr(optim, "fused_adam", fake)
    opt = _optimizer(params)
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    counts, names = _span_counts(opt, params, grads)
    assert counts == [{"leaves_fused": len(params), "leaves_plain": 0, "launches": 4}]
    assert "metatts.wait.clip" not in names and opt.count == 1
    assert all(torch.equal(p, before[n]) for n, p in params.items())   # the fake did nothing
    c1, c2, lr = opt._scalars(1)
    assert (calls[0]["c1"], calls[0]["c2"], calls[0]["lr"]) == (c1, c2, lr)
    assert abs(c1 - 0.1) < 1e-6 and lr < 0
    # a gradient the kernel does not take: an error, and no plain loop
    with pytest.raises(ValueError, match="does not fit"):
        _span_counts(opt, params, grads)
    names = [r["name"] for r in profiling.records()]
    assert "metatts.wait.clip" not in names and opt.count == 1
    assert all(torch.equal(p, before[n]) for n, p in params.items())


def test_signatures_match_the_source():
    """``ops/adam.py``'s ctypes signatures, read without a card or a
    compiler, against the C functions of ``csrc/adam.cu``."""
    src = open(SOURCE).read()
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}
    for fn, (restype, argtypes) in adam._SIGNATURES.items():
        m = re.search(r"\n(const char\*|int) " + fn + r"\(([^)]*)\)", src)
        assert m, fn
        assert (restype is ctypes.c_char_p) == (m.group(1) == "const char*")
        params = [p.strip() for p in m.group(2).split(",")]
        got = ["ptr" if "*" in p else p.split()[0] for p in params]
        assert got == [kinds[a] for a in argtypes], fn
