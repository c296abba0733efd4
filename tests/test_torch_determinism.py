"""Port: the one-hot length regulator and the meta step's state over
consecutive steps, against the JAX package on the CPU.

``length_regulate`` expands by a product with the (B, T, L) one-hot
alignment, so that its gradient has no scatter-add (whose CUDA kernel adds
in the order its atomics arrive) and a training step repeats itself on the
card.  Here it is held to the JAX package's gather: the values equal bit
for bit, in fp32 and bf16, with zero durations and truncation at
``max_mel_len``; the gradient and a Hessian-vector product through it at
rtol 1e-6 of their largest entries.  ``gather_phoneme_level`` and ``dynamic_range_decompression``
against JAX's.  Then three consecutive ``MetaSystem.train_step`` calls at
tests/helpers.py's tiny config, from the JAX package's own initial weights
carried over by ``metatts_torch.convert``, dropout off on both sides,
against three calls of the JAX ``MetaSystem``'s step compiled once, at
tests/test_torch_train.py's one-step tolerances (losses rtol 1e-5,
parameter moves atol lr / 10 each step), which holds the state carried from
step to step: Adam's moments, the Noam count, and BatchNorm buffers left as
they were.  One test, so that ``--dist loadfile`` starts it late.
"""

import copy

import numpy as np
import torch
import jax
import jax.numpy as jnp

import metatts_tpu.algorithms.base as jbase
import metatts_tpu.models.nn as jnn
from metatts_tpu.algorithms.meta import MetaSystem as JaxMetaSystem
from metatts_tpu.ops import length_regulator as JL
from metatts_tpu.ops.stft import dynamic_range_decompression as jax_decompress
from metatts_tpu.train.optim import make_optimizer
from metatts_torch.algorithms.meta import MetaSystem
from metatts_torch.convert import fs2_state_dict_from_jax, load_fs2_from_jax
from metatts_torch.data.collate import Batch as TBatch
from metatts_torch.models import nn as tnn
from metatts_torch.ops import length_regulator as TL
from metatts_torch.ops.stft import dynamic_range_decompression

from helpers import (tiny_model_cfg, tiny_preprocess_cfg, tiny_train_cfg,
                     algorithm_cfg, synth_batch, STATS)
from torch_port_helpers import one_torch_thread  # noqa: F401

N_STEPS = 3


def _t(b):
    return TBatch(*(None if v is None else torch.from_numpy(np.array(v)) for v in b))


def _durations(rng, B, L, T):
    """Durations with zeros, rows that overflow ``T`` and a row of all 0."""
    d = rng.randint(0, 6, size=(B, L)).astype(np.int32)
    d[0, :3] = 0
    d[1] = 0
    d[2] = T          # every phoneme alone fills the frames: truncation
    return d


def _close(got, ref, rtol=1e-6):
    """Within ``rtol`` of the largest entry: a phoneme's gradient sums its
    frames in another order than the gather's scatter-add, and where those
    terms cancel an elementwise rtol would measure the cancellation."""
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


def _check_length_regulator():
    rng = np.random.RandomState(0)
    B, L, H, T = 5, 11, 7, 40
    d = _durations(rng, B, L, T)
    x = rng.randn(B, L, H).astype(np.float32)
    jax_regulate = jax.jit(JL.length_regulate, static_argnums=2)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        got, got_len = TL.length_regulate(xt, torch.from_numpy(d), T)
        ref, ref_len = jax_regulate(jnp.asarray(x).astype(jdt), jnp.asarray(d), T)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert int(got_len[2]) == T and not got[1].float().abs().sum()

    # the gradient of a weighted sum of the output, and a Hessian-vector
    # product of a loss that is not linear in x: the one-hot product's sums
    # against the gather's scatter-add and its transpose
    w = rng.randn(B, T, H).astype(np.float32)
    v = rng.randn(B, L, H).astype(np.float32)

    def jax_loss(xx):
        out, _ = JL.length_regulate(xx, jnp.asarray(d), T)
        return jnp.sum(jnp.asarray(w) * out) + 0.5 * jnp.sum(jnp.tanh(out) ** 2)

    def port_loss(xx):
        out, _ = TL.length_regulate(xx, torch.from_numpy(d), T)
        return (torch.from_numpy(w) * out).sum() + 0.5 * (torch.tanh(out) ** 2).sum()

    g_ref = jax.jit(jax.grad(jax_loss))(jnp.asarray(x))
    _, hv_ref = jax.jit(lambda a, b: jax.jvp(jax.grad(jax_loss), (a,), (b,)))(
        jnp.asarray(x), jnp.asarray(v))
    xt = torch.from_numpy(x).requires_grad_()
    g, = torch.autograd.grad(port_loss(xt), xt, create_graph=True)
    hv, = torch.autograd.grad(g, xt, grad_outputs=torch.from_numpy(v))
    _close(g.detach().numpy(), np.asarray(g_ref))
    _close(hv.numpy(), np.asarray(hv_ref))

    # frame-level features averaged to phoneme level
    feat = rng.randn(B, T).astype(np.float32)
    got = TL.gather_phoneme_level(torch.from_numpy(feat), torch.from_numpy(d),
                                  torch.full((B,), L))
    ref = jax.jit(JL.gather_phoneme_level)(jnp.asarray(feat), jnp.asarray(d), jnp.full((B,), L))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    logmel = rng.randn(3, 8, 20).astype(np.float32) * 4
    np.testing.assert_allclose(dynamic_range_decompression(torch.from_numpy(logmel), C=2.0).numpy(),
                               np.asarray(jax_decompress(jnp.asarray(logmel), C=2.0)),
                               rtol=1e-6)


def _step_train_cfg():
    # Adam divides each first moment by its own root mean square: from the
    # second step on, a parameter whose gradients so far cancel to within
    # the meta-gradients' rounding (atol 2e-5, tests/test_torch_train.py)
    # moves by up to lr in a direction the rounding picks.  Eps 1e-4, as in
    # tests/test_torch_lang.py, keeps such parameters still on both sides
    tcfg = copy.deepcopy(tiny_train_cfg())
    tcfg["optimizer"]["eps"] = 1e-4
    return tcfg


def _check_meta_steps():
    pcfg, mcfg, acfg = tiny_preprocess_cfg(), tiny_model_cfg(), algorithm_cfg("meta")
    tcfg = _step_train_cfg()
    # the JAX system's own init, as one jitted program (op by op it compiles
    # ~80 small ones)
    init, jbase.fastspeech2_init = jbase.fastspeech2_init, (
        lambda key, *args: jax.jit(lambda k: init(k, *args))(key))
    try:
        jsys = JaxMetaSystem(pcfg, mcfg, tcfg, acfg, STATS, 4, seed=0)
    finally:
        jbase.fastspeech2_init = init
    system = MetaSystem(pcfg, mcfg, tcfg, acfg, STATS, 4, device="cpu")
    load_fs2_from_jax(system.model, jsys.params, jsys.state)
    state = jax.tree.map(np.asarray, jsys.state)
    bn = {k: v.clone() for k, v in system.model.state_dict().items() if "running" in k}
    rng = np.random.RandomState(9)
    episodes = [(synth_batch(rng, B=2, L=12, T=48, n_mels=8, episode_axis=2),
                 synth_batch(rng, B=2, L=12, T=48, n_mels=8, episode_axis=2))
                for _ in range(N_STEPS)]
    lr_at = make_optimizer(mcfg, tcfg)[1]

    dropout, jnn.dropout = jnn.dropout, lambda rng, x, rate, train: x
    port_dropout, tnn.dropout = tnn.dropout, lambda x, rate, train, generator: x
    try:
        prev = {n: p.detach().clone() for n, p in system.params.items()}
        ref_prev = fs2_state_dict_from_jax(jax.tree.map(np.asarray, jsys.params), state)
        for k, (sup, qry) in enumerate(episodes):
            losses_r = jsys.train_step(sup, qry)
            losses = system.train_step(_t(sup), _t(qry))
            ref = fs2_state_dict_from_jax(jax.tree.map(np.asarray, jsys.params), state)
            for name, a, b in zip(losses._fields, losses, losses_r):
                np.testing.assert_allclose(a.item(), float(b), rtol=1e-5,
                                           err_msg=f"step {k + 1} {name}")
            lr = float(lr_at(k))          # step k + 1 moves by lr(k)
            for n, p in system.params.items():
                np.testing.assert_allclose((p.detach() - prev[n]).numpy(),
                                           (ref[n] - ref_prev[n]).numpy(), atol=0.1 * lr,
                                           rtol=0, err_msg=f"step {k + 1} {n}")
            prev = {n: p.detach().clone() for n, p in system.params.items()}
            ref_prev = ref
    finally:
        jnn.dropout, tnn.dropout = dropout, port_dropout
    assert len(jsys._compiled) == 1 and "meta_train" in jsys._compiled
    assert system.global_step == jsys.global_step == N_STEPS == system.optimizer.count
    for k, v in bn.items():
        assert torch.equal(v, system.model.state_dict()[k]), k


def test_length_regulator_and_consecutive_meta_steps_match_jax():
    _check_length_regulator()
    _check_meta_steps()
