"""Port: the training slice against the JAX package, at the tiny config of
tests/helpers.py (hidden 32, 1 + 1 layers, fp32; 2 shots, 2 queries,
2 inner steps, 2 episodes).  Inputs come from numpy with a fixed seed and
parameters cross over through metatts_torch.convert; each JAX reference is
built once per module.

JAX and the port draw different dropout bits, so every comparison with JAX
runs without dropout (no seed on the port's side, no key or an identity
dropout on the JAX side); the port's own mask replay is checked against
its own unrolled second-order gradient with dropout on.

Tolerances (fp32; only the order of summation differs): outputs atol 1e-4
(tests/test_torch_serve.py), losses rtol 1e-5, parameter gradients atol
5e-6 / rtol 1e-3 (tests/test_forward_parity.py:273-274); meta-gradients,
which go through two inner steps and their Hessian-vector products,
atol 2e-5 / rtol 1e-3; the optimizer, the same operations in the same
order, rtol 1e-6.
"""

import copy

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

import metatts_tpu.models.nn as jnn
from metatts_tpu.algorithms.adapt import Adaptor as JaxAdaptor
from metatts_tpu.algorithms.meta import MetaSystem as JaxMetaSystem
from metatts_tpu.models.fastspeech2 import fastspeech2_apply
from metatts_tpu.models.loss import fastspeech2_loss as jax_loss
from metatts_tpu.train.optim import make_optimizer
from metatts_torch.algorithms.adapt import Adaptor, episode_speaker_args
from metatts_torch.algorithms.meta import MetaSystem
from metatts_torch.convert import fs2_state_dict_from_jax, load_fs2_from_jax
from metatts_torch.data.collate import Batch as TBatch
from metatts_torch.models import nn as tnn
from metatts_torch.models.fastspeech2 import FastSpeech2
from metatts_torch.models.loss import fastspeech2_loss
from metatts_torch.ops import attention as A
from metatts_torch.train.optim import NoamAdam

from helpers import (tiny_model_cfg, tiny_preprocess_cfg, tiny_train_cfg,
                     algorithm_cfg, synth_batch, STATS)
from torch_port_helpers import fs2_params, one_torch_thread  # noqa: F401

INNER_LR = 0.01         # above the configs' 1e-3, so that second-order terms show
STEPS = 2


def _t(b):
    return TBatch(*(None if v is None else torch.from_numpy(np.array(v))
                    for v in b))


def _port_model(pcfg, mcfg, acfg, params, state):
    model = FastSpeech2(pcfg, mcfg, acfg, STATS, 4)
    return load_fs2_from_jax(model, params, state)


def _grads_by_name(jax_grads, state, names):
    sd = fs2_state_dict_from_jax(jax.tree.map(np.asarray, jax_grads), state)
    return {n: sd[n].numpy() for n in names}


def _close_grads(got, ref, atol, rtol=1e-3):
    assert got.keys() == ref.keys()
    for n in got:
        g = np.zeros_like(ref[n]) if got[n] is None else got[n].detach().numpy()
        np.testing.assert_allclose(g, ref[n], atol=atol, rtol=rtol, err_msg=n)


@pytest.fixture(scope="module")
def cfgs():
    pcfg, acfg = tiny_preprocess_cfg(), algorithm_cfg("meta")
    mcfg = tiny_model_cfg()
    params, state = fs2_params(pcfg, mcfg, acfg, STATS, 4)
    return pcfg, mcfg, acfg, params, state


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout(dtype):
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 50, 16)
                         .astype(np.float32)).to(dtype)
    rate = 0.3
    a = tnn.dropout(x, rate, True, tnn.generator(7, "cpu"))
    b = tnn.dropout(x, rate, True, tnn.generator(7, "cpu"))
    assert torch.equal(a, b) and a.dtype == dtype            # replayable
    assert not torch.equal(a, tnn.dropout(x, rate, True, tnn.generator(8, "cpu")))
    mask = torch.rand(x.shape, generator=tnn.generator(7, "cpu")) < 1 - rate
    # the JAX package's formula on the same mask
    ref = jnp.where(jnp.asarray(mask.numpy()),
                    jnp.asarray(x.float().numpy()).astype(
                        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
                    / (1 - rate), 0.0)
    np.testing.assert_array_equal(a.float().numpy(), np.asarray(ref, np.float32))
    assert abs(mask.float().mean().item() - (1 - rate)) < 0.03
    for args in ((rate, False, tnn.generator(7, "cpu")), (0.0, True, tnn.generator(7, "cpu")),
                 (rate, True, None)):
        assert tnn.dropout(x, *args) is x


def test_batch_norm_batch_statistics_leave_state():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7, 5).astype(np.float32) * 2 + 0.5
    p = {"scale": rng.randn(5).astype(np.float32), "bias": rng.randn(5).astype(np.float32)}
    s = {"mean": rng.randn(5).astype(np.float32),
         "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    ref, _ = jnn.batch_norm(p, s, jnp.asarray(x), True)
    bn = tnn.BatchNorm(5)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])})
    with torch.no_grad():
        got = bn(torch.from_numpy(x), train=True, update_state=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert np.array_equal(bn.running_mean.numpy(), s["mean"])
    assert np.array_equal(bn.running_var.numpy(), s["var"])


# -------------------------------------------------- training forward + loss

@pytest.fixture(scope="module")
def forward_ref(cfgs):
    pcfg, mcfg, acfg, params, state = cfgs
    batch = synth_batch(np.random.RandomState(3), B=3, L=12, T=48, n_mels=8)

    def loss_fn(p):
        out, _ = fastspeech2_apply(p, state, batch, mcfg, pcfg, acfg,
                                   train=True, rng=None)
        losses = jax_loss(batch, out, pcfg)
        return losses.total, (losses, out)

    (_, (losses, out)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return batch, losses, out, grads


@pytest.mark.parametrize("impl", ["einsum", "einsum_remat", "flash"])
def test_training_forward_loss_and_grads(cfgs, forward_ref, impl):
    """train=True without dropout: BatchNorm batch statistics, the five
    LossValues and every parameter gradient."""
    pcfg, mcfg, acfg, params, state = cfgs
    batch, losses_r, out_r, grads_r = forward_ref
    model = _port_model(pcfg, mcfg, acfg, params, state).train()
    bn_before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    tb = _t(batch)
    out = model(tb, attention_impl=impl, update_bn_state=False)
    losses = fastspeech2_loss(tb, out, pcfg)
    for name in ("mel", "postnet_mel", "p_pred", "e_pred", "log_d_pred"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(out_r, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    for name, a, b in zip(losses._fields, losses, losses_r):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, err_msg=name)
    names = [n for n, _ in model.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(losses.total, list(model.parameters()))))
    _close_grads(got, _grads_by_name(grads_r, state, names), atol=5e-6)
    for k, v in bn_before.items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_forward_default_updates_running_statistics(cfgs, forward_ref):
    pcfg, mcfg, acfg, params, state = cfgs
    model = _port_model(pcfg, mcfg, acfg, params, state).train()
    before = model.postnet.convolutions[0][1].running_mean.clone()
    with torch.no_grad():
        model(_t(forward_ref[0]))
    assert not torch.equal(before, model.postnet.convolutions[0][1].running_mean)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("acc", [1, 2])
def test_adam_noam_matches_optax_chain(acc):
    """clip by global norm -> Adam -> weight decay -> Noam lr (annealed),
    against the JAX package's optax chain, with gradient accumulation."""
    mcfg = tiny_model_cfg()
    tcfg = copy.deepcopy(tiny_train_cfg())
    tcfg["optimizer"].update(grad_acc_step=acc, weight_decay=0.01,
                             anneal_steps=[2, 3])
    rng = np.random.RandomState(5)
    params = {"a": rng.randn(7, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    tx, _ = make_optimizer(mcfg, tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = NoamAdam(tp, mcfg, tcfg)
    for i in range(4 * acc):
        scale = 0.1 if i % 2 else 10.0            # clipped and not clipped
        g = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
             for k, v in params.items()}
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{k} {i}")
    assert opt.count == 4


# ------------------------------------------------------------ meta-gradient

@pytest.fixture(scope="module")
def episode(cfgs):
    rng = np.random.RandomState(7)
    return (synth_batch(rng, B=2, L=12, T=48, n_mels=8),
            synth_batch(rng, B=2, L=12, T=48, n_mels=8))


def _without_jax_dropout(fn):
    """fn() with the JAX package's dropout an identity, so that a key only
    makes the inner loop a ``lax.scan``, as in the JAX training step."""
    orig, jnn.dropout = jnn.dropout, lambda rng, x, rate, train: x
    try:
        return fn()
    finally:
        jnn.dropout = orig


@pytest.fixture(scope="module")
def meta_grad_refs(cfgs, episode):
    pcfg, mcfg, acfg, params, state = cfgs
    sup, qry = episode
    refs = {}
    for key, over in (("custom_hvp", {}), ("unrolled", {}),
                      ("fwd", {"hvp_mode": "fwd"})):
        ad = JaxAdaptor(pcfg, dict(mcfg, second_order_impl=key, **over)
                        if key != "fwd" else dict(mcfg, **over), acfg)
        refs[key] = _without_jax_dropout(lambda: jax.jit(jax.grad(
            lambda p: ad.meta_learn(p, state, sup, qry, steps=STEPS, lr=INNER_LR,
                                    train=True, rng=jax.random.PRNGKey(0))[0].total))(
                                        params))
    return refs


def _port_meta_grad(cfgs, episode, mcfg_over, first_order=False, seed=None):
    pcfg, mcfg, acfg, params, state = cfgs
    m = dict(mcfg, **mcfg_over)
    model = _port_model(pcfg, m, acfg, params, state).train()
    ad = Adaptor(model, pcfg, m, acfg)
    sup, qry = (_t(b) for b in episode)
    p = dict(model.named_parameters())
    if first_order:
        adapted = ad.adapt(p, sup, steps=STEPS, lr=INNER_LR, first_order=True,
                           train=True)
        out = ad.forward(adapted, qry._replace(speaker_args=episode_speaker_args(
                             sup.speaker_args, qry.speaker_args)),
                         train=True, average_spk_emb=True)
        loss = ad.loss(qry, out).total
    else:
        loss = ad.meta_learn(p, sup, qry, steps=STEPS, lr=INNER_LR, train=True,
                             seed=seed)[0].total
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return dict(zip(p, grads)), model


@pytest.mark.parametrize("so,over,flash_calls", [
    ("custom_hvp", {}, (0, 0)),
    ("unrolled", {}, (0, 0)),
    # flash on the query forward and its backward only, as on the card
    # (1 + 1 layers here)
    ("custom_hvp", {"attention_impl": "flash"}, (2, 2)),
    # and on the inner loop's forward gradient: per inner step 2 forwards
    # and 1 backward (the frozen encoder needs no gradient there)
    ("custom_hvp", {"attention_impl": "flash", "fast_attention_impl": "flash"},
     (6, 4)),
    # the forward-over-reverse HVP against the JAX package's
    ("custom_hvp", {"hvp_mode": "fwd"}, (0, 0)),
])
def test_meta_grad_matches_meta_learn(cfgs, episode, meta_grad_refs,
                                      monkeypatch, so, over, flash_calls):
    """Second-order meta-gradient of one episode against the JAX
    ``Adaptor.meta_learn``.  The encoder is not adapted, so its gradient
    holds the cross term -lr * H_fa u of every inner step."""
    calls = {"fwd": 0, "bwd": 0}

    def spy(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(A, "flash_attention_fwd_plain",
                        spy("fwd", A.flash_attention_fwd_plain))
    monkeypatch.setattr(A, "flash_attention_bwd_plain",
                        spy("bwd", A.flash_attention_bwd_plain))
    state = cfgs[4]
    got, _ = _port_meta_grad(cfgs, episode, dict(over, second_order_impl=so))
    assert (calls["fwd"], calls["bwd"]) == flash_calls
    names = list(got)
    ref = _grads_by_name(meta_grad_refs[over.get("hvp_mode", so)], state, names)
    _close_grads(got, ref, atol=2e-5)
    # the second-order terms are far above the tolerance: the first-order
    # gradient of the same episode misses them
    fo, _ = _port_meta_grad(cfgs, episode, {}, first_order=True)
    enc = [n for n in names if n.startswith("encoder.")]
    gap = max(np.abs(fo[n].numpy() - ref[n]).max() for n in enc)
    assert gap > 100 * 2e-5, gap


def test_custom_hvp_replays_dropout_masks(cfgs, episode):
    """With dropout on, the custom-HVP step's backward must see the masks
    of its forward: its meta-gradient equals the port's own unrolled
    second-order gradient under the same seed."""
    over = {"transformer": dict(cfgs[1]["transformer"], encoder_dropout=0.2,
                                decoder_dropout=0.2),
            "variance_predictor": dict(cfgs[1]["variance_predictor"], dropout=0.5)}
    got, _ = _port_meta_grad(cfgs, episode, dict(over, second_order_impl="custom_hvp"),
                             seed=11)
    ref, _ = _port_meta_grad(cfgs, episode, dict(over, second_order_impl="unrolled"),
                             seed=11)
    _close_grads(got, {n: g.numpy() for n, g in ref.items()}, atol=2e-5)
    other, _ = _port_meta_grad(cfgs, episode, dict(over, second_order_impl="unrolled"),
                               seed=12)
    assert max((other[n] - ref[n]).abs().max().item() for n in ref) > 1e-3


def test_hvp_fwd_mode_not_ported(cfgs, episode, meta_grad_refs):
    """``hvp_mode="fwd"`` (one forward-mode JVP of the full gradient per
    inner step) gives the reverse-over-reverse meta-gradient: against the
    port's ``rev`` with dropout on (the masks replayed in both) and
    against the JAX package's ``fwd`` (the port's counterpart of
    tests/test_systems.py's fwd-vs-rev check)."""
    over = {"transformer": dict(cfgs[1]["transformer"], encoder_dropout=0.2,
                                decoder_dropout=0.2),
            "variance_predictor": dict(cfgs[1]["variance_predictor"], dropout=0.5)}
    fwd, _ = _port_meta_grad(cfgs, episode, dict(over, hvp_mode="fwd"), seed=11)
    rev, _ = _port_meta_grad(cfgs, episode, dict(over, hvp_mode="rev"), seed=11)
    _close_grads(fwd, {n: g.numpy() for n, g in rev.items()}, atol=2e-5)
    got, _ = _port_meta_grad(cfgs, episode, {"hvp_mode": "fwd"})
    names = list(got)
    ref = _grads_by_name(meta_grad_refs["fwd"], cfgs[4], names)
    _close_grads(got, ref, atol=2e-5)
    with pytest.raises(ValueError, match="hvp_mode"):
        _port_meta_grad(cfgs, episode, {"hvp_mode": "jvp"})


# ------------------------------------------------------------ meta system

def _step_train_cfg():
    # Adam's first step is lr * g / (|g| + eps): with eps 1e-9 a gradient
    # that is 0 up to rounding (a conv bias before a batch-statistics
    # BatchNorm) moves its parameter by up to lr in a direction set by the
    # rounding; eps 1e-6 keeps such parameters still on both sides
    tcfg = copy.deepcopy(tiny_train_cfg())
    tcfg["optimizer"]["eps"] = 1e-6
    return tcfg


@pytest.fixture(scope="module")
def step_ref(cfgs):
    """One JAX ``_meta_train_step`` at E=2 without dropout."""
    pcfg, mcfg, acfg, params, state = cfgs
    rng = np.random.RandomState(9)
    sup = synth_batch(rng, B=2, L=12, T=48, n_mels=8, episode_axis=2)
    qry = synth_batch(rng, B=2, L=12, T=48, n_mels=8, episode_axis=2)
    jsys = JaxMetaSystem.__new__(JaxMetaSystem)
    jsys.acfg = acfg
    jsys.adaptor = JaxAdaptor(pcfg, mcfg, acfg)
    jsys.tx, _ = make_optimizer(mcfg, _step_train_cfg())
    new_params, _, losses = _without_jax_dropout(lambda: jax.jit(
        jsys._meta_train_step)(params, state, jsys.tx.init(params), sup, qry,
                               jax.random.PRNGKey(0)))
    return sup, qry, new_params, losses


def test_meta_train_step_matches_jax(cfgs, step_ref, monkeypatch):
    """The parameter delta and the mean LossValues of one
    ``MetaSystem.train_step`` (E=2) against the JAX ``_meta_train_step``;
    the BatchNorm running statistics stay as they were."""
    pcfg, mcfg, acfg, params, state = cfgs
    sup, qry, new_params, losses_r = step_ref
    monkeypatch.setattr(tnn, "dropout", lambda x, rate, train, generator: x)
    system = MetaSystem(pcfg, mcfg, _step_train_cfg(), acfg, STATS, 4,
                        device="cpu")
    load_fs2_from_jax(system.model, params, state)
    bn = {k: v.clone() for k, v in system.model.state_dict().items() if "running" in k}
    before = {n: p.detach().clone() for n, p in system.params.items()}
    losses = system.train_step(_t(sup), _t(qry))
    assert system.global_step == 1
    for name, a, b in zip(losses._fields, losses, losses_r):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, err_msg=name)
    after = fs2_state_dict_from_jax(jax.tree.map(np.asarray, new_params), state)
    # Adam's first step moves each parameter by about +-lr wherever its
    # gradient is not ~0: compare the deltas to a tenth of the lr
    lr = float(make_optimizer(mcfg, _step_train_cfg())[1](1))
    moved = 0
    for n, p in system.params.items():
        d_got = (p.detach() - before[n]).numpy()
        d_ref = after[n].numpy() - before[n].numpy()
        np.testing.assert_allclose(d_got, d_ref, atol=0.1 * lr, rtol=0, err_msg=n)
        moved += int((np.abs(d_got) > 0.5 * lr).sum())
    assert moved > 0.5 * sum(p.numel() for p in system.params.values())
    for k, v in bn.items():
        assert torch.equal(v, system.model.state_dict()[k]), k


def test_validation_step_first_order(cfgs, episode):
    pcfg, mcfg, acfg, params, state = cfgs
    system = MetaSystem(pcfg, mcfg, tiny_train_cfg(), acfg, STATS, 4, device="cpu")
    before = {k: v.clone() for k, v in system.model.state_dict().items()}
    losses = system.validation_step(*(_t(b) for b in episode))
    assert all(np.isfinite(v.item()) for v in losses)
    for k, v in before.items():
        assert torch.equal(v, system.model.state_dict()[k]), k


def test_meta_system_needs_a_card_unless_asked_for_cpu(cfgs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pcfg, mcfg, acfg, *_ = cfgs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MetaSystem(pcfg, mcfg, tiny_train_cfg(), acfg, STATS, 4)
