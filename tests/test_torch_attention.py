"""Port: the flash-attention op's plain PyTorch version against the JAX
package's Pallas kernel in interpret mode, and the op's autograd contract.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
the plain versions there); on a CPU tensor the wrappers run the plain
versions, which is what these tests reach.  Inputs come from numpy with a
fixed seed; a partly masked row and a row with no valid key are included.

The unfused attention at bf16 compute, activations and scores is held
against the JAX ``mha`` to the bf16 rounding itself (see its test).

Tolerances are the TPU kernel's own (tests/test_pallas_attention.py):
fp32 output atol 2e-5 / rtol 1e-4, fp32 gradients atol 5e-4 / rtol 1e-3;
bf16 inputs (both sides round P and dS to bf16 at the same places and
accumulate in fp32): output max abs 3e-2, gradients relative error < 0.05.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from metatts_tpu.models import transformer as jtr
from metatts_tpu.ops.pallas.attention import (_fwd_call, _pick_tq,
                                              flash_attention as jax_flash)
from metatts_torch.convert import fft_block_state_dict_from_jax
from metatts_torch.models import transformer
from metatts_torch.models.transformer import FFTBlock, _Precision
from metatts_torch.ops import attention as A

from torch_port_helpers import fill_tree, one_torch_thread  # noqa: F401

BH, T, D = 3, 64, 32


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    q = rng.randn(BH, T, D).astype(np.float32) * 0.5
    k = rng.randn(BH, T, D).astype(np.float32) * 0.5
    v = rng.randn(BH, T, D).astype(np.float32)
    do = rng.randn(BH, T, D).astype(np.float32)
    mask = np.ones((BH, T), np.float32)
    mask[0, 40:] = 0.0           # padded keys
    mask[2] = 0.0                # no valid key: averages v, no NaN
    return q, k, v, do, mask


def _jax_ref(q, k, v, do, mask, dtype):
    cast = lambda x: jnp.asarray(x).astype(dtype)
    jm = jnp.asarray(mask)
    scale = 1.0 / np.sqrt(D)
    out, lse = _fwd_call(cast(q), cast(k), cast(v), jm, scale, _pick_tq(T, 128), True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, jm, 128, True),
                     cast(q), cast(k), cast(v))
    grads = vjp(jnp.asarray(do))
    return (np.asarray(out), np.asarray(lse)[:, 0],
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(q, k, v, do, mask, dtype):
    t = lambda x: torch.from_numpy(x).to(dtype).requires_grad_()
    qt, kt, vt = t(q), t(k), t(v)
    m = torch.from_numpy(mask)
    _, lse = A.flash_attention_fwd(qt, kt, vt, m)
    out = A.flash_attention(qt, kt, vt, m)
    out.backward(torch.from_numpy(do))
    return out, lse, (qt.grad, kt.grad, vt.grad)


def test_fp32_matches_pallas_interpret(inputs):
    out_r, lse_r, grads_r = _jax_ref(*inputs, jnp.float32)
    out, lse, grads = _port(*inputs, torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), out_r, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(lse), lse_r, atol=2e-5, rtol=1e-4)
    for name, g, r in zip("qkv", grads, grads_r):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), r, atol=5e-4, rtol=1e-3,
                                   err_msg=f"d{name}")
    # the row without a valid key is the mean of v, finite
    np.testing.assert_allclose(_np(out)[2], np.broadcast_to(
        inputs[2][2].mean(0), (T, D)), atol=2e-5, rtol=1e-4)


def test_bf16_matches_pallas_interpret(inputs):
    out_r, _, grads_r = _jax_ref(*inputs, jnp.bfloat16)
    out, _, grads = _port(*inputs, torch.bfloat16)
    assert out.dtype == torch.float32
    assert np.isfinite(_np(out)).all()
    assert np.abs(_np(out) - out_r).max() < 3e-2
    for g, r in zip(grads, grads_r):
        assert g.dtype == torch.bfloat16
        rel = np.abs(_np(g) - r).max() / (np.abs(r).max() + 1e-9)
        assert rel < 0.05, rel


def test_double_backward_raises(inputs):
    """Differentiable once, like the TPU kernel's custom_vjp; the inner
    loop's HVP therefore runs on einsum attention."""
    q, k, v, _, mask = inputs
    qt = torch.from_numpy(q).requires_grad_()
    out = A.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(mask))
    (g,) = torch.autograd.grad((out ** 2).sum(), qt, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_cpu_runs_plain_version_and_counts_no_launch(inputs):
    q, k, v, do, mask = inputs
    before = (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches)
    _port(q, k, v, do, mask, torch.float32)
    assert (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("shape,dtype,ok", [
    ((2, 77, 128), torch.bfloat16, True),
    ((2, 77, 40), torch.float32, True),
    ((2, 77, 136), torch.float32, False),     # wider than the tiles
    ((2, 77, 60), torch.bfloat16, False),     # bf16 rows load 8 at a time
])
def test_kernel_shape_error(shape, dtype, ok):
    q = torch.zeros(shape, dtype=dtype)
    why = A.kernel_shape_error(q, q, q, torch.ones(shape[:2]))
    assert (why is None) == ok, why


# ------------------------------------------- unfused attention at bf16

@pytest.mark.parametrize("impl", ["einsum", "einsum_remat"])
def test_unfused_mha_bf16_rounds_as_jax(impl, monkeypatch):
    """bf16 compute, activations and scores: the port's unfused attention
    rounds where the JAX ``mha`` does (scores, then softmax in bf16).  Taking
    softmax in fp32 and rounding after, as the port did before, puts 299 of
    these 1920 outputs (15.6%) off (max abs 1.6e-2; the share is checked
    below);
    now none is, and the test allows 1% of them one step."""
    D, H, L = 32, 2, 20
    p = fill_tree(jax.eval_shape(lambda key: jtr.fft_block_init(
        key, D, H, D // H, D // H, 48, [9, 1]), jax.random.PRNGKey(0)), 4)
    rng = np.random.RandomState(5)
    x = (rng.randn(3, L, D) * 2).astype(np.float32)
    valid = np.arange(L)[None, :] < np.array([L, 13, 0])[:, None]
    bf = jnp.bfloat16
    ref = np.asarray(jtr.mha(p["attn"], jnp.asarray(x).astype(bf), jnp.asarray(valid),
                             H, cdtype=bf, drop_rate=0.0, train=False, rng=None,
                             attn_impl="einsum", scores_dtype=bf, adtype=bf)
                     .astype(jnp.float32))
    blk = FFTBlock(D, H, 48, [9, 1])
    blk.load_state_dict(fft_block_state_dict_from_jax(p))
    prec = _Precision(dict(compute_dtype="bfloat16", activation_dtype="bfloat16",
                           attention_scores_dtype="bfloat16"))
    def run():
        with torch.no_grad():
            return blk.slf_attn(torch.from_numpy(x).to(torch.bfloat16),
                                torch.from_numpy(valid), H, prec, attn_impl=impl)

    got = run()
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - ref)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (d > 0).mean() < 0.01 and (d <= step).all(), (d > 0).sum()
    monkeypatch.setattr(transformer, "softmax",
                        lambda s: torch.softmax(s.float(), -1).to(s.dtype))
    d_fp32 = np.abs(run().float().numpy() - ref)
    assert (d_fp32 > 0).mean() > 0.1
