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


# ------------------------------- the bf16 kernels' decomposition (CPU)
#
# The Hopper kernels run only on the card.  These emulate, in torch on the
# CPU, the order in which they compute: the forward's 128-key steps of pass
# 1 (base-2 running max and sum), then pass 2's 64-key tiles with
# 2^(s - m) rounded to bf16 before P V and the division last; the
# backward's dK/dV per 64-key tile over the 64-query tiles and dQ per
# 64-query tile over the 64-key tiles, fp32 accumulation in that order.
# Scores are in base 2, s log2(e) = fma(dot, scale log2(e), bias log2(e)),
# as the kernels form them.  They are held against the plain versions at
# the bf16 tolerances, at a ragged T and at a head width that is a multiple
# of 8 and not of 16.

LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def _fma(a, b, c):
    """a * b + c rounded once to fp32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_terms(q, mask):
    """(scale, scale log2(e), base-2 key biases (BH, T)) in fp32."""
    scale = torch.tensor(A.kernel_scale(q.shape[-1]), dtype=torch.float32)
    bias2 = (mask.float() - 1.0) * 1e9 * torch.tensor(LOG2E)
    return scale, scale * torch.tensor(LOG2E), bias2


def _kernel_fwd(q, k, v, mask):
    BH, T, D = q.shape
    _, scale2, bias2 = _kernel_terms(q, mask)
    s2 = _fma(q.float() @ k.float().transpose(1, 2), scale2, bias2[:, None, :])
    m = torch.full((BH, T), -np.inf)
    l = torch.zeros(BH, T)
    for k0 in range(0, T, 128):                       # pass 1
        st = s2[..., k0:k0 + 128]
        m_new = torch.maximum(m, st.amax(-1))
        l = l * torch.exp2(m - m_new) + torch.exp2(st - m_new[..., None]).sum(-1)
        m = m_new
    acc = torch.zeros(BH, T, D)
    for k0 in range(0, T, 64):                        # pass 2
        p = torch.exp2(s2[..., k0:k0 + 64] - m[..., None]).to(torch.bfloat16)
        acc = acc + p.float() @ v[:, k0:k0 + 64].float()
    lc = l.clamp_min(1e-30)
    return acc / lc[..., None], m * torch.tensor(LN2) + torch.log(lc)


def _kernel_bwd(q, k, v, mask, out, lse, dout):
    BH, T, D = q.shape
    bf = torch.bfloat16
    scale, scale2, bias2 = _kernel_terms(q, mask)
    delta = (dout * out).sum(-1)                      # the prologue, fp32
    do_b = dout.to(bf).float()
    lse2 = lse * torch.tensor(LOG2E)
    qf, kf, vf = q.float(), k.float(), v.float()
    dq, dk, dv = (torch.zeros(BH, T, D) for _ in range(3))
    tiles = range(0, T, 64)
    for k0 in tiles:                                  # role 0: a key tile
        K, V, b = kf[:, k0:k0 + 64], vf[:, k0:k0 + 64], bias2[:, k0:k0 + 64, None]
        for q0 in tiles:
            Q, Do = qf[:, q0:q0 + 64], do_b[:, q0:q0 + 64]
            p = torch.exp2(_fma(K @ Q.transpose(1, 2), scale2, b) - lse2[:, None, q0:q0 + 64])
            ds = p * (V @ Do.transpose(1, 2) - delta[:, None, q0:q0 + 64]) * scale
            dv[:, k0:k0 + 64] += p.to(bf).float() @ Do
            dk[:, k0:k0 + 64] += ds.to(bf).float() @ Q
    for q0 in tiles:                                  # role 1: a query tile
        Q, Do = qf[:, q0:q0 + 64], do_b[:, q0:q0 + 64]
        for k0 in tiles:
            K, V = kf[:, k0:k0 + 64], vf[:, k0:k0 + 64]
            p = torch.exp2(_fma(Q @ K.transpose(1, 2), scale2, bias2[:, None, k0:k0 + 64])
                           - lse2[:, q0:q0 + 64, None])
            ds = p * (Do @ V.transpose(1, 2) - delta[:, q0:q0 + 64, None]) * scale
            dq[:, q0:q0 + 64] += ds.to(bf).float() @ K
    return dq.to(bf), dk.to(bf), dv.to(bf)


@pytest.fixture(scope="module", params=[(77, 128), (77, 72)], ids=["T77-D128", "T77-D72"])
def ragged(request):
    T, D = request.param
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(3, T, D).astype(np.float32) * s).to(torch.bfloat16)
               for s in (0.5, 0.5, 1.0))
    mask = torch.ones(3, T)
    mask[1, T // 3:] = 0.0          # padded keys
    mask[2] = 0.0                   # no valid key
    dout = torch.from_numpy(rng.randn(3, T, D).astype(np.float32))
    return q, k, v, mask, dout


def test_kernel_forward_decomposition(ragged):
    q, k, v, mask, _ = ragged
    out, lse = _kernel_fwd(q, k, v, mask)
    ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, mask)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out - ref).abs().max() < 3e-2
    assert (lse - ref_lse).abs().max() < 3e-2
    # the row without a valid key averages v
    assert (out[2] - v[2].float().mean(0)).abs().max() < 3e-2


def test_kernel_backward_decomposition(ragged):
    q, k, v, mask, dout = ragged
    out, lse = A.flash_attention_fwd_plain(q, k, v, mask)
    got = _kernel_bwd(q, k, v, mask, out, lse, dout)
    ref = A.flash_attention_bwd_plain(q, k, v, mask, out, lse, dout)
    for name, g, r in zip("qkv", got, ref):
        assert torch.isfinite(g.float()).all()
        rel = (g.float() - r.float()).abs().max() / (r.float().abs().max() + 1e-9)
        assert rel < 0.05, (f"d{name}", rel)


def test_kernel_scale_is_cached_scale():
    """The wrappers hand the kernels a scale computed once per head width;
    it is the plain versions' fp32 1 / sqrt(D) for every width the gate
    admits."""
    for d in range(1, A.MAX_D + 1):
        assert A.kernel_scale(d) == A._scale(d), d
        assert A._scales[d] == A._scale(d)
