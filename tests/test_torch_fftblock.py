"""Port: the fused FFT block's plain PyTorch version against the JAX
package's Pallas kernel in interpret mode, and the serving engine's refusal
to run on the CPU unasked.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there); on a CPU tensor the wrapper runs the
plain version, which is what these tests reach.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from metatts_tpu.models.transformer import fft_block_init
from metatts_tpu.ops.pallas.fftblock import fused_block_supported as jax_gate
from metatts_tpu.ops.pallas.fftblock import fused_fft_block as jax_fused
from metatts_torch.convert import fft_block_state_dict_from_jax
from metatts_torch.models.transformer import FFTBlock
from metatts_torch.ops.fftblock import (fused_block_supported, fused_fft_block,
                                        fused_fft_block_plain,
                                        kernel_shape_error)

from torch_port_helpers import fill_tree, one_torch_thread  # noqa: F401

D, H, F, K, B, T = 128, 2, 256, 9, 3, 48
LENS = np.array([T, 29, 0])


def _setup(seed=0):
    p = fill_tree(jax.eval_shape(lambda k: fft_block_init(
        k, D, H, D // H, D // H, F, [K, 1]), jax.random.PRNGKey(0)), seed)
    blk = FFTBlock(D, H, F, [K, 1])
    blk.load_state_dict(fft_block_state_dict_from_jax(p), strict=True)
    x = np.random.RandomState(seed).randn(B, T, D).astype(np.float32)
    valid = np.arange(T)[None, :] < LENS[:, None]
    return p, blk, x, valid


@pytest.fixture(scope="module")
def setup():
    p, blk, x, valid = _setup()
    ref = np.asarray(jax_fused(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               jnp.asarray(valid), H, interpret=True))
    got = fused_fft_block_plain(blk.fused_params(), torch.from_numpy(x),
                                torch.from_numpy(valid), H).numpy()
    return p, blk, x, valid, ref, got


def test_plain_matches_pallas_interpret(setup):
    *_, ref, got = setup
    # both round to bf16 at the same places; the tolerance is the TPU
    # kernel's own against its XLA block (tests/test_pallas_fftblock.py)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 5e-3, rel
    assert np.isfinite(got).all()


def test_plain_zeroes_padding(setup):
    _, _, _, valid, _, got = setup
    assert np.abs(got[~valid]).max() == 0.0
    assert np.abs(got[valid]).max() > 0.0


def test_plain_mask_invariance(setup):
    _, blk, x, valid, _, got = setup
    x2 = x.copy()
    x2[1, 40:] = 1e3               # garbage beyond row 1's length (29)
    x2[2] = -1e3                   # row 2 has no valid position at all
    got2 = fused_fft_block_plain(blk.fused_params(), torch.from_numpy(x2),
                                 torch.from_numpy(valid), H).numpy()
    assert np.abs(got2[valid] - got[valid]).max() < 1e-5
    assert np.abs(got2[~valid]).max() == 0.0


def test_wrapper_runs_plain_version_on_cpu(setup):
    _, blk, x, valid, _, got = setup
    before = fused_fft_block.launches
    out = fused_fft_block(blk.fused_params(), torch.from_numpy(x),
                          torch.from_numpy(valid), H)
    assert np.array_equal(out.numpy(), got)
    assert fused_fft_block.launches == before      # no kernel launched


def test_fused_params_repack_after_update():
    _, blk, x, valid = _setup(seed=1)
    a = blk.fused_params()
    assert blk.fused_params() is a
    with torch.no_grad():
        blk.pos_ffn.w_2.bias.add_(1.0)
    b = blk.fused_params()
    assert b is not a
    assert torch.equal(b["b2"], a["b2"] + 1.0)


@pytest.mark.parametrize("d_model,d_k,ok", [
    (256, 128, True), (128, 64, True), (200, 100, False), (512, 128, True),
    (256, 4, True), (384, 96, True), (1024, 128, True), (512, 256, False)])
def test_supported_gate(d_model, d_k, ok):
    # the port's gate is the TPU kernel's: a width that ran fused there
    # runs through the kernel here, or the kernel raises
    assert fused_block_supported(d_model, d_k) == ok == jax_gate(d_model, d_k)


@pytest.mark.parametrize("d_model,n_head,filter_size,ok", [
    (256, 2, 1024, True), (128, 2, 256, True), (512, 4, 2048, True),
    (256, 64, 1024, True), (256, 2, 1000, True), (256, 2, 1020, True),
    (384, 3, 1536, True), (1024, 8, 4096, True), (200, 2, 800, False),
    (256, 3, 1024, False), (512, 2, 2048, False)])
def test_kernel_shape_limits(d_model, n_head, filter_size, ok):
    # the kernel takes every width the gate admits (heads are zero-padded
    # in its tiles, F is padded by pack_block_params); it refuses only a
    # D that is no multiple of the heads and what the gate refuses
    assert (kernel_shape_error(d_model, n_head, filter_size) is None) == ok


@pytest.mark.parametrize("d_model", range(128, 1025, 128))
def test_kernel_takes_every_gated_width(d_model):
    for n_head in range(1, d_model + 1):
        if d_model % n_head:
            continue
        d_k = d_model // n_head
        for filter_size in (1, 4 * d_model - 4, 4 * d_model):
            ok = kernel_shape_error(d_model, n_head, filter_size) is None
            assert ok == fused_block_supported(d_model, d_k), (n_head, filter_size)


def _unpadded(blk):
    """The block's parameters in the kernel layout without padding F,
    straight from the modules."""
    p = dict(blk.fused_params())
    w1 = blk.pos_ffn.w_1.weight.detach()                      # (F, D, K)
    F = w1.shape[0]
    p["w1"] = w1.permute(0, 2, 1).reshape(F, -1).to(torch.bfloat16)
    p["b1"] = blk.pos_ffn.w_1.bias.detach().float().clone()
    p["w2"] = blk.pos_ffn.w_2.weight.detach()[:, :, 0].to(torch.bfloat16)
    return p


def test_pack_pads_filter_size():
    """F=1020: w1, b1 and w2 are stored with F rounded up to 1024, the pad
    zero; the plain version on them is bit for bit the unpadded
    computation and agrees with the Pallas kernel in interpret mode."""
    d, h, f, b, t = 128, 2, 1020, 2, 32
    p = fill_tree(jax.eval_shape(lambda k: fft_block_init(
        k, d, h, d // h, d // h, f, [K, 1]), jax.random.PRNGKey(0)), 2)
    blk = FFTBlock(d, h, f, [K, 1])
    blk.load_state_dict(fft_block_state_dict_from_jax(p), strict=True)
    packed = blk.fused_params()
    assert packed["filter_size"] == f
    assert tuple(packed["w1"].shape) == (1024, K * d)
    assert tuple(packed["w2"].shape) == (d, 1024)
    assert packed["b1"].shape == (1024,)
    assert not packed["w1"][f:].any() and not packed["w2"][:, f:].any()
    assert not packed["b1"][f:].any()
    rs = np.random.RandomState(2)
    x = rs.randn(b, t, d).astype(np.float32)
    valid = np.arange(t)[None, :] < np.array([t, 19])[:, None]
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    got = fused_fft_block_plain(packed, xt, vt, h)
    assert torch.equal(got, fused_fft_block_plain(_unpadded(blk), xt, vt, h))
    ref = np.asarray(jax_fused(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               jnp.asarray(valid), h, interpret=True))
    rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert rel < 5e-3, rel


def test_plain_out_dtype_and_bf16_input(setup):
    """out_dtype=bf16 is the fp32 result rounded, and a bf16 input is read
    as the same values: bit-equal to ``.to(torch.bfloat16)`` of the fp32
    path, which is what ``_run`` applied before it passed out_dtype."""
    _, blk, x, valid, _, got = setup
    p = blk.fused_params()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    vt = torch.from_numpy(valid)
    ref = fused_fft_block_plain(p, xb.float(), vt, H).to(torch.bfloat16)
    for xin in (xb, xb.float()):
        out = fused_fft_block(p, xin, vt, H, out_dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    out = fused_fft_block_plain(p, torch.from_numpy(x), vt, H,
                                out_dtype=torch.bfloat16)
    assert torch.equal(out, torch.from_numpy(got).to(torch.bfloat16))


def test_run_passes_activation_dtype():
    """A bf16-activation stack's fused path returns what the blocks' fp32
    outputs cast to bf16 gave before ``_run`` passed out_dtype."""
    from metatts_torch import config as C
    from metatts_torch.models import nn as L
    from metatts_torch.models.transformer import Encoder
    _, mcfg, _ = C.base_configs()
    mcfg["transformer"].update(encoder_layer=2, encoder_hidden=128,
                               encoder_head=2, conv_filter_size=256)
    enc = Encoder(mcfg).eval()
    gen = torch.Generator().manual_seed(3)
    L.reset_parameters(enc, gen)
    assert enc.prec.adtype == torch.bfloat16
    x = torch.randn(2, 24, 128, generator=gen)
    x = x.to(torch.bfloat16)
    valid = torch.arange(24)[None, :] < torch.tensor([24, 9])[:, None]
    with torch.no_grad():
        got = enc._run(x, valid, True, False, None, None)
        ref = x
        for layer in enc.layer_stack:
            ref = fused_fft_block_plain(layer.fused_params(), ref, valid,
                                        2).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert torch.equal(got, ref)


def test_engine_without_device_refuses_cpu_only_host():
    from metatts_torch import config as C
    from metatts_torch.models.fastspeech2 import FastSpeech2
    from metatts_torch.serve import SynthesisEngine
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the engine would use it")
    pcfg, mcfg, acfg = C.base_configs()
    mcfg["transformer"].update(encoder_layer=1, decoder_layer=1)
    model = FastSpeech2(pcfg, mcfg, acfg,
                        {"pitch": [-2, 8, 0, 1], "energy": [-1, 8, 0, 1]}, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SynthesisEngine(model, pcfg, mcfg, acfg)
