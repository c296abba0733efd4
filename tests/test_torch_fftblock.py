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
    (256, 4, True)])
def test_supported_gate(d_model, d_k, ok):
    # the port's gate is the TPU kernel's: a width that ran fused there
    # runs through the kernel here, or the kernel raises
    assert fused_block_supported(d_model, d_k) == ok == jax_gate(d_model, d_k)


@pytest.mark.parametrize("d_model,n_head,filter_size,ok", [
    (256, 2, 1024, True), (128, 2, 256, True), (512, 4, 2048, False),
    (256, 64, 1024, False), (256, 2, 1000, True), (256, 2, 1020, False)])
def test_kernel_shape_limits(d_model, n_head, filter_size, ok):
    assert (kernel_shape_error(d_model, n_head, filter_size) is None) == ok


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
