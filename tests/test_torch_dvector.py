"""Port: the evaluation d-vector encoder (``evaluation/dvector.py``) and the
scratch GE2E verifier (``evaluation/ge2e_scratch.py``) against the JAX
package.

Inputs come from numpy with a fixed seed; weights cross over as arrays:
the JAX random init through ``metatts_torch.convert.ge2e_state_dict_from_jax``
and the repository's one GE2E weight file,
``examples/meta_advantage_eer/ge2e_scratch.npz`` (hidden 128, embed 128).
Each JAX reference is compiled once: the encoders' jitted ``ge2e_embed``
(two partial counts a width), the scratch loss's ``value_and_grad`` and
``train_ge2e``'s own step program (3 steps).

Tolerances (fp32; only the order of summation differs): d-vectors and
per-partial embeddings max abs 1e-5; the GE2E loss rel 1e-5, each network
gradient tensor rel 1e-5 of its largest entry and the similarity scale's
two scalars 1e-5 of the largest gradient entry; three ``train_ge2e`` steps
from one start, losses and every returned network tensor rel 1e-4 of its
largest entry, ``sim_b`` (gradient 0 up to rounding, which Adam turns
into moves of lr) within 2 x 3 x lr; features, ``fold_input_norm`` and the
npz round trip bit for bit.
"""

import os
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from metatts_tpu.evaluation import dvector as jdv
from metatts_tpu.evaluation import ge2e_scratch as jg
from metatts_torch.convert import ge2e_state_dict_from_jax
from metatts_torch.evaluation import dvector as tdv
from metatts_torch.evaluation import ge2e_scratch as tg

from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "examples", "meta_advantage_eer", "ge2e_scratch.npz")
SR = 22050
SCRATCH = dict(hidden=32, embed=32, layers=3)


def _voice(seed, seconds, f0):
    """A harmonic tone with a little noise, from a seed."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    wav = sum(np.sin(2 * np.pi * f0 * k * t + rng.rand()) / k for k in range(1, 6))
    return (0.3 * wav + 0.01 * rng.randn(t.size)).astype(np.float32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port_params(tree):
    """A JAX scratch-GE2E tree -> the port's named tensors."""
    out = {"net." + k: v for k, v in ge2e_state_dict_from_jax(_np(tree["net"])).items()}
    out["sim_w"] = torch.tensor(np.asarray(tree["sim_w"], np.float32))
    out["sim_b"] = torch.tensor(np.asarray(tree["sim_b"], np.float32))
    return out


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (np.abs(got - want).max(), scale)


@pytest.fixture(scope="module")
def encoders():
    """(JAX encoder, port encoder) pairs on the same weights: the JAX
    random init (seed 0, resemblyzer's width) and the repository's npz."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_rand = jdv.DVectorEncoder(seed=0)
        t_rand = tdv.DVectorEncoder(seed=0, device="cpu")
    t_rand.net = tdv.ge2e_from_state_dict(ge2e_state_dict_from_jax(_np(j_rand.params))).eval()
    return {"random": (j_rand, t_rand),
            "npz": (jdv.DVectorEncoder(NPZ), tdv.DVectorEncoder(NPZ, device="cpu"))}


@pytest.mark.parametrize("weights", ["random", "npz"])
def test_dvectors_match_jax(encoders, weights):
    """A short utterance (looped to one partial) and a 4 s one (several
    partials): the utterance d-vectors, and each partial's embedding."""
    j, t = encoders[weights]
    assert t.calibrated == j.calibrated == (weights == "npz")
    width = 256 if weights == "random" else 128
    assert t.net.linear.weight.shape == (width, width)
    for seconds, f0 in ((0.6, 140.0), (4.0, 210.0)):
        wav = _voice(int(seconds * 10), seconds, f0)
        got, want = t.embed_utterance(wav, SR), j.embed_utterance(wav, SR)
        assert got.shape == want.shape == (width,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    from metatts_torch.preprocess.refmel import ref_mel_slices
    parts = ref_mel_slices(_voice(3, 4.0, 180.0), SR)
    assert len(parts) > 2
    np.testing.assert_allclose(t.embed_partials(parts),
                               np.asarray(j._embed(j.params, jnp.asarray(parts))),
                               atol=1e-5, rtol=0)


def test_random_init_and_refusal():
    """The port's random init: seeded by a torch.Generator, warned about,
    uncalibrated; ``require_weights`` refuses a missing file."""
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        a = tdv.DVectorEncoder(seed=0, device="cpu")
    with pytest.warns(UserWarning):
        b = tdv.DVectorEncoder(seed=0, device="cpu")
        c = tdv.DVectorEncoder(seed=1, device="cpu")
    sa, sb, sc = (e.net.state_dict() for e in (a, b, c))
    assert not a.calibrated and list(sa) == list(tdv.ge2e_from_state_dict(
        np.load(NPZ)).state_dict())
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["linear.weight"], sc["linear.weight"])
    with pytest.raises(FileNotFoundError, match="refusing"):
        tdv.DVectorEncoder("missing.npz", require_weights=True, device="cpu")


# ------------------------------------------------------------- scratch GE2E

def _partials(n_speakers=3, n_utts=3, frames=20, scale=1.0, seed=0):
    """Speaker-distinct features: a per-speaker offset plus noise."""
    rng = np.random.RandomState(seed)
    return {f"s{i}": (scale * (rng.randn(1, 1, 40) + 0.3 * rng.randn(n_utts, frames, 40))
                      ).astype(np.float32) for i in range(n_speakers)}


@pytest.fixture(scope="module")
def jax_start():
    return jg.ge2e_init(jax.random.PRNGKey(0), mel_channels=40, **SCRATCH)


def test_ge2e_loss_and_gradient_match_jax(jax_start):
    """The GE2E softmax loss (leave-one-out centroids) and its gradient
    with respect to every tensor.  The features are speaker-distinct: where
    every embedding is alike (the uniform-softmax plateau) each gradient is
    a cancellation of O(1) terms and fp32 rounding alone moves it by ~1e-4
    of itself, in either package.  The similarity scale's two scalars are
    held to 1e-5 of the largest gradient entry: ``sim_b``'s gradient is 0
    up to rounding (the softmax is invariant to a shift of every logit)
    and ``sim_w``'s is a sum of 18 terms of ~0.3 that cancel to ~6e-3."""
    batch = np.stack(list(_partials(n_utts=2, scale=10.0, seed=1).values()))
    j_loss, j_grad = jax.jit(jax.value_and_grad(jg.ge2e_softmax_loss))(
        jax_start, jnp.asarray(batch))
    live = {k: v.requires_grad_(True) for k, v in _port_params(jax_start).items()}
    loss = tg.ge2e_softmax_loss(live, torch.from_numpy(batch))
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    _close(loss.item(), float(j_loss), 1e-5)
    want = _port_params(j_grad)
    assert set(grads) == set(want)
    top = max(np.abs(v.numpy()).max() for v in want.values())
    for k in want:
        if k.startswith("net."):
            _close(grads[k].numpy(), want[k].numpy(), 1e-5)
        else:
            assert abs(grads[k].item() - want[k].item()) <= 1e-5 * top, k


def test_train_ge2e_matches_jax(jax_start, monkeypatch):
    """Three steps from the JAX init (the port's ``ge2e_init`` patched to
    return it): the same batches from ``RandomState(seed + 1)``, the clip
    and Adam of optax, the best-loss params with the input norm folded.
    ``sim_b``'s gradient is 0 up to rounding, which Adam turns into a move
    of up to lr a step in either direction: it is held within 2 x steps x
    lr of the JAX value (no other tensor depends on it)."""
    parts = _partials(n_speakers=4)
    kw = dict(SCRATCH, steps=3, lr=1e-3, n_speakers_per_batch=3, m_utts_per_speaker=2,
              seed=0)
    j_params, j_trace = jg.train_ge2e(parts, **kw)
    monkeypatch.setattr(tg, "ge2e_init", lambda *a, **k: _port_params(jax_start))
    t_params, t_trace = tg.train_ge2e(parts, device="cpu", **kw)
    assert len(t_trace) == len(j_trace) == 3
    _close(t_trace, j_trace, 1e-4)
    want = _port_params(j_params)
    assert set(t_params) == set(want)
    for k in want:
        if k != "sim_b":
            _close(t_params[k].numpy(), want[k].numpy(), 1e-4)
    assert abs(t_params["sim_b"].item() - want["sim_b"].item()) <= 2 * 3 * 1e-3
    with pytest.raises(ValueError, match="need >= 8 speakers"):
        tg.train_ge2e(parts, steps=1, device="cpu")


def test_features_fold_and_npz_round_trip(jax_start, tmp_path):
    """``utterance_partial``, ``_input_norm_stats`` and ``fold_input_norm``
    bit for bit; ``save_ge2e_npz`` writes the JAX package's arrays, and
    ``DVectorEncoder(require_weights=True)`` reads them back exactly."""
    wav = _voice(5, 0.9, 160.0)
    np.testing.assert_array_equal(tg.utterance_partial(wav, SR), jg.utterance_partial(wav, SR))
    parts = _partials()
    mu, scale = tg._input_norm_stats(parts)
    for got, want in zip((mu, scale), jg._input_norm_stats(parts)):
        np.testing.assert_array_equal(got, want)
    folded = tg.fold_input_norm(_port_params(jax_start), mu, scale)
    want = _port_params(jg.fold_input_norm(jax_start, mu, scale))
    for k in want:
        np.testing.assert_array_equal(folded[k].numpy(), want[k].numpy(), err_msg=k)
    t_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tg.save_ge2e_npz(folded, t_path)
    jg.save_ge2e_npz(jg.fold_input_norm(jax_start, mu, scale), j_path)
    t_z, j_z = np.load(t_path), np.load(j_path)
    assert sorted(t_z.files) == sorted(j_z.files)
    for k in j_z.files:
        np.testing.assert_array_equal(t_z[k], j_z[k], err_msg=k)
    enc = tdv.DVectorEncoder(t_path, require_weights=True, device="cpu")
    assert enc.calibrated
    for k, v in enc.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), folded["net." + k].numpy(), err_msg=k)
    two = {k: v for k, v in folded.items() if not k.endswith("_l2")}
    with pytest.raises(ValueError, match="exactly GE2E_LAYERS"):
        tg.save_ge2e_npz(two, str(tmp_path / "two.npz"))
