"""Port: the GE2E d-vector speaker modes (``encoder``, ``dvec``,
``scratch_encoder``) against the JAX package, at the tiny config of
tests/helpers.py (fp32, hidden 32, 1 + 1 layers) with a small
``model.ge2e`` (8 mel channels, hidden 16, embed 32, 2 LSTM layers) and
reference slices of 6 frames, 3 a utterance with the last one masked at
random.  Inputs come from numpy with a fixed seed and parameters cross
over through metatts_torch.convert; dropout is patched out on both sides;
each JAX reference is compiled once.

Also the d-vector ``speaker_args`` pair through the port's Batch plumbing:
collation of a corpus with ``spk_ref_mel_slices`` by both packages'
datamodules, ``split_batch``, ``Batch.to`` and ``episode``, and the test
stage's stacked 1-shot sub-tasks.

Tolerances (fp32; only the order of summation differs): the LSTM and
speaker embeddings atol 1e-5 (atol 2e-2 in bf16, a rounding of the inputs
of every product and so a different gradient trajectory of 12 steps);
meta-gradients atol 2e-5 / rtol 1e-3 (tests/test_torch_train.py); the
port's batched sub-tasks against its sequential ones rtol 1e-6; batches,
trees and checkpoints exactly.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import metatts_tpu.models.nn as jnn
from metatts_tpu.algorithms.adapt import Adaptor as JaxAdaptor
from metatts_tpu.data import collate as jcollate
from metatts_tpu.data.datamodule import MetaDataModule as JaxMetaDM
from metatts_tpu.models.speaker_encoder import ge2e_embed, speaker_encoder_apply
from metatts_tpu.train import checkpoint as jck
from metatts_torch import config as C
from metatts_torch.algorithms.adapt import Adaptor
from metatts_torch.algorithms.base import System, episode
from metatts_torch.algorithms.meta import MetaSystem
from metatts_torch.convert import (fs2_state_dict_from_jax, jax_trees_from_fs2,
                                   load_fs2_from_jax)
from metatts_torch.data.collate import Batch, split_batch
from metatts_torch.data.datamodule import MetaDataModule
from metatts_torch.models import nn as tnn
from metatts_torch.models.fastspeech2 import FastSpeech2
from metatts_torch.models.speaker_encoder import GE2E_MODES
from metatts_torch.train import checkpoint as ck

from helpers import (tiny_model_cfg, tiny_preprocess_cfg, tiny_train_cfg,
                     algorithm_cfg, synth_batch, STATS)
from torch_port_helpers import fs2_params, one_torch_thread  # noqa: F401

GE2E = {"mel_channels": 8, "hidden": 16, "embed": 32, "layers": 2}
SLICES = (3, 6, 8)            # S, frames, mel channels of the reference slices
INNER_LR = 0.01
MODES = list(GE2E_MODES)


@pytest.fixture(scope="module", autouse=True)
def no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "dropout", lambda rng, x, rate, train: x)
        mp.setattr(tnn, "dropout", lambda x, rate, train, generator: x)
        yield


def _arr(v):
    return tuple(_arr(x) for x in v) if isinstance(v, tuple) else \
        torch.from_numpy(np.array(v))


def _t(b):
    return Batch(*(None if v is None else _arr(v) for v in b))


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _cfgs(mode):
    pcfg, mcfg = tiny_preprocess_cfg(), tiny_model_cfg(ge2e=dict(GE2E))
    acfg = algorithm_cfg("meta", speaker_emb=mode)
    if mode == "dvec":
        acfg["adapt"]["modules"] = ["variance_adaptor", "decoder", "mel_linear", "postnet"]
    params, state = fs2_params(pcfg, mcfg, acfg, STATS, 4)
    return pcfg, mcfg, acfg, _f32(params), _f32(state)


def _model(cfgs, params=None, state=None, seed=1):
    pcfg, mcfg, acfg = cfgs[:3]
    model = FastSpeech2(pcfg, mcfg, acfg, STATS, 4,
                        generator=torch.Generator().manual_seed(seed))
    if params is not None:
        load_fs2_from_jax(model, params, state)
    return model


def _slices(seed, B=3):
    rng = np.random.RandomState(seed)
    S, T, C = SLICES
    ref = rng.randn(B, S, T, C).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[:, -1] = rng.rand(B) > 0.5
    valid[0, -1] = False
    return ref, valid


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_matches_jax(dtype):
    """Outputs and each layer's final h against ``nn.lstm``, torch gate
    order i, f, g, o, the weights carried transposed."""
    rng = np.random.RandomState(0)
    d_in, H, n = 5, 7, 2
    layers = []
    for k in range(n):
        din = d_in if k == 0 else H
        layers.append({"w_ih": rng.uniform(-0.4, 0.4, (din, 4 * H)).astype(np.float32),
                       "w_hh": rng.uniform(-0.4, 0.4, (H, 4 * H)).astype(np.float32),
                       "b_ih": rng.uniform(-0.4, 0.4, 4 * H).astype(np.float32),
                       "b_hh": rng.uniform(-0.4, 0.4, 4 * H).astype(np.float32)})
    x = rng.randn(3, 12, d_in).astype(np.float32)
    ref_out, ref_fin = jnn.lstm({"layers": layers}, jnp.asarray(x), jnp.dtype(dtype))
    lstm = tnn.LSTM(d_in, H, n)
    lstm.load_state_dict({f"{name}_l{k}": torch.from_numpy(
        np.ascontiguousarray(lp[key].T if key.startswith("w") else lp[key]))
        for k, lp in enumerate(layers)
        for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                          ("bias_ih", "b_ih"), ("bias_hh", "b_hh"))})
    out, fin = lstm(torch.from_numpy(x), tnn.dtype(dtype))
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=atol, rtol=0)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(ref_fin), atol=atol, rtol=0)
    assert out.dtype == fin.dtype == torch.float32


@pytest.mark.parametrize("mode", MODES)
def test_speaker_modes_match_jax(mode):
    """``ge2e_embed`` over the partials, then all three modes' masked
    slice means against ``speaker_encoder_apply``; ``dvec`` passes no
    gradient to its network, the other two do."""
    cfgs = _cfgs(mode)
    params = cfgs[3]
    model = _model(cfgs, params, cfgs[4])
    ref, valid = _slices(1)
    B, S, T, C = ref.shape
    parts = model.speaker_emb.model(torch.from_numpy(ref.reshape(B * S, T, C)))
    want = ge2e_embed(params["speaker_emb"], jnp.asarray(ref.reshape(B * S, T, C)))
    np.testing.assert_allclose(parts.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    got = model.speaker_emb((torch.from_numpy(ref), torch.from_numpy(valid)))
    want = speaker_encoder_apply(params["speaker_emb"], (jnp.asarray(ref), jnp.asarray(valid)),
                                 mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # a masked slice changes nothing
    ref2 = ref.copy()
    ref2[0, -1] += 5.0
    again = model.speaker_emb((torch.from_numpy(ref2), torch.from_numpy(valid)))
    assert torch.equal(again, got)
    if mode == "dvec":          # cut from the graph: nothing flows back
        assert not got.requires_grad
        return
    grads = torch.autograd.grad(got.square().sum() + got.sum(),
                                list(model.speaker_emb.parameters()))
    assert all(g.abs().sum() > 0 for g in grads)


def test_ge2e_norm_gradient_at_zero_is_finite():
    """An all-zero embedding (every unit cut by the ReLU) has gradient 0,
    not NaN: sqrt(sum + eps), as in the JAX package."""
    cfgs = _cfgs("encoder")
    model = _model(cfgs, cfgs[3], cfgs[4])
    with torch.no_grad():
        model.speaker_emb.model.linear.bias.fill_(-100.0)
    ref, _ = _slices(2)
    x = torch.from_numpy(ref.reshape(-1, *ref.shape[2:]))
    e = model.speaker_emb.model(x)
    assert torch.equal(e, torch.zeros_like(e))
    grads = torch.autograd.grad(e.sum(), list(model.speaker_emb.parameters()), allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)


# ------------------------------------------------------------ meta-gradient

@pytest.fixture(scope="module")
def meta_setup():
    cfgs = _cfgs("encoder")
    pcfg, mcfg, acfg, params, state = cfgs
    rng = np.random.RandomState(7)
    sup = synth_batch(rng, B=2, L=12, T=48, n_mels=8, dvec_dims=SLICES)
    qry = synth_batch(rng, B=2, L=12, T=48, n_mels=8, dvec_dims=SLICES)
    ad = JaxAdaptor(pcfg, mcfg, acfg)
    grads = jax.jit(jax.grad(lambda p: ad.meta_learn(
        p, state, sup, qry, steps=2, lr=INNER_LR, train=True,
        rng=jax.random.PRNGKey(0))[0].total))(params)
    return cfgs, sup, qry, grads


@pytest.mark.parametrize("hvp_mode", ["rev", "fwd"])
def test_encoder_meta_grad_matches_meta_learn(meta_setup, hvp_mode):
    """The second-order meta-gradient in ``encoder`` mode (the LSTM adapted
    in the inner loop, so differentiated twice) against the JAX
    ``Adaptor.meta_learn``, every parameter, with either HVP."""
    cfgs, sup, qry, ref_grads = meta_setup
    pcfg, mcfg, acfg, params, state = cfgs
    m = dict(mcfg, hvp_mode=hvp_mode)
    model = _model((pcfg, m, acfg), params, state).train()
    ad = Adaptor(model, pcfg, m, acfg)
    p = dict(model.named_parameters())
    loss = ad.meta_learn(p, _t(sup), _t(qry), steps=2, lr=INNER_LR, train=True,
                         seed=3)[0].total
    got = dict(zip(p, torch.autograd.grad(loss, list(p.values()), allow_unused=True)))
    ref = fs2_state_dict_from_jax(jax.tree.map(np.asarray, ref_grads), state)
    lstm = [n for n in got if n.startswith("speaker_emb.")]
    assert len(lstm) == 4 * GE2E["layers"] + 2
    for n, g in got.items():
        want = ref[n].numpy()
        g = np.zeros_like(want) if g is None else g.detach().numpy()
        np.testing.assert_allclose(g, want, atol=2e-5, rtol=1e-3, err_msg=n)
    assert max(np.abs(ref[n].numpy()).max() for n in lstm) > 100 * 2e-5


@pytest.mark.parametrize("hvp_mode", ["rev", "fwd"])
def test_dvec_meta_step_leaves_the_network(hvp_mode):
    """A ``dvec`` meta step (the speaker network frozen outside the inner
    loop's modules) moves the model but not one d-vector parameter, with
    either HVP."""
    pcfg, mcfg, acfg, params, state = _cfgs("dvec")
    system = MetaSystem(pcfg, dict(mcfg, hvp_mode=hvp_mode), tiny_train_cfg(), acfg,
                        STATS, 4, device="cpu")
    load_fs2_from_jax(system.model, params, state)
    before = {n: p.detach().clone() for n, p in system.params.items()}
    rng = np.random.RandomState(3)
    sup = _t(synth_batch(rng, B=2, L=12, T=48, n_mels=8, dvec_dims=SLICES, episode_axis=2))
    qry = _t(synth_batch(rng, B=2, L=12, T=48, n_mels=8, dvec_dims=SLICES, episode_axis=2))
    losses = system.train_step(sup, qry)
    assert torch.isfinite(losses.total)
    for n, p in system.params.items():
        assert torch.equal(p, before[n]) == n.startswith("speaker_emb."), n


# -------------------------------------------------------------- checkpoints

def _assert_trees_equal(got, ref):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(ref)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_encoder_checkpoint_round_trip(tmp_path):
    """The LSTM and linear parameters under torch's names, both ways: a
    JAX checkpoint loads into the port, a port checkpoint into the JAX
    package, bit for bit, and the trees match the JAX init's layout."""
    cfgs = _cfgs("encoder")
    params, state = cfgs[3], cfgs[4]
    model = _model(cfgs, params, state)
    sd = model.state_dict()
    assert tuple(sd["speaker_emb.model.lstm.weight_ih_l0"].shape) == (4 * 16, 8)
    assert np.array_equal(sd["speaker_emb.model.lstm.weight_hh_l1"].numpy(),
                          params["speaker_emb"]["lstm"]["layers"][1]["w_hh"].T)
    got_p, got_s = jax_trees_from_fs2(model)
    _assert_trees_equal(got_p, params)
    path = str(tmp_path / "jax.msgpack")
    jck.save_checkpoint(path, params, state, {}, 4)
    port = _model(cfgs, seed=5)
    _, step, report = ck.load_checkpoint(path, port)
    assert step == 4 and report[0].startswith("no optimizer state")
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k
    path = str(tmp_path / "port.msgpack")
    ck.save_checkpoint(path, model, 6)
    like_p, like_s = jax_trees_from_fs2(_model(cfgs, seed=5))
    p, s, _, step, report = jck.load_checkpoint(path, like_p, like_s, {})
    assert step == 6 and report == []
    _assert_trees_equal(jax.tree.map(np.asarray, p), params)


# ------------------------------------------------- collation and batches

SPEAKERS = ("spk_a", "spk_b")


def _write_corpus(root, n_utts=3, seed=0):
    """A preprocessed corpus with reference slices (2 speakers x 3
    utterances, 1-4 slices of 6 x 8 each)."""
    rng = np.random.RandomState(seed)
    kinds = ("mel", "pitch", "energy", "duration", "spk_ref_mel_slices")
    for sub in kinds:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines = []
    for spk in SPEAKERS:
        for u in range(n_utts):
            base = f"{spk}_{u}"
            n = rng.randint(5, 13)
            d = rng.randint(1, 5, n).astype(np.int64)
            arrays = {"mel": rng.randn(int(d.sum()), 8).astype(np.float32),
                      "pitch": rng.randn(n).astype(np.float32),
                      "energy": rng.randn(n).astype(np.float32), "duration": d,
                      "spk_ref_mel_slices": rng.randn(rng.randint(1, 5), 6, 8)
                      .astype(np.float32)}
            for kind, a in arrays.items():
                tag = "mel" if kind == "spk_ref_mel_slices" else kind
                np.save(os.path.join(root, kind, f"{spk}-{tag}-{base}.npy"), a)
            lines.append(f"{base}|{spk}|{{HH AH0 L OW1}}|hello")
    for split in ("train", "val", "test"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "speakers.json"), "w") as f:
        json.dump({s: i for i, s in enumerate(SPEAKERS)}, f)
    with open(os.path.join(root, "stats.json"), "w") as f:
        json.dump(STATS, f)


def _assert_batches_equal(got, ref):
    for name, a, b in zip(Batch._fields, got, ref):
        if b is None:
            assert a is None, name
            continue
        pairs = zip(a, b) if isinstance(b, tuple) else [(a, b)]
        assert isinstance(a, tuple) == isinstance(b, tuple), name
        for x, y in pairs:
            y = np.asarray(y)
            assert x.numpy().dtype == y.dtype and np.array_equal(x.numpy(), y), name


@pytest.mark.parametrize("mode", ["table"] + MODES)
def test_collate_matches_jax(tmp_path, mode):
    """Both datamodules' episode batches from one corpus: the id speaker
    args in ``table`` mode, ``(ref (E, B, S, 6, 8), valid (E, B, S))`` in
    the d-vector modes with S shared across the meta-batch; then
    ``split_batch``, ``Batch.to`` and ``episode`` on them."""
    root = str(tmp_path / "corpus")
    _write_corpus(root)
    pcfg = C.deep_merge(tiny_preprocess_cfg(), {
        "dataset": "synth", "path": {"preprocessed_path": root},
        "subsets": {"train": "train", "val": "val", "test": "test"}})
    acfg = algorithm_cfg("meta", speaker_emb=mode)
    acfg["adapt"]["train"].update(shots=1, queries=1)
    acfg["adapt"]["test"].update(shots=1, queries=1)
    refer = mode in GE2E_MODES
    dm = MetaDataModule([pcfg], tiny_train_cfg(), acfg, log_dir=str(tmp_path / "p"),
                        spk_refer_wav=refer)
    jdm = JaxMetaDM([pcfg], tiny_train_cfg(), acfg, log_dir=str(tmp_path / "j"),
                    spk_refer_wav=refer)
    dm.setup()
    jdm.setup()
    got, ref = dm.train_episode_batches(2), jdm.train_episode_batches(2)
    for _ in range(3):
        a, b = next(got), next(ref)
        for x, y in zip(a[:2], b[:2]):
            _assert_batches_equal(x, y)
    sup = a[0]
    assert isinstance(sup.speaker_args, tuple) == refer
    if refer:
        S = sup.speaker_args[0].shape[2]
        assert S == max(s["spk_ref_mel_slices"].shape[0]
                        for s in (dm.train_set[i] for i in range(len(dm.train_set))))
    one = episode(sup, 1)
    _assert_batches_equal(one, jax.tree.map(lambda v: v[1], b[0]))
    moved = one.to("cpu")
    _assert_batches_equal(moved, jax.tree.map(lambda v: v[1], b[0]))
    flat = jcollate.collate_batch([dm.train_set[i] for i in (0, 3, 4)])[0]
    port_flat = _port_collate([dm.train_set[i] for i in (0, 3, 4)])
    _assert_batches_equal(port_flat, flat)
    _assert_batches_equal(split_batch(port_flat, [2, 0]),
                          jcollate.split_batch(flat, np.array([2, 0])))


def _port_collate(samples):
    from metatts_torch.data.collate import collate_batch
    return collate_batch(samples)[0]


def test_one_shot_sub_tasks_stack_the_speaker_pair():
    """``test_adapt_tasks`` in 1-shot mode stacks the d-vector pair of its
    K sub-tasks (``test_adapt_batched``) and gives each the rows of its
    own sequential ``test_adapt``, here in ``scratch_encoder`` mode."""
    pcfg, mcfg, acfg, params, state = _cfgs("scratch_encoder")
    acfg["adapt"]["test"].update(steps=2, saving_steps=[1, 2])
    acfg["adapt"]["test"]["1-shot"] = True
    rng = np.random.RandomState(4)
    sup = _t(synth_batch(rng, B=2, L=12, T=48, n_mels=8, dvec_dims=SLICES))
    qry = _t(synth_batch(rng, B=1, L=12, T=48, n_mels=8, dvec_dims=SLICES))
    runs = {}
    for batched in (True, False):
        a = copy.deepcopy(acfg)
        a["adapt"]["test"]["batch_sub_tasks"] = batched
        system = System(pcfg, mcfg, tiny_train_cfg(), a, STATS, 4, device="cpu")
        load_fs2_from_jax(system.model, params, state)
        runs[batched] = list(system.test_adapt_tasks(sup, qry))
    for (sfx_b, rows_b, snaps_b), (sfx_s, rows_s, snaps_s) in zip(runs[True], runs[False]):
        assert sfx_b == sfx_s
        assert [ft for ft, _ in rows_b] == [0, 1, 2]
        for (_, lb), (_, ls) in zip(rows_b, rows_s):
            np.testing.assert_allclose([float(v) for v in lb], [float(v) for v in ls],
                                       rtol=1e-6)
        moved = snaps_b[-1][1]["speaker_emb.model.lstm.weight_ih_l0"]
        assert not torch.equal(moved, snaps_b[0][1]["speaker_emb.model.lstm.weight_ih_l0"])
