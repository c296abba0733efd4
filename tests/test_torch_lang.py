"""Port: the cross-lingual codebook path against the JAX package, at the
tiny config of tests/helpers.py (fp32, hidden 32, 1 + 1 layers) with
config/algorithm/meta_lang_codebook.yaml cut to 2 shots, 2 queries, 2
inner steps and 2 episodes, and its representation_dim set to the
corpus's 8 mel channels (the built-in featurizer's dimension).

The corpus takes the slice's whole data path: a LibriTTS-layout corpus at
24 kHz written here (2 speakers x 4 utterances with ``.normalized.txt``
transcripts and ``phones`` TextGrids) goes through the port's
``prepare_align`` (resampled to 22.05 kHz) and its ``Preprocessor``
(``device="cpu"``) with representations on.  Both packages' language
datamodules then draw their episodes from it, and one of the port's
episode batches feeds the lang meta step on both sides: the one JAX
second-order program of this file.

JAX and the port draw different dropout bits, so dropout is patched out on
both sides for the whole module.

Tolerances (fp32): the codebook table atol 1e-6 and its gradients rel
1e-5 (one small product; only the order of summation differs); the meta
step's gradient and new parameters rel 1e-4, its losses rtol 1e-5; the
numpy helpers, loaders, checkpoints and surgery reports exactly.
"""

import copy
import json
import os
import re

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

import metatts_tpu.models.nn as jnn
from metatts_tpu.algorithms.adapt import Adaptor as JaxAdaptor
from metatts_tpu.algorithms.meta import MetaSystem as JaxMetaSystem
from metatts_tpu.data import collate as jcollate
from metatts_tpu.data import lang_episodes as jle
from metatts_tpu.data.datamodule import MetaDataModule as JaxMetaDM
from metatts_tpu.models.phoneme_embedding import get_new_embedding as jax_new_embedding
from metatts_tpu.train import checkpoint as jck
from metatts_tpu.train.optim import make_optimizer
from metatts_torch import config as C
from metatts_torch.algorithms.meta import MetaSystem
from metatts_torch.convert import fs2_state_dict_from_jax, load_fs2_from_jax
from metatts_torch.data import lang_episodes as le
from metatts_torch.data.datamodule import MetaDataModule
from metatts_torch.models import nn as tnn
from metatts_torch.models.phoneme_embedding import get_new_embedding
from metatts_torch.preprocess.audio_io import save_wav
from metatts_torch.preprocess.prepare_align import prepare_align
from metatts_torch.preprocess.preprocessor import Preprocessor
from metatts_torch.serve import SynthesisEngine
from metatts_torch.train import checkpoint as ck

from helpers import tiny_model_cfg, tiny_preprocess_cfg, tiny_train_cfg
from torch_port_helpers import fs2_params, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHONES = ["HH", "AH0", "L", "OW1", "W", "ER1", "D", "S", "T", "IY1"]
SPEAKERS = ("103", "1034")
SR_IN, SEC_PER_PHONE, SIL = 24000, 0.06, 0.1
EPISODES = 2
VOCAB = 361


@pytest.fixture(scope="module", autouse=True)
def no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "dropout", lambda rng, x, rate, train: x)
        mp.setattr(tnn, "dropout", lambda x, rate, train, generator: x)
        yield


def _textgrid(path, phones):
    """A long-form MFA-style TextGrid: silence, the phones, silence."""
    items, t = [(0.0, SIL, "sil")], SIL
    for p in phones:
        items.append((t, t + SEC_PER_PHONE, p))
        t += SEC_PER_PHONE
    items.append((t, t + SIL, "sil"))
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0.0", f"xmax = {t + SIL}", "tiers? <exists>", "size = 1",
             "item []:", "\titem [1]:", '\t\tclass = "IntervalTier"',
             '\t\tname = "phones"', "\t\txmin = 0.0", f"\t\txmax = {t + SIL}",
             f"\t\tintervals: size = {len(items)}"]
    for i, (s, e, p) in enumerate(items):
        lines += [f"\t\tintervals [{i + 1}]:", f"\t\t\txmin = {s}",
                  f"\t\t\txmax = {e}", f'\t\t\ttext = "{p}"']
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _lang_acfg():
    acfg = C.load_algorithm_config(os.path.join(ROOT, "config", "algorithm",
                                                "meta_lang_codebook.yaml"))
    acfg["adapt"]["phoneme_emb"]["representation_dim"] = 8
    acfg["adapt"]["train"].update(shots=2, queries=2, steps=2, meta_batch_size=EPISODES)
    acfg["adapt"]["test"].update(shots=2, queries=1, steps=10, saving_steps=[5, 10])
    return acfg


def _train_cfg(**steps):
    # eps 1e-4: Adam's first step moves a parameter by lr * g / (|g| + eps),
    # whose slope in g is at most 1 / eps; with the configs' 1e-9 a gradient
    # that is 0 up to rounding (a conv bias before a batch-statistics
    # BatchNorm) moves its parameter by up to lr in a direction the rounding
    # sets.  At 1e-4 the gradients' agreement (a few 1e-8 at most) carries
    # over to the new parameters
    tcfg = copy.deepcopy(tiny_train_cfg())
    tcfg["optimizer"]["eps"] = 1e-4
    tcfg["step"].update(steps)
    tcfg.update(distributed="off")
    return tcfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The LibriTTS-layout corpus through ``prepare_align`` and the port's
    ``Preprocessor`` with representations -> (preprocess config, stats)."""
    root = str(tmp_path_factory.mktemp("lang"))
    rng = np.random.RandomState(0)
    pcfg = C.deep_merge(tiny_preprocess_cfg(), {
        "dataset": "LibriTTS",
        "path": {"corpus_path": os.path.join(root, "corpus"),
                 "raw_path": os.path.join(root, "raw"),
                 "preprocessed_path": os.path.join(root, "pp")},
        "preprocessing": {"representation": {"enabled": True}},
        "subsets": {"train": "train-clean-100", "val": "train-clean-100",
                    "test": "train-clean-100"}})
    for s, spk in enumerate(SPEAKERS):
        for u in range(4):
            base = f"{spk}_1240_{u:06d}_000000"
            phones = [PHONES[i] for i in rng.randint(0, len(PHONES), rng.randint(5, 9))]
            n = int(SR_IN * (2 * SIL + SEC_PER_PHONE * len(phones)))
            t = np.arange(n) / SR_IN
            f0 = 110.0 + 60.0 * s
            wav = 0.5 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(4 * np.pi * f0 * t)
            wav *= 0.3 + 0.7 * np.abs(np.sin(np.pi * (u + 2) * t))
            wav += 0.01 * rng.randn(n)
            d = os.path.join(root, "corpus", "train-clean-100", spk, "1240")
            os.makedirs(d, exist_ok=True)
            save_wav(os.path.join(d, base + ".wav"), (0.6 * wav).astype(np.float32), SR_IN)
            with open(os.path.join(d, base + ".normalized.txt"), "w") as f:
                f.write(f"Hello world, number {u}.\n")
            _textgrid(os.path.join(root, "pp", "TextGrid", spk, base + ".TextGrid"), phones)
    assert prepare_align(pcfg) == 2 * 4
    Preprocessor(pcfg, device="cpu").build_from_path()
    with open(os.path.join(root, "pp", "stats.json")) as f:
        stats = json.load(f)
    return pcfg, stats, root


# ---------------------------------------------------------------- codebook

def _codebook(rng, attention, size=16, d=32, d_feat=8):
    p = {"emb_banks": rng.randn(size, d).astype(np.float32)}
    if attention == "hard":
        p["att_banks"] = rng.randn(size, d_feat).astype(np.float32)
        p["att_banks"][5] = p["att_banks"][3]                 # a tie
    else:
        p["att_banks"] = rng.randn(size, d).astype(np.float32)
        for name, d_in in (("w_qs", d_feat), ("w_ks", d)):
            p[name] = {"w": (rng.uniform(-1, 1, (d_in, d)) / np.sqrt(d_in)).astype(np.float32),
                       "b": (0.1 * rng.randn(d)).astype(np.float32)}
    return p


def _port_codebook(p):
    out = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()
           if not isinstance(v, dict)}
    for name in ("w_qs", "w_ks"):
        if name in p:
            out[f"{name}.weight"] = torch.from_numpy(p[name]["w"].T.copy()).requires_grad_()
            out[f"{name}.bias"] = torch.from_numpy(p[name]["b"]).requires_grad_()
    return out


@pytest.mark.parametrize("attention", ["hard", "soft"])
def test_get_new_embedding_matches_jax(attention):
    """The table (zero ``ref`` rows, a non-zero PAD row and, for hard
    attention, two equal banks that a row matches exactly) and the gradient
    of a weighted sum of it with respect to every codebook tensor."""
    rng = np.random.RandomState(3)
    p = _codebook(rng, attention)
    ref = rng.randn(VOCAB, 8).astype(np.float32)
    ref[rng.rand(VOCAB) < 0.5] = 0.0
    ref[0] = rng.randn(8)                                     # PAD, zeroed anyway
    if attention == "hard":
        ref[7] = 2.0 * p["att_banks"][3]                      # ties banks 3 and 5
    w = rng.randn(VOCAB, 32).astype(np.float32)

    new = jax.jit(lambda q: jax_new_embedding(q, jnp.asarray(ref), attention))
    table_r = np.asarray(new(p))
    grads_r = jax.jit(jax.grad(lambda q: jnp.sum(new(q) * w)))(p)
    tp = _port_codebook(p)
    table = get_new_embedding(tp, torch.from_numpy(ref), attention)
    assert table.shape == (VOCAB, 32) and table.dtype == torch.float32
    np.testing.assert_allclose(table.detach().numpy(), table_r, atol=1e-6, rtol=0)
    assert not table[0].any() and not table_r[0].any()
    if attention == "hard":
        zero = np.flatnonzero(np.abs(ref).sum(1) == 0)
        assert not table[torch.from_numpy(zero)].any()
        np.testing.assert_array_equal(table[7].detach().numpy(), p["emb_banks"][3])
    got = torch.autograd.grad((table * torch.from_numpy(w)).sum(), list(tp.values()),
                              allow_unused=True)
    ref_grads = {k: np.asarray(v) for k, v in grads_r.items() if not isinstance(v, dict)}
    for name in ("w_qs", "w_ks"):
        if name in grads_r:
            ref_grads[f"{name}.weight"] = np.asarray(grads_r[name]["w"]).T
            ref_grads[f"{name}.bias"] = np.asarray(grads_r[name]["b"])
    largest = max(np.abs(r).max() for r in ref_grads.values())
    for (name, _), g in zip(tp.items(), got):
        g = np.zeros_like(ref_grads[name]) if g is None else g.numpy()
        r = ref_grads[name]
        # softmax is invariant to w_ks.bias (it shifts a row of scores by
        # one constant): its gradient is 0 up to rounding, held to 1e-5 of
        # the codebook's largest gradient
        scale = largest if name == "w_ks.bias" else np.abs(r).max()
        assert np.abs(g - r).max() <= 1e-5 * scale, name
    if attention == "hard":                  # the pick carries no gradient
        assert got[list(tp).index("att_banks")] is None and not ref_grads["att_banks"].any()


# ------------------------------------------------------------ lang episodes

def _samples(rng, n, with_rep=True):
    out = []
    for _ in range(n):
        text = rng.randint(1, 12, rng.randint(3, 8)).astype(np.int32)
        s = {"text": text}
        if with_rep:
            s["representation"] = rng.randn(len(text) - rng.randint(0, 2), 5).astype(np.float32)
        out.append(s)
    return out


def test_episode_phoneme_representation_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    samples = _samples(rng, 5)
    os.makedirs(tmp_path / "representation")
    np.save(tmp_path / "representation" / "spk-representation-utt.npy",
            samples[0]["representation"])
    for spk in ("spk", "other"):
        got, ref = (f(str(tmp_path), spk, "utt") for f in (le.load_representation,
                                                           jle.load_representation))
        assert (got is None) == (ref is None) == (spk == "other")
        if got is not None:
            np.testing.assert_array_equal(got, ref)
    samples[2] = {"text": samples[2]["text"]}                 # no representation
    for d_feat in (None, 5):
        got = le.episode_phoneme_representation(samples, d_feat)
        ref = jle.episode_phoneme_representation(samples, d_feat)
        assert got.dtype == np.float32 and got.shape == (VOCAB, 5)
        np.testing.assert_array_equal(got, ref)
    bare = [{"text": s["text"]} for s in samples]
    with pytest.raises(ValueError) as e_ref:
        jle.episode_phoneme_representation(bare)
    with pytest.raises(ValueError) as e_got:
        le.episode_phoneme_representation(bare)
    assert str(e_got.value) == str(e_ref.value)


def test_assign_support_query_matches_jax():
    """Feasible pools (the same split) and an infeasible one (every
    utterance has a phoneme of its own: the same ValueError)."""
    rng = np.random.RandomState(5)
    feasible = 0
    for _ in range(20):
        pool = _samples(rng, 6, with_rep=False)
        try:
            ref = jle.assign_support_query(pool, 3, 3)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                le.assign_support_query(pool, 3, 3)
            continue
        got = le.assign_support_query(pool, 3, 3)
        assert got == ref
        feasible += 1
        sup_phones = {int(p) for i in got[0] for p in pool[i]["text"]}
        assert all(int(p) in sup_phones for i in got[1] for p in pool[i]["text"])
    assert 0 < feasible < 20
    unique = [{"text": np.array([10 * i + 1, 10 * i + 2], np.int32)} for i in range(4)]
    with pytest.raises(ValueError) as e_ref:
        jle.assign_support_query(unique, 2, 2)
    with pytest.raises(ValueError) as e_got:
        le.assign_support_query(unique, 2, 2)
    assert str(e_got.value) == str(e_ref.value) and "infeasible" in str(e_got.value)


def test_split_disjoint_phonemes_matches_jax():
    rng = np.random.RandomState(6)
    sup, qry = _samples(rng, 3, with_rep=False), _samples(rng, 3, with_rep=False)
    for seed in (None, 1, 2):
        mk = lambda: None if seed is None else np.random.RandomState(seed)
        got, ref = le.split_disjoint_phonemes(sup, qry, mk()), jle.split_disjoint_phonemes(
            sup, qry, mk())
        for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(a, b)
        kept_s = {int(p) for s, m in zip(sup, got[0]) for p in s["text"][m]}
        kept_q = {int(p) for s, m in zip(qry, got[1]) for p in s["text"][m]}
        assert not kept_s & kept_q


def _datamodules(pcfg, acfg, root):
    out = []
    for side, cls in (("port", MetaDataModule), ("jax", JaxMetaDM)):
        dm = cls([pcfg], _train_cfg(), acfg, log_dir=os.path.join(root, "log", side))
        dm.setup()
        out.append(dm)
    return out


def test_lang_episode_batches_match_jax(corpus):
    """Three draws of 2 episodes: the batches, the metas and ``phn_ref``
    exactly as the JAX package's; every query phoneme in its episode's
    support; ``phn_ref`` the host recomputation; and the same error when
    ``representation_dim`` disagrees with the corpus."""
    pcfg, _, root = corpus
    acfg = _lang_acfg()
    dm, jdm = _datamodules(pcfg, acfg, root)
    got, ref = dm.train_episode_batches(EPISODES), jdm.train_episode_batches(EPISODES)
    index = {b: i for i, b in enumerate(dm.train_set.basename)}
    covered = 0
    for _ in range(3):
        a, b = next(got), next(ref)
        assert len(a) == len(b) == 5
        for x, y in zip(a[:2], b[:2]):
            for name, u, v in zip(x._fields, x, y):
                assert (u is None) == (v is None), name
                if u is not None:
                    np.testing.assert_array_equal(u.numpy(), np.asarray(v), err_msg=name)
        assert [m.ids for m in a[2] + a[3]] == [m.ids for m in b[2] + b[3]]
        assert isinstance(a[4], torch.Tensor) and a[4].device.type == "cpu"
        assert a[4].shape == (EPISODES, VOCAB, 8)
        np.testing.assert_array_equal(a[4].numpy(), np.asarray(b[4]))
        for e in range(EPISODES):
            sup_ids = set(a[0].texts[e][a[0].texts[e] > 0].tolist())
            if set(a[1].texts[e][a[1].texts[e] > 0].tolist()) <= sup_ids:
                covered += 1
            else:       # no re-split covers the query: the sampler's split stays
                pool = [dm.train_set[index[i]] for i in a[2][e].ids + a[3][e].ids]
                with pytest.raises(ValueError, match="infeasible"):
                    le.assign_support_query(pool, 2, 2)
            rows = a[4][e].abs().sum(1) > 0
            assert set(torch.nonzero(rows).flatten().tolist()) == sup_ids
    assert covered >= 3
    bad = copy.deepcopy(acfg)
    bad["adapt"]["phoneme_emb"]["representation_dim"] = 256
    dm, jdm = _datamodules(pcfg, bad, root)
    with pytest.raises(ValueError) as e_ref:
        next(jdm.train_episode_batches(EPISODES))
    with pytest.raises(ValueError) as e_got:
        next(dm.train_episode_batches(EPISODES))
    assert str(e_got.value) == str(e_ref.value)


# ------------------------------------------------------------- meta step

def _jax_params(pcfg, mcfg, acfg, stats):
    params, state = fs2_params(pcfg, mcfg, acfg, stats, len(SPEAKERS))
    rng = np.random.RandomState(7)
    size = acfg["adapt"]["phoneme_emb"]["size"]
    params["phn_emb_generator"] = {
        "emb_banks": rng.randn(size, mcfg["transformer"]["encoder_hidden"]).astype(np.float32),
        "att_banks": rng.randn(size, 8).astype(np.float32)}
    return params, state


@pytest.fixture(scope="module")
def stepped(corpus):
    """One lang meta step (E=2, hard codebook, custom_hvp) on an episode
    batch of the port's datamodule, on both sides from the same weights:
    the JAX ``_meta_train_step`` with a transformation ahead of its
    optimizer that keeps the gradient in the optimizer state, and the
    port's ``_meta_train_step`` then ``apply_updates``."""
    pcfg, stats, root = corpus
    mcfg = tiny_model_cfg(max_seq_len=128)
    acfg = _lang_acfg()
    params, state = _jax_params(pcfg, mcfg, acfg, stats)
    dm = MetaDataModule([pcfg], _train_cfg(), acfg, log_dir=os.path.join(root, "log", "step"))
    dm.setup()
    sup, qry, _, _, phn_ref = next(dm.train_episode_batches(EPISODES))

    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    jsys = JaxMetaSystem.__new__(JaxMetaSystem)
    jsys.acfg = acfg
    jsys.adaptor = JaxAdaptor(pcfg, mcfg, acfg)
    jsys.tx = optax.chain(keep, make_optimizer(mcfg, _train_cfg())[0])
    jp = jax.tree.map(jnp.asarray, params)
    to_j = lambda b: jcollate.Batch(*(None if t is None else jnp.asarray(t.numpy()) for t in b))
    new_params, opt_state, losses_r = jax.jit(jsys._meta_train_step)(
        jp, jax.tree.map(jnp.asarray, state), jsys.tx.init(jp), to_j(sup), to_j(qry),
        jax.random.PRNGKey(0), jnp.asarray(phn_ref.numpy()))

    system = MetaSystem(pcfg, mcfg, _train_cfg(), acfg, stats, len(SPEAKERS), device="cpu")
    load_fs2_from_jax(system.model, params, state)
    before = {n: p.detach().clone() for n, p in system.params.items()}
    losses, grads = system._meta_train_step(sup, qry, 0, phn_ref)
    system.apply_updates(grads)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(system=system, before=before, losses=losses, grads=grads,
                losses_r=losses_r, grads_r=fs2_state_dict_from_jax(np_tree(opt_state[0]), state),
                new_r=fs2_state_dict_from_jax(np_tree(new_params), state), params=params,
                state=state, mcfg=mcfg, acfg=acfg, lr=float(make_optimizer(
                    mcfg, _train_cfg())[1](0)), sup=sup, phn_ref=phn_ref)


def test_lang_meta_train_step_matches_jax(stepped):
    """The losses, the meta-gradient (the codebook's included) and the new
    parameters against the JAX step; ``emb_banks`` rows that no episode's
    table picks get a gradient of exactly 0 and stay; the original phoneme
    table gets none and its Adam moments stay 0."""
    s = stepped
    system = s["system"]
    for name, a, b in zip(s["losses"]._fields, s["losses"], s["losses_r"]):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, err_msg=name)
    grads = {n: np.zeros(p.shape, np.float32) if s["grads"][n] is None
             else s["grads"][n].numpy() for n, p in system.params.items()}
    ref = {n: s["grads_r"][n].numpy() for n in grads}
    # relative L2 over the whole gradient: some tensors' gradients are 0 up
    # to rounding (attention is invariant to the key bias), so they are
    # held against the gradient's norm, not their own
    num = sum(float(((grads[n] - ref[n]).astype(np.float64) ** 2).sum()) for n in grads)
    den = sum(float((ref[n].astype(np.float64) ** 2).sum()) for n in grads)
    assert np.sqrt(num / den) <= 1e-4
    codebook = "phn_emb_generator.emb_banks"
    assert np.abs(grads[codebook] - ref[codebook]).max() <= 1e-4 * np.abs(ref[codebook]).max()
    for n, p in system.params.items():
        new, new_r = p.detach().numpy(), s["new_r"][n].numpy()
        assert np.abs(new - new_r).max() <= 1e-4 * np.abs(new_r).max(), n
    assert s["grads"]["encoder.src_word_emb.weight"] is None
    opt = system.optimizer
    assert not opt.mu["encoder.src_word_emb.weight"].any()
    assert not opt.nu["encoder.src_word_emb.weight"].any()
    # the rows the hard codebook picks: each support phoneme's nearest bank
    g_emb = s["grads_r"]["phn_emb_generator.emb_banks"].numpy()
    att = system.params["phn_emb_generator.att_banks"].detach()
    picked = set()
    for e in range(EPISODES):
        ref = s["phn_ref"][e]
        rows = torch.nonzero(ref.abs().sum(1) > 0).flatten()
        rows = rows[rows > 0]
        sim = torch.nn.functional.normalize(ref[rows], dim=1) @ torch.nn.functional.normalize(
            att, dim=1).T
        picked |= set(sim.argmax(1).tolist())
    unpicked = sorted(set(range(g_emb.shape[0])) - picked)
    assert picked and unpicked
    assert not g_emb[unpicked].any() and not s["grads"]["phn_emb_generator.emb_banks"][
        unpicked].any()
    assert np.abs(g_emb[sorted(picked)]).sum(1).min() > 0
    moved = (system.params["phn_emb_generator.emb_banks"].detach()
             != s["before"]["phn_emb_generator.emb_banks"]).any(1)
    assert set(torch.nonzero(moved).flatten().tolist()) == picked


# ------------------------------------------------------------ checkpoints

def _jnp(tree):
    """A numpy tree as jnp arrays, its dicts' key order kept (``jax.tree.map``
    sorts it, and a surgery report follows the order)."""
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jnp(v) for v in tree]
    return jnp.asarray(tree)


def test_lang_checkpoints_cross_packages(stepped, corpus, tmp_path, capsys):
    """A lang system's checkpoint, the codebook and its Adam moments
    included, read by the JAX ``load_checkpoint`` and written back by its
    ``save_checkpoint`` into a fresh port system, bit for bit; a lang
    checkpoint into a model without the codebook drops it silently (the
    optimizer state kept), a checkpoint without it into a lang system keeps
    the init with the JAX package's report and drops the optimizer state;
    ``SynthesisEngine.from_checkpoint`` loads a lang checkpoint."""
    s = stepped
    pcfg, stats, _ = corpus
    system, mcfg, acfg = s["system"], s["mcfg"], s["acfg"]
    path = str(tmp_path / "lang.ckpt")
    ck.save_checkpoint(path, system.model, 1, system.optimizer)
    tx = make_optimizer(mcfg, _train_cfg())[0]
    like_p = _jnp(s["params"])      # the codebook's keys in the JAX init's order
    like_s = jax.tree.map(jnp.asarray, s["state"])
    jp, js, jopt, step, report = jck.load_checkpoint(path, like_p, like_s, tx.init(like_p))
    assert report == [] and step == 1 and jopt is not None
    sd = fs2_state_dict_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    for k, v in system.model.state_dict().items():
        assert torch.equal(sd[k], v.cpu()), k
    mu = jopt[1].mu["phn_emb_generator"]
    assert np.array_equal(np.asarray(mu["emb_banks"]),
                           system.optimizer.mu["phn_emb_generator.emb_banks"].numpy())
    assert np.asarray(mu["emb_banks"]).any()

    back = str(tmp_path / "back.ckpt")
    jck.save_checkpoint(back, jp, js, jopt, 1)
    fresh = MetaSystem(pcfg, mcfg, _train_cfg(), acfg, stats, len(SPEAKERS), seed=5,
                       device="cpu")
    opt_state, step, report = ck.load_checkpoint(back, fresh.model)
    assert report == [] and step == 1
    fresh.optimizer.load_state_tree(opt_state, fresh.model)
    for n, p in system.params.items():
        assert torch.equal(fresh.params[n], p), n
        for m in ("mu", "nu"):
            assert torch.equal(getattr(fresh.optimizer, m)[n], getattr(system.optimizer, m)[n])
    assert fresh.optimizer.count == system.optimizer.count == 1

    # surgery both ways, against the JAX package's reports
    spk_acfg = copy.deepcopy(acfg)
    spk_acfg["adapt"].update(type="spk", phoneme_emb={"type": "embedding", "refresh": False})
    plain = MetaSystem(pcfg, mcfg, _train_cfg(), spk_acfg, stats, len(SPEAKERS), device="cpu")
    assert not any(n.startswith("phn_emb_generator") for n in plain.params)
    opt_state, _, report = ck.load_checkpoint(path, plain.model)
    plain_like = {k: v for k, v in like_p.items() if k != "phn_emb_generator"}
    *_, jreport = jck.load_checkpoint(path, plain_like, like_s, tx.init(plain_like))
    assert report == jreport == [] and opt_state is not None
    plain.optimizer.load_state_tree(opt_state, plain.model)
    for n, p in plain.params.items():
        assert torch.equal(p, system.params[n]), n
    plain_path = str(tmp_path / "plain.ckpt")
    ck.save_checkpoint(plain_path, plain.model, 1, plain.optimizer)
    init = {n: p.detach().clone() for n, p in fresh.params.items()}
    opt_state, _, report = ck.load_checkpoint(plain_path, fresh.model)
    *_, jreport = jck.load_checkpoint(plain_path, like_p, like_s, tx.init(like_p))
    assert report == jreport == ["missing /phn_emb_generator/emb_banks: kept init",
                                 "missing /phn_emb_generator/att_banks: kept init"]
    assert opt_state is None
    for n in ("phn_emb_generator.emb_banks", "phn_emb_generator.att_banks"):
        assert torch.equal(fresh.params[n], init[n])

    capsys.readouterr()
    engine = SynthesisEngine.from_checkpoint(path, pcfg, mcfg, acfg, stats, len(SPEAKERS),
                                             device="cpu")
    assert "[ckpt surgery]" not in capsys.readouterr().out
    assert not hasattr(engine.model, "phn_emb_generator")
    for k, v in engine.model.state_dict().items():
        assert torch.equal(v, system.model.state_dict()[k]), k


# ------------------------------------------------------------------- CLI

def test_train_cli_lang_on_cpu(corpus, tmp_path):
    """``-s train --device cpu`` with config/algorithm/meta_lang_codebook.yaml
    (cut as above) on the tiny model: 2 steps of lang episodes, whose
    checkpoint carries the codebook, moved, and its Adam moments."""
    from metatts_torch.__main__ import main, parse_args
    pcfg, _, _ = corpus
    tcfg = _train_cfg(total_step=2, log_step=1, val_step=100, save_step=2)
    main(parse_args(["-s", "train", "--output_dir", str(tmp_path), "-e", "lang",
                     "--no_synth", "--device", "cpu"]),
         ([pcfg], tiny_model_cfg(max_seq_len=128), tcfg, _lang_acfg()))
    assert sorted(os.listdir(tmp_path / "ckpt" / "lang")) == ["last.ckpt", "step_2.ckpt"]
    with open(tmp_path / "log" / "lang" / "train.csv") as f:
        rows = [line.strip().split(",") for line in f][1:]
    assert [r[0] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(v)) for r in rows for v in r[1:])
    with open(tmp_path / "ckpt" / "lang" / "last.ckpt", "rb") as f:
        raw = ck.msgpack_restore(f.read())
    codebook = raw["params"]["phn_emb_generator"]
    assert sorted(codebook) == ["att_banks", "emb_banks"]
    assert codebook["emb_banks"].shape == (128, 32)
    assert np.asarray(raw["opt_state"]["1"]["mu"]["phn_emb_generator"]["emb_banks"]).any()
    init = MetaSystem(pcfg, tiny_model_cfg(max_seq_len=128), tcfg, _lang_acfg(),
                      None, len(SPEAKERS), device="cpu").params
    assert not np.array_equal(codebook["emb_banks"],
                              init["phn_emb_generator.emb_banks"].detach().numpy())
