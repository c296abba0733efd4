"""Port: the synthetic corpus (``metatts_torch/data/synthetic.py``) and the
meta-vs-baseline experiments (``metatts_torch/experiments/``) against the
JAX package's ``data/synthetic.py``, ``tools/exp_meta_advantage.py`` and
``tools/exp_meta_eer.py``, on the CPU at tiny sizes (hidden 16, 1 + 1
layers, 4 mels, 8-phone / 24-frame utterances).

* The corpus: both packages sample with numpy's ``RandomState``, so every
  array of ``utterance``, ``batch``, ``episode`` and ``meta_batch`` is equal
  bit for bit, for two seeds.
* The vocoder: the non-negative pseudo-inverse of the mel basis (the lift)
  bit for bit; the lifted magnitudes rtol 1e-5 (``exp`` and the 4-term sum
  round differently in numpy and torch); the wavs from the JAX package's
  initial phases atol 1e-4 after peak normalisation
  (``tests/test_torch_melspec.py``'s Griffin-Lim bound), 2 iterations at
  n_fft 256.
* ``run_experiment`` with the baseline arm alone, 2 outer steps, saving
  steps (1, 2), from the JAX package's initial weights (converted by
  ``metatts_torch/convert.py``), dropout off on both sides: traces, probe
  losses (with the BatchNorm statistics of the first probe, as the JAX
  script's jitted probe keeps them) and summary rtol 1e-4.
* The episodic draws of a two-arm run equal those the JAX script's loop
  makes with the JAX corpus; the meta arm's trace equals a fresh
  ``MetaSystem.train_step`` on them (``tests/test_torch_train.py`` holds
  that step against JAX), so no second-order JAX program is compiled here.
* ``_synthesize_result_tree``: the file names and ``test_descriptions.json``
  of the JAX script's, byte for byte.
* ``run_eer_experiment`` at a tiny configuration runs to its end with the
  JAX run's ``eer.txt`` row labels, and ``rescore`` rewrites the same
  ``eer.txt``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import metatts_tpu.models.nn as jnn
from metatts_tpu.data import synthetic as jsyn
from metatts_torch.convert import load_fs2_from_jax
from metatts_torch.data import synthetic as tsyn
from metatts_torch.experiments import meta_advantage as tma
from metatts_torch.experiments import meta_eer as teer
from metatts_torch.models import nn as tnn

from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import exp_meta_advantage as jma  # noqa: E402
import exp_meta_eer as jeer  # noqa: E402

CORPUS = dict(vocab=12, L=8, T=24)
RUN = dict(outer_steps=2, n_train=4, n_test=1, n_mels=4, shots=2, queries=2,
           meta_batch=2, inner_steps=1, saving_steps=(1, 2),
           episodes_per_speaker=2, eval_queries=2, hidden=16, layers=1, seed=0,
           log_every=1, verbose=False, corpus_kwargs=CORPUS, keep_systems=True)
REL = 1e-4


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same_batch(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _check_corpus(seed):
    j = jsyn.SyntheticVoices(6, n_mels=4, seed=seed, **CORPUS)
    t = tsyn.SyntheticVoices(6, n_mels=4, seed=seed, **CORPUS)
    for name in ("proto", "base_p", "base_e", "base_d", "tilt", "pitch_off",
                 "energy_off", "dur_rate"):
        assert np.array_equal(getattr(j, name), getattr(t, name)), name
    rj, rt = np.random.RandomState(seed + 1), np.random.RandomState(seed + 1)
    uj, ut = j.utterance(3, rj), t.utterance(3, rt)
    assert uj.keys() == ut.keys()
    for k in uj:
        assert np.array_equal(uj[k], ut[k]), k
    _same_batch(j.batch([0, 5, 2], rj), t.batch([0, 5, 2], rt))
    for a, b in zip(j.episode(4, 2, 3, rj), t.episode(4, 2, 3, rt)):
        _same_batch(a, b)
    for a, b in zip(j.meta_batch([1, 2], 2, 3, rj), t.meta_batch([1, 2], 2, 3, rt)):
        _same_batch(a, b)
    assert np.array_equal(rj.randint(1 << 30, size=4), rt.randint(1 << 30, size=4))


def _check_vocoder():
    kw = dict(n_mels=4, n_fft=256, hop=128, n_iters=2, seed=0)
    jv, tv = jsyn.SyntheticMelVocoder(**kw), tsyn.SyntheticMelVocoder(**kw, device="cpu")
    assert np.array_equal(jv._inv, tv._inv.numpy())
    batch = jsyn.SyntheticVoices(3, n_mels=4, seed=0, **CORPUS).batch(
        [0, 1, 2], np.random.RandomState(0))
    mels, lens = np.asarray(batch.mels), np.asarray(batch.mel_lens)
    mags = np.einsum("fm,btm->bft", jv._inv, np.exp(np.clip(mels, -10.0, 6.0)))
    np.testing.assert_allclose(tv.magnitudes(mels).numpy(), mags, rtol=1e-5, atol=0)
    angles = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mags.shape,
                                           minval=-np.pi, maxval=np.pi))
    want, got = jv(mels, lens), tv(mels, lens, angles=angles)
    assert [len(w) for w in got] == [len(w) for w in want] == list(lens * tv.hop)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        assert abs(np.abs(g).max() - 0.9) < 1e-6
    own = tv(mels, lens)
    assert all(np.isfinite(w).all() for w in own)


def _baseline_runs():
    """The baseline arm through both scripts from the JAX package's initial
    weights, dropout off on both sides; also the port's result tree inputs."""
    inits = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "dropout", lambda rng, x, rate, train: x)
        mp.setattr(tnn, "dropout", lambda x, rate, train, generator: x)
        import metatts_tpu.algorithms as jalg
        j_get, t_get = jalg.get_system, tma.get_system

        def j_make(name):
            def make(*a, **kw):
                s = j_get(name)(*a, **kw)
                inits[name] = (jax.device_get(s.params), jax.device_get(s.state))
                return s
            return make

        def t_make(name):
            def make(*a, **kw):
                s = t_get(name)(*a, **kw)
                load_fs2_from_jax(s.model, *inits[name])
                return s
            return make

        mp.setattr(jalg, "get_system", j_make)
        j_out = jma.run_experiment(algorithms=("baseline",), **RUN)
        mp.setattr(tma, "get_system", t_make)
        t_out = tma.run_experiment(algorithms=("baseline",), device="cpu", **RUN)
    return j_out, t_out


def _check_baseline_arm(j_out, t_out):
    np.testing.assert_allclose(t_out["traces"]["baseline"], j_out["traces"]["baseline"],
                               rtol=REL)
    jp, tp = (np.asarray(o["traces"]["baseline_plain"]) for o in (j_out, t_out))
    assert np.array_equal(jp[:, 0], tp[:, 0])
    np.testing.assert_allclose(tp[:, 1], jp[:, 1], rtol=REL)
    assert t_out["summary"].keys() == j_out["summary"].keys()
    for ft, want in j_out["summary"]["baseline"].items():
        got = t_out["summary"]["baseline"][ft]
        assert got["n"] == want["n"]
        np.testing.assert_allclose([got["mean"], got["std"]], [want["mean"], want["std"]],
                                   rtol=REL, atol=REL * want["mean"])
    assert t_out["config"].keys() == j_out["config"].keys()
    assert {k for k in t_out if k.startswith("_")} == {k for k in j_out if k.startswith("_")}


def _check_episodic_draws():
    """Two arms, 2 outer steps: every draw equals the JAX script's, and the
    meta arm's trace equals a fresh ``MetaSystem.train_step`` on them."""
    from metatts_torch.algorithms.baseline import BaselineSystem
    from metatts_torch.algorithms.meta import MetaSystem
    seen = []
    meta_step, base_step = MetaSystem.train_step, BaselineSystem.train_step
    run = {**RUN, "keep_systems": False, "saving_steps": (1,), "n_test": 1,
           "episodes_per_speaker": 1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MetaSystem, "train_step",
                   lambda self, s, q: seen.append(("meta", s, q)) or meta_step(self, s, q))
        mp.setattr(BaselineSystem, "train_step",
                   lambda self, b: seen.append(("baseline", b)) or base_step(self, b))
        out = tma.run_experiment(device="cpu", **run)

    corpus = jsyn.SyntheticVoices(5, n_mels=4, seed=0, **CORPUS)
    rng = np.random.RandomState(1)
    want = []
    for _ in range(2):
        spk = rng.choice(range(4), size=2, replace=False)
        want.append(("meta",) + corpus.meta_batch(spk, 2, 2, rng))
        want.append(("baseline", corpus.batch(list(rng.choice(range(4), size=8)), rng)))
    assert [w[0] for w in want] == [s[0] for s in seen]
    for w, s in zip(want, seen):
        for a, b in zip(w[1:], s[1:]):
            _same_batch(a, b)

    pcfg, mcfg, tcfg, acfg = tma._configs(4, 1, 0.001, 0.001, 2, 2, 2, (1,), hidden=16)
    acfg["type"] = "meta"
    fresh = MetaSystem(pcfg, mcfg, tcfg, acfg, stats=tsyn.STATS, n_speakers=5, seed=7,
                       device="cpu")
    again = [float(fresh.train_step(s[1], s[2]).total) for s in seen if s[0] == "meta"]
    assert again == out["traces"]["meta"]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _check_result_tree(j_out, t_out, tmp_path):
    jv = jsyn.SyntheticMelVocoder(n_mels=4, n_iters=1, seed=0)
    tv = tsyn.SyntheticMelVocoder(n_mels=4, n_iters=1, seed=0, device="cpu")
    # durations of ~2 frames a phone: after 2 outer steps the predictor
    # gives 0, an empty wav, which the JAX vocoder cannot normalise
    j_sys, t_sys = j_out["_systems"]["baseline"], t_out["_systems"]["baseline"]
    lin = j_sys.params["variance_adaptor"]["duration_predictor"]["linear"]
    lin["b"] = jnp.full_like(lin["b"], np.log(3.0))
    with torch.no_grad():
        t_sys.model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
            float(np.float32(np.log(3.0))))
    for pkg, out, voc, fn in (("jax", j_out, jv, jeer._synthesize_result_tree),
                              ("torch", t_out, tv, teer._synthesize_result_tree)):
        fn(out["_systems"]["baseline"], voc, out["_episodes"],
           str(tmp_path / pkg / "result"), str(tmp_path / pkg / "log"),
           out["_episode_speakers"], verbose=False)
    names = _tree(tmp_path / "jax")
    assert names == _tree(tmp_path / "torch")
    assert "result/audio/Testing/step_last/test_001/qry01.step_last-FTstep_2.synth.wav" in names
    for rel in ("log/test_descriptions.json",):
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "torch" / rel).read_bytes()


def _labels(path):
    with open(path) as f:
        return [line.split()[0] for line in f if len(line.split()) == 2]


def _check_eer_run(tmp_path):
    # the duration predictor's bias starts at log 3, so that systems trained
    # for one step predict ~2 frames a phone, not none (an empty wav has no
    # d-vector)
    get = tma.get_system

    def make(name):
        def build(*a, **kw):
            s = get(name)(*a, **kw)
            with torch.no_grad():
                s.model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
                    float(np.log(3.0)))
            return s
        return build
    out_dir = str(tmp_path / "eer")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tma, "get_system", make)
        result = teer.run_eer_experiment(
            out_dir=out_dir, outer_steps=1, n_train=4, n_test=2, n_mels=4, hidden=16,
            saving_steps=(1, 2), episodes_per_speaker=1, eval_queries=2,
            ge2e_hidden=16, ge2e_steps=2, ge2e_utts=2, ge2e_spk_per_batch=4,
            ge2e_utt_per_spk=2, enroll_utts=2, gl_iters=1, verbose=False, device="cpu",
            shots=2, queries=2, meta_batch=2, inner_steps=1, corpus_kwargs=CORPUS)
    with open(os.path.join(ROOT, "examples", "meta_advantage_eer", "results.json")) as f:
        jax_result = json.load(f)
    assert result.keys() == jax_result.keys()
    assert result["config"].keys() == jax_result["config"].keys()
    # the JAX run's labels at the FT steps this run saves
    jax_labels = [lab for lab in _labels(os.path.join(
        ROOT, "examples", "meta_advantage_eer", "eval", "eer.txt"))
        if "FTstep" not in lab or lab.split("FTstep")[1].split("_")[0] in ("0", "5", "10")]
    eer_path = os.path.join(out_dir, "eval", "eer.txt")
    got = [lab.replace("FTstep1", "FTstep5").replace("FTstep2", "FTstep10")
           for lab in _labels(eer_path)]
    assert got == jax_labels
    for name in ("meta", "baseline"):
        assert set(result["eer_table"][name]) == {0, 1, 2}
        assert all(np.isfinite(v) for v in result["eer_table"][name].values())
        assert os.path.exists(os.path.join(out_dir, f"ckpt_{name}.msgpack"))
    assert np.isfinite(result["real_eer"])
    with open(eer_path, "rb") as f:
        first = f.read()
    again = teer.rescore(out_dir, verbose=False, device="cpu")
    with open(eer_path, "rb") as f:
        assert f.read() == first
    assert json.loads(json.dumps(again["eer_table"])) == json.loads(
        json.dumps(result["eer_table"]))


def test_synthetic_corpus_and_experiments_match_jax(tmp_path):
    """Every check of the module docstring, in one test: pytest-xdist's
    ``--dist loadfile`` queues the files with the most tests first, so a
    file of one test runs after the suite's longest single test has
    started instead of ahead of it."""
    for seed in (0, 5):
        _check_corpus(seed)
    _check_vocoder()
    j_out, t_out = _baseline_runs()
    _check_baseline_arm(j_out, t_out)
    _check_episodic_draws()
    _check_result_tree(j_out, t_out, tmp_path / "trees")
    _check_eer_run(tmp_path)
