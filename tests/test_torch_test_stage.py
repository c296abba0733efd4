"""Port: the test stage (``System.test_adapt*``, ``Trainer.test``,
``SynthesisEngine.adapt_speaker`` / ``from_checkpoint``, the CLI's
``predict``) against the JAX package, at the tiny config of tests/helpers.py
(fp32, hidden 32, 1 + 1 layers, test steps 10, saving steps [5, 10]) with
1-shot / 1-query tasks, so that the 1-shot mode's sub-tasks share their
shapes too.

The tasks come from a small corpus preprocessed by the port on the CPU
(tests/test_torch_preprocess.py's writer: 2 speakers x 3 utterances of
harmonic tones), so every parity case shares one episode shape and the
JAX side compiles each function once.  JAX and the port draw different
dropout bits, so dropout is patched out on both sides for the whole module
(``metatts_tpu.models.nn.dropout`` and ``metatts_torch.models.nn.dropout``).
Tiny widths take the unfused FFT block on both sides, as the JAX gate does;
one port-only case at D=128 counts the fused calls of the snapshot
evaluations.

Tolerances (fp32): query-loss rows rtol 2e-4 (the JAX package's own
batched-vs-sequential bound, tests/test_systems.py), snapshots and adapted
weights rtol 2e-4 / atol 1e-5; the port's batched episodes against its own
sequential ones exactly (the same operations in the same order); episode
descriptions and the files that hold them exactly; ``prepare_tracks``
exactly.
"""

import copy
import csv
import ctypes
import json
import os
import sys

import numpy as np
import pytest
import torch
import jax

import metatts_tpu.models.nn as jnn
from metatts_tpu.algorithms.adapt import Adaptor as JaxAdaptor
from metatts_tpu.algorithms.meta import MetaSystem as JaxMetaSystem
from metatts_tpu.data.collate import collate_episode as jax_collate_episode
from metatts_tpu.data.datamodule import MetaDataModule as JaxDataModule
from metatts_tpu.models import vocoder as jvoc
from metatts_tpu.serve import SynthesisEngine as JaxEngine
from metatts_tpu.train import synth_utils as jsynth
from metatts_tpu.train.loop import Trainer as JaxTrainer
from metatts_torch import config as C
from metatts_torch.algorithms.base import episode
from metatts_torch.algorithms.meta import MetaSystem
from metatts_torch.convert import (jax_trees_from_fs2, load_fs2_from_jax,
                                   load_vocoder_from_jax)
from metatts_torch.data.collate import collate_episode
from metatts_torch.data.datamodule import BaselineDataModule
from metatts_torch.data.dataset import TTSDataset
from metatts_torch.models import nn as tnn
from metatts_torch.models import transformer
from metatts_torch.models.vocoder import Vocoder
from metatts_torch.preprocess import audio_io
from metatts_torch.preprocess.preprocessor import Preprocessor
from metatts_torch.serve import SynthesisEngine
from metatts_torch.train import synth_utils
from metatts_torch.train.checkpoint import save_checkpoint
from metatts_torch.train.loop import Trainer

from helpers import algorithm_cfg, tiny_model_cfg, tiny_train_cfg
from test_torch_preprocess import SR, PHONES, make_corpus, write_textgrid
from torch_port_helpers import fill_tree, fs2_params, one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 1e-5
STEPS = [0, 5, 10]


@pytest.fixture(scope="module", autouse=True)
def no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "dropout", lambda rng, x, rate, train: x)
        mp.setattr(tnn, "dropout", lambda x, rate, train, generator: x)
        yield


def _third_utterances(root):
    """One more utterance per speaker of ``make_corpus``'s corpus."""
    rng = np.random.RandomState(1)
    for spk, f0 in (("spk_a", 140.0), ("spk_b", 190.0)):
        base = f"{spk}_utt2"
        t = np.arange(int(SR * 0.09 * len(PHONES))) / SR
        wav = 0.4 * np.sin(2 * np.pi * f0 * (1 + 0.03 * np.sin(5 * t)) * t)
        wav *= 0.3 + 0.7 * np.abs(np.sin(2.5 * np.pi * t))
        wav += 0.01 * rng.randn(len(t))
        d = os.path.join(root, "raw", "train", spk)
        audio_io.save_wav(os.path.join(d, f"{base}.wav"), wav.astype(np.float32), SR)
        with open(os.path.join(d, f"{base}.lab"), "w") as fh:
            fh.write("hello 2")
        write_textgrid(os.path.join(root, "port", "TextGrid", spk, f"{base}.TextGrid"),
                       PHONES, 0.09)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, the configs, one set of weights and the JAX system."""
    root = str(tmp_path_factory.mktemp("stage"))
    raw = make_corpus(root, np.random.RandomState(0))
    _third_utterances(root)
    pcfg = C.deep_merge(C.PREPROCESS_DEFAULTS, {
        "dataset": "synth",
        "path": {"raw_path": raw, "preprocessed_path": os.path.join(root, "port")},
        "subsets": {"train": "train", "val": "train", "test": "train"}})
    Preprocessor(pcfg, device="cpu").build_from_path()
    with open(os.path.join(root, "port", "stats.json")) as f:
        stats = json.load(f)
    mcfg = tiny_model_cfg(max_seq_len=128)
    acfg = algorithm_cfg("meta")
    acfg["adapt"]["train"].update(shots=1, queries=1)
    acfg["adapt"]["test"].update(shots=1, queries=1)
    tcfg = tiny_train_cfg()
    params, state = fs2_params(pcfg, mcfg, acfg, stats, 2)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    state = jax.tree.map(lambda a: np.asarray(a, np.float32), state)
    # random weights predict ~0 frames; a bias on the log-duration gives a few
    params["variance_adaptor"]["duration_predictor"]["linear"]["b"] = \
        np.full((1,), 1.6, np.float32)

    js = JaxMetaSystem.__new__(JaxMetaSystem)
    js.pcfg, js.mcfg, js.tcfg, js.acfg, js.stats = pcfg, mcfg, tcfg, acfg, stats
    js.n_speakers = 2
    js.adaptor = JaxAdaptor(pcfg, mcfg, acfg)
    js.params, js.state = params, state
    js.train_rng = jax.random.PRNGKey(0)
    js._compiled, js.mesh, js._rep, js._ep = {}, None, None, None
    js.global_step = 0
    return dict(root=root, pcfg=pcfg, mcfg=mcfg, acfg=acfg, tcfg=tcfg,
                stats=stats, params=params, state=state, js=js)


def _port_system(s, **over):
    acfg = copy.deepcopy(s["acfg"])
    acfg["adapt"]["test"].update(over)
    system = MetaSystem(s["pcfg"], s["mcfg"], s["tcfg"], acfg, s["stats"], 2,
                        device="cpu")
    load_fs2_from_jax(system.model, s["params"], s["state"])
    return system


def _tasks(dm, n=1):
    return [ep for _, ep in dm.test_episodes(n)]


@pytest.fixture(scope="module")
def episodes(setup):
    """The frozen test tasks of both packages' datamodules."""
    jdm = JaxDataModule([setup["pcfg"]], setup["tcfg"], setup["acfg"],
                        log_dir=os.path.join(setup["root"], "jax_log"))
    dm = BaselineDataModule([setup["pcfg"]], setup["tcfg"], setup["acfg"],
                           log_dir=os.path.join(setup["root"], "port_log"))
    jdm.setup()
    dm.setup()
    return jdm, dm


@pytest.fixture(scope="module")
def jax_trajectory(setup, episodes):
    """JAX ``test_adapt`` on the first test task, and that task collated."""
    sup, qry = _tasks(episodes[1])[0]
    jsup, jqry, _, _ = jax_collate_episode([sup], [qry])
    first = lambda b: jax.tree.map(lambda x: x[0], b)
    rows, snaps = setup["js"].test_adapt(first(jsup), first(jqry))
    return (sup, qry), rows, snaps


def _np_rows(rows):
    return [(ft, np.array([float(v) for v in vals])) for ft, vals in rows]


def _adapted_names(system):
    return [k for k in system.params if k.split(".")[0] in system.adaptor.modules]


def test_collate_episode_matches_jax(jax_trajectory):
    (sup, qry), _, _ = jax_trajectory
    got = collate_episode([sup, sup], [qry, qry])
    ref = jax_collate_episode([sup, sup], [qry, qry])
    for a, b in zip(got[:2], ref[:2]):
        for name, x, y in zip(a._fields, a, b):
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.shape == y.shape and np.array_equal(x.numpy(), np.asarray(y)), name
    assert [m.ids for m in got[3]] == [m.ids for m in ref[3]]


def _leaves(system, snapshot):
    model = copy.deepcopy(system.model)
    model.load_state_dict({**model.state_dict(), **snapshot})
    return jax_trees_from_fs2(model)[0]


def _assert_close_trees(got, ref):
    got = jax.tree_util.tree_leaves_with_path(got)
    ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, ref))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=str(path))


def _assert_locked(setup, system, rows, snaps, sup, qry):
    """Each saving step against the JAX package's own compiled programs
    (those its ``test_adapt`` ran for these shapes), started from the
    port's snapshot before it: the chunk of SGD steps gives the snapshot,
    the evaluation gives the row."""
    js = setup["js"]
    jsup, jqry = (jax.tree.map(lambda x: x[0], b)
                  for b in jax_collate_episode([sup], [qry])[:2])
    chunk, evaluate = js._compiled["test_adapt_5"], js._compiled["test_eval"]
    for (_, before), (ft, snap), (_, row) in zip(snaps, snaps[1:], rows[1:]):
        _assert_close_trees(_leaves(system, snap), chunk(
            _leaves(system, before), js.state, jsup, jax.random.PRNGKey(0)))
        ref = evaluate(_leaves(system, snap), js.state, jsup, jqry, None)
        np.testing.assert_allclose([float(v) for v in row], [float(v) for v in ref],
                                   rtol=RTOL, err_msg=f"ft_step {ft}")


def test_test_adapt_matches_jax(setup, jax_trajectory):
    """The two trajectories from one start agree at step 0 and over the
    first chunk; every later chunk and its row are held against the JAX
    package's programs from the port's snapshot before it.  Free-running,
    the weights drift apart by up to 6e-5 after step 8: the L1 mel loss's
    gradient jumps where a residual crosses zero, and at step 8 one
    residual lies 7e-6 from zero, within the rounding by which the two
    packages differ; from one start every chunk agrees to 3e-7."""
    (sup, qry), rows_r, snaps_r = jax_trajectory
    system = _port_system(setup)
    sup_b, qry_b, _, _ = collate_episode([sup], [qry])
    rows, snaps = system.test_adapt(episode(sup_b, 0), episode(qry_b, 0))
    assert [ft for ft, _ in rows] == [ft for ft, _ in snaps] == STEPS
    for (ft, got), (ft_r, ref) in zip(_np_rows(rows)[:2], _np_rows(rows_r)[:2]):
        assert ft == ft_r
        np.testing.assert_allclose(got, ref, rtol=RTOL, err_msg=f"ft_step {ft}")
    _assert_close_trees(_leaves(system, snaps[1][1]), snaps_r[1][1])
    _assert_locked(setup, system, rows, snaps, sup, qry)
    assert rows[0][1].total != rows[-1][1].total
    assert not np.array_equal(_leaves(system, snaps[-1][1])["mel_linear"]["w"],
                              setup["params"]["mel_linear"]["w"])
    # a snapshot's frozen tensors are the model's own
    for k, v in system.params.items():
        if k not in _adapted_names(system):
            assert snaps[-1][1][k].data_ptr() == v.data_ptr(), k


def test_test_adapt_batched_matches_sequential(setup, episodes):
    tasks = _tasks(episodes[1])[:2]
    system = _port_system(setup)
    sup_b, qry_b, _, _ = collate_episode([t[0] for t in tasks], [t[1] for t in tasks])
    rows_E, snaps_E = system.test_adapt_batched(sup_b, qry_b, ft_steps=[2, 4])
    assert [ft for ft, _ in rows_E] == [0, 2, 4]
    for e in range(2):
        rows, snaps = system.test_adapt(episode(sup_b, e), episode(qry_b, e),
                                        ft_steps=[2, 4])
        for (ft_b, vals_b), (ft_s, vals_s) in zip(rows_E, rows):
            assert ft_b == ft_s
            assert [float(v[e]) for v in vals_b] == [float(v) for v in vals_s]
        for k in system.params:
            assert torch.equal(snaps_E[-1][1][k][e], snaps[-1][1][k]), k


def test_test_adapt_tasks_one_shot_matches_jax(setup, jax_trajectory):
    """1-shot mode: the port's sub-tasks (one ``test_adapt_batched`` call)
    against the JAX package's sequential sub-tasks (``batch_sub_tasks``
    off there, which its own tests hold equal to its batched ones), each
    as in ``test_test_adapt_matches_jax``."""
    (sup, qry), _, _ = jax_trajectory
    ds = TTSDataset("train.txt", setup["pcfg"])
    sup = sup + [ds[i] for i in range(len(ds))
                 if ds[i]["speaker"] == sup[0]["speaker"]
                 and ds[i]["id"] not in {sup[0]["id"], qry[0]["id"]}]
    js = setup["js"]
    acfg = copy.deepcopy(setup["acfg"])
    acfg["adapt"]["test"].update({"1-shot": True, "batch_sub_tasks": False})
    js_acfg, js.acfg = js.acfg, acfg
    try:
        jsup, jqry, _, _ = jax_collate_episode([sup], [qry])
        first = lambda b: jax.tree.map(lambda x: x[0], b)
        ref = list(js.test_adapt_tasks(first(jsup), first(jqry), ft_steps=[5]))
        system = _port_system(setup, **{"1-shot": True})
        sup_b, qry_b, _, _ = collate_episode([sup], [qry])
        got = list(system.test_adapt_tasks(episode(sup_b, 0), episode(qry_b, 0),
                                           ft_steps=[5]))
        assert [g[0] for g in got] == [r[0] for r in ref] == ["_0", "_1"]
        for i, ((_, rows, snaps), (_, rows_r, snaps_r)) in enumerate(zip(got, ref)):
            assert [ft for ft, _ in rows] == [0, 5]
            for (ft, a), (_, b) in zip(_np_rows(rows)[:2], _np_rows(rows_r)[:2]):
                np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=f"ft_step {ft}")
            _assert_close_trees(_leaves(system, snaps[1][1]), snaps_r[1][1])
            _assert_locked(setup, system, rows, snaps, [sup[i]], qry)
    finally:
        js.acfg = js_acfg


@pytest.mark.parametrize("mode,budget,want", [
    ("device", None, "device"), ("host", None, "host"), ("auto", None, "device"),
    ("auto", "1", "host")])
def test_snapshot_keep(setup, monkeypatch, mode, budget, want):
    if budget is not None:
        monkeypatch.setenv("METATTS_SNAPSHOT_HBM_BUDGET", budget)
    system = _port_system(setup, snapshot_offload=mode)
    p = system._start_params()
    kept = system._snapshot_keep(6)(p)
    assert system.snapshot_mode == want
    assert (kept is p) == (want == "device")
    assert all(v.device.type == "cpu" for v in kept.values())
    # the JAX package takes the same mode
    js = setup["js"]
    js_acfg, js.acfg = js.acfg, system.acfg
    try:
        ref = js._snapshot_keep(6)
    finally:
        js.acfg = js_acfg
    tree = {"x": np.zeros(2)}
    assert (ref(tree) is tree) == (want == "device")


def test_test_episodes_match_jax(setup, tmp_path):
    """Both packages' datamodules on the same corpus draw the same val and
    test tasks and write the same description files."""
    dms = {}
    for side, cls in (("jax", JaxDataModule), ("port", BaselineDataModule)):
        dms[side] = cls([setup["pcfg"]], setup["tcfg"], setup["acfg"],
                        log_dir=str(tmp_path / side))
        dms[side].setup()
    got = [d for d, _ in dms["port"].test_episodes(3)]
    assert got == [d for d, _ in dms["jax"].test_episodes(3)] and len(got) == 6
    assert [d for d, _ in dms["port"].val_episodes(2)] == \
        [d for d, _ in dms["jax"].val_episodes(2)]
    for name in ("test_descriptions.json", "test_SQids.json",
                 "val_descriptions.json", "val_SQids.json"):
        with open(tmp_path / "jax" / name, "rb") as f, \
                open(tmp_path / "port" / name, "rb") as g:
            assert f.read() == g.read(), name
    sup, qry = next(dms["port"].test_episodes(3))[1]
    assert [s["id"] for s in sup + qry] == [dms["port"].test_set[i]["id"]
                                           for i in got[0]["sup"] + got[0]["qry"]]


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_trainer_test_matches_jax(setup, tmp_path, monkeypatch):
    """Both packages' ``Trainer.test`` on the same frozen task, with equal
    vocoder weights and without matplotlib (the figures fall back to the
    mel as ``.npy``, as on a machine without it): the same result tree
    (the CSV, the recon and per-step synth wavs, the figures) and the same
    CSV rows (held as in ``test_test_adapt_matches_jax``: free-running up
    to the first chunk)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    vshapes = jax.eval_shape(lambda k: jvoc.melgan_init(k, n_mels=80),
                             jax.random.PRNGKey(0))
    vparams = fill_tree(vshapes, 3)
    jvocoder = jvoc.Vocoder.__new__(jvoc.Vocoder)
    jvocoder.kind, jvocoder.pretrained = "MelGAN", False
    jvocoder.params, jvocoder._apply = vparams, jax.jit(jvoc.melgan_apply)
    vocoder = Vocoder(setup["mcfg"], n_mels=80, device="cpu")
    load_vocoder_from_jax(vocoder, vparams)

    outs = {}
    for side in ("jax", "port"):
        log = os.path.join(str(tmp_path), side, "log", "exp")
        if side == "jax":
            dm = JaxDataModule([setup["pcfg"]], setup["tcfg"], setup["acfg"], log_dir=log)
            dm.setup()
            trainer = JaxTrainer(setup["js"], dm, setup["tcfg"], vocoder=jvocoder,
                                 output_dir=os.path.join(str(tmp_path), side),
                                 exp_name="exp")
        else:
            dm = BaselineDataModule([setup["pcfg"]], setup["tcfg"], setup["acfg"],
                                   log_dir=log)
            dm.setup()
            trainer = Trainer(_port_system(setup), dm, setup["tcfg"], vocoder=vocoder,
                              output_dir=os.path.join(str(tmp_path), side),
                              exp_name="exp")
        outs[side] = trainer.test(max_tasks=1, tasks_per_label=1, task_batch=1)
    root = lambda side: os.path.join(str(tmp_path), side, "result", "exp")
    tree = _tree(root("port"))
    assert tree == _tree(root("jax"))
    assert sorted(outs["port"]) == sorted(outs["jax"]) == ["test_000"]
    wavs = [f for f in tree if f.endswith(".wav")]
    assert len([f for f in wavs if f.endswith(".recon.wav")]) == 1
    assert len([f for f in wavs if "FTstep_" in f]) == len(STEPS)
    assert all(f.replace("audio", "figure", 1).replace(".wav", ".png.npy") in tree
               for f in wavs)
    for f in tree:
        if f.endswith(".csv"):
            read = lambda side: list(csv.reader(open(os.path.join(root(side), f))))
            got, ref = read("port"), read("jax")
            assert got[0] == ref[0] == ["ft_step", "total", "mel", "postnet_mel",
                                        "pitch", "energy", "duration"]
            assert [r[0] for r in got[1:]] == [r[0] for r in ref[1:]] == \
                [str(s) for s in STEPS]
            np.testing.assert_allclose(np.array(got[1:3], float), np.array(ref[1:3], float),
                                       rtol=RTOL, err_msg=f)


def test_trainer_test_remainder_batch_and_avg_train_spk_emb(setup, tmp_path):
    """``test_task_batch`` 3 over 2 tasks: the remainder runs as one batched
    call of 2 episodes; ``avg_train_spk_emb`` first sets every speaker row to
    the mean of the training speakers' rows."""
    system = _port_system(setup, avg_train_spk_emb=True, steps=5, saving_steps=[5])
    table = system.model.speaker_emb.model.weight
    mean = table.detach().mean(0)               # both speakers train
    dm = BaselineDataModule([setup["pcfg"]], setup["tcfg"], setup["acfg"],
                           log_dir=str(tmp_path / "log"))
    dm.setup()
    calls = []
    batched = system.test_adapt_batched
    system.test_adapt_batched = lambda *a, **k: calls.append(a[0].texts.shape[0]) or \
        batched(*a, **k)
    out = Trainer(system, dm, setup["tcfg"], output_dir=str(tmp_path)).test(
        tasks_per_label=1, task_batch=3)
    assert calls == [2] and sorted(out) == ["test_000", "test_001"]
    assert all([ft for ft, _ in rows] == [0, 5] for rows in out.values())
    np.testing.assert_allclose(table.detach().numpy(), mean.expand_as(table).numpy(),
                               rtol=1e-6)


def test_adapt_speaker_matches_jax(setup, jax_trajectory):
    (sup, _), _, _ = jax_trajectory
    pcfg, mcfg, acfg = setup["pcfg"], setup["mcfg"], setup["acfg"]
    jeng = JaxEngine(setup["params"], setup["state"], pcfg, mcfg, acfg,
                     vocoder=object())
    jsup = jax.tree.map(lambda x: x[0], jax_collate_episode([sup], [sup])[0])
    ref = jeng.adapt_speaker(jsup, steps=3, lr=0.01)
    model = _port_system(setup).model
    eng = SynthesisEngine(model, pcfg, mcfg, acfg, vocoder=object(), device="cpu")
    sup_b = episode(collate_episode([sup], [sup])[0], 0)
    got = eng.adapt_speaker(sup_b, steps=3, lr=0.01)
    assert got.model is not eng.model and got.vocoder is eng.vocoder
    got_p = jax_trees_from_fs2(got.model)[0]
    ref_p = jax.tree.map(np.asarray, ref.params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got_p),
                            jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=str(path))
    assert not np.array_equal(got_p["decoder"]["layers"][0]["attn"]["fc"]["w"],
                              jax_trees_from_fs2(eng.model)[0]["decoder"]["layers"][0]
                              ["attn"]["fc"]["w"])
    assert np.array_equal(got_p["encoder"]["src_word_emb"]["table"],
                          setup["params"]["encoder"]["src_word_emb"]["table"])


def test_from_checkpoint_and_predict_cli(setup, tmp_path, capsys):
    from metatts_torch.__main__ import main, parse_args
    pcfg, mcfg, acfg = setup["pcfg"], setup["mcfg"], setup["acfg"]
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, _port_system(setup).model, 11)
    eng = SynthesisEngine.from_checkpoint(path, pcfg, mcfg, acfg, setup["stats"], 4,
                                          device="cpu")
    out = capsys.readouterr().out
    assert "[ckpt surgery] resized /speaker_emb/table: (2, 32) -> (4, 32) " \
           "(copied 2 rows)" in out
    wav, mel = eng.synthesize(["hello world"], speakers=[1], mel_cap=128)[0]
    assert wav.dtype == np.int16 and len(wav) == 256 * mel.shape[0] > 0

    source = tmp_path / "source.txt"
    source.write_text("u0|spk_a|{HH AH0 L OW1}|hello\nu1|spk_b|{L OW1 sp HH AH0}|low\n")
    args = parse_args(["-s", "predict", "--source", str(source), "-c", path,
                       "--output_dir", str(tmp_path / "out"), "-e", "p",
                       "--device", "cpu"])
    main(args, ([pcfg], mcfg, setup["tcfg"], acfg))
    d = tmp_path / "out" / "result" / "p" / "audio" / "Prediction" / "step_last" / "predict"
    assert sorted(os.listdir(d)) == ["u0.wav", "u1.wav"]
    assert all(audio_io.load_wav(str(d / f))[0].size > 0 for f in os.listdir(d))


@pytest.mark.parametrize("level", ["phoneme_level", "frame_level"])
def test_prepare_tracks_matches_jax(setup, level):
    from metatts_torch.models.fastspeech2 import FS2Output
    rng = np.random.RandomState(4)
    d = rng.randint(0, 4, size=(2, 7)).astype(np.int32)
    lens = np.minimum(d.sum(1), 20).astype(np.int32)
    n = 7 if level == "phoneme_level" else 20
    out = FS2Output(None, torch.from_numpy(rng.randn(2, 20, 80).astype(np.float32)),
                    torch.from_numpy(rng.randn(2, n).astype(np.float32)),
                    torch.from_numpy(rng.randn(2, n).astype(np.float32)), None,
                    torch.from_numpy(d), None, None, None, torch.from_numpy(lens))
    pcfg = C.deep_merge(setup["pcfg"], {"preprocessing": {
        "pitch": {"feature": level}, "energy": {"feature": level}}})
    ref_out = out._replace(**{k: None if v is None else v.numpy()
                              for k, v in out._asdict().items()})
    for index in (0, 1):
        got = synth_utils.prepare_tracks(out, setup["stats"], pcfg, index)
        ref = jsynth.prepare_tracks(ref_out, setup["stats"], pcfg, index)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and np.array_equal(a, b)


def test_fused_pack_follows_freed_parameter_dicts():
    """The fused block's weight pack is rebuilt for every parameter dict
    swapped in by ``functional_call``, each dict freed before the next."""
    from torch.func import functional_call
    from metatts_torch.ops import fftblock

    class Fused(torch.nn.Module):
        def __init__(self, blk):
            super().__init__()
            self.blk = blk

        def forward(self, x, valid):
            return fftblock.fused_fft_block_plain(self.blk.fused_params(), x, valid, 2)

    gen = torch.Generator().manual_seed(0)
    blk = transformer.FFTBlock(128, 2, 64, [9, 1])
    tnn.reset_parameters(blk, gen)
    fused = Fused(blk)
    x = torch.randn(2, 16, 128, generator=gen)
    valid = torch.ones(2, 16, dtype=torch.bool)
    outs = []
    for i in range(4):
        p = {k: v.detach() + 0.05 * (i + 1) * torch.randn(v.shape, generator=gen)
             for k, v in blk.named_parameters()}
        fresh = transformer.FFTBlock(128, 2, 64, [9, 1])
        fresh.load_state_dict(p)
        want = fftblock.fused_fft_block_plain(
            fftblock.pack_block_params(fresh.slf_attn, fresh.pos_ffn), x, valid, 2)
        got = functional_call(fused, {f"blk.{k}": v for k, v in p.items()}, (x, valid))
        assert torch.equal(got, want), i
        outs.append(got)
        del p, fresh                              # freed before the next dict
    assert not torch.equal(outs[0], outs[1])
    # and the module's own parameters again, then after an in-place update
    pack = blk.fused_params()
    own = fftblock.fused_fft_block_plain(pack, x, valid, 2)
    # a copy packs its own tensors (the card's pack holds C pointers, which
    # cannot be copied)
    pack["_kernel_args"] = (ctypes.c_void_p * 1)(pack["w1"].data_ptr())
    twin = copy.deepcopy(blk)
    assert twin._packed[2] is None and twin.fused_params()["w1"] is not pack["w1"]
    assert torch.equal(fftblock.fused_fft_block_plain(twin.fused_params(), x, valid, 2),
                       own)
    del pack["_kernel_args"]
    with torch.no_grad():
        blk.pos_ffn.w_1.weight.mul_(0.5)
    assert not torch.equal(fftblock.fused_fft_block_plain(blk.fused_params(), x, valid, 2),
                           own)


def test_test_adapt_evaluations_take_the_fused_route(setup, monkeypatch):
    """At D=128 the blocks pass the fused gate: every snapshot evaluation of
    ``test_adapt`` runs its 2 blocks fused (here at steps 0, 1 and 2), and
    the batched path none."""
    mcfg = tiny_model_cfg(max_seq_len=128)
    mcfg["transformer"].update(encoder_hidden=128, decoder_hidden=128,
                               conv_filter_size=64)
    pcfg, acfg = setup["pcfg"], setup["acfg"]
    system = MetaSystem(pcfg, mcfg, setup["tcfg"], acfg, setup["stats"], 2,
                        device="cpu", seed=0)
    calls = []
    plain = transformer.fused_fft_block
    monkeypatch.setattr(transformer, "fused_fft_block",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    ds = TTSDataset("train.txt", pcfg)
    sup_b, qry_b, _, _ = collate_episode([[ds[0], ds[1]]], [[ds[2]]])
    rows, _ = system.test_adapt(episode(sup_b, 0), episode(qry_b, 0), ft_steps=[1, 2])
    assert len(calls) == 3 * 2
    assert all(np.isfinite(float(v)) for _, vals in rows for v in vals)
    calls.clear()
    system.test_adapt_batched(sup_b, qry_b, ft_steps=[1, 2])
    assert calls == []
