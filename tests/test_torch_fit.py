"""Port: training runs (``BaselineSystem``, the training loaders,
``validation_step_batched``, the optimizer state in checkpoints,
``Trainer.fit`` and ``python -m metatts_torch -s train``) against the JAX
package, at the tiny config of tests/helpers.py (fp32, hidden 32, 1 + 1
layers; 1 shot, 1 query, 2 inner steps) on a small corpus written here
as a preprocessor would (2 speakers x 4 utterances of random features, so
that every batch and episode shares the text bucket 32 and the mel bucket
128, and each JAX function compiles once).

JAX and the port draw different dropout bits, so dropout is patched out on
both sides for the whole module.  The JAX systems are built without their
random init (``__new__``), from the numpy parameters the port loads too,
and share one cache of compiled functions.

Tolerances (fp32): losses rtol 1e-5; BatchNorm running statistics rtol
1e-5, and atol 1e-5 of the vector's largest (a batch mean near 0 is summed
in another order, so only its absolute rounding is small);
parameter deltas of an Adam step atol 0.1 x lr (tests/test_torch_train.py's
meta step: a first step moves a parameter by about +-lr wherever its
gradient is not ~0), ``last.ckpt`` after 4 free-running steps within the
sum of the 4 steps' tolerances; validation losses rtol 1e-5; the optimizer, the same operations in
the same order, rtol 1e-6; loaders, trees and files exactly.
"""

import copy
import functools
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from flax import serialization

import metatts_tpu.models.nn as jnn
from metatts_tpu.algorithms.adapt import Adaptor as JaxAdaptor
from metatts_tpu.algorithms.baseline import BaselineSystem as JaxBaselineSystem
from metatts_tpu.data import collate as jcollate
from metatts_tpu.data.datamodule import (BaselineDataModule as JaxBaselineDM,
                                         MetaDataModule as JaxMetaDM)
from metatts_tpu.train import checkpoint as jck
from metatts_tpu.train.loop import Trainer as JaxTrainer
from metatts_tpu.train.optim import make_optimizer
from metatts_torch import config as C
from metatts_torch.algorithms import get_system
from metatts_torch.algorithms.baseline import BaselineSystem
from metatts_torch.convert import (fs2_state_dict_from_jax, jax_params_tree,
                                   jax_trees_from_fs2, load_fs2_from_jax,
                                   named_from_jax_params_tree)
from metatts_torch.data.collate import Batch, split_batch
from metatts_torch.data.datamodule import BaselineDataModule, MetaDataModule
from metatts_torch.models import nn as tnn
from metatts_torch.models.vocoder import Vocoder
from metatts_torch.train import checkpoint as ck
from metatts_torch.train.loop import Trainer

from helpers import algorithm_cfg, tiny_model_cfg, tiny_preprocess_cfg, tiny_train_cfg
from torch_port_helpers import fs2_params, one_torch_thread  # noqa: F401

PHONES = ["HH", "AH0", "L", "OW1", "W", "ER1", "D", "S", "T", "IY1"]
SPEAKERS = ("spk_a", "spk_b")
STATS = {"pitch": [-2.0, 8.0, 0.0, 1.0], "energy": [-1.5, 8.0, 0.0, 1.0]}
BATCH = 2                 # the training runs' batch


@pytest.fixture(scope="module", autouse=True)
def no_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "dropout", lambda rng, x, rate, train: x)
        mp.setattr(tnn, "dropout", lambda x, rate, train, generator: x)
        yield


def write_corpus(root, n_utts=4, n_mels=8, seed=0, representations=False):
    """A preprocessed corpus as the preprocessor lays it out: metadata
    lines, per-utterance mel / phoneme-level pitch and energy / duration
    ``.npy`` files (and, with ``representations``, (L, n_mels) per-phoneme
    representations), speakers.json and stats.json."""
    rng = np.random.RandomState(seed)
    subs = ("mel", "pitch", "energy", "duration") + (
        ("representation",) if representations else ())
    for sub in subs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines = []
    for spk in SPEAKERS:
        for u in range(n_utts):
            base = f"{spk}_{u}"
            n = rng.randint(5, 13)
            d = rng.randint(1, 5, n).astype(np.int64)
            arrays = {"mel": rng.randn(int(d.sum()), n_mels).astype(np.float32),
                      "pitch": rng.randn(n).astype(np.float32),
                      "energy": rng.randn(n).astype(np.float32), "duration": d}
            if representations:
                arrays["representation"] = rng.randn(n, n_mels).astype(np.float32)
            for kind, a in arrays.items():
                np.save(os.path.join(root, kind, f"{spk}-{kind}-{base}.npy"), a)
            phones = " ".join(PHONES[i] for i in rng.randint(0, len(PHONES), n))
            lines.append(f"{base}|{spk}|{{{phones}}}|hello")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "speakers.json"), "w") as f:
        json.dump({s: i for i, s in enumerate(SPEAKERS)}, f)
    with open(os.path.join(root, "stats.json"), "w") as f:
        json.dump(STATS, f)


def _acfg(kind):
    """1-shot / 1-query tasks: the postnet's 512 channels at the mel bucket
    of 128 frames set the CPU's time, which is linear in the batch."""
    acfg = algorithm_cfg(kind)
    acfg["adapt"]["train"].update(shots=1, queries=1)
    acfg["adapt"]["test"].update(shots=1, queries=1)
    return acfg


def _step_train_cfg(**steps):
    # eps 1e-6: Adam's first step moves a parameter whose gradient is 0 up
    # to rounding by up to lr in a direction the rounding sets; 1e-6 keeps
    # such parameters still on both sides (tests/test_torch_train.py)
    tcfg = copy.deepcopy(tiny_train_cfg())
    tcfg["optimizer"].update(eps=1e-6, batch_size=BATCH)
    tcfg["step"].update(steps)
    tcfg.update(distributed="off", test_task_batch=2)
    return tcfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fit"))
    write_corpus(os.path.join(root, "pp"))
    pcfg = C.deep_merge(tiny_preprocess_cfg(), {
        "dataset": "synth", "path": {"preprocessed_path": os.path.join(root, "pp")},
        "subsets": {"train": "train", "val": "train", "test": "train"}})
    mcfg = tiny_model_cfg(max_seq_len=128)
    acfg = _acfg("baseline")
    params, state = fs2_params(pcfg, mcfg, acfg, STATS, len(SPEAKERS))
    compiled = {}

    def jax_system(tcfg=None, acfg_=acfg):
        """A JAX BaselineSystem on the shared weights; every one shares
        the compiled functions of the first."""
        tcfg = tcfg or _step_train_cfg()
        js = JaxBaselineSystem.__new__(JaxBaselineSystem)
        js.pcfg, js.mcfg, js.tcfg, js.acfg, js.stats = pcfg, mcfg, tcfg, acfg_, STATS
        js.n_speakers = len(SPEAKERS)
        js.adaptor = JaxAdaptor(pcfg, mcfg, acfg_)
        js.params = jax.tree.map(jnp.asarray, params)
        js.state = jax.tree.map(jnp.asarray, state)
        js.tx, js.lr_schedule = make_optimizer(mcfg, tcfg)
        js.opt_state = js.tx.init(js.params)
        js.train_rng = jax.random.PRNGKey(0)
        js._compiled, js.mesh, js._rep, js._ep = compiled, None, None, None
        js.global_step = 0
        return js

    return dict(root=root, pcfg=pcfg, mcfg=mcfg, acfg=acfg, params=params,
                state=state, jax_system=jax_system)


def _port_system(s, tcfg=None, acfg=None):
    acfg = acfg or s["acfg"]
    system = get_system(acfg["type"])(s["pcfg"], s["mcfg"], tcfg or _step_train_cfg(),
                                      acfg, STATS, len(SPEAKERS), device="cpu")
    load_fs2_from_jax(system.model, s["params"], s["state"])
    return system


def _datamodules(s, cls_port, cls_jax, acfg=None, log="log"):
    acfg = acfg or s["acfg"]
    out = []
    for side, cls in (("port", cls_port), ("jax", cls_jax)):
        dm = cls([s["pcfg"]], _step_train_cfg(), acfg,
                 log_dir=os.path.join(s["root"], log, side))
        dm.setup()
        out.append(dm)
    return out


def _assert_batches_equal(got, ref):
    for name, x, y in zip(got._fields, got, ref):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.shape == y.shape and np.array_equal(x.numpy(), np.asarray(y)), name


def _t(batch):
    return Batch(*(None if v is None else torch.from_numpy(np.array(v)) for v in batch))


# ------------------------------------------------------------------ loaders

@pytest.mark.parametrize("batch_size", [3, 10])
def test_train_batches_match_jax(setup, batch_size):
    """A permutation per epoch (3 batches of 3 cross the 8-utterance
    epoch), and draws with replacement for a batch larger than the corpus."""
    dm, jdm = _datamodules(setup, BaselineDataModule, JaxBaselineDM)
    got, ref = dm.train_batches(batch_size), jdm.train_batches(batch_size)
    for _ in range(3):
        (b, meta), (rb, rmeta) = next(got), next(ref)
        assert meta.ids == rmeta.ids and len(meta.ids) == batch_size
        _assert_batches_equal(b, rb)
    idx = [2, 0]
    _assert_batches_equal(split_batch(b, idx), jcollate.split_batch(rb, idx))


def test_train_episode_batches_match_jax(setup):
    acfg = _acfg("meta")
    dm, jdm = _datamodules(setup, MetaDataModule, JaxMetaDM, acfg)
    got, ref = dm.train_episode_batches(2), jdm.train_episode_batches(2)
    for _ in range(3):
        a, b = next(got), next(ref)
        for x, y in zip(a[:2], b[:2]):
            assert x.texts.shape[0] == 2
            _assert_batches_equal(x, y)
        assert [m.ids for m in a[2] + a[3]] == [m.ids for m in b[2] + b[3]]
    # language episodes, on the same corpus with per-phoneme representations:
    # the coverage re-split, and the support's phn_ref as a fifth item
    acfg["adapt"].update(type="lang", phoneme_emb={
        "type": "codebook", "size": 16, "representation_dim": 8, "attention": {"type": "hard"}})
    root = os.path.join(setup["root"], "lang_pp")
    write_corpus(root, representations=True)
    lang = dict(setup, pcfg=C.deep_merge(setup["pcfg"], {"path": {"preprocessed_path": root}}))
    dm, jdm = _datamodules(lang, MetaDataModule, JaxMetaDM, acfg, log="lang_log")
    got, ref = dm.train_episode_batches(2), jdm.train_episode_batches(2)
    for _ in range(3):
        a, b = next(got), next(ref)
        assert len(a) == len(b) == 5
        for x, y in zip(a[:2], b[:2]):
            _assert_batches_equal(x, y)
        assert [m.ids for m in a[2] + a[3]] == [m.ids for m in b[2] + b[3]]
        assert a[4].shape == (2, 361, 8)
        np.testing.assert_array_equal(a[4].numpy(), np.asarray(b[4]))


# ---------------------------------------------------------- baseline step

def _bn(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def test_baseline_train_step_matches_jax(setup):
    """Two ``train_step`` calls against the JAX ``_train_step``: the losses,
    every parameter's delta and the BatchNorm running statistics (the JAX
    step's ``new_state``).  The second step starts both sides from the
    port's weights, statistics and optimizer state after the first (the
    optimizer through ``NoamAdam.state_tree``), so each step is held on its
    own."""
    js = setup["jax_system"]()
    step = js._cached_jit("train", js._train_step, donate_argnums=(0, 1, 2))
    system = _port_system(setup)
    dm = BaselineDataModule([setup["pcfg"]], _step_train_cfg(), setup["acfg"])
    dm.setup()
    batches = dm.train_batches(BATCH)
    params, state, opt_state = js.params, js.state, js.opt_state
    for i in range(2):
        batch = next(batches)[0]
        before = {n: p.detach().clone() for n, p in system.params.items()}
        bn = _bn(system.model)
        losses = system.train_step(batch)
        params, state, opt_state, losses_r = step(
            params, state, opt_state,
            jcollate.Batch(*(None if t is None else jnp.asarray(t.numpy()) for t in batch)),
            jax.random.PRNGKey(0), i)
        assert system.global_step == i + 1
        for name, a, b in zip(losses._fields, losses, losses_r):
            np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, err_msg=name)
        after = fs2_state_dict_from_jax(jax.tree.map(np.asarray, params),
                                        jax.tree.map(np.asarray, state))
        lr = float(js.lr_schedule(i))
        moved = 0
        for n, p in system.params.items():
            d_got = (p.detach() - before[n]).numpy()
            np.testing.assert_allclose(d_got, after[n].numpy() - before[n].numpy(),
                                       atol=0.1 * lr, rtol=0, err_msg=f"{n} step {i + 1}")
            moved += int((np.abs(d_got) > 0.5 * lr).sum())
        assert moved > 0.5 * sum(p.numel() for p in system.params.values())
        for k, v in _bn(system.model).items():
            assert not torch.equal(v, bn[k]), k
            ref = after[k].numpy()
            np.testing.assert_allclose(v.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=k)
        # lock: the next JAX step starts from the port's state
        params, state = (jax.tree.map(jnp.asarray, t) for t in jax_trees_from_fs2(system.model))
        opt_state = serialization.from_state_dict(
            js.tx.init(params), system.optimizer.state_tree(system.model))


# ---------------------------------------------------- batched validation

def test_validation_step_batched_matches_jax(setup):
    """Two val episodes at once against the JAX ``validation_step_batched``
    (vmapped), episode by episode; the second also as one
    ``validation_step``, exactly."""
    dm, _ = _datamodules(setup, BaselineDataModule, JaxBaselineDM)
    pairs = [ep for _, ep in dm.val_episodes(1)]
    sup, qry, _, _ = jcollate.collate_episode([p[0] for p in pairs], [p[1] for p in pairs])
    ref = setup["jax_system"]().validation_step_batched(sup, qry)
    system = _port_system(setup)
    got = system.validation_step_batched(_t(sup), _t(qry))
    assert got.total.shape == (2,)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, err_msg=name)
    one = system.validation_step(_t(jax.tree.map(lambda x: x[1], sup)),
                                 _t(jax.tree.map(lambda x: x[1], qry)))
    assert [float(v) for v in one] == [float(v[1]) for v in got]


# ---------------------------------------------- optimizer state, both ways

_GRADS = {}


def _grads(system, seed):
    """Gradients from a seed, alternately clipped (x10) and not (x0.1)."""
    if seed not in _GRADS:
        rng = np.random.default_rng(seed)
        _GRADS[seed] = {n: torch.from_numpy(rng.standard_normal(p.shape, np.float32)
                                            * (10.0 if seed % 2 else 0.1))
                        for n, p in system.params.items()}
    return _GRADS[seed]


def _acc_cfg(acc):
    tcfg = _step_train_cfg()
    tcfg["optimizer"].update(grad_acc_step=acc, weight_decay=0.01)
    return tcfg


@pytest.fixture(scope="module")
def optax_chain(setup):
    """acc -> (the JAX package's optax chain, its init and its update with
    ``apply_updates``, each compiled once)."""
    cache = {}

    def get(acc):
        if acc not in cache:
            tx, _ = make_optimizer(setup["mcfg"], _acc_cfg(acc))

            def update(grads, opt, params):
                upd, opt = tx.update(grads, opt, params)
                return optax.apply_updates(params, upd), opt
            cache[acc] = tx, jax.jit(tx.init), jax.jit(update)
        return cache[acc]
    return get


@pytest.mark.parametrize("acc", [1, 2])
def test_port_checkpoint_opt_state_loads_into_jax(setup, optax_chain, tmp_path, acc):
    """A port checkpoint's ``opt_state`` through the JAX ``load_checkpoint``
    equals the port's Adam state, leaf for leaf and bit for bit; without
    it (as every port checkpoint was before the optimizer tree), the JAX
    loader raises."""
    system = _port_system(setup, _acc_cfg(acc))
    for i in range(3):
        system.optimizer.step(system.params, _grads(system, i))
    path = str(tmp_path / "port.ckpt")
    ck.save_checkpoint(path, system.model, 3, system.optimizer)
    like_p, like_s = jax_trees_from_fs2(system.model)
    _, init, _ = optax_chain(acc)
    p, s, opt, step, report = jck.load_checkpoint(path, like_p, like_s, init(like_p))
    assert step == 3 and report == [] and opt is not None
    got = jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(opt))
    ref = jax.tree_util.tree_leaves_with_path(system.optimizer.state_tree(system.model))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(got, ref):
        assert np.asarray(a).dtype == np.asarray(b).dtype and \
            np.array_equal(np.asarray(a), np.asarray(b)), k
    assert int(opt[1].count if acc == 1 else opt.gradient_step) == 3 // acc
    ck.save_checkpoint(path, system.model, 3)
    with pytest.raises(ValueError):
        jck.load_checkpoint(path, like_p, like_s, init(like_p))


@pytest.mark.parametrize("acc", [1, 2])
def test_port_resumes_jax_opt_state(setup, optax_chain, tmp_path, acc):
    """A JAX checkpoint after 3 optax updates (with 2 accumulated calls,
    one update and one call half way) loads into the port's optimizer; one
    more update on each side agrees."""
    system = _port_system(setup, _acc_cfg(acc))
    _, init, update = optax_chain(acc)
    params = setup["params"]
    opt = init(params)
    grads = [jax_params_tree(system.model, _grads(system, i)) for i in range(4)]
    for i in range(3):
        params, opt = update(grads[i], opt, params)
    path = str(tmp_path / "jax.ckpt")
    host = lambda t: jax.tree.map(np.asarray, t)
    jck.save_checkpoint(path, host(params), setup["state"], host(opt), 3)
    opt_tree, step, report = ck.load_checkpoint(path, system.model)
    assert step == 3 and report == []
    system.optimizer.load_state_tree(opt_tree, system.model)
    assert system.optimizer.count == 3 // acc
    assert system.optimizer.mini_step == (3 % acc if acc > 1 else 0)
    mu = named_from_jax_params_tree(system.model, serialization.to_state_dict(
        opt[1] if acc == 1 else opt.inner_opt_state[1])["mu"])
    for n in mu:
        assert torch.equal(system.optimizer.mu[n], mu[n]), n
    params, opt = update(grads[3], opt, params)
    system.optimizer.step(system.params, _grads(system, 3))
    ref = named_from_jax_params_tree(system.model, jax.tree.map(np.asarray, params))
    for n, p in system.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    # a checkpoint without optimizer state still loads, and says so
    ck.save_checkpoint(path, system.model, 4)
    assert ck.load_checkpoint(path, system.model)[::2] == (None, [ck.NO_OPT_STATE])
    with pytest.raises(ValueError, match="accumulat"):
        _port_system(setup, _acc_cfg(3 - acc)).optimizer.load_state_tree(
            opt_tree, system.model)


# ------------------------------------------------------------------- fit

def _two_val_tasks(dm, log):
    """Freeze one val task per speaker into ``log``, where ``validate``
    reads the frozen tasks from (the JAX package's default is 4 a
    speaker)."""
    dm.val_sampler.prefetch_tasks(1, log, "val")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_fit_matches_jax(setup, tmp_path):
    """Both packages' ``Trainer.fit`` for 4 baseline steps, validation and
    checkpoints every 2, no vocoder: the same file tree (checkpoints, the
    train CSV, the event stream, the frozen val tasks, a CSV per val
    task), the same train CSV rows (the first at rtol 1e-5, the losses
    after free-running steps at 1e-4) and ``last.ckpt`` within the step
    tolerance; then the JAX loader takes the port's ``step_2.ckpt`` with its
    optimizer state.  The val rows at step 4 are only held finite here
    (``validation_step_batched`` is held against JAX above): after 4
    free-running steps the postnet's conv biases, whose training gradient
    its batch-statistics BatchNorm cancels, part by up to 0.08 lr, and the
    eval forward's running statistics carry that into the postnet loss
    (1e-3)."""
    tcfg = _step_train_cfg(total_step=4, log_step=1, val_step=2, save_step=2,
                           synth_step=0)
    out = {}
    for side in ("port", "jax"):
        out[side] = str(tmp_path / side)
        log = os.path.join(out[side], "log", "exp")
        if side == "port":
            system = _port_system(setup, tcfg)
            dm = BaselineDataModule([setup["pcfg"]], tcfg, setup["acfg"], log_dir=log)
            trainer = Trainer(system, dm, tcfg, output_dir=out[side], exp_name="exp")
        else:
            dm = JaxBaselineDM([setup["pcfg"]], tcfg, setup["acfg"], log_dir=log)
            trainer = JaxTrainer(setup["jax_system"](tcfg), dm, tcfg,
                                 output_dir=out[side], exp_name="exp")
        dm.setup()
        _two_val_tasks(dm, log)
        trainer.fit()
    assert _tree(out["port"]) == _tree(out["jax"])
    with open(os.path.join(out["port"], "log", "exp", "events.jsonl")) as f:
        assert any("profile/data_wait_ms" in json.loads(line).get("metrics", {}) for line in f)
    tree = _tree(out["port"])
    assert [f for f in tree if f.startswith("ckpt")] == [
        "ckpt/exp/last.ckpt", "ckpt/exp/step_2.ckpt", "ckpt/exp/step_4.ckpt"]
    val = [f for f in tree if "/Validation/" in f]
    assert len(val) == 2 and all(f.endswith(".csv") for f in val)
    rows = {side: {f: np.genfromtxt(os.path.join(out[side], f), delimiter=",",
                                    skip_header=1, ndmin=2) for f in ["log/exp/train.csv"] + val}
            for side in out}
    train = [rows[side]["log/exp/train.csv"] for side in ("port", "jax")]
    np.testing.assert_allclose(train[0][0], train[1][0], rtol=1e-5)
    np.testing.assert_allclose(train[0][1:], train[1][1:], rtol=1e-4)
    assert [r[f][:, 0].tolist() for r in rows.values() for f in val] == [[4.0]] * 4
    assert all(np.isfinite(r[f]).all() for r in rows.values() for f in val)
    sched = make_optimizer(setup["mcfg"], tcfg)[1]
    tol = sum(0.1 * float(sched(i)) for i in range(4))   # each step's tolerance
    model = _port_system(setup).model
    _, step, _ = ck.load_checkpoint(os.path.join(out["port"], "ckpt/exp/last.ckpt"), model)
    got = jax_trees_from_fs2(model)[0]
    jmodel = _port_system(setup).model
    ck.load_checkpoint(os.path.join(out["jax"], "ckpt/exp/last.ckpt"), jmodel)
    ref = jax_trees_from_fs2(jmodel)[0]
    assert step == 4
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=str(path))
    js = setup["jax_system"](tcfg)
    JaxTrainer(js, JaxBaselineDM([setup["pcfg"]], tcfg, setup["acfg"],
                                 log_dir=str(tmp_path / "resume")),
               tcfg, output_dir=str(tmp_path / "resume"), exp_name="exp")
    p, s, opt, step, report = jck.load_checkpoint(
        os.path.join(out["port"], "ckpt/exp/step_2.ckpt"), js.params, js.state, js.opt_state)
    assert step == 2 and report == [] and int(opt[1].count) == 2


def test_fit_writes_samples_under_jax_names(setup, tmp_path):
    """With a vocoder: the validation sample (reconstructed and synthesized
    wavs, the two-panel figure) and the training sample (recon and synth,
    each with its figure) at every val / synth step."""
    tcfg = _step_train_cfg(total_step=2, log_step=1, val_step=2, save_step=2,
                           synth_step=2)
    system = _port_system(setup, tcfg)
    dm = BaselineDataModule([setup["pcfg"]], tcfg, setup["acfg"],
                            log_dir=str(tmp_path / "log" / "exp"))
    dm.setup()
    _two_val_tasks(dm, dm.log_dir)
    vocoder = Vocoder(setup["mcfg"], n_mels=8, device="cpu")
    Trainer(system, dm, tcfg, output_dir=str(tmp_path), exp_name="exp",
            vocoder=vocoder).fit()
    tree = _tree(str(tmp_path / "result" / "exp"))
    for kind in ("audio", "figure"):
        got = sorted(os.path.basename(f) for f in tree
                     if f.startswith(f"{kind}/Validation/step_last/step_2/"))
        want = (["sample.reconstructed.wav", "sample.synthesized.wav"] if kind == "audio"
                else ["sample.png"])
        assert [g.replace(".npy", "") for g in got] == want, got
        got = sorted(os.path.basename(f) for f in tree
                     if f.startswith(f"{kind}/Training/step_last/step_2/"))
        want = ["sample.recon", "sample.synth"]
        assert [g.split(".wav")[0].split(".png")[0] for g in got] == want, got


# ------------------------------------------------------------------- CLI

@pytest.mark.parametrize("kind", ["baseline", "meta"])
def test_train_cli_on_cpu(setup, tmp_path, capsys, kind):
    """``-s train --device cpu`` writes the checkpoints and the train CSV;
    ``-c`` resumes with the optimizer state (the meta system at 1 episode
    of 1 inner step: one step, resumed for one more)."""
    from metatts_torch.__main__ import main, parse_args
    acfg = _acfg(kind)
    acfg["adapt"]["train"].update(steps=1, meta_batch_size=1)
    n = 2 if kind == "baseline" else 1
    tcfg = _step_train_cfg(total_step=n, log_step=1, val_step=100, save_step=1)
    configs = ([setup["pcfg"]], setup["mcfg"], tcfg, acfg)
    base = ["-s", "train", "--output_dir", str(tmp_path), "-e", "cli", "--no_synth",
            "--device", "cpu"]
    main(parse_args(base), configs)
    ckpts = sorted(os.listdir(tmp_path / "ckpt" / "cli"))
    assert ckpts == ["last.ckpt"] + [f"step_{i + 1}.ckpt" for i in range(n)]
    main(parse_args(base + ["-c", str(tmp_path / "ckpt" / "cli" / f"step_{n}.ckpt"),
                            "--max_steps", str(n + 1)]), configs)
    assert f"step_{n + 1}.ckpt" in os.listdir(tmp_path / "ckpt" / "cli")
    with open(tmp_path / "log" / "cli" / "train.csv") as f:
        assert [line.split(",")[0] for line in f][1:] == [str(i + 1) for i in range(n + 1)]
    assert "[ckpt surgery]" not in capsys.readouterr().out


def test_train_cli_needs_a_card_and_imaml_raises(setup, tmp_path):
    """Without a card ``-s train`` raises unless ``--device cpu``; the
    iMAML system is the port's ``IMAMLSystem`` and ``-s train --device
    cpu`` with config/algorithm/dev_imaml.yaml (cut to 1 shot, 1 query, 1
    episode of 1 inner step) takes its steps through ``Trainer.fit``."""
    from metatts_torch.__main__ import main, parse_args
    from metatts_torch.algorithms.imaml import IMAMLSystem
    tcfg = _step_train_cfg(total_step=1)
    args = parse_args(["-s", "train", "--output_dir", str(tmp_path), "--no_synth"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args, ([setup["pcfg"]], setup["mcfg"], tcfg, setup["acfg"]))
    assert get_system("imaml") is IMAMLSystem
    assert isinstance(_port_system(setup), BaselineSystem)
    acfg = C.load_algorithm_config(os.path.join(os.path.dirname(__file__), os.pardir, "config",
                                                "algorithm", "dev_imaml.yaml"))
    acfg["adapt"]["train"].update(shots=1, queries=1, steps=1, meta_batch_size=1)
    acfg["adapt"]["test"].update(shots=1, queries=1)
    tcfg = _step_train_cfg(total_step=2, log_step=1, val_step=100, save_step=2)
    main(parse_args(["-s", "train", "--output_dir", str(tmp_path), "-e", "imaml",
                     "--no_synth", "--device", "cpu"]),
         ([setup["pcfg"]], setup["mcfg"], tcfg, acfg))
    assert sorted(os.listdir(tmp_path / "ckpt" / "imaml")) == ["last.ckpt", "step_2.ckpt"]
    with open(tmp_path / "log" / "imaml" / "train.csv") as f:
        rows = [line.strip().split(",") for line in f][1:]
    assert [r[0] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(v)) for r in rows for v in r[1:])


@pytest.mark.parametrize("kind", ["baseline", "meta"])
def test_debug_cli_prints_the_jax_line(setup, tmp_path, capsys, kind):
    """``-s debug`` reads every test sample once and prints the JAX CLI's
    line (``main.py``'s debug stage: the count of its datamodule's test
    set); without a card it raises unless ``--device cpu``."""
    from metatts_torch.__main__ import main, parse_args
    acfg = _acfg(kind)
    configs = ([setup["pcfg"]], setup["mcfg"], _step_train_cfg(), acfg)
    jdm = (JaxMetaDM if kind == "meta" else JaxBaselineDM)(
        [setup["pcfg"]], _step_train_cfg(), acfg, log_dir=str(tmp_path / "jax"))
    jdm.setup()
    args = ["-s", "debug", "--output_dir", str(tmp_path), "-e", "debug"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(parse_args(args), configs)
    capsys.readouterr()
    main(parse_args(args + ["--device", "cpu"]), configs)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"debug: iterated {len(jdm.test_set)} test samples OK"
    assert len(jdm.test_set) > 0


# ------------------------------------------------------- host utilities

def test_prefetcher_yields_in_order_and_raises_the_producers_error():
    """Every ``next`` waits on the producer thread, so each waits against a
    deadline of its own: an item that never comes fails as ``queue.Empty``
    after 30 s (the whole check takes milliseconds)."""
    from metatts_torch.data.prefetch import Prefetcher

    def gen():
        yield from range(5)
        raise RuntimeError("collation failed")
    p = Prefetcher(gen(), depth=2)
    p._q.get = functools.partial(p._q.get, timeout=30)
    assert [next(p) for _ in range(5)] == list(range(5))
    with pytest.raises(RuntimeError, match="collation failed"):
        next(p)
    endless = Prefetcher(iter(range(10 ** 9)), depth=2)
    endless._q.get = functools.partial(endless._q.get, timeout=30)
    assert next(endless) == 0
    endless.close()
    endless._thread.join(timeout=10)
    assert not endless._thread.is_alive()


def test_profiling_trace_timer_and_memory(tmp_path):
    from metatts_torch.utils.profiling import StepTimer, device_memory_stats, trace
    with trace(str(tmp_path / "profile")):
        torch.ones(8).sum()
    assert [f for f in os.listdir(tmp_path / "profile") if f.endswith(".json")]
    timer = StepTimer(window=3)
    for _ in range(5):
        with timer:
            pass
    s = timer.stats()
    assert s["steps"] == 3 and s["p50_ms"] <= s["p95_ms"] and s["steps_per_sec"] > 0
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
