"""Port: checkpoints across the two packages (``metatts_torch/train/
checkpoint.py`` and ``convert.jax_trees_from_fs2``) at the tiny config of
tests/helpers.py.

* The port's msgpack reader reads what ``flax.serialization.to_bytes``
  writes, for every dtype of a FastSpeech2 tree and its step plus a
  ``bfloat16`` leaf, leaf for leaf and bit for bit; its writer gives back
  flax's bytes exactly, so flax reads it (a ``bfloat16`` numpy scalar
  comes back as a 0-d array).
* A blob from the JAX ``save_checkpoint`` loads into the port equal to
  ``load_fs2_from_jax`` on the same trees; a blob from the port's
  ``save_checkpoint`` loads through the JAX ``load_checkpoint`` into the
  source trees, exactly.
* The three surgery cases (rows resized, a shape mismatch, missing leaves)
  give the JAX package's tensors exactly and its report line for line;
  ``average_speaker_rows`` matches the JAX one at rtol 1e-6 (fp32 means
  summed in another order).
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch
import jax
from flax import serialization

from metatts_tpu.train import checkpoint as jck
from metatts_torch.convert import jax_trees_from_fs2, load_fs2_from_jax
from metatts_torch.models.fastspeech2 import FastSpeech2
from metatts_torch.train import checkpoint as ck

from helpers import tiny_model_cfg, tiny_preprocess_cfg, algorithm_cfg, STATS
from torch_port_helpers import fs2_params, one_torch_thread  # noqa: F401

DTYPES = ["float32", "float64", "float16", "int32", "int64", "uint8", "bool",
          "bfloat16"]


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def fs2():
    pcfg, mcfg, acfg = tiny_preprocess_cfg(), tiny_model_cfg(), algorithm_cfg("meta")
    params, state = fs2_params(pcfg, mcfg, acfg, STATS, 4)
    return pcfg, mcfg, acfg, _f32(params), _f32(state)


def _model(fs2, params=None, state=None, seed=1):
    pcfg, mcfg, acfg = fs2[:3]
    model = FastSpeech2(pcfg, mcfg, acfg, STATS, 4,
                        generator=torch.Generator().manual_seed(seed))
    if params is not None:
        load_fs2_from_jax(model, params, state)
    return model


def _assert_trees_equal(got, ref):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def _leaf(dtype, rng, shape=(3, 5)):
    x = np.asarray(rng.randn(*shape) * 100)
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    if dtype == "bool":
        return x > 0
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_and_writer_match_flax(fs2, dtype):
    rng = np.random.RandomState(DTYPES.index(dtype))
    tree = {"params": fs2[3], "state": fs2[4], "opt_state": {},
            "step": np.asarray(12, np.int64),
            "extra": {"leaf": _leaf(dtype, rng), "scalar": _leaf(dtype, rng, ())[()],
                      "big": _leaf(dtype, rng, (300, 120)),
                      "list": [_leaf(dtype, rng, (2,)), _leaf(dtype, rng, (0, 4))],
                      "wide": {f"k{i}": np.float32(i) for i in range(20)}}}
    blob = serialization.to_bytes(tree)
    got = ck.msgpack_restore(blob)
    ref = serialization.msgpack_restore(blob)

    def same(a, b):
        if isinstance(a, torch.Tensor):       # a bfloat16 leaf
            assert a.dtype == torch.bfloat16 and b.dtype == ml_dtypes.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  np.asarray(b).view(np.int16))
        else:
            assert type(a) is type(b) and np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(a, b)
    jax.tree.map(same, got, ref, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert ck.to_bytes(tree) == blob
    if dtype == "bfloat16":
        # a bfloat16 numpy scalar reads as a 0-d tensor and is written back
        # as a 0-d array
        tree["extra"]["scalar"] = np.asarray(tree["extra"]["scalar"])
        blob = serialization.to_bytes(tree)
    assert ck.to_bytes(got) == blob


def test_writer_python_scalars_read_by_flax():
    tree = {"s": "a string longer than thirty-one bytes", "f": 0.25, "i": -70000,
            "u": 2 ** 40, "n": None, "t": True, "b": b"\x00\x01",
            "t16": torch.arange(5, dtype=torch.float32).bfloat16()}
    back = serialization.msgpack_restore(ck.to_bytes(tree))
    assert {k: v for k, v in back.items() if k != "t16"} == \
        {k: v for k, v in tree.items() if k != "t16"}
    np.testing.assert_array_equal(np.asarray(back["t16"], np.float32), np.arange(5))
    assert ck.msgpack_restore(ck.to_bytes(tree))["s"] == tree["s"]


def test_jax_trees_round_trip(fs2):
    params, state = fs2[3:]
    got_p, got_s = jax_trees_from_fs2(_model(fs2, params, state))
    _assert_trees_equal(got_p, params)
    _assert_trees_equal(got_s, state)


def test_jax_checkpoint_loads_into_port(fs2, tmp_path):
    pcfg, mcfg, acfg, params, state = fs2
    path = str(tmp_path / "jax.msgpack")
    opt_state = {"mu": params["mel_linear"], "count": np.asarray(3, np.int32)}
    jck.save_checkpoint(path, params, state, opt_state, 5)
    model = _model(fs2)
    opt, step, report = ck.load_checkpoint(path, model)
    assert step == 5 and report == [] and int(opt["count"]) == 3
    ref = _model(fs2, params, state, seed=2).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_port_checkpoint_loads_into_jax(fs2, tmp_path):
    pcfg, mcfg, acfg, params, state = fs2
    path = str(tmp_path / "ckpt" / "port.msgpack")
    ck.save_checkpoint(path, _model(fs2, params, state), 7)
    assert not os.path.exists(path + ".tmp")
    like_p, like_s = jax_trees_from_fs2(_model(fs2))
    p, s, opt, step, report = jck.load_checkpoint(path, like_p, like_s, {})
    assert step == 7 and report == [] and opt == {}
    _assert_trees_equal(jax.tree.map(np.asarray, p), params)
    _assert_trees_equal(jax.tree.map(np.asarray, s), state)


def _edit(case, params, state):
    params = jax.tree.map(np.copy, params)
    state = jax.tree.map(np.copy, state)
    if case == "resized":        # a speaker table of another corpus
        params["speaker_emb"]["table"] = params["speaker_emb"]["table"][:2] + 1.0
    elif case == "mismatch":     # a bias and a conv of other widths
        params["mel_linear"]["b"] = np.ones(9, np.float32)
        params["decoder"]["layers"][0]["ffn"]["w1"]["w"] = np.ones((48, 32, 3), np.float32)
    else:                        # missing leaves in params and state
        del params["postnet"]["convs"][1]["bn"]
        del state["postnet"]["convs"][0]["mean"]
    return params, state


@pytest.mark.parametrize("case", ["resized", "mismatch", "missing"])
def test_surgery_matches_jax(fs2, tmp_path, case):
    params, state = _edit(case, *fs2[3:])
    path = str(tmp_path / f"{case}.msgpack")
    jck.save_checkpoint(path, params, state, {}, 3)
    model = _model(fs2)
    like_p, like_s = jax_trees_from_fs2(model)
    ref_p, ref_s, _, _, ref_report = jck.load_checkpoint(path, like_p, like_s, {})
    opt, step, report = ck.load_checkpoint(path, model)
    assert report == ref_report and len(report) >= 1 and opt is None
    assert any(line.startswith({"resized": "resized", "mismatch": "shape mismatch",
                                "missing": "missing"}[case]) for line in report)
    got_p, got_s = jax_trees_from_fs2(model)
    _assert_trees_equal(got_p, jax.tree.map(np.asarray, ref_p))
    _assert_trees_equal(got_s, jax.tree.map(np.asarray, ref_s))


def test_average_speaker_rows_matches_jax(fs2):
    params, state = fs2[3:]
    model = _model(fs2, params, state)
    ck.average_speaker_rows(model, [0, 2, 3])
    ref = jck.average_speaker_rows(params, [0, 2, 3])
    np.testing.assert_allclose(model.speaker_emb.model.weight.detach().numpy(),
                               np.asarray(ref["speaker_emb"]["table"]), rtol=1e-6)
