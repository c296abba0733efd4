"""JAX parameter trees (nested dicts/lists of numpy arrays) -> state dicts
of the port's modules.

The FastSpeech2 mapping is the reference checkpoint mapping of
``tools/load_reference_fs2.py``: the port's parameter names are the
reference's torch names, linear weights are transposed to torch's
(out, in), conv kernels keep their (out, in, k) layout.  Loading uses
``load_state_dict(strict=True)``, so a tensor the mapping misses raises
instead of staying at its init.
"""

import numpy as np
import torch


def _mha_paths(base, i):
    pre = f"{base}.layer_stack.{i}"
    m = {}
    for torch_name, key in (("w_qs", "w_q"), ("w_ks", "w_k"),
                            ("w_vs", "w_v"), ("fc", "fc")):
        m[f"{pre}.slf_attn.{torch_name}.weight"] = (
            ["layers", i, "attn", key, "w"], True)
        m[f"{pre}.slf_attn.{torch_name}.bias"] = (
            ["layers", i, "attn", key, "b"], False)
    for torch_name, key in (("weight", "scale"), ("bias", "bias")):
        m[f"{pre}.slf_attn.layer_norm.{torch_name}"] = (
            ["layers", i, "attn", "ln", key], False)
        m[f"{pre}.pos_ffn.layer_norm.{torch_name}"] = (
            ["layers", i, "ffn", "ln", key], False)
    for torch_name, key in (("w_1", "w1"), ("w_2", "w2")):
        m[f"{pre}.pos_ffn.{torch_name}.weight"] = (
            ["layers", i, "ffn", key, "w"], False)
        m[f"{pre}.pos_ffn.{torch_name}.bias"] = (
            ["layers", i, "ffn", key, "b"], False)
    return m


def _vp_paths(name):
    pre = f"variance_adaptor.{name}"
    m = {}
    for j in (1, 2):
        m[f"{pre}.conv_layer.conv1d_{j}.conv.weight"] = ([name, f"conv{j}", "w"], False)
        m[f"{pre}.conv_layer.conv1d_{j}.conv.bias"] = ([name, f"conv{j}", "b"], False)
        m[f"{pre}.conv_layer.layer_norm_{j}.weight"] = ([name, f"ln{j}", "scale"], False)
        m[f"{pre}.conv_layer.layer_norm_{j}.bias"] = ([name, f"ln{j}", "bias"], False)
    m[f"{pre}.linear_layer.weight"] = ([name, "linear", "w"], True)
    m[f"{pre}.linear_layer.bias"] = ([name, "linear", "b"], False)
    return m


def build_mapping(params):
    """torch name -> ("params" | "state", path list, transpose?)."""
    m = {"encoder.src_word_emb.weight":
         ("params", ["encoder", "src_word_emb", "table"], False)}
    for stack in ("encoder", "decoder"):
        for i in range(len(params[stack]["layers"])):
            for k, (path, t) in _mha_paths(stack, i).items():
                m[k] = ("params", [stack] + path, t)
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        for k, (path, t) in _vp_paths(name).items():
            m[k] = ("params", ["variance_adaptor"] + path, t)
    for name in ("pitch", "energy"):
        m[f"variance_adaptor.{name}_embedding.weight"] = (
            "params", ["variance_adaptor", f"{name}_embedding", "table"], False)
        m[f"variance_adaptor.{name}_bins"] = (
            "params", ["variance_adaptor", f"{name}_bins"], False)
    m["mel_linear.weight"] = ("params", ["mel_linear", "w"], True)
    m["mel_linear.bias"] = ("params", ["mel_linear", "b"], False)
    for i in range(len(params["postnet"]["convs"])):
        pre = f"postnet.convolutions.{i}"
        m[f"{pre}.0.conv.weight"] = ("params", ["postnet", "convs", i, "conv", "w"], False)
        m[f"{pre}.0.conv.bias"] = ("params", ["postnet", "convs", i, "conv", "b"], False)
        m[f"{pre}.1.weight"] = ("params", ["postnet", "convs", i, "bn", "scale"], False)
        m[f"{pre}.1.bias"] = ("params", ["postnet", "convs", i, "bn", "bias"], False)
        m[f"{pre}.1.running_mean"] = ("state", ["postnet", "convs", i, "mean"], False)
        m[f"{pre}.1.running_var"] = ("state", ["postnet", "convs", i, "var"], False)
    if "speaker_emb" in params:
        if "table" not in params["speaker_emb"]:
            raise NotImplementedError(
                "GE2E speaker-encoder parameters are not ported yet: "
                "ROADMAP Queue 1 item 11")
        m["speaker_emb.model.weight"] = ("params", ["speaker_emb", "table"], False)
    return m


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tensor(v, transpose=False):
    v = np.asarray(v)
    return torch.from_numpy(np.array(v.T if transpose else v, order="C"))


def fs2_state_dict_from_jax(params, state):
    """FastSpeech2 ``params`` / ``state`` trees -> the port's state dict."""
    trees = {"params": params, "state": state}
    return {name: _tensor(_get(trees[which], path), t)
            for name, (which, path, t) in build_mapping(params).items()}


def fft_block_state_dict_from_jax(p):
    """One FFT block's tree (``fft_block_init``) -> ``FFTBlock`` state dict."""
    pre = "stack.layer_stack.0."
    return {name[len(pre):]: _tensor(_get({"layers": [p]}, path), t)
            for name, (path, t) in _mha_paths("stack", 0).items()}


def tree_state_dict(tree, prefix=""):
    """Nested dicts/lists with ``w`` / ``b`` conv leaves (the vocoder trees)
    -> flat state dict with ``weight`` / ``bias`` names."""
    leaf = {"w": "weight", "b": "bias"}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(tree_state_dict(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{leaf.get(k, k)}"] = _tensor(v)
    return out


def load_fs2_from_jax(model, params, state):
    model.load_state_dict(fs2_state_dict_from_jax(params, state), strict=True)
    return model


def load_vocoder_from_jax(vocoder, params):
    vocoder.load_state_dict(tree_state_dict(params))
    return vocoder
