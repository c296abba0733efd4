"""JAX parameter trees (nested dicts/lists of numpy arrays) <-> state dicts
of the port's modules.

The FastSpeech2 mapping is the reference checkpoint mapping of
``tools/load_reference_fs2.py``: the port's parameter names are the
reference's torch names, linear weights are transposed to torch's
(out, in), conv kernels keep their (out, in, k) layout.  Loading uses
``load_state_dict(strict=True)``, so a tensor the mapping misses raises
instead of staying at its init.  ``jax_trees_from_fs2`` runs the same
mapping backwards, with the JAX init's key order.
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


def build_mapping(n_encoder, n_decoder, n_postnet, speaker_table,
                  ge2e_layers=0, codebook=None):
    """torch name -> ("params" | "state", path list, transpose?), for a
    FastSpeech2 with these layer counts and, if ``speaker_table``, a
    speaker table, or with ``ge2e_layers`` > 0 a GE2E d-vector network of
    that many LSTM layers (torch's and resemblyzer's names and (4H, in)
    layout; the JAX tree's ``lstm/layers/k/w_ih`` is (in, 4H)); with
    ``codebook`` ("hard" | "soft") the cross-lingual codebook, which the
    JAX package keeps at the top of ``params`` as ``phn_emb_generator``."""
    m = {"encoder.src_word_emb.weight":
         ("params", ["encoder", "src_word_emb", "table"], False)}
    for stack, n in (("encoder", n_encoder), ("decoder", n_decoder)):
        for i in range(n):
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
    for i in range(n_postnet):
        pre = f"postnet.convolutions.{i}"
        m[f"{pre}.0.conv.weight"] = ("params", ["postnet", "convs", i, "conv", "w"], False)
        m[f"{pre}.0.conv.bias"] = ("params", ["postnet", "convs", i, "conv", "b"], False)
        m[f"{pre}.1.weight"] = ("params", ["postnet", "convs", i, "bn", "scale"], False)
        m[f"{pre}.1.bias"] = ("params", ["postnet", "convs", i, "bn", "bias"], False)
        m[f"{pre}.1.running_mean"] = ("state", ["postnet", "convs", i, "mean"], False)
        m[f"{pre}.1.running_var"] = ("state", ["postnet", "convs", i, "var"], False)
    if speaker_table:
        m["speaker_emb.model.weight"] = ("params", ["speaker_emb", "table"], False)
    for k in range(ge2e_layers):
        path = ["speaker_emb", "lstm", "layers", k]
        for name, key, t in (("weight_ih", "w_ih", True), ("weight_hh", "w_hh", True),
                             ("bias_ih", "b_ih", False), ("bias_hh", "b_hh", False)):
            m[f"speaker_emb.model.lstm.{name}_l{k}"] = ("params", path + [key], t)
    if ge2e_layers:
        m["speaker_emb.model.linear.weight"] = (
            "params", ["speaker_emb", "linear", "w"], True)
        m["speaker_emb.model.linear.bias"] = ("params", ["speaker_emb", "linear", "b"], False)
    if codebook:
        for bank in ("emb_banks", "att_banks"):
            m[f"phn_emb_generator.{bank}"] = ("params", ["phn_emb_generator", bank], False)
    if codebook == "soft":
        for proj in ("w_qs", "w_ks"):
            m[f"phn_emb_generator.{proj}.weight"] = (
                "params", ["phn_emb_generator", proj, "w"], True)
            m[f"phn_emb_generator.{proj}.bias"] = (
                "params", ["phn_emb_generator", proj, "b"], False)
    return m


def _jax_mapping(params):
    """``build_mapping`` for a JAX FastSpeech2 ``params`` tree."""
    spk = params.get("speaker_emb", {})
    codebook = params.get("phn_emb_generator")
    return build_mapping(len(params["encoder"]["layers"]),
                         len(params["decoder"]["layers"]),
                         len(params["postnet"]["convs"]), "table" in spk,
                         len(spk["lstm"]["layers"]) if "lstm" in spk else 0,
                         None if codebook is None
                         else "soft" if "w_qs" in codebook else "hard")


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
            for name, (which, path, t) in _jax_mapping(params).items()}


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


# The key order of the JAX package's ``fastspeech2_init`` trees (a key's
# place among its siblings), so that trees built here walk in the order
# the JAX package's do, e.g. in a checkpoint's surgery report.
_JAX_KEY_ORDER = {k: i for i, k in enumerate((
    "encoder", "variance_adaptor", "decoder", "mel_linear", "postnet",
    "speaker_emb", "src_word_emb", "layers", "attn", "ffn", "w_q", "w_k",
    "w_v", "fc", "w1", "w2", "ln", "duration_predictor", "pitch_predictor",
    "energy_predictor", "pitch_embedding", "energy_embedding", "pitch_bins",
    "energy_bins", "conv1", "ln1", "conv2", "ln2", "lstm", "linear", "convs", "conv",
    "bn", "w", "b", "scale", "bias", "table", "mean", "var", "w_ih", "w_hh",
    "b_ih", "b_hh", "phn_emb_generator", "emb_banks", "att_banks", "w_qs", "w_ks"))}


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _finish(tree):
    """Build-time dicts -> the JAX layout: integer keys become lists, other
    keys take the JAX init's order."""
    if not isinstance(tree, dict):
        return tree
    if all(isinstance(k, int) for k in tree):
        return [_finish(tree[i]) for i in range(len(tree))]
    return {k: _finish(tree[k]) for k in sorted(tree, key=_JAX_KEY_ORDER.__getitem__)}


def _fs2_mapping(model):
    spk = model.speaker_emb
    lstm = getattr(getattr(spk, "model", None), "lstm", None)
    codebook = getattr(model, "phn_emb_generator", None)
    return build_mapping(len(model.encoder.layer_stack),
                         len(model.decoder.layer_stack),
                         len(model.postnet.convolutions),
                         spk is not None and lstm is None,
                         lstm.n_layers if lstm is not None else 0,
                         None if codebook is None
                         else "hard" if codebook.attention == "hard" else "soft")


def _trees(named, mapping):
    trees = {"params": {}, "state": {}}
    for name, (which, path, t) in mapping.items():
        v = named[name].detach().cpu().numpy()
        _put(trees[which], path, np.array(v.T if t else v, order="C"))
    return _finish(trees["params"]), _finish(trees["state"])


def jax_trees_from_fs2(model):
    """A port ``FastSpeech2`` -> the JAX package's (params, state) trees of
    numpy arrays, with linear weights transposed back to (in, out)."""
    return _trees(model.state_dict(), _fs2_mapping(model))


def jax_params_tree(model, named):
    """``named`` (parameter name of ``model`` -> tensor of its shape: an Adam
    moment, a gradient) -> a tree in the layout of the JAX ``params``.  The
    pitch and energy bins, buffers here and parameters there, are zeros:
    no gradient reaches them, so every moment of theirs is 0 in the JAX
    package too."""
    sd = model.state_dict()
    full = {k: named[k] if k in named else torch.zeros_like(v)
            for k, v in sd.items()}
    return _trees(full, _fs2_mapping(model))[0]


def named_from_jax_params_tree(model, tree):
    """A tree in the layout of the JAX ``params`` -> parameter name of
    ``model`` -> fp32 tensor (``jax_params_tree`` run backwards); raises
    ValueError where a leaf is missing or has another shape.  Lists may be
    maps with string indices, as a checkpoint stores them."""
    mapping, out = _fs2_mapping(model), {}
    for name, p in model.named_parameters():
        _, path, t = mapping[name]
        try:
            leaf = tree
            for k in path:
                leaf = leaf[str(k)] if isinstance(leaf, dict) and isinstance(k, int) \
                    else leaf[k]
            v = _tensor(leaf, t)
        except (KeyError, IndexError, TypeError):
            raise ValueError(f"no leaf /{'/'.join(map(str, path))}") from None
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"/{'/'.join(map(str, path))}: shape "
                             f"{tuple(v.shape)}, the model's {tuple(p.shape)}")
        out[name] = v.float()
    return out


def load_vocoder_from_jax(vocoder, params):
    vocoder.load_state_dict(tree_state_dict(params))
    return vocoder
