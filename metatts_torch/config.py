"""Config stack: four orthogonal groups (preprocess / model / train /
algorithm), each a defaults dict that a YAML file overlays.

``MODEL_DEFAULTS`` equals ``config/model/base.yaml`` and ``base_configs``
builds the base serving configuration, so it needs no YAML file and no
PyYAML, which is imported only inside ``load_yaml``.
"""

import copy


def deep_merge(base, overlay):
    """Recursive dict merge; overlay wins. Lists/scalars are replaced."""
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_yaml(path):
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


# ---------------------------------------------------------------- defaults

MODEL_DEFAULTS = {
    "transformer": {
        "encoder_layer": 4, "encoder_head": 2, "encoder_hidden": 256,
        "decoder_layer": 6, "decoder_head": 2, "decoder_hidden": 256,
        "conv_filter_size": 1024, "conv_kernel_size": [9, 1],
        "encoder_dropout": 0.2, "decoder_dropout": 0.2,
    },
    "variance_predictor": {
        "filter_size": 256, "kernel_size": 3, "dropout": 0.5,
    },
    "variance_embedding": {
        "pitch_quantization": "linear", "energy_quantization": "linear",
        "n_bins": 256,
    },
    "multi_speaker": True,
    "multi_lingual": True,
    "max_seq_len": 1000,
    "vocoder": {"model": "MelGAN", "speaker": "universal"},
    "compute_dtype": "bfloat16",     # matmul/conv input precision
    "activation_dtype": "bfloat16",  # FFT-block residual stream between
                                     # blocks (LN stats, params and losses
                                     # stay fp32); float32 for parity work
    "attention_scores_dtype": "bfloat16",  # (B,h,T,T) scores + softmax
    "max_src_len": 192,
    "remat": False,
    "layer_scan": "auto",
    "second_order_impl": "custom_hvp",
}

TRAIN_DEFAULTS = {
    "distributed": "auto",
    "test_task_batch": "auto",
    "profile": "simple",
    "transfer_mel_dtype": "auto",
    "optimizer": {
        "batch_size": 80, "betas": [0.9, 0.98], "eps": 1e-9,
        "weight_decay": 0.0, "grad_clip_thresh": 1.0, "grad_acc_step": 1,
        "warm_up_step": 4000, "anneal_steps": [300000, 400000, 500000],
        "anneal_rate": 0.3,
    },
    "step": {
        "total_step": 100000, "log_step": 100, "synth_step": 1000,
        "val_step": 1000, "save_step": 1000,
    },
    "path": {
        "ckpt_path": "./output/ckpt", "log_path": "./output/log",
        "result_path": "./output/result",
    },
}

ALGORITHM_DEFAULTS = {
    "name": "base_emb_vad",
    "type": "baseline",  # baseline | meta | imaml
    "adapt": {
        "type": "spk",  # spk | lang
        "speaker_emb": "table",  # table | shared | encoder | dvec | scratch_encoder
        "phoneme_emb": {"type": "embedding", "refresh": False},
        "modules": ["speaker_emb", "variance_adaptor", "decoder",
                    "mel_linear", "postnet"],
        "task": {"ways": 1, "shots": 5, "queries": 5, "lr": 0.001},
        "train": {"ways": 1, "shots": 5, "queries": 5, "lr": 0.001,
                  "steps": 5, "meta_batch_size": 8},
        "test": {"ways": 1, "shots": 5, "queries": 1, "lr": 0.001,
                 "steps": 100,
                 "saving_steps": [5, 10, 20, 50, 100],
                 "avg_train_spk_emb": False, "1-shot": False,
                 "snapshot_offload": "auto"},
        "imaml": {"reg_param": 1.0, "cg_steps": 5, "batch_size": None},
    },
}

# ``config/algorithm/meta_emb_vad.yaml`` as an overlay of the defaults.
META_EMB_VAD = {
    "name": "meta_emb_vad",
    "type": "meta",
    "adapt": {
        "type": "spk",
        "speaker_emb": "table",
        "modules": ["speaker_emb", "variance_adaptor", "decoder",
                    "mel_linear", "postnet"],
        "train": {"ways": 1, "shots": 5, "queries": 5, "lr": 0.001,
                  "steps": 5, "meta_batch_size": 8},
        "test": {"ways": 1, "shots": 5, "queries": 1, "lr": 0.001,
                 "steps": 100, "saving_steps": [5, 10, 20, 50, 100]},
    },
}

PREPROCESS_DEFAULTS = {
    "dataset": "miniLibriTTS",
    "lang_id": 0,
    "path": {
        "corpus_path": "", "lexicon_path": "lexicon/librispeech-lexicon.txt",
        "raw_path": "./raw_data/LibriTTS",
        "preprocessed_path": "./preprocessed_data/miniLibriTTS",
    },
    "subsets": {"train": "train-clean", "val": "dev-clean", "test": "test-clean"},
    "preprocessing": {
        "val_size": 512,
        "text": {"text_cleaners": ["english_cleaners"], "language": "en"},
        "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
        "stft": {"filter_length": 1024, "hop_length": 256, "win_length": 1024},
        "mel": {"n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": None},
        "pitch": {"feature": "phoneme_level", "normalization": True},
        "energy": {"feature": "phoneme_level", "normalization": True},
    },
}


def load_preprocess_configs(paths):
    """-p: list of preprocess YAMLs -> list of filled configs."""
    return [deep_merge(PREPROCESS_DEFAULTS, load_yaml(p)) for p in paths]


def load_model_config(path):
    cfg = deep_merge(MODEL_DEFAULTS, load_yaml(path))
    for key in ("compute_dtype", "activation_dtype",
                "attention_scores_dtype"):
        v = cfg.get(key)
        if v not in (None, "float32", "bfloat16", "float16"):
            raise ValueError(
                f"model config {key}={v!r}: expected one of "
                "float32 | bfloat16 | float16")
    return cfg


def load_train_configs(paths):
    """-t: base + overlay train YAMLs merged left-to-right."""
    cfg = TRAIN_DEFAULTS
    for p in paths:
        cfg = deep_merge(cfg, load_yaml(p))
    return cfg


def load_algorithm_config(path):
    cfg = deep_merge(ALGORITHM_DEFAULTS, load_yaml(path))
    _validate_algorithm(cfg)
    return cfg


def _validate_algorithm(cfg):
    if cfg["type"] not in ("baseline", "meta", "imaml"):
        raise ValueError(f"unknown algorithm type {cfg['type']!r}")
    adapt = cfg["adapt"]
    if adapt["type"] not in ("spk", "lang"):
        raise ValueError(f"unknown adapt type {adapt['type']!r}")
    if adapt["speaker_emb"] not in (
            "table", "shared", "encoder", "dvec", "scratch_encoder"):
        raise ValueError(f"unknown speaker_emb {adapt['speaker_emb']!r}")
    known = {"encoder", "speaker_emb", "variance_adaptor", "decoder",
             "mel_linear", "postnet"}
    unknown = set(adapt["modules"]) - known
    if unknown:
        raise ValueError(f"unknown adapt.modules {sorted(unknown)}")


def default_configs():
    """All four groups at their defaults."""
    return (
        [copy.deepcopy(PREPROCESS_DEFAULTS)],
        copy.deepcopy(MODEL_DEFAULTS),
        copy.deepcopy(TRAIN_DEFAULTS),
        copy.deepcopy(ALGORITHM_DEFAULTS),
    )


def base_configs():
    """(preprocess, model, algorithm) of the base serving configuration:
    ``config/preprocess/LibriTTS.yaml``, ``config/model/base.yaml`` and
    ``config/algorithm/meta_emb_vad.yaml``, built from the dicts above.
    ``tests/test_torch_modules.py`` checks that they equal the YAML files."""
    pcfg = deep_merge(PREPROCESS_DEFAULTS, {
        "dataset": "LibriTTS",
        "path": {"corpus_path": "./corpus/LibriTTS",
                 "preprocessed_path": "./preprocessed_data/LibriTTS"}})
    acfg = deep_merge(ALGORITHM_DEFAULTS, META_EMB_VAD)
    _validate_algorithm(acfg)
    return pcfg, copy.deepcopy(MODEL_DEFAULTS), acfg
