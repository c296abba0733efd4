"""Tiny versions of the cells for CPU tests: the configurations cut in
depth and width, short utterances, small pools."""

import copy
import json
import os

from perfbench import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = {"serve-b8": "metatts-libritts-meta", "base-train-b80": "metatts-libritts-base"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    t = cfg["model"]["transformer"]
    t.update(encoder_layer=1, decoder_layer=1, encoder_hidden=64, decoder_hidden=64,
             conv_filter_size=128)
    cfg["model"]["variance_predictor"]["filter_size"] = 64
    cfg["model"]["max_seq_len"] = 128
    cfg["n_speakers"] = 8
    return cfg


def mix(cell):
    m = copy.deepcopy(traffic.load(cell))
    m["lengths"] = {"mean_s": 0.5, "sigma": 0.6, "min_s": 0.1}
    m["frames_per_phoneme"] = 4.0
    m["pool_units"] = 2
    m["trace_seconds"] = 0.2
    if m["entry"] == "synthesize":
        m.update(per_unit=2, mel_cap=64, check_requests=2)
    else:
        m["per_unit"] = 4
    return m


def cell_args(cell):
    return dict(bench=bench(), cfg=config(CELLS[cell]), mix=mix(cell), device="cpu")
