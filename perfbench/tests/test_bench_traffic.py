"""The traffic generator: the same seed gives the same requests and
batches, another seed others; the lengths' mean is LibriTTS's; a mix's
keys, not its entry point, decide targets and speakers."""

import json
import os

import numpy as np
import pytest

from perfbench import traffic as T

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = ["serve-b8", "base-train-b80"]


def cfg():
    with open(os.path.join(HERE, "configs", "metatts-libritts-meta.json")) as f:
        return json.load(f)


def flat(units):
    out = []
    for u in units:
        for s in u:
            out.append((s["speaker"], s["text"].tobytes(),
                        s["mel"].tobytes() if "mel" in s else b""))
    return out


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_draw_other_seed_other(mix):
    m = T.load(mix)
    a, ra = T.draw(m, cfg(), 2 ** 31 + 7)
    b, rb = T.draw(m, cfg(), 2 ** 31 + 7)
    c, rc = T.draw(m, cfg(), 2 ** 31 + 8)
    assert flat(a) == flat(b)
    assert np.array_equal(ra, rb)
    assert flat(a) != flat(c)
    # every seed offers the same set of sizes, in another order
    assert sorted(ra.ravel()) == pytest.approx(sorted(rc.ravel()))


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_mean_is_the_configured_libritts_mean(mix):
    m = T.load(mix)
    c = cfg()
    _, raw = T.draw(m, c, 3)
    fps = 22050 / 256
    assert raw.mean() / fps == pytest.approx(m["lengths"]["mean_s"], rel=1e-9)
    assert m["lengths"]["mean_s"] == pytest.approx(53.78 * 3600 / 33236, abs=1e-3)
    units, _ = T.draw(m, c, 3)
    for u in units:
        assert len(u) == m["per_unit"]
        for s in u:
            if "mel" in s:
                assert len(s["mel"]) <= c["model"]["max_seq_len"]
                assert int(s["duration"].sum()) == len(s["mel"])
                assert len(s["pitch"]) == len(s["text"]) == len(s["duration"])


def test_stratum_means_average_to_the_mean():
    for n in (1, 8, 10, 80, 128):
        assert T.stratum_means(n, 5.825, 0.6).mean() == pytest.approx(5.825, rel=1e-9)


def test_one_speaker_per_unit_is_a_key_of_the_mix():
    m = T.load("base-train-b80")
    units, _ = T.draw(m, cfg(), 11)
    assert all(len({s["speaker"] for s in u}) > 1 for u in units)
    units, _ = T.draw({**m, "one_speaker_per_unit": True}, cfg(), 11)
    assert all(len({s["speaker"] for s in u}) == 1 for u in units)


def test_targets_are_drawn_where_the_mix_has_them():
    serve, train = T.load("serve-b8"), T.load("base-train-b80")
    assert all("mel" not in s for u in T.draw(serve, cfg(), 5)[0] for s in u)
    units, _ = T.draw({**serve, "targets": train["targets"]}, cfg(), 5)
    assert all("mel" in s and "duration" in s for u in units for s in u)


def test_large_seed():
    units, _ = T.draw(T.load("serve-b8"), cfg(), 2 ** 33 + 1)
    assert len(units) == T.load("serve-b8")["pool_units"]
