"""Port: the evaluation metrics (``evaluation/similarity.py``,
``verification.py``, ``mos.py``'s interval), the figures, and the CLI
``python -m metatts_torch.evaluate`` against the JAX package.

The metrics are numpy in both packages and must agree exactly; the
Student-t quantile, numpy and the standard library in the port and
``scipy.stats.t.ppf`` in the JAX package, within rel 1e-10 for df 1-200.

The CLI runs on a result tree written from a seed as
tests/test_eval_matrix.py builds one (2 real speakers x 3 wavs; 2 test
tasks of 2 queries, recon and synth at FT steps 0 and 10, with the frozen
episode descriptions beside it), with the repository's GE2E weights
(``examples/meta_advantage_eer/ge2e_scratch.npz``).  The JAX
``run_matrix`` and ``main`` run first; the port then runs over the same
cache directory and must write the same ``eer.txt`` string for string
without rewriting a cache file; with a fresh cache every label matches
and every EER / AUC value is within one pair's step, 1 / min(#same
pairs, #different pairs) (the d-vectors agree to ~1e-6, which can move a
threshold past a tied pair), every centroid similarity within 1.5e-4 (a
4-decimal rounding).
"""

import json
import os
import runpy
import sys
import types
import warnings

import numpy as np
import pytest
import scipy.stats
import yaml

import evaluate as jev
from metatts_tpu.evaluation import mos as jmos
from metatts_tpu.evaluation import similarity as jsim
from metatts_tpu.evaluation import verification as jver
from metatts_tpu.preprocess.audio_io import save_wav
from metatts_torch.evaluation import figures as tfig
from metatts_torch.evaluation import mos as tmos
from metatts_torch.evaluation import similarity as tsim
from metatts_torch.evaluation import verification as tver
from metatts_torch.evaluation import visualize as tvis

from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "examples", "meta_advantage_eer", "ge2e_scratch.npz")
SR = 22050


def _groups(seed, sizes=(4, 3, 1, 5), d=8):
    rng = np.random.RandomState(seed)
    return {f"spk{i}": rng.randn(n, d).astype(np.float32) for i, n in enumerate(sizes)}


def test_similarity_and_verification_exact():
    """centroid and pair similarities (with ``n_pairs``' RandomState
    subsampling) and EER / threshold / AUC / DET arrays, equal to the JAX
    package's; the degenerate case NaN with a warning."""
    g = _groups(0)
    for n_pairs in (None, 5):
        got = tsim.pair_similarity(g, rng=np.random.RandomState(3), n_pairs=n_pairs)
        want = jsim.pair_similarity(g, rng=np.random.RandomState(3), n_pairs=n_pairs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsim.centroid_similarity(g["spk0"], g["spk3"]),
                                  jsim.centroid_similarity(g["spk0"], g["spk3"]))
    same, diff = tsim.pair_similarity(g)
    got, want = tver.speaker_verification_eer(same, diff), jver.speaker_verification_eer(same, diff)
    assert set(got) == set(want) == {"eer", "threshold", "auc", "fpr", "fnr"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.warns(UserWarning, match="returning NaN"):
        r = tver.speaker_verification_eer(np.zeros(0), diff)
    assert np.isnan(r["eer"]) and np.isnan(r["auc"]) and r["fpr"].size == 0


def test_t_quantile_and_interval_match_scipy():
    """The numpy / standard-library Student-t quantile against
    ``scipy.stats.t.ppf`` for df 1-200 at confidence 0.9, 0.95 and 0.99,
    and ``mean_confidence_interval`` against the JAX package's."""
    worst = 0.0
    for df in range(1, 201):
        for conf in (0.9, 0.95, 0.99):
            q = (1 + conf) / 2
            want = scipy.stats.t.ppf(q, df)
            worst = max(worst, abs(tmos.t_ppf(q, df) - want) / want)
    assert worst < 1e-10, worst
    rng = np.random.RandomState(0)
    for n in (1, 2, 3, 17, 150):
        data = 3 + rng.randn(n)
        for conf in (0.9, 0.95, 0.99):
            (m, h), (jm, jh) = (tmos.mean_confidence_interval(data, conf),
                                jmos.mean_confidence_interval(data, conf))
            assert m == jm and abs(h - jh) <= 1e-10 * max(jh, 1e-300), (n, conf, h, jh)
    with pytest.raises(ValueError):
        tmos.t_ppf(0.4, 3)


def test_figures_write_pngs(tmp_path):
    """Each plotting function writes a non-empty PNG."""
    g = _groups(1, sizes=(4, 4, 4))
    same, diff = tsim.pair_similarity(g)
    res = {"real": tver.speaker_verification_eer(same, diff)}
    pts = {"synth": [(0, 0.5, 0.1), (10, 0.6, 0.05)]}
    out = {
        "tsne.png": lambda p: tvis.tsne_plot(g, p),
        "modes.png": lambda p: tvis.tsne_mode_plot({"real": g, "recon": _groups(2, (4, 4, 4))}, p),
        "density.png": lambda p: tvis.similarity_density_plot(same, diff, p),
        "det.png": lambda p: tvis.det_plot(res, p),
        "roc.png": lambda p: tvis.roc_plot(res, p),
        "mos.png": lambda p: tvis.mos_step_plot({"proxy": pts["synth"]},
                                                {"real": {"proxy": (3.0, 0.2)}}, p),
        "bar.png": lambda p: tvis.mos_bar_plot({"real": {"proxy": (3.0, 0.2)},
                                                "synth": {"proxy": (2.5, 0.1)}}, p),
        "sim.png": lambda p: tvis.similarity_step_plot(pts, {"recon": (0.7, 0.05)}, p),
    }
    for name, draw in out.items():
        draw(str(tmp_path / name))
    merged = tfig.merge_images([str(tmp_path / n) for n in ("det.png", "roc.png")],
                               str(tmp_path / "merged.png"), cols=2, titles=["det", "roc"])
    for p in [str(tmp_path / n) for n in out] + [merged]:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
        assert os.path.getsize(p) > 1000, p


# --------------------------------------------------------------------- CLI

def _tone(rng, f):
    t = np.arange(SR // 3) / SR
    return (0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * 2.7 * f * t)
            + 0.02 * rng.randn(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Real speakers and a test result tree, from a seed."""
    root = tmp_path_factory.mktemp("evaltree")
    rng = np.random.RandomState(0)
    for spk, f in (("s1", 180), ("s2", 420)):
        d = root / "real" / spk
        d.mkdir(parents=True)
        for i in range(3):
            save_wav(str(d / f"u{i}.wav"), _tone(rng, f * (1 + 0.03 * i)), SR)
    res = root / "output" / "result" / "meta"
    for i, f in ((0, 190), (1, 400)):
        task = res / "audio" / "Testing" / "step_last" / f"test_{i:03d}"
        task.mkdir(parents=True)
        for u in ("u0", "u1"):
            save_wav(str(task / f"{u}.recon.wav"), _tone(rng, f), SR)
            for n in (0, 10):
                save_wav(str(task / f"{u}.step_last-FTstep_{n}.synth.wav"),
                         _tone(rng, f * (1.1 - 0.01 * n)), SR)
    log = root / "output" / "log" / "meta"
    log.mkdir(parents=True)
    (log / "test_descriptions.json").write_text(json.dumps(
        [{"label": "T-spk_s1"}, {"label": "T-spk_s2"}]))
    cfg = {"corpus": "T", "real_dir": str(root / "real"), "n_sample": 3,
           "step_list": ["step_last"], "ft_step_list": [0, 10],
           "modes": {"meta": str(res)}}
    (root / "matrix.yaml").write_text(yaml.safe_dump(cfg))
    return root


def _report(path):
    with open(path) as f:
        return f.read()


def _cache(out):
    d = os.path.join(out, "cache")
    return {f: (os.path.getmtime(os.path.join(d, f)), _report(os.path.join(d, f))
                if f.endswith(".json") else np.load(os.path.join(d, f)).tobytes())
            for f in sorted(os.listdir(d))}


def _values(report):
    return [line.split("\t") for line in report.splitlines() if not line.startswith("#")]


def test_cli_matches_jax(tree, monkeypatch):
    """``run_matrix`` (``--config``) and ``main`` (``--real/--result``) of
    the port against the JAX CLI's ``eer.txt``: over the JAX package's
    cache string for string with the cache untouched (the matrix through
    the module's ``__main__`` entry, ``main`` called), and
    from a fresh cache within one pair's step."""
    from metatts_torch import evaluate as tev
    real, res = str(tree / "real"), str(tree / "output" / "result" / "meta")
    runs = {"matrix": ["--config", str(tree / "matrix.yaml")],
            "main": ["--real", real, "--result", res, "--max-per-speaker", "3"]}
    want = {}
    for name, argv in runs.items():
        out = str(tree / f"shared_{name}")
        argv = argv + ["--out", out, "--dvector-weights", NPZ]
        monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if name == "matrix":
                jev.run_matrix(types.SimpleNamespace(
                    config=argv[1], out=out, dvector_weights=NPZ, mosnet_weights=None,
                    mbnet_weights=None, mos=False))
            else:
                jev.main()
        want[name] = _report(os.path.join(out, "eer.txt"))
        before = _cache(out)
        if name == "matrix":        # as ``python -m metatts_torch.evaluate`` runs it
            monkeypatch.setattr(sys, "argv", ["evaluate"] + argv + ["--device", "cpu"])
            with warnings.catch_warnings():     # the module is imported already
                warnings.filterwarnings("ignore", "'metatts_torch.evaluate' found",
                                        RuntimeWarning)
                runpy.run_module("metatts_torch.evaluate", run_name="__main__")
        else:
            tev.main(argv + ["--device", "cpu"])
        assert _report(os.path.join(out, "eer.txt")) == want[name], name
        assert _cache(out) == before, name
    labels = [r[0] for r in _values(want["matrix"])]
    assert labels[:3] == ["real", "meta_recon_step_last", "meta_recon_step_last_centroid"]
    assert "meta_synth_step_last_FTstep10" in labels
    assert "UNCALIBRATED" not in want["main"] and "real_auc" in want["main"]

    # 2 speakers of 3 (real) or 2 x 2 (regrouped tasks) wavs: the fewest
    # same-speaker pairs is 2 x 1, the fewest different-speaker pairs 4
    step = 1 / min(2 * 1, 4)
    for name, argv in runs.items():
        out = str(tree / f"fresh_{name}")
        rows = tev.main(argv + ["--out", out, "--dvector-weights", NPZ, "--device", "cpu"])
        got = _values(_report(os.path.join(out, "eer.txt")))
        assert [r[0] for r in got] == [r[0] for r in _values(want[name])]
        assert [tuple(r) for r in got] == [(lbl, v) for lbl, v in rows]
        for (lbl, g), (_, w) in zip(got, _values(want[name])):
            tol = 1.5e-4 if "_centroid" in lbl else step    # 4 decimals
            assert abs(float(g) - float(w)) <= tol, (name, lbl, g, w)
    assert os.path.exists(str(tree / "fresh_matrix" / "det.png"))
