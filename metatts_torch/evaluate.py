"""Offline evaluation CLI of the port (reference ``evaluation/main.py:8-27``
pipeline): wavs -> d-vectors -> similarity -> EER/DET/AUC -> reports and
figures.  The root ``evaluate.py`` stays the TPU package's; this one takes
the same flags plus ``--device``:

  python -m metatts_torch.evaluate --real <dir-of-speaker-dirs> \\
      --result <output/result/<exp>> [--dvector-weights ge2e.npz] \\
      [--out eval_out] [--mos] [--device cuda|cpu]
  python -m metatts_torch.evaluate --config config/evaluation/LibriTTS.yaml \\
      [--device cuda|cpu]

It reads the result tree ``Trainer.test`` writes
(``audio/Testing/step_<n>/<task>/*-FTstep_<k>.synth.wav``) and the
``test_descriptions.json`` the datamodule persists beside it, and writes
the same ``eer.txt`` rows as the TPU package's CLI; its d-vector cache
directory serves either package.  The rows need neither matplotlib nor
sklearn; where they are missing the figures are skipped with a note.
"""

import argparse
import glob
import json
import os
import re

import numpy as np

from .evaluation import mos as M
from .evaluation import visualize as V
from .evaluation.harness import EvaluationHarness
from .evaluation.similarity import pair_similarity
from .evaluation.verification import speaker_verification_eer
from .preprocess.audio_io import load_wav


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m metatts_torch.evaluate")
    ap.add_argument("--config", type=str, default=None,
                    help="evaluation matrix YAML (config/evaluation/*.yaml)")
    ap.add_argument("--real", type=str, default=None,
                    help="dir of <speaker>/<utt>.wav real/enrollment speech")
    ap.add_argument("--result", type=str, default=None,
                    help="Saver result dir with audio/Testing trees")
    ap.add_argument("--step", type=str, default="step_last")
    ap.add_argument("--ft-step", type=int, default=None,
                    help="restrict synth wavs to one adaptation saving step "
                         "(*-FTstep_<n>.synth.wav)")
    ap.add_argument("--descriptions", type=str, default=None,
                    help="test_descriptions.json for task->speaker "
                         "regrouping (default: auto-derived from --result "
                         "by replacing /result/ with /log/)")
    ap.add_argument("--dvector-weights", type=str, default=None)
    ap.add_argument("--mosnet-weights", type=str, default=None,
                    help="converted official MOSNet npz "
                         "(tools/convert_torch_weights.py mosnet)")
    ap.add_argument("--mbnet-weights", type=str, default=None,
                    help="converted official MBNet npz "
                         "(tools/convert_torch_weights.py mbnet)")
    ap.add_argument("--wav2vec2-weights", type=str, default=None,
                    help="converted wav2vec2 npz "
                         "(tools/convert_torch_weights.py wav2vec2); "
                         "calibrated when the npz carries a MOS regression head")
    ap.add_argument("--out", type=str, default="eval_out")
    ap.add_argument("--max-per-speaker", type=int, default=16)
    ap.add_argument("--mos", action="store_true",
                    help="also score wavs with available pseudo-MOS scorers "
                         "(reference compute_mos.py; MOSNet needs external "
                         "weights, a spectral proxy always exists)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _figure(fn, *args):
    """Draw one figure.  matplotlib and sklearn are imported inside the
    plotting functions; where either is missing the figure is skipped with
    a note, since no row depends on it."""
    try:
        return fn(*args)
    except ImportError as e:
        print(f"[eval] {fn.__name__} skipped: {e}")
        return None


def _load_descriptions(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _write(h, path, rows):
    path = h.write_report(path, rows)
    print(f"wrote {path}")
    for label, value in rows:
        print(f"  {label}\t{value}")
    return rows


def main(argv=None):
    args = parse_args(argv)
    if args.config:
        from .config import load_yaml
        return run_matrix(load_yaml(args.config), out=args.out,
                          dvector_weights=args.dvector_weights,
                          mosnet_weights=args.mosnet_weights,
                          mbnet_weights=args.mbnet_weights,
                          wav2vec2_weights=args.wav2vec2_weights,
                          mos=args.mos, device=args.device)
    if not args.real:
        raise SystemExit("either --config or --real is required")

    h = EvaluationHarness(cache_dir=os.path.join(args.out, "cache"),
                          weights_npz=args.dvector_weights, device=args.device)
    rows = []

    real = h.embed_speaker_dirs(args.real, "real",
                                max_per_speaker=args.max_per_speaker)
    same, diff = pair_similarity(real)
    res = speaker_verification_eer(same, diff)
    rows.append(("real_eer", f"{res['eer']:.4f}"))
    rows.append(("real_auc", f"{res['auc']:.4f}"))
    curve_results = {"real": res}
    _figure(V.similarity_density_plot, same, diff,
            os.path.join(args.out, "real_similarity.png"))
    _figure(V.tsne_plot, real, os.path.join(args.out, "real_tsne.png"))

    if args.result:
        # task -> speaker regrouping via the persisted frozen episode
        # descriptions, so same/different-speaker pairs span tasks (the
        # reference pools d-vectors per speaker)
        dpath = args.descriptions or derive_descriptions_path(args.result)
        descs = _load_descriptions(dpath)
        if descs is not None:
            print(f"[eval] speaker regrouping via {dpath}")
        else:
            print(f"[eval] WARNING: no episode descriptions at {dpath}; "
                  "d-vectors stay grouped per task (pass --descriptions "
                  "to enable per-speaker pooling)")
        sim_steps, sim_bands = {}, {}
        mode_pools = {"real": real}
        for kind in ("recon", "synth"):
            if kind == "synth":
                # evaluate each adaptation saving step separately: pooling
                # step-0 (un-adapted) with step-100 audio would silently
                # change the metric; --ft-step restricts to one step
                fts = ([args.ft_step] if args.ft_step is not None
                       else discover_ft_steps(args.result, args.step)
                       or [None])
            else:
                fts = [None]
            for ft in fts:
                groups = h.embed_result_tree(args.result, kind, args.step,
                                             ft_step=ft)
                if not groups:
                    continue
                if descs:
                    groups = h.regroup_by_speaker(groups, descs)
                label = f"{kind}_{args.step}" + (
                    f"_FTstep{ft}" if ft is not None else "")
                # cross-mode t-SNE pools: recon + the last synth step
                # (reference tsne_mode_list, e.g. recon vs meta_step20)
                if kind == "recon":
                    mode_pools["recon"] = groups
                else:
                    mode_pools[f"synth_step{ft}" if ft is not None
                               else "synth"] = groups
                r = speaker_verification_eer(*pair_similarity(groups))
                curve_results[label] = r
                rows.append((f"{label}_eer", f"{r['eer']:.4f}"))
                rows.append((f"{label}_auc", f"{r['auc']:.4f}"))
                sims = h.similarity_to_enrollment(real, groups)
                if sims:
                    rows.append((f"{label}_centroid_sim",
                                 f"{np.mean(list(sims.values())):.4f}"))
                vals = h.similarity_values(real, groups)
                if len(vals):
                    m, ci = M.mean_confidence_interval(vals)
                    if kind == "synth" and ft is not None:
                        sim_steps.setdefault("synth", []).append((ft, m, ci))
                    elif kind == "recon":
                        sim_bands["recon"] = (m, ci)
        if sim_steps:
            # similarity-vs-adaptation-step errorbar figure (reference
            # evaluation/similarity_plot.py errorbar_plot)
            _figure(V.similarity_step_plot, sim_steps, sim_bands,
                    os.path.join(args.out, "similarity_vs_step.png"))
        # cross-mode t-SNE: real vs recon vs the LAST adaptation step
        # (reference visualize.py tsne_mode_list figure)
        synth_keys = sorted((k for k in mode_pools if k.startswith("synth")),
                            key=lambda k: int(k.rsplit("step", 1)[-1] or 0)
                            if k != "synth" else -1)
        keep = {k: mode_pools[k] for k in ("real", "recon")
                if k in mode_pools}
        if synth_keys:
            keep[synth_keys[-1]] = mode_pools[synth_keys[-1]]
        if len(keep) >= 2:
            _figure(V.tsne_mode_plot, keep, os.path.join(args.out, "tsne_modes.png"))

    # DET + ROC figures over every evaluated group (reference
    # speaker_verification.py:20 emits both per mode)
    _figure(V.det_plot, curve_results, os.path.join(args.out, "det.png"))
    _figure(V.roc_plot, curve_results, os.path.join(args.out, "roc.png"))

    if args.mos:
        rows += mos_rows(args.real, args.result, args.step,
                         args.max_per_speaker, args.mosnet_weights,
                         mbnet_weights=args.mbnet_weights,
                         wav2vec2_weights=args.wav2vec2_weights,
                         out_dir=args.out, device=args.device)

    return _write(h, os.path.join(args.out, "eer.txt"), rows)


def derive_descriptions_path(result_dir):
    """Locate ``test_descriptions.json`` next to a Saver result tree by
    swapping only the LAST ``/result/`` path segment for ``/log/``: a
    plain str.replace would rewrite every occurrence and silently resolve
    the wrong log dir for paths like ``/data/result/output/result/mode``
    (speaker regrouping would then be skipped and EER computed on per-task
    groups, which cannot form cross-task same-speaker pairs)."""
    seg = os.sep + "result" + os.sep
    head, found, tail = result_dir.rpartition(seg)
    log_dir = (head + os.sep + "log" + os.sep + tail) if found \
        else result_dir
    return os.path.join(log_dir, "test_descriptions.json")


def discover_ft_steps(result_dir, step):
    """Adaptation saving steps present in the Saver test tree
    (``*-FTstep_<n>.synth.wav``), sorted ascending."""
    steps = set()
    for f in glob.glob(os.path.join(result_dir, "audio", "Testing", step,
                                    "*", "*.synth.wav")):
        m = re.search(r"-FTstep_(\d+)\.synth\.wav$", os.path.basename(f))
        if m:
            steps.add(int(m.group(1)))
    return sorted(steps)


def mos_rows(real_dir, result_dir, step, max_per_speaker,
             mosnet_weights=None, mbnet_weights=None, wav2vec2_weights=None,
             out_dir=None, summary=None, device="cuda"):
    """Pseudo-MOS over real + synthesized wavs (reference
    evaluation/compute_mos.py:25,52).

    Mirrors the reference aggregation: every mode row carries the mean and
    the 95% t-interval half-width (``compute_mos.py:173-178``), synth audio
    is scored PER adaptation step (``<mode>_step{i}`` rows,
    ``compute_mos.py:83-94``), and with ``out_dir`` a MOS-vs-step figure
    with real/recon bands and a bar chart are written
    (``compute_mos.py:196-315``); with ``out_dir=None`` nothing is drawn.
    The native scorers run on ``device`` and claim their names when their
    converted weights are given."""
    M.try_register_mosnet_native(mosnet_weights, device=device)
    M.try_register_mbnet_native(mbnet_weights, device=device)
    M.try_register_wav2vec2_native(wav2vec2_weights, device=device)
    rows = []
    bands = {}         # label -> scorer -> (mean, ci)  [real/recon]
    step_scores = {}   # scorer -> [(ft_step, mean, ci)]
    # per-tag means for the grouped bar chart (reference bar_plot); the
    # caller may pass a dict to collect across mos_rows calls (run_matrix)
    summary = {} if summary is None else summary

    def score_files(files, tag, band=None, ft_step=None):
        for name in M.available_scorers():
            vals = []
            for f in files[:max_per_speaker]:
                wav, sr = load_wav(f)
                vals.append(M.score(name, wav, sr))
            if vals:
                m, ci = M.mean_confidence_interval(vals)
                rows.append((f"mos_{name}_{tag}", f"{m:.3f} ±{ci:.3f}"))
                summary.setdefault(tag, {})[name] = (m, ci)
                if band is not None:
                    bands.setdefault(band, {})[name] = (m, ci)
                if ft_step is not None:
                    step_scores.setdefault(name, []).append((ft_step, m, ci))

    if real_dir:
        real_files = []
        for spk in sorted(os.listdir(real_dir)):
            d = os.path.join(real_dir, spk)
            if os.path.isdir(d):
                real_files += [os.path.join(d, f)
                               for f in sorted(os.listdir(d))
                               if f.endswith(".wav")]
        score_files(real_files, "real", band="real")
    if result_dir:
        audio_glob = os.path.join(result_dir, "audio", "Testing", step, "*")
        score_files(sorted(glob.glob(os.path.join(audio_glob, "*.recon.wav"))),
                    "recon", band="recon")
        for ft in discover_ft_steps(result_dir, step):
            files = sorted(glob.glob(os.path.join(
                audio_glob, f"*-FTstep_{ft}.synth.wav")))
            score_files(files, f"synth_step{ft}", ft_step=ft)
    if out_dir and step_scores:
        _figure(V.mos_step_plot, step_scores, bands, os.path.join(out_dir, "mos.png"))
    if out_dir and summary:
        # grouped bar chart across the modes scored in this call
        # (reference compute_mos.py bar_plot)
        _figure(V.mos_bar_plot, summary, os.path.join(out_dir, "mos_bar.png"))
    return rows


def run_matrix(cfg, out=None, dvector_weights=None, mosnet_weights=None,
               mbnet_weights=None, wav2vec2_weights=None, mos=False, device="cuda"):
    """Mode x step evaluation matrix (reference evaluation/config.py:72-138)
    over a parsed matrix config (``config/evaluation/*.yaml``); writes
    ``<out>/eer.txt`` and returns its rows."""
    out_dir = out or f"eval_out/{cfg['corpus']}"
    h = EvaluationHarness(cache_dir=os.path.join(out_dir, "cache"),
                          weights_npz=dvector_weights, device=device)
    rows = []
    real = h.embed_speaker_dirs(cfg["real_dir"], "real",
                                max_per_speaker=cfg.get("n_sample", 16))
    r = speaker_verification_eer(*pair_similarity(real))
    rows.append(("real", f"{r['eer']:.4f}"))
    curve_results = {"real": r}
    # ft_step_list: adaptation saving steps to evaluate separately
    # (reference evaluation/config.py step matrix {0, 5, 10, 20, 50, 100});
    # a None entry evaluates over all synth wavs regardless of step.
    ft_steps = cfg.get("ft_step_list", [None])
    sim_steps, sim_bands = {}, {}
    mode_pools = {"real": real}
    for mode, mode_cfg in cfg.get("modes", {}).items():
        # a mode maps to a result dir, or to {dir, ft_step_list} for a
        # per-mode step list (reference config.py mode_step_list pairs,
        # e.g. 1-shot modes evaluate out to step 1000)
        if isinstance(mode_cfg, dict):
            result_dir = mode_cfg["dir"]
            mode_fts = mode_cfg.get("ft_step_list", ft_steps)
            mode_descs = mode_cfg.get("descriptions")
        else:
            result_dir, mode_fts, mode_descs = mode_cfg, ft_steps, None
        # task -> speaker regrouping via the mode's persisted frozen episode
        # descriptions (a per-mode ``descriptions`` key overrides the
        # derivation from the LAST /result/ segment): the reference pools
        # d-vectors per SPEAKER, and without regrouping the per-task groups
        # can't form same-speaker pairs across tasks
        dpath = mode_descs or derive_descriptions_path(result_dir)
        descs = _load_descriptions(dpath)
        if descs is None:
            print(f"[eval] WARNING: mode {mode}: no episode descriptions "
                  f"at {dpath}; d-vectors stay grouped per task")
        for step in cfg.get("step_list", ["step_last"]):
            for kind in ("recon", "synth"):
                for ft in (mode_fts if kind == "synth" else [None]):
                    groups = h.embed_result_tree(result_dir, kind, step,
                                                 ft_step=ft)
                    if not groups:
                        continue
                    if descs:
                        groups = h.regroup_by_speaker(groups, descs)
                    label = f"{mode}_{kind}_{step}" + (
                        f"_FTstep{ft}" if ft is not None else "")
                    r = speaker_verification_eer(*pair_similarity(groups))
                    if kind == "recon":
                        mode_pools.setdefault("recon", groups)
                    elif ft == (mode_fts[-1] if mode_fts else None):
                        # last adaptation step represents the mode in the
                        # cross-mode t-SNE (reference tsne_mode_list, e.g.
                        # ['recon', 'base_step20', 'meta_step20'])
                        mode_pools[f"{mode}_step{ft}" if ft is not None
                                   else mode] = groups
                    curve_results[label] = r
                    rows.append((label, f"{r['eer']:.4f}"))
                    sims = h.similarity_to_enrollment(real, groups)
                    if sims:
                        rows.append((f"{label}_centroid",
                                     f"{np.mean(list(sims.values())):.4f}"))
                    vals = h.similarity_values(real, groups)
                    if len(vals):
                        m, ci = M.mean_confidence_interval(vals)
                        if kind == "synth" and ft is not None:
                            sim_steps.setdefault(mode, []).append((ft, m, ci))
                        elif kind == "recon" and "recon" not in sim_bands:
                            # one recon band: the reference plot draws a
                            # single reconstruction region across modes
                            sim_bands["recon"] = (m, ci)
    _figure(V.det_plot, curve_results, os.path.join(out_dir, "det.png"))
    _figure(V.roc_plot, curve_results, os.path.join(out_dir, "roc.png"))
    if sim_steps:
        # per-mode errorbar lines over adaptation steps (reference
        # evaluation/similarity_plot.py errorbar_plot)
        _figure(V.similarity_step_plot, sim_steps, sim_bands,
                os.path.join(out_dir, "similarity_vs_step.png"))
    if len(mode_pools) >= 2:
        # real vs recon vs each mode's last adaptation step, one joint
        # embedding (reference visualize.py mode x speaker figure)
        _figure(V.tsne_mode_plot, mode_pools, os.path.join(out_dir, "tsne_modes.png"))
    if mos or cfg.get("mos"):
        # reference compute_mos.py scores real once, then every mode x step
        # tree; per-mode MOS-vs-step figures land under <out>/<mode>/mos.png
        bar_summary = {}
        n_sample = cfg.get("n_sample", 16)
        weights = dict(mosnet_weights=mosnet_weights, mbnet_weights=mbnet_weights,
                       wav2vec2_weights=wav2vec2_weights, device=device)
        rows += mos_rows(cfg["real_dir"], None, None, n_sample,
                         summary=bar_summary, **weights)
        step_list = cfg.get("step_list", ["step_last"])
        for mode, mode_cfg in cfg.get("modes", {}).items():
            result_dir = (mode_cfg["dir"] if isinstance(mode_cfg, dict)
                          else mode_cfg)
            for step in step_list:
                mode_summary = {}
                mode_rows = mos_rows(None, result_dir, step, n_sample,
                                     out_dir=os.path.join(out_dir, mode),
                                     summary=mode_summary, **weights)
                rows += [(f"{mode}_{step}_{lbl}", v) for lbl, v in mode_rows]
                for tag, d in mode_summary.items():
                    key = (f"{mode}_{step}_{tag}" if len(step_list) > 1
                           else f"{mode}_{tag}")
                    bar_summary[key] = d
        if bar_summary:
            # mode x step grouped bars in one figure (reference bar_plot,
            # compute_mos.py:196-237: Real/Recon + every mode_step tick)
            _figure(V.mos_bar_plot, bar_summary, os.path.join(out_dir, "mos_bar.png"))
    return _write(h, os.path.join(out_dir, "eer.txt"), rows)


if __name__ == "__main__":
    main()
