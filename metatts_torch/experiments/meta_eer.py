"""EER against adaptation steps, meta against baseline, on the port (the
JAX package's ``tools/exp_meta_eer.py``): the reference's headline table
(speaker-verification EER of synthesized held-out speakers at each
adaptation step) with no external weights.

1. train the meta and baseline systems on the synthetic corpus
   (``meta_advantage.run_experiment``: the same init, utterance budget and
   optimizer) and save both checkpoints (``train/checkpoint.py``, readable
   by either package);
2. write Griffin-Lim enrolment wavs of the held-out speakers
   (``data/synthetic.SyntheticMelVocoder``);
3. train a scratch GE2E verifier (``evaluation/ge2e_scratch.py``) on
   Griffin-Lim audio of the train speakers only, so the held-out speakers
   are unseen by model and verifier alike;
4. adapt each system on every held-out test episode and write the Saver
   test tree: a teacher-forced reconstruction from the un-adapted weights
   and a fully predicted synthesis from every saving-step snapshot;
5. run the evaluation matrix (``evaluate.run_matrix``) over real, recon
   and synth wavs into ``eval/eer.txt``;
6. write the table, ``results.json`` and the figure.

Run::

    python -m metatts_torch.experiments.meta_eer [--device cuda|cpu]
        [--out DIR] [--rescore]

``--rescore`` replays stages 5-6 on a previous run's files.  Each stage's
wall time is printed as a ``[time]`` line and kept in ``timing.json``.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..algorithms.adapt import episode_speaker_args
from ..data.synthetic import SyntheticMelVocoder
from ..evaluate import run_matrix
from ..evaluation.ge2e_scratch import save_ge2e_npz, train_ge2e, utterance_partial
from ..preprocess.audio_io import save_wav
from ..train.checkpoint import save_checkpoint
from .meta_advantage import run_experiment


def _write_speaker_wavs(voc, corpus, speakers, n_utts, rng, out_dir):
    """Ground-truth utterances -> Griffin-Lim wavs under
    ``<out_dir>/<speaker>/utt<j>.wav`` (the evaluation's ``--real``
    layout)."""
    for s in speakers:
        batch = corpus.batch([s] * n_utts, rng)
        wavs = voc(batch.mels, batch.mel_lens)
        d = os.path.join(out_dir, str(int(s)))
        os.makedirs(d, exist_ok=True)
        for j, w in enumerate(wavs):
            save_wav(os.path.join(d, f"utt{j:03d}.wav"), w, voc.sr)


def _ge2e_partials(voc, corpus, speakers, n_utts, rng):
    """speaker -> (n_utts, 160, 40) GE2E partials of Griffin-Lim wavs."""
    out = {}
    for s in speakers:
        batch = corpus.batch([s] * n_utts, rng)
        out[int(s)] = np.stack([utterance_partial(w, voc.sr)
                                for w in voc(batch.mels, batch.mel_lens)])
    return out


@torch.no_grad()
def _synthesize(system, params, qry_c, teacher):
    """The postnet mel and its lengths of the query from ``params``: the
    inference forward on the fused FFT blocks (where the gate admits the
    width), speaker embedding averaged over the episode."""
    params = {k: v.to(system.device) for k, v in params.items()}
    out = system.adaptor.forward(params, qry_c, train=False, teacher_forced=teacher,
                                 average_spk_emb=True, fused_infer=True)
    return out.postnet_mel, out.mel_lens.cpu().numpy()


def _synthesize_result_tree(system, voc, episodes, out_root, log_root,
                            episode_speakers, verbose=True):
    """Test adaptation of every episode and synthesis at every saving step
    into the Saver test tree ``<out_root>/audio/Testing/step_last/test_NNN/``
    (``qryJJ.recon.wav``, ``qryJJ.step_last-FTstep_<n>.synth.wav``), and the
    episodes' descriptions in ``<log_root>/test_descriptions.json``, which
    the evaluation regroups tasks by."""
    t0 = time.time()
    for i, (sup, qry) in enumerate(episodes):
        sup, qry = sup.to(system.device), qry.to(system.device)
        _, snapshots = system.test_adapt(sup, qry)
        qry_c = qry._replace(speaker_args=episode_speaker_args(
            sup.speaker_args, qry.speaker_args))
        task_dir = os.path.join(out_root, "audio", "Testing", "step_last", f"test_{i:03d}")
        os.makedirs(task_dir, exist_ok=True)
        # teacher-forced reconstruction from the un-adapted weights
        for j, w in enumerate(voc(*_synthesize(system, snapshots[0][1], qry_c, True))):
            save_wav(os.path.join(task_dir, f"qry{j:02d}.recon.wav"), w, voc.sr)
        # fully predicted synthesis from every snapshot
        for ft, params in snapshots:
            for j, w in enumerate(voc(*_synthesize(system, params, qry_c, False))):
                save_wav(os.path.join(task_dir, f"qry{j:02d}.step_last-FTstep_{ft}.synth.wav"),
                         w, voc.sr)
        if verbose and (i % 4 == 0 or i == len(episodes) - 1):
            print(f"[synth] task {i + 1}/{len(episodes)} ({time.time() - t0:.0f}s)",
                  flush=True)
    os.makedirs(log_root, exist_ok=True)
    with open(os.path.join(log_root, "test_descriptions.json"), "w") as f:
        json.dump([{"label": f"syn-spk_{s}"} for s in episode_speakers], f)


def _eer_rows(out_dir):
    rows = {}
    with open(os.path.join(out_dir, "eval", "eer.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                rows[parts[0]] = float(parts[1])
    return rows


def _evaluate(out_dir, matrix, names, device):
    """Stage 5 and the table: ``run_matrix`` over ``matrix`` with the
    scratch verifier, then (synth EER table, real EER, recon EERs)."""
    run_matrix(matrix, out=os.path.join(out_dir, "eval"),
               dvector_weights=os.path.join(out_dir, "ge2e_scratch.npz"), device=device)
    rows = _eer_rows(out_dir)
    table = {name: {} for name in names}
    for name in names:
        for ft in matrix["ft_step_list"]:
            key = f"{name}_synth_step_last_FTstep{ft}"
            if key in rows:
                table[name][ft] = rows[key]
    recon = {name: rows.get(f"{name}_recon_step_last") for name in names}
    return table, rows.get("real"), recon


def _headline(result):
    table = result["eer_table"]
    m10, b10 = table.get("meta", {}).get(10), table.get("baseline", {}).get(10)
    print(f"[headline] EER @ 10 adaptation steps: meta {m10} vs baseline {b10} "
          f"(real {result['real_eer']}; reference eer.txt: meta 0.1776 vs "
          f"baseline 0.4309)")


class _Stages:
    """Wall time of each named stage, printed as ``[time]`` lines."""

    def __init__(self, verbose):
        self.verbose, self.times = verbose, {}

    def __call__(self, name, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        self.times[name] = round(time.time() - t0, 3)
        if self.verbose:
            print(f"[time] {name}: {self.times[name]:.1f} s", flush=True)
        return out


def run_eer_experiment(out_dir="output/meta_advantage_eer", outer_steps=400,
                       n_train=32, n_test=8, n_mels=8, hidden=32, layers=1,
                       seed=0, saving_steps=(5, 10, 20, 50, 100),
                       episodes_per_speaker=2, eval_queries=8,
                       ge2e_hidden=128, ge2e_steps=300, ge2e_utts=16,
                       ge2e_spk_per_batch=8, ge2e_utt_per_spk=4,
                       enroll_utts=12, gl_iters=24, verbose=True,
                       algorithms=("meta", "baseline"), device="cuda",
                       **experiment_kw):
    """The whole pipeline on ``device`` (default the card); returns the
    ``results.json`` dict (``eer_table``: system -> ft step -> EER, ...).
    ``experiment_kw`` goes to ``run_experiment`` (e.g. ``shots``,
    ``queries``, ``meta_batch``, ``corpus_kwargs``)."""
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    stage = _Stages(verbose)

    # 1. train every system, then the loss-space test stage
    out = stage("train_and_test", run_experiment,
                outer_steps=outer_steps, n_train=n_train, n_test=n_test,
                n_mels=n_mels, hidden=hidden, layers=layers, seed=seed,
                saving_steps=saving_steps,
                episodes_per_speaker=episodes_per_speaker,
                eval_queries=eval_queries, verbose=verbose,
                algorithms=algorithms, keep_systems=True, device=device,
                **experiment_kw)
    systems = out.pop("_systems")
    corpus = out.pop("_corpus")
    episodes = out.pop("_episodes")
    episode_speakers = out.pop("_episode_speakers")
    train_speakers = out.pop("_train_speakers")
    test_speakers = out.pop("_test_speakers")
    # the trained systems first, so the later stages can be rerun alone
    for name, system in systems.items():
        save_checkpoint(os.path.join(out_dir, f"ckpt_{name}.msgpack"), system.model,
                        system.global_step, system.optimizer)
    with open(os.path.join(out_dir, "loss_results.json"), "w") as f:
        json.dump(out, f, indent=1)

    voc = SyntheticMelVocoder(n_mels=n_mels, n_iters=gl_iters, seed=seed, device=device)

    # 2. enrolment wavs of the held-out speakers
    wav_rng = np.random.RandomState(seed + 11)
    real_dir = os.path.join(out_dir, "real")
    stage("enrolment_wavs", _write_speaker_wavs, voc, corpus, test_speakers,
          enroll_utts, wav_rng, real_dir)

    # 3. the scratch GE2E verifier on the train speakers only
    partials = stage("ge2e_partials", _ge2e_partials, voc, corpus, train_speakers,
                     ge2e_utts, wav_rng)
    ge2e_params, ge2e_trace = stage(
        "ge2e_train", train_ge2e, partials, hidden=ge2e_hidden, embed=ge2e_hidden,
        steps=ge2e_steps, n_speakers_per_batch=ge2e_spk_per_batch,
        m_utts_per_speaker=ge2e_utt_per_spk, seed=seed, verbose=verbose, device=device)
    save_ge2e_npz(ge2e_params, os.path.join(out_dir, "ge2e_scratch.npz"))
    if verbose:
        print(f"[eer] GE2E loss {ge2e_trace[0]:.3f} -> {ge2e_trace[-1]:.3f}", flush=True)

    # 4. each system's result tree
    for name, system in systems.items():
        stage(f"synthesize_{name}", _synthesize_result_tree, system, voc, episodes,
              os.path.join(out_dir, "result", name), os.path.join(out_dir, "log", name),
              episode_speakers, verbose=verbose)

    # 5. the evaluation matrix
    matrix = {
        "corpus": "synthetic",
        "real_dir": real_dir,
        "n_sample": max(enroll_utts, eval_queries),
        "step_list": ["step_last"],
        "ft_step_list": [0] + list(saving_steps),
        "modes": {name: os.path.join(out_dir, "result", name) for name in systems},
    }
    import yaml
    from ..config import load_yaml
    matrix_path = os.path.join(out_dir, "matrix.yaml")
    with open(matrix_path, "w") as f:
        yaml.safe_dump(matrix, f)
    # read back, as the evaluation CLI reads it: its modes in sorted order
    matrix = load_yaml(matrix_path)
    table, real_eer, recon = stage("evaluate", _evaluate, out_dir, matrix,
                                   list(systems), device)

    # 6. table and figure
    result = {
        "eer_table": table,
        "real_eer": real_eer,
        "recon_eer": recon,
        "loss_summary": out["summary"],
        "ge2e": {"best_loss": float(min(v for v in ge2e_trace if np.isfinite(v))),
                 "final_loss": ge2e_trace[-1], "hidden": ge2e_hidden,
                 "steps": ge2e_steps, "calibration": "scratch-trained on "
                 "synthetic-corpus train split (no external weights)"},
        "config": {**out["config"], "enroll_utts": enroll_utts,
                   "ge2e_utts": ge2e_utts, "gl_iters": gl_iters,
                   "wall_s": round(time.time() - t0, 1)},
    }
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(result, f, indent=1)
    plot_eer(result, out_dir)
    with open(os.path.join(out_dir, "timing.json"), "w") as f:
        json.dump({**stage.times, "total": round(time.time() - t0, 3)}, f, indent=1)
    if verbose:
        _headline(result)
    return result


def rescore(out_dir="output/meta_advantage_eer", verbose=True, device="cuda"):
    """Stages 5-6 alone, on a previous run's ``matrix.yaml``, result
    trees, ``ge2e_scratch.npz`` and ``real/``; rewrites ``eval/eer.txt``
    and updates the EER entries of ``results.json``."""
    from ..config import load_yaml
    matrix = load_yaml(os.path.join(out_dir, "matrix.yaml"))
    with open(os.path.join(out_dir, "results.json")) as f:
        result = json.load(f)
    table, real_eer, recon = _evaluate(out_dir, matrix, list(matrix["modes"]), device)
    result.update(eer_table=table, real_eer=real_eer, recon_eer=recon)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(result, f, indent=1)
    plot_eer(result, out_dir)
    if verbose:
        _headline(result)
    return result


def plot_eer(result, out_dir):
    """EER against adaptation step as ``<out_dir>/eer_vs_step.png``;
    without matplotlib ``eer_vs_step.npy``, a (systems, ft steps, 2) array
    of (ft step, EER) in the table's order.  Returns the path written."""
    curves = np.asarray([[[float(ft), steps[ft]] for ft in sorted(steps, key=float)]
                         for steps in result["eer_table"].values()], np.float64)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        path = os.path.join(out_dir, "eer_vs_step.npy")
        np.save(path, curves)
        return path
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    colors = {"meta": "tab:blue", "baseline": "tab:orange", "imaml": "tab:green"}
    for name, c in zip(result["eer_table"], curves):
        if len(c):
            ax.plot(c[:, 0], c[:, 1], "-o", color=colors.get(name, "tab:gray"), label=name)
    if result.get("real_eer") is not None:
        ax.axhline(result["real_eer"], color="k", ls="--", lw=1,
                   label=f"real ({result['real_eer']:.3f})")
    ax.axhline(0.5, color="gray", ls=":", lw=1, label="chance")
    ax.set_xlabel("adaptation step (held-out speakers)")
    ax.set_ylabel("speaker-verification EER")
    ax.set_title("EER vs adaptation steps (scratch GE2E verifier)")
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out_dir, "eer_vs_step.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m metatts_torch.experiments.meta_eer")
    ap.add_argument("--outer-steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ge2e-steps", type=int, default=300)
    ap.add_argument("--ge2e-hidden", type=int, default=128)
    ap.add_argument("--with-imaml", action="store_true")
    ap.add_argument("--rescore", action="store_true",
                    help="rerun only the evaluation and the report on the "
                         "files of a previous full run")
    ap.add_argument("--out", default="output/meta_advantage_eer")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.rescore:
        return rescore(out_dir=args.out, device=args.device)
    algorithms = (("meta", "imaml", "baseline") if args.with_imaml
                  else ("meta", "baseline"))
    return run_eer_experiment(out_dir=args.out, outer_steps=args.outer_steps,
                              seed=args.seed, ge2e_steps=args.ge2e_steps,
                              ge2e_hidden=args.ge2e_hidden, algorithms=algorithms,
                              device=args.device)


if __name__ == "__main__":
    main()
