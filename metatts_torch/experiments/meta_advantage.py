"""Meta-learning advantage A/B on the port: ``MetaSystem`` against
``BaselineSystem`` on held-out synthetic speakers (the JAX package's
``tools/exp_meta_advantage.py``).

1. a deterministic synthetic corpus where speaker identity has learnable
   structure (``data/synthetic.py``);
2. a meta system (second-order MAML over train-speaker episodes) and a
   baseline (flat multi-task batches, the same utterance budget and the
   same initial weights) trained side by side;
3. the shared test stage (``System.test_adapt``) on episodes of speakers
   neither system saw;
4. query loss against fine-tune step for each system.

Run (writes ``<out>/results.json`` and the figure)::

    python -m metatts_torch.experiments.meta_advantage [--device cuda|cpu]

At the reference's inner / test lr of 0.001 meta wins at steps 5-20 and the
baseline overtakes by step 50-100; meta training passes through a phase
where the plain-loss probe grows while the post-adaptation query loss falls.
"""

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from .. import config as C
from ..algorithms import get_system
from ..data.synthetic import STATS, SyntheticVoices
from ..train.optim import NoamAdam, linear_warmup_schedule
from ..utils.tools import resolve_device


def _configs(n_mels, inner_steps, inner_lr, test_lr, meta_batch, shots,
             queries, saving_steps, hidden=32, layers=1):
    mcfg = copy.deepcopy(C.MODEL_DEFAULTS)
    mcfg["transformer"].update(
        encoder_layer=layers, decoder_layer=layers, encoder_hidden=hidden,
        decoder_hidden=hidden, encoder_head=2, decoder_head=2,
        conv_filter_size=max(48, hidden))
    mcfg["variance_predictor"].update(filter_size=max(16, hidden // 2))
    mcfg["variance_embedding"].update(n_bins=32)
    mcfg["max_seq_len"] = 64
    mcfg["compute_dtype"] = "float32"
    mcfg["activation_dtype"] = "float32"
    mcfg["attention_scores_dtype"] = "float32"
    mcfg["remat"] = False

    pcfg = copy.deepcopy(C.PREPROCESS_DEFAULTS)
    pcfg["preprocessing"]["mel"]["n_mel_channels"] = n_mels

    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    tcfg["optimizer"]["warm_up_step"] = 200

    acfg = copy.deepcopy(C.ALGORITHM_DEFAULTS)
    acfg["adapt"]["train"].update(steps=inner_steps, shots=shots,
                                  queries=queries, lr=inner_lr,
                                  meta_batch_size=meta_batch)
    acfg["adapt"]["task"]["lr"] = inner_lr
    acfg["adapt"]["test"].update(lr=test_lr, steps=max(saving_steps),
                                 saving_steps=list(saving_steps))
    return pcfg, mcfg, tcfg, acfg


def run_experiment(outer_steps=400, n_train=32, n_test=8, n_mels=8,
                   shots=5, queries=5, meta_batch=4, inner_steps=5,
                   inner_lr=0.001, test_lr=0.001,
                   saving_steps=(5, 10, 20, 50, 100),
                   episodes_per_speaker=2, eval_queries=8, seed=0,
                   hidden=32, layers=1, log_every=50, verbose=True,
                   flat_lr=None, corpus_kwargs=None,
                   algorithms=("meta", "baseline"), keep_systems=False,
                   device="cuda"):
    """Train the requested systems on the synthetic corpus and run the
    shared test stage on held-out speakers, on ``device`` (default the
    card).  Returns ``results`` (system -> ft_step -> per-task total
    losses), ``summary``, ``traces`` and ``config``; with ``keep_systems``
    also the ``_``-prefixed handles the EER experiment needs.

    ``algorithms`` may add "imaml".  The episodic arms consume the same
    episode draw each outer step, then the baseline draws its flat batch of
    ``meta_batch * (shots + queries)`` utterances from the same stream.
    Every arm starts from the same weights (seed ``seed + 7``)."""
    device = resolve_device(device)
    corpus = SyntheticVoices(n_train + n_test, n_mels=n_mels, seed=seed,
                             **(corpus_kwargs or {}))
    train_speakers = list(range(n_train))
    test_speakers = list(range(n_train, n_train + n_test))
    pcfg, mcfg, tcfg, acfg = _configs(
        n_mels, inner_steps, inner_lr, test_lr, meta_batch, shots, queries,
        saving_steps, hidden=hidden, layers=layers)

    systems = {}
    for name in algorithms:
        acfg_n = copy.deepcopy(acfg)
        acfg_n["type"] = name
        systems[name] = get_system(name)(
            pcfg, copy.deepcopy(mcfg), tcfg, acfg_n, stats=STATS,
            n_speakers=n_train + n_test, seed=seed + 7, device=device)
    episodic = [n for n in algorithms if n != "baseline"]

    if flat_lr is not None:
        # a 100-step linear warm-up into a constant outer lr, the same for
        # every arm: the Noam peak at hidden 32 and warm-up 200 is 12.5x the
        # reference's, which the second-order meta-gradient does not bear
        for system in systems.values():
            system.optimizer = NoamAdam(system.params, system.mcfg, tcfg,
                                        schedule=linear_warmup_schedule(flat_lr, 100))

    data_rng = np.random.RandomState(seed + 1)
    flat_bs = meta_batch * (shots + queries)   # the same utterance budget
    traces = {name: [] for name in algorithms}

    # the plain supervised loss of every system on one fixed train-speaker
    # batch: an episodic arm's own trace is its post-adaptation query loss.
    # Every probe runs with the first system's BatchNorm statistics as they
    # stand at the first probe, which the JAX script's jitted probe captures
    # when it is first traced.
    any_sys = next(iter(systems.values()))
    bn_state = {}
    probe_rng = np.random.RandomState(seed + 3)
    probe = corpus.batch(list(probe_rng.choice(train_speakers, size=16)),
                         probe_rng, device)

    @torch.no_grad()
    def plain_loss(params):
        if not bn_state:
            bn_state.update((k, v.clone()) for k, v in any_sys.model.named_buffers())
        out = any_sys.adaptor.forward({**params, **bn_state}, probe, train=False)
        return float(any_sys.adaptor.loss(probe, out).total)

    for name in algorithms:
        traces[f"{name}_plain"] = []
    t0 = time.time()
    for step in range(outer_steps):
        losses = {}
        if episodic:
            # one episodic draw a step, shared by every episodic arm
            spk = data_rng.choice(train_speakers, size=meta_batch, replace=False)
            sup, qry = corpus.meta_batch(spk, shots, queries, data_rng, device)
            for name in episodic:
                losses[name] = float(systems[name].train_step(sup, qry).total)
        if "baseline" in systems:
            flat_spk = data_rng.choice(train_speakers, size=flat_bs)
            batch = corpus.batch(list(flat_spk), data_rng, device)
            losses["baseline"] = float(systems["baseline"].train_step(batch).total)
        for name, v in losses.items():
            traces[name].append(v)
        if step % log_every == 0 or step == outer_steps - 1:
            plains = {name: plain_loss(systems[name].params) for name in algorithms}
            for name, v in plains.items():
                traces[f"{name}_plain"].append([step, v])
            if verbose:
                print(f"[train] step {step:4d}  "
                      + "  ".join(f"{n} {v:.4f}" for n, v in losses.items())
                      + "  plain(probe) "
                      + " ".join(f"{n} {v:.4f}" for n, v in plains.items())
                      + f"  ({time.time() - t0:.0f}s)", flush=True)

    # ---- the shared test stage on held-out speakers: the same frozen
    # episodes for every system
    eval_rng = np.random.RandomState(seed + 2)
    episodes, episode_speakers = [], []
    for s in test_speakers:
        for _ in range(episodes_per_speaker):
            episodes.append(corpus.episode(s, shots, eval_queries, eval_rng, device))
            episode_speakers.append(int(s))

    results = {name: {int(ft): [] for ft in (0,) + tuple(saving_steps)}
               for name in algorithms}
    for name, system in systems.items():
        for sup, qry in episodes:
            rows, _ = system.test_adapt(sup, qry)
            for ft, losses in rows:
                results[name][int(ft)].append(float(losses.total))
        if verbose:
            means = {ft: float(np.mean(v)) for ft, v in results[name].items()}
            print(f"[test] {name}: " + "  ".join(
                f"step{ft}={m:.4f}" for ft, m in sorted(means.items())), flush=True)

    summary = {name: {ft: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                           "n": len(v)}
                      for ft, v in results[name].items()}
               for name in results}
    extras = {}
    if keep_systems:
        # handles for the EER experiment's later stages; callers strip the
        # "_"-prefixed keys before writing JSON
        extras = {"_systems": systems, "_corpus": corpus, "_episodes": episodes,
                  "_episode_speakers": episode_speakers,
                  "_train_speakers": train_speakers, "_test_speakers": test_speakers}
    return {**extras,
            "results": results, "summary": summary, "traces": traces,
            "config": dict(outer_steps=outer_steps, n_train=n_train,
                           n_test=n_test, n_mels=n_mels, shots=shots,
                           queries=queries, meta_batch=meta_batch,
                           inner_steps=inner_steps, inner_lr=inner_lr,
                           test_lr=test_lr, hidden=hidden, layers=layers,
                           saving_steps=list(saving_steps),
                           episodes_per_speaker=episodes_per_speaker,
                           eval_queries=eval_queries, seed=seed,
                           flat_lr=flat_lr, algorithms=list(algorithms),
                           wall_s=round(time.time() - t0, 1))}


def _curves(out):
    """(systems, ft steps, 3) array of (ft step, mean, 95% half-width) of
    the summary, systems in its order."""
    steps = sorted(next(iter(out["summary"].values())))
    rows = []
    for name in out["summary"]:
        s = [out["summary"][name][ft] for ft in steps]
        rows.append([[ft, d["mean"], 1.96 * d["std"] / np.sqrt(max(d["n"], 1))]
                     for ft, d in zip(steps, s)])
    return np.asarray(rows, np.float64)


def plot(out, outdir):
    """The query loss against fine-tune step and the training traces as
    ``<outdir>/curves.png``; without matplotlib (the card machine has none)
    the curves go to ``<outdir>/curves.npy`` (see ``_curves``).  Returns the
    path written."""
    curves = _curves(out)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        path = os.path.join(outdir, "curves.npy")
        np.save(path, curves)
        return path
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    colors = {"meta": "tab:blue", "baseline": "tab:orange", "imaml": "tab:green"}
    for name, c in zip(out["summary"], curves):
        color = colors.get(name, "tab:gray")
        axes[0].plot(c[:, 0], c[:, 1], "-o", color=color, label=name)
        axes[0].fill_between(c[:, 0], c[:, 1] - c[:, 2], c[:, 1] + c[:, 2],
                             color=color, alpha=0.2)
    axes[0].set_xlabel("fine-tune step (held-out speakers)")
    axes[0].set_ylabel("query total loss")
    axes[0].set_title("Few-shot adaptation: meta vs baseline init")
    axes[0].legend()
    for name in out["summary"]:
        color = colors.get(name, "tab:gray")
        tr = np.array(out["traces"][name])
        axes[1].plot(np.arange(len(tr)), tr, color=color, alpha=0.7,
                     label=f"{name} train")
        plain = np.array(out["traces"].get(f"{name}_plain", []))
        if plain.size:
            axes[1].plot(plain[:, 0], plain[:, 1], "--", color=color, alpha=0.9,
                         label=f"{name} plain probe")
    axes[1].set_xlabel("outer step")
    axes[1].set_ylabel("training loss")
    axes[1].set_title("Training traces (meta = post-adaptation query loss)")
    axes[1].legend()
    fig.tight_layout()
    path = os.path.join(outdir, "curves.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m metatts_torch.experiments.meta_advantage")
    ap.add_argument("--outer-steps", type=int, default=400)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--inner-lr", type=float, default=0.001)
    ap.add_argument("--test-lr", type=float, default=0.001)
    ap.add_argument("--flat-lr", type=float, default=None,
                    help="replace Noam with a 100-step warm-up into a constant "
                         "outer lr (the same for every system)")
    ap.add_argument("--meta-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--with-imaml", action="store_true",
                    help="add an IMAMLSystem arm trained on meta's episodes")
    ap.add_argument("--out", default="output/meta_advantage")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    algorithms = (("meta", "imaml", "baseline") if args.with_imaml
                  else ("meta", "baseline"))
    out = run_experiment(outer_steps=args.outer_steps, hidden=args.hidden,
                         layers=args.layers, inner_lr=args.inner_lr,
                         test_lr=args.test_lr, seed=args.seed,
                         flat_lr=args.flat_lr, meta_batch=args.meta_batch,
                         algorithms=algorithms, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(out, f, indent=1)
    path = plot(out, args.out)
    print(f"[done] results.json + {path}")
    meta10 = out["summary"]["meta"].get(10, {}).get("mean")
    base10 = out["summary"]["baseline"].get(10, {}).get("mean")
    if meta10 is not None:
        print(f"[headline] query loss @ 10 adaptation steps: "
              f"meta {meta10:.4f} vs baseline {base10:.4f} "
              f"({'META WINS' if meta10 < base10 else 'baseline wins'})")


if __name__ == "__main__":
    main()
