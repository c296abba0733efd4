#!/usr/bin/env python3
"""The meta-vs-baseline orderings of tests/test_meta_advantage.py over
seeds, on the card or the CPU, with the PyTorch port.

    python3 tools/meta_drift_seeds.py --device cuda [--seeds 0 1 2 3]
        [--jobs 4] [--threads N] [--out meta_drift_seeds.json]

Each seed runs ``metatts_torch.experiments.meta_advantage.run_experiment``
at the test's reduced configuration (hidden 16, 1 + 1 layers, 4 mels, 8
train and 4 held-out speakers, 250 outer steps of 4 episodes of 3 + 3, 5
inner steps at lr 1e-3, test-stage saving steps 5 and 10) with that seed.
For each run it prints and writes the meta arm's plain-loss probe (eval
mode on a fixed batch of train speakers) at its last step, both arms'
held-out query losses at adaptation steps 0, 5 and 10, and whether each of
the test's three orderings holds: meta below the baseline at step 5, at
step 10, and meta's gain (step 10 over step 0) below 0.9 of the
baseline's.  ``--jobs`` runs that many seeds at once, one process each
(the steps are bound by the host's launches, so a card takes several);
``--threads`` fixes torch's intra-op threads of each (the CPU's results
depend on it).  Each seed's record is also kept in ``<out>.seed<k>``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_meta_advantage.py's configuration
CONFIG = dict(outer_steps=250, n_train=8, n_test=4, n_mels=4, shots=3, queries=3,
              meta_batch=4, inner_steps=5, inner_lr=0.001, test_lr=0.001,
              saving_steps=(5, 10), episodes_per_speaker=3, eval_queries=6,
              hidden=16, layers=1, corpus_kwargs=dict(vocab=12, L=8, T=24))


STEPS = (0, 5, 10)          # the adaptation steps the orderings read


def orderings(summary):
    """The test's three orderings (and its two adaptation checks) from a
    ``run_experiment`` summary; the arms' losses as lists over ``STEPS``."""
    m0, m5, m10 = (summary["meta"][ft]["mean"] for ft in STEPS)
    b0, b5, b10 = (summary["baseline"][ft]["mean"] for ft in STEPS)
    return {"meta": [m0, m5, m10], "baseline": [b0, b5, b10],
            "gain_meta": m10 / m0, "gain_baseline": b10 / b0,
            "meta_below_at_5": m5 < b5, "meta_below_at_10": m10 < b10,
            "gain_ordering": m10 / m0 < 0.9 * (b10 / b0),
            "both_adapt": m10 < m0 and b10 < b0 * 1.05}


def run_seed(seed, device, threads):
    import torch
    sys.path.insert(0, HERE)
    from metatts_torch.experiments.meta_advantage import run_experiment
    if threads:
        torch.set_num_threads(threads)
    t0 = time.time()
    out = run_experiment(seed=seed, verbose=False, device=device, **CONFIG)
    probe = out["traces"]["meta_plain"]
    return {"seed": seed, "device": device, "threads": torch.get_num_threads(),
            "seconds": round(time.time() - t0, 1), "meta_probe": probe,
            "meta_probe_last": probe[-1], **orderings(out["summary"])}


def line(r):
    marks = ", ".join(f"{k} {'holds' if r[k] else 'fails'}"
                      for k in ("meta_below_at_5", "meta_below_at_10", "gain_ordering"))
    arms = "; ".join(f"{arm} " + " -> ".join(f"{v:.4f}" for v in r[arm])
                     for arm in ("meta", "baseline"))
    return (f"seed {r['seed']} ({r['device']}, {r['threads']} threads, {r['seconds']} s): "
            f"meta probe {r['meta_probe_last'][1]:.4f} at step {r['meta_probe_last'][0]}; "
            f"{arms} at steps {STEPS}; {marks}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tools/meta_drift_seeds.py")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--jobs", type=int, default=1, help="seeds run at once, a process each")
    ap.add_argument("--threads", type=int, default=None, help="torch's intra-op threads")
    ap.add_argument("--out", default="meta_drift_seeds.json")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:      # a worker: one seed, its record as JSON in ``--out``
        with open(args.out, "w") as f:
            json.dump(run_seed(args.seeds[0], args.device, args.threads), f)
        return 0
    results, running, queue = [], [], list(args.seeds)
    while queue or running:
        while queue and len(running) < args.jobs:
            seed = queue.pop(0)
            part = f"{args.out}.seed{seed}"
            cmd = [sys.executable, os.path.abspath(__file__), "--one", "--device", args.device,
                   "--seeds", str(seed), "--out", part] + (
                       ["--threads", str(args.threads)] if args.threads else [])
            running.append((subprocess.Popen(cmd), part))
        proc, part = running.pop(0)
        if proc.wait():
            raise SystemExit(f"a seed's run failed ({proc.returncode})")
        with open(part) as f:
            results.append(json.load(f))
        print(line(results[-1]), flush=True)
    results.sort(key=lambda r: r["seed"])
    counts = {k: sum(r[k] for r in results)
              for k in ("meta_below_at_5", "meta_below_at_10", "gain_ordering")}
    print(f"{args.device}: orderings held over {len(results)} seeds: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))
    with open(args.out, "w") as f:
        json.dump({"config": CONFIG, "runs": results, "counts": counts}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
