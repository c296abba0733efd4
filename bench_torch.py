#!/usr/bin/env python3
"""Benchmark of the PyTorch port on one CUDA card, at ``bench.py``'s workload:

    python3 bench_torch.py

* the meta step (``MetaSystem.train_step``, second-order MAML): one episode
  of 5 support and 5 query utterances, 128 symbols, 896 mel frames, 5 inner
  steps, the default configs with 256 speakers; 2 warm-up and 10 timed
  steps.  ``value`` is mel frames per second: (support frames x inner steps
  + query frames) per step;
* one effective step of the reference recipe's meta batch 8 on one card
  (``grad_acc_step`` 8): 8 chained micro-steps;
* test-time adaptation: 100 first-order SGD steps on one episode's support
  set, then the query's synthesis (fused FFT blocks) and the MelGAN
  vocoder, against the seconds of audio produced (``adapt100_synth_rtf``);
  the synthesis forward alone, 10 calls (``synth_forward_ms_chained``);
* the test stage: ``System.test_adapt`` (100 steps, saving steps [5, 10,
  20, 50, 100], snapshot evaluations) per task, and
  ``test_adapt_batched`` over 8 copies of the task, which runs them one
  after another on the card;
* the baseline step (``BaselineSystem.train_step``) at the reference
  recipe's batch: 80 utterances of 128 symbols and 896 mel frames, 256
  speakers; 3 warm-up and 10 timed steps (``baseline_step_ms_B80``, and
  ``baseline_mel_frames_per_sec``: the batch's mel frames per step time).

Every time is a host clock around work that ends in
``torch.cuda.synchronize()``.  It prints one JSON line with ``bench.py``'s
keys; those of the TPU's compiler and baselines are null.  The card's name and power limit are in
the line.  It exits with an error where no CUDA device is available.
"""

import copy
import json
import subprocess
import sys
import time

import numpy as np

SHOTS, QUERIES, SRC_LEN, MEL_LEN, INNER_STEPS, EPISODES = 5, 5, 128, 896, 5, 1
WARMUP, ITERS = 2, 10
BASELINE_B, BASELINE_WARMUP = 80, 3
N_SPEAKERS = 256
BATCHED = 8           # tasks of test_adapt_batched
TEST_REPS = 2         # timed sequential tasks, after one untimed


def _batch(rng, B, L, T, n_mels, n_speakers=8):
    """Synthetic utterances as ``bench.py`` makes them: durations 1 .. T // L
    - 1 per symbol, mel length their sum (at most T), random mels, pitch,
    energy, symbols and one speaker id each (numpy, no JAX)."""
    d = rng.randint(1, max(2, T // L), size=(B, L)).astype(np.int32)
    return (rng.randint(0, n_speakers, (B,)).astype(np.int32),
            rng.randint(1, 360, (B, L)).astype(np.int32),
            np.full((B,), L, np.int32),
            rng.randn(B, T, n_mels).astype(np.float32),
            np.minimum(d.sum(1), T).astype(np.int32),
            rng.randn(B, L).astype(np.float32),
            rng.randn(B, L).astype(np.float32),
            d)


def episode_stack(rng, B):
    """``EPISODES`` episodes of B utterances on a leading axis, on the card."""
    import torch
    from metatts_torch.data.collate import Batch
    eps = [_batch(rng, B, SRC_LEN, MEL_LEN, 80, N_SPEAKERS) for _ in range(EPISODES)]
    return Batch(*(torch.from_numpy(np.stack(f)) for f in zip(*eps))).to("cuda")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def wall(fn):
    """(result, seconds) of fn(), synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main():
    import torch
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device is available", file=sys.stderr)
        return 2
    from metatts_torch import config as C
    from metatts_torch.algorithms.base import episode
    from metatts_torch.algorithms.meta import MetaSystem
    from metatts_torch.models.vocoder import Vocoder

    [pcfg], mcfg, tcfg, acfg = C.default_configs()
    acfg["type"] = "meta"
    acfg["adapt"]["train"].update(shots=SHOTS, queries=QUERIES, steps=INNER_STEPS)
    system = MetaSystem(pcfg, mcfg, tcfg, acfg, n_speakers=N_SPEAKERS, device="cuda")
    rng = np.random.RandomState(0)
    sup, qry = episode_stack(rng, SHOTS), episode_stack(rng, QUERIES)

    # the meta step
    _, first_s = wall(lambda: system.train_step(sup, qry))
    for _ in range(WARMUP):
        system.train_step(sup, qry)
    torch.cuda.reset_peak_memory_stats()
    losses, dt = wall(lambda: [system.train_step(sup, qry) for _ in range(ITERS)][-1])
    dt /= ITERS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    frames_per_step = int(sup.mel_lens.sum()) * INNER_STEPS + int(qry.mel_lens.sum())

    # adaptation (100 first-order steps) + synthesis + vocoder
    sup1, qry1 = episode(sup, 0), episode(qry, 0)
    test_cfg = acfg["adapt"]["test"]
    vocoder = Vocoder(mcfg, n_mels=80, device="cuda")
    adaptor = system.adaptor

    def adapt(steps):
        return adaptor.adapt_first_order(system.params, sup1, steps=steps,
                                         lr=test_cfg["lr"], train=False)

    @torch.no_grad()
    def synth(params):
        return adaptor.forward(params, qry1, train=False, average_spk_emb=True,
                               fused_infer=True)

    def adapt_synth(steps):
        out = synth(adapt(steps))
        lens = out.mel_lens.cpu().numpy()
        return vocoder.infer(out.postnet_mel, lengths=lens * 256), lens

    adapt_synth(10)                                   # warm-up
    (wavs, lens), adapt_synth_s = wall(lambda: adapt_synth(test_cfg["steps"]))
    audio_s = float(lens.sum()) * 256 / 22050.0
    params = adapt(1)
    synth(params)
    _, synth_s = wall(lambda: [synth(params) for _ in range(10)])

    # one effective meta-batch-8 step (grad_acc_step 8)
    tcfg_acc = copy.deepcopy(tcfg)
    tcfg_acc["optimizer"]["grad_acc_step"] = 8
    accsys = MetaSystem(pcfg, mcfg, tcfg_acc, acfg, n_speakers=N_SPEAKERS, device="cuda")
    for _ in range(3):
        accsys.train_step(sup, qry)
    _, acc_dt = wall(lambda: [accsys.train_step(sup, qry) for _ in range(8)])
    del accsys

    # the test stage: sequential tasks, then 8 tasks through the batched path
    def task():
        rows, snaps = system.test_adapt(sup1, qry1)
        float(rows[-1][1].total)
        return snaps

    _, first_task_s = wall(task)
    seq_task_s = float(np.mean([wall(task)[1] for _ in range(TEST_REPS)]))
    mode_seq = system.snapshot_mode
    stack = lambda b: type(b)(*(t[None].expand(BATCHED, *t.shape) for t in b))
    _, bat_wall_s = wall(lambda: system.test_adapt_batched(stack(sup1), stack(qry1)))
    mode_batched = system.snapshot_mode

    # the baseline step at batch 80
    from metatts_torch.algorithms.baseline import BaselineSystem
    from metatts_torch.data.collate import Batch
    bsys = BaselineSystem(pcfg, mcfg, tcfg, dict(acfg, type="baseline"),
                          n_speakers=N_SPEAKERS, device="cuda")
    bbatch = Batch(*(torch.from_numpy(f) for f in _batch(
        rng, BASELINE_B, SRC_LEN, MEL_LEN, 80, N_SPEAKERS))).to("cuda")
    for _ in range(BASELINE_WARMUP):
        bsys.train_step(bbatch)
    _, b_dt = wall(lambda: [bsys.train_step(bbatch) for _ in range(ITERS)])
    b_dt /= ITERS
    b_frames = int(bbatch.mel_lens.sum())

    card = card_line()
    print(json.dumps({
        "metric": "train_mel_frames_per_sec_per_chip",
        "value": round(frames_per_step / dt, 1),
        "unit": "mel-frames/s/chip (MAML outer step, 5-shot/5-query, "
                "5 second-order inner steps)",
        "device": torch.cuda.get_device_name(0),
        "card": card,
        "vs_baseline": None,
        "baseline_kind": None,
        "vs_torch_same_host_cpu_measured": None,
        "step_time_ms": round(dt * 1e3, 2),
        "first_step_s": round(first_s, 2),
        "peak_memory_gib": round(peak_gib, 2),
        "xla_step_tflops": None,
        "compile_s": None,
        "loss": float(losses.total),
        "adapt100_synth_rtf": round(adapt_synth_s / max(audio_s, 1e-6), 4),
        "adapt100_synth_s": round(adapt_synth_s, 3),
        "synth_forward_ms_chained": round(synth_s / 10 * 1e3, 2),
        "baseline_step_ms_B80": round(b_dt * 1e3, 2),
        "baseline_mel_frames_per_sec": round(b_frames / b_dt, 1),
        "gradacc8_effective_step_ms": round(acc_dt * 1e3, 2),
        "gradacc8_frames_per_sec": round(frames_per_step * 8 / acc_dt, 1),
        "test_stage_tasks_per_sec_seq": round(1.0 / seq_task_s, 3),
        "test_stage_tasks_per_sec_batched8": round(BATCHED / bat_wall_s, 3),
        "test_stage_speedup_batched8": round(seq_task_s * BATCHED / bat_wall_s, 2),
        "test_stage_snapshot_offload": {"seq": mode_seq, "batched8": mode_batched},
        # the port compiles nothing: the first task's extra seconds over a
        # steady one (lazy CUDA and cuDNN set-up)
        "test_stage_compile_s": round(first_task_s - seq_task_s, 1),
    }))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
