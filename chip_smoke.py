#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. build   -- compiles ``metatts_torch/csrc/fftblock.cu``,
              ``flash_attention.cu``, ``melspec.cu`` and ``adam.cu`` (with
              the shared ``hopper.cuh``) for sm_90a, one nvcc each, and the
              native F0/FLAC library (``csrc/world.cpp``, ``csrc/flac.cpp``,
              g++), all in parallel;
   tf32    -- with PyTorch's global flags at their defaults (cuDNN's fp32
              convolutions in TF32), two sentences through
              ``SynthesisEngine(device="cuda").synthesize`` against the same
              engine on the CPU in fp32 (largest mel and int16 wav
              differences), then the MelGAN vocoder alone on the card's
              mels with TF32 on and off, each against the CPU, the TF32 gap
              within serving's bound; TF32 and fp32 matmuls are then turned
              off for the rest of the run;
2. kernel  -- the fused FFT-block kernel (wgmma + TMA) against its plain
              PyTorch version at the base width (D=256, 2 heads, F=1024,
              k=9) for (B=8, T=1000) with lengths 1000, 777 and 0 among the
              rows, (1, 1000), (8, 160) and (8, 64), and in the serving mode
              (bf16 in, bf16 out, which must also be the bits of the fp32
              output rounded) at (8, 1000); then at widths the gate admits
              beyond the base model's (D=384 / 3 heads, D=512 / 4 heads,
              D=1024 / 8 heads, D=256 / 64 heads with F=1020) at B=2,
              T=100; relative error, padded rows, invariance to garbage in
              padded rows, no NaN; a call's ms (median of 5 runs of 20
              calls), device ms (CUDA graph),
              plain, bound, the library composite (``F.linear``, SDPA,
              ``F.layer_norm``, ``F.conv1d``, never on the port's path) and
              each stage's device ms at (8, 1000);
3. flash   -- the flash-attention forward and backward kernels (wgmma +
              TMA in bf16) against their plain versions at the training
              slice's shapes, bf16 (BH=10, D=128, T=896 and T=128), a
              ragged fp32 case (T=77) and the baseline step's width (BH=160,
              T=896 and T=128, bf16), then in bf16 at T=1000 (the serving
              cap), T=77 and D=72, with rows fully valid, partly padded and
              fully padded, at the TPU kernel's own test tolerances and, in
              bf16, at tighter limits set from the card's readings; two
              bf16 calls on the same inputs bit-identical; a call's ms
              (median of 5 runs of 20 calls), device ms (20 calls in a
              CUDA graph), plain, bound and scaled_dot_product_attention
              ms;
4. mel     -- the log-mel kernel (a real FFT per frame) against its plain
              PyTorch version (TF32 off) on 16 and on 1 utterance of 10 s
              of noise at 22.05 kHz (n_fft 1024, hop 256, 80 mels), 3 x 1000
              samples of silence (log 1e-5 everywhere), two 10 s -60 dBFS
              tones half silent (bins near the clamp), 220,501 samples (no
              multiple of hop), 2 x 300 samples (repeated reflect padding)
              and four other parameter sets (n_fft 256 to 2048, hop 200,
              128 mels), at the TPU kernel's test tolerances (log-mel atol
              1e-4, energy rtol and atol 1e-4), with where the worst error
              sits; kernel (a call, and device time in a CUDA graph), plain,
              bound and ``torch.stft``-route ms, the kernel faster than the
              ``torch.stft`` route at both 10 s shapes;
   adam    -- NoamAdam's multi-tensor kernel (``ops/adam.py``, not run by
              the benchmark's harness) over the base configuration's 216
              leaves (34.94 M fp32 parameters, 1151 speakers): 3 steps at a
              constant lr of 1e-3 from random gradients of global norm 4, 0.5
              and 2 (the last with one leaf's gradient None), so clipped, not
              clipped, clipped, at weight decay 0 and 0.01: after each step p,
              mu and nu bit for bit those of the per-leaf loop fed the
              kernel's norm, the norm within 1e-6 of the loop's, at most 8
              launches; two runs from one start bit for bit; a step's host
              time, a call's and its device time (CUDA graph) within twice
              its byte bound, and the per-leaf loop's call; the main
              path's own launches are counted in the train, fit, lang and
              ddp phases (4 an optimizer step at the base configuration);
5. preprocess -- a synthetic corpus from a seed (4 speakers x 8
              utterances whose mean length, 5.83 s, is LibriTTS
              train-clean-100's, with ``phones`` TextGrids) through
              ``Preprocessor(device="cuda").build_from_path()`` with
              LibriTTS's preprocessing at full width: native F0, exactly one
              mel kernel launch per utterance written, every artifact's
              shape, stats.json and speakers.json; three utterances again on
              the card and on the CPU (atol 1e-4); the corpus read back with
              ``TTSDataset`` and ``collate_batch`` into a teacher-forced
              base-config FastSpeech2 forward and loss on the card (finite);
              utterances/s, audio seconds per wall second and the per
              utterance split of F0, mel, reference slices and file I/O, on
              this synthetic mix only (the smoke's throughput, not a
              preprocessing benchmark);
6. serve   -- ``SynthesisEngine`` at the base configuration (the port's
              defaults, equal to config/model/base.yaml,
              config/preprocess/LibriTTS.yaml and
              config/algorithm/meta_emb_vad.yaml; bf16 compute and
              activations; MelGAN; 8 speakers; random weights from seed 0)
              serves request batches of 8, 1 and 4 sentences at
              mel_cap=1000, each through exactly 10 kernel launches; a
              teacher-forced forward through the kernel agrees with the same
              forward through the plain version; ms per call, real-time
              factor, and the split between acoustic model, fused blocks
              and vocoder;
7. train   -- ``MetaSystem.train_step`` at the same base configuration
              (second-order MAML, 5 inner SGD steps, custom-HVP) on
              ``bench.py``'s workload: one episode of 5 support and 5 query
              utterances, 128 symbols, 896 mel frames, synthetic from a
              seed; exactly 10 flash forward and 10 flash backward launches
              per step, finite losses, parameters that move, BatchNorm
              running statistics untouched, and one meta-gradient through
              the kernels against the same step through the plain versions,
              in bf16 and at fp32 compute (the kernels' fp32 path, under
              deterministic algorithms, with the plain step's own gap at
              PyTorch's default algorithms); ``length_regulate`` (a product
              with the one-hot alignment) against the previous gather
              version bit for bit, fp32 and bf16, with zero durations and
              truncation; ms per step, mel frames/s, peak memory; then one
              first-order ``validation_step``, and the same meta step as the
              port ran it previously (gather, embeddings by index, cuDNN's
              default algorithms) timed; then seven training steps (the
              meta step in bf16 on this workload and in fp32 at the EER
              experiment's config, the baseline step in bf16 at B=80 and in
              fp32 at the EER config, the iMAML step in bf16, one step of
              the test stage's ``adapt_first_order`` in bf16 and in fp32,
              called with no flags set around it), each as previously and as
              now: two calls' losses and gradients, and a census of the
              ops that do not repeat themselves (every op that is neither
              elementwise nor a view run twice on the same inputs, those
              PyTorch documents as non-deterministic on the card, and
              PyTorch's own warnings under ``warn_only`` deterministic
              algorithms); now each step's two calls must agree bit for
              bit and no such op may be left;
   imaml   -- ``IMAMLSystem.train_step`` at the same base configuration's
              full width and depth with imaml_emb_vad's adapt settings (5
              first-order inner steps on einsum attention, CG of 5 steps at
              reg 0.5) on the train phase's workload: the fp32 hypergradient
              (after its NaN-zeroing and clip) through the flash kernels
              against the same step through their plain versions under
              deterministic algorithms; the same at a state where CG steps
              (the EER config after 20 baseline steps: the CG steps taken
              per episode, at least one, held at the meta-gradient's 1e-4);
              then one warm-up and 3 timed steps
              with exactly 10 flash forward and 10 flash backward launches a
              step (the query's forward and its gradient; inner loop and CG
              run on einsum), finite losses, parameters that move, peak
              memory, and one profiled step's device time and idle share;
   hvp_fwd -- the train phase's meta step with ``model.hvp_mode="fwd"``
              (one forward-mode JVP of the full support gradient per inner
              step) against ``"rev"``: the fp32 meta-gradient under
              deterministic algorithms, then both step times in one call;
8. test    -- the few-shot test stage at the base configuration: a
              checkpoint written by ``save_checkpoint`` and read by
              ``SynthesisEngine.from_checkpoint`` synthesizes the 8
              sentences bit for bit as its source, and a 4-speaker
              checkpoint loads into 8 rows with the surgery report; then
              ``Trainer.test`` on the preprocess phase's corpus (its own
              stats.json), 2 tasks of 5 support and 1 query utterance, each
              100 first-order steps (dropout on, flash in the inner loop)
              with query evaluations and snapshots at [5, 10, 20, 50, 100]
              (fused blocks), a teacher-forced recon wav and a synth wav per
              saving step: exactly 1000 flash forward, 600 flash backward
              and 130 fused launches per task, finite rows, moved
              snapshots, the CSVs and non-empty int16 wavs; again with
              ``test_task_batch`` 2 at saving steps [5, 10]
              (``test_adapt_batched``: stacked shapes, finite rows); a
              first-order support gradient through the flash kernels
              against their plain versions (bf16, and fp32 under
              deterministic algorithms); two snapshot evaluations back to
              back through the fused kernel against its plain version;
              ``adapt_speaker`` (100 steps) then ``synthesize``; s per task,
              ms per inner step and per evaluation, the adapt + synthesis
              real-time factor, peak memory, the snapshot mode and the
              flash kernels' share of an inner step's device time;
   eval    -- offline evaluation (``python -m metatts_torch.evaluate``'s
              functions) of the test stage's result tree and the preprocess
              corpus's real wavs (4 speakers x 8), all at published widths
              in fp32: a scratch GE2E verifier (3 x LSTM-256) trained by
              ``train_ge2e`` on the card for 20 steps on the corpus's
              partials, 4 speakers a batch, its first 3 losses against the
              CPU; ``run_matrix``'s eer.txt rows over one mode (the test
              tree at its FT steps) with three d-vector encoders (a random
              init at resemblyzer's width, examples/meta_advantage_eer/
              ge2e_scratch.npz at width 128, the scratch verifier read back
              from its npz with ``require_weights``), each against the same
              rows and d-vectors on the CPU (EER/AUC within one pair,
              d-vectors max abs 1e-4), the real rows finite (a test-tree
              group of one wav gives NaN rows, as in the JAX package);
              ``mos_rows`` with MOSNet, MBNet (random weights at their
              published widths) and wav2vec2-base with a regression head
              registered beside the spectral proxy, then with the headless
              wav2vec2 and the proxy; each scorer against the CPU on 3 wavs
              (rel 1e-4), the headless wav2vec2's hidden states too;
              seconds a wav of each embedder and scorer (every 4th wav),
              kernel launches a d-vector, seconds a scratch-GE2E step;
9. fit     -- training runs at the base configuration on the preprocess
              phase's corpus (its own stats.json): ``Trainer.fit`` of the
              baseline system (config/algorithm/base_emb_vad.yaml,
              config/train/base.yaml: batch 80, drawn with replacement from
              the corpus's 32 utterances) for 6 steps, with validation (one
              frozen task a speaker), in-loop synthesis through MelGAN and
              checkpoints every 3: exactly 10 + 10 flash launches a step, 60
              + 30 a validation task and the total of the run (the
              validation and training samples included), no fused or mel
              launch; finite losses in train.csv, every BatchNorm buffer
              moved, the checkpoints, CSVs and wavs under the JAX package's
              names; a second ``Trainer`` resumed from ``step_3.ckpt`` to
              step 6 starts from the first run's Adam moments, counts,
              step and weights bit for bit; the gradient of one batch-80
              step through the flash kernels against their plain versions
              (bf16, and fp32 under deterministic algorithms); the step's
              mean and p95 over 5 synchronised steps, mel frames/s, the
              run's ``[profile]`` (e2e steps/s with validation, synthesis
              and checkpoints), peak memory, and one profiled step's
              device time, idle share, largest kernels and flash share;
              then ``Trainer.fit`` of the meta system (meta_emb_vad, 2
              episodes a step, 2 steps, validation at step 2) with its
              launches a step and a validation task;
10. dvec   -- the GE2E d-vector speaker modes at the base width (3 x
              LSTM-256 over 160 x 40-mel reference slices) on episodes that
              ``MetaDataModule(..., spk_refer_wav=True)`` collates from the
              preprocess phase's corpus (5 support + 3 query utterances):
              the encoder mode's fp32 meta-gradient through the flash kernels
              against their plain versions under deterministic algorithms;
              one second-order ``MetaSystem.train_step`` in ``encoder`` mode
              (every GE2E tensor moves) and one in ``dvec`` mode (none
              does), exactly 10 + 10 flash launches each; one first-order
              ``test_adapt`` task of 10 steps in ``scratch_encoder`` mode
              (10 + 6 flash launches a step, 10 fused a query evaluation);
              times of each;
11. lang   -- cross-lingual meta-training with the codebook phoneme
              embedding (config/algorithm/meta_lang_codebook.yaml): a
              LibriTTS-layout corpus from a seed (4 speakers x 8 utterances
              at 24 kHz with ``.normalized.txt`` transcripts, the preprocess
              phase's length spread, MFA-style TextGrids) through
              ``prepare_align`` and ``Preprocessor(device="cuda")`` with
              representations (one mel launch per utterance); language
              episodes from ``MetaDataModule`` (every query phoneme in its
              support, ``phn_ref`` equal to a host recomputation) at
              representation_dim 80, the built-in featurizer's; at the base
              width with the 128-entry hard codebook, 2 episodes of 5 + 3
              utterances, 5 inner steps: the fp32 meta-gradient through the
              flash kernels against their plain versions under
              deterministic algorithms (``emb_banks`` included; rows no
              episode picks exactly 0), one ``train_step`` (10 + 10 flash
              launches an episode, exactly the picked rows move) and a
              profiled one; at the config's representation_dim 256 on the
              train phase's episode, steps timed against the same meta step
              without the codebook; ``python -m metatts_torch -s train``'s
              entry point for 2 steps on the corpus, its ``last.ckpt`` read
              back with the codebook and its Adam moments bit for bit;
12. synth_eer -- the meta-vs-baseline EER experiment
              (``metatts_torch.experiments.meta_eer.run_eer_experiment``) at
              the JAX run's widths (examples/meta_advantage_eer/
              results.json: hidden 32, 1 + 1 layers, 8 mels, 4 episodes of
              5 + 5, 5 inner steps), cut in depth (4 outer steps, 8 + 2
              speakers, 1 episode a held-out speaker, saving steps [5, 10],
              4 queries, 10 GE2E steps, 4 enrolment utterances, 8
              Griffin-Lim iterations; the duration bias at log 3): first the
              first outer step of each arm, fp32 with dropout off under
              deterministic algorithms, held against the same step on the
              CPU from the same weights (gradient rel L2 < 1e-4, with
              PyTorch's own CUDA convolutions; cuDNN's gap printed); then
              the run, with exact flash launches per meta step, baseline
              step, test task and synthesis forward and for the whole run,
              the result tree, ``eer.txt``'s row labels and
              ``results.json``'s keys those of the JAX script, every value
              finite; then one step of each arm and a test task with
              synthesis at hidden 256 (2 heads, 80 mels): flash at d_k 128,
              every evaluation and synthesis on the fused block, counted;
              ms per step of each arm, per test task and step, per
              synthesis forward and Griffin-Lim call, seconds per stage;
    meta_drift -- (in a process of its own, started before ``eval``
              and collected after ``ddp``, so that its minutes run beside
              theirs, whose ``[time]`` lines are marked contended) the card's meta-training trajectory against the CPU's
              at the EER experiment's config (the JAX run's: hidden 32, 32
              + 8 speakers, 4 episodes of 5 + 5, fp32): the meta arm of
              ``run_experiment`` trained 50 outer steps on the card, then
              10 more outer steps on the card and, from the same state
              (weights, BatchNorm buffers, Adam's moments, the step, the
              seed chain), on the CPU at 1 thread (in a process of its
              own, ``chip_smoke.py --drift-cpu <state> <out>``, beside the
              other two) and at the machine's thread count, on the same
              episodes with dropout on (masks
              from a CPU generator on both sides); per step the weights'
              and the meta-gradient's rel L2 card vs CPU and CPU vs CPU,
              and the losses; the card's weights within 10 x the CPU's own
              gap (at least 1e-7) at every step;
13. ddp    -- two ranks over gloo on the one card (``chip_smoke.py
              --ddp-rank <r> <store> <out>``; NCCL refuses two ranks on one
              device) against one process: a meta and an iMAML step of 2
              episodes and a baseline step on a batch of 4 whose halves hold
              different numbers of valid frames, at the base width in fp32
              under deterministic algorithms, with cuDNN's convolutions and
              with PyTorch's own: losses rtol 2e-4 and parameters atol 2e-4
              both ways, the optimizer's gradient rel L2 2e-4 with
              PyTorch's own, both ranks' parameters bit for bit, 10 + 10
              flash launches a rank a step;
14. report -- one JSON line of kernels, then the card's name and power
              limit, then the result line.

It exits with an error and prints no result where no CUDA device is
available, or where the ``metatts_torch`` package is not beside it.
"""

import contextlib
import functools
import glob
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

BASE_SHAPE = dict(D=256, H=2, F=1024, K=9)
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
REL_TOL = 5e-3                # max|kernel - plain| / max|plain|, as the TPU
                              # kernel's own test holds it against XLA
INVARIANCE_TOL = 1e-5
# relative L2 gap of gradients through the flash kernels against the same
# computation through their plain versions.  At the kernel the two agree
# to rounding (fp32 ~4e-7, bf16 one ulp of dq/dk), but at random init the
# model's gradient amplifies any rounding: the postnet's batch-statistics
# BatchNorms dominate the gap, and switching the query attention between
# two plain implementations of the same math (einsum with bf16 scores and
# softmax, as the JAX package rounds, against the flash plain version)
# moves the bf16 gradient by ~0.09 and the meta-gradient (5 inner steps
# whose HVPs are large) by ~0.12.  The tolerances hold the kernels to that
# order, with the fp32 path much tighter.
GRAD_TOL_F32 = 2e-3
GRAD_TOL = 0.25
META_GRAD_TOL = 0.3
# the same meta-gradient at fp32 compute, through the kernels' fp32 path,
# with PyTorch's deterministic algorithms: there the step through the plain
# versions repeats itself exactly, and only the order of the kernels' sums
# differs.  At this random init the step amplifies rounding-level
# differences by orders of magnitude, so the reading moves with rounding
# elsewhere in the step (PERF.md, section 6): 7.195e-6 on the tree before
# the steps were made repeatable, 8.883e-5 after it, and 8.883e-5 to
# 8.886e-5 with the step flags, the one-hot regulator or the one-hot
# embeddings undone, alone or all together.
META_GRAD_TOL_F32 = 1e-4
# the iMAML hypergradient at fp32 compute under deterministic algorithms.
# At random init CG's first step meets p'Ap <= 0 and freezes (x = 0), so
# the adapted modules' hypergradient is 0 and what is left is the frozen
# encoder's query gradient at w*, clipped: a quantity that any change in
# the order of the attention's sums moves far more than the meta-gradient
# (the card's readings, PERF.md section 6: the kernels 2.334e-4 from the
# plain versions, einsum attention 1.909e-4 from them; 3.716e-3 and
# 3.727e-3 with cuDNN's convolutions and index ops).  The meta-gradient's
# 1e-4 above holds there only because its norm is the adapted modules' HVP
# terms'.
IMAML_GRAD_TOL_F32 = 1e-2
# the bf16 flash kernels against their plain versions, beside the TPU
# tests' tolerances and set from the card's readings (PERF.md, section 6):
# out max abs 6.3e-4 at worst (T=1000; in a row with few valid keys one
# bf16 step of P moves out by ~4e-3 over the key count), lse 9.5e-7 (two
# fp32 ulps at |lse| ~7), grads rel 4.2e-3 (one bf16 step of the largest
# gradient)
FLASH_BF16_OUT, FLASH_BF16_LSE, FLASH_BF16_GRAD_REL = 2e-3, 1e-5, 1e-2
SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "She sells sea shells by the sea shore, and the shells she sells are surely sea shells.",
    "A journey of a thousand miles begins with a single step.",
    "Printing, in the only sense with which we are at present concerned, differs from most if not from all the arts and crafts represented in the exhibition.",
    "It was the best of times, it was the worst of times.",
    "How much wood would a woodchuck chuck if a woodchuck could chuck wood?",
    "Meta learning lets a speech synthesizer adapt to a new voice from a handful of recordings.",
    "All that glitters is not gold.",
]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, reps=5):
    """A call's time where the host's enqueue may set it: the median of
    ``reps`` runs of ``cuda_ms`` (20 calls each), so that a stall of the
    shared host in one run does not count."""
    fn()
    runs = sorted(cuda_ms(fn, warmup=1) for _ in range(reps))
    return runs[reps // 2]


def block_bound(B, T, D, H, F, K):
    """(bound_ms, bound_by, flops, bytes) of one FFT block call: each input
    read once, each output written once, against the card's peaks."""
    flops = B * T * (2 * D * 3 * D + 4 * T * D + 2 * D * D + 2 * K * D * F
                     + 2 * F * D)
    weights = 2 * (3 * D * D + D * D + F * K * D + D * F)
    vectors = 4 * (3 * D + D + 2 * D + F + D + 2 * D)
    nbytes = 4 * B * T * D * 2 + 4 * B * T + weights + vectors
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


KERNEL_SOURCES = ("fftblock", "flash_attention", "melspec", "adam")


def phase_build():
    from metatts_torch.ops import _build, adam, attention, fftblock, melspec
    from metatts_torch.preprocess import pitch
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as pool:
        host = pool.submit(_build.build_host, "world", pitch.SOURCES)
        list(pool.map(_build.build, KERNEL_SOURCES))
        host.result()
    fftblock._lib()
    attention._lib()
    melspec._lib()
    adam._lib()
    if pitch.f0_backend() != "native-dio":
        raise AssertionError("the native F0 library did not load")
    print(f"[build] {', '.join(n + '.cu' for n in KERNEL_SOURCES)} and the native "
          f"F0/FLAC library in parallel: {time.perf_counter() - t0:.2f} s ("
          + ", ".join(f"{n} {_build.build_seconds.get(n, 0.0):.2f} s"
                      for n in KERNEL_SOURCES + ("world",)) + ")")
    for name in KERNEL_SOURCES:
        log = os.path.join(_build.BUILD_DIR, name + ".log")
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if any(w in line.lower() for w in ("entry function", "registers",
                                                       "spill", "warning")):
                        print(f"[build] {name}: " + line.strip())


def _block(D, H, F, K, gen):
    import torch
    from metatts_torch.models import nn as L
    from metatts_torch.models.transformer import FFTBlock
    blk = FFTBlock(D, H, F, [K, 1])
    L.reset_parameters(blk, gen)
    with torch.no_grad():      # non-trivial LayerNorm parameters
        for ln in (blk.slf_attn.layer_norm, blk.pos_ffn.layer_norm):
            ln.weight.copy_(1 + 0.1 * torch.randn(D, generator=gen))
            ln.bias.copy_(0.1 * torch.randn(D, generator=gen))
    return blk.cuda().eval()


def check_block(p, B, T, H, lens, gen, bf16=False):
    """Kernel against plain version on one input; raises on disagreement.
    ``bf16``: the input in bf16 and ``out_dtype=bf16`` (the serving path's
    mode).  Two roundings to bf16 of fp32 results that differ by ~1e-3 can
    land one bf16 step apart (0.03125 at |y| in [4, 8)), so there the
    kernel's output is held (a) at the same relative tolerance against the
    plain version's fp32 result for the same inputs, (b) to the bits of
    its own fp32 output rounded, and (c) against the plain version's bf16
    output element by element: each element within the tolerance or one
    bf16 step apart.  Returns (x, valid, max_abs_err, max_rel_err)."""
    import torch
    from metatts_torch.ops.fftblock import fused_fft_block, fused_fft_block_plain
    D = p["w_fc"].shape[0]
    x = torch.randn(B, T, D, generator=gen).to(torch.bfloat16).float().cuda()
    lens_t = torch.tensor(lens)
    valid = (torch.arange(T)[None, :] < lens_t[:, None]).cuda()
    kw = {}
    if bf16:
        kw = dict(out_dtype=torch.bfloat16)
        x = x.to(torch.bfloat16)
    got = fused_fft_block(p, x, valid, H, **kw)
    ref = fused_fft_block_plain(p, x, valid, H)              # fp32
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    pad_max = got[~valid].float().abs().max().item() if (~valid).any() else 0.0
    x2 = x.clone()
    g = min(1, B - 1)
    x2[g, lens[g]:] = 1e3                 # garbage beyond a row's length
    if B > 2:
        x2[2] = -1e3                      # a row with no valid position at all
    got2 = fused_fft_block(p, x2, valid, H, **kw)
    inv = (got2[valid].float() - got[valid].float()).abs().max().item()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(got2).all())
    bf16_ok, note = True, ""
    if bf16:
        same_bits = torch.equal(got, fused_fft_block(p, x.float(), valid, H)
                                .to(torch.bfloat16))
        ref_b = fused_fft_block_plain(p, x, valid, H, **kw).float()
        gap = (got.float() - ref_b).abs()
        over = gap > REL_TOL * ref_b.abs().max()
        step = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
            torch.log2(ref_b[over].abs())))                    # one bf16 step
        steps = (gap[over] / step).max().item() if over.any() else 0.0
        bf16_ok = same_bits and steps <= 1.0
        note = (f"; bf16 out == fp32 out rounded {same_bits}; vs the plain bf16 "
                f"output: rel {gap.max().item() / ref_b.abs().max().item():.3e}, "
                f"{int((gap > 0).sum())} of {gap.numel()} elements differ, "
                f"{int(over.sum())} beyond the tolerance, those {steps:.0f} bf16 "
                f"step(s) apart")
    print(f"[kernel] B={B} T={T} D={D} H={H} F={p['filter_size']}"
          f"{' bf16 in/out' if bf16 else ''}: max_abs_err {err:.3e} rel {rel:.3e} "
          f"pad_max {pad_max} invariance {inv:.3e} finite {finite}{note}")
    if not (rel < REL_TOL and pad_max == 0.0 and inv < INVARIANCE_TOL
            and finite and bf16_ok):
        raise AssertionError(f"fused_fft_block disagrees with its plain "
                             f"version at B={B} T={T} D={D}")
    return x, valid, err, rel


def composite_block(p, H):
    """The yardstick, never on the port's path: the same block through
    PyTorch's library calls in bf16 (``F.linear``, SDPA with a key mask,
    ``F.layer_norm``, ``F.conv1d``; TF32 off), for timing.  Returns a
    function of (x, valid)."""
    import torch
    import torch.nn.functional as Fn
    bf = torch.bfloat16
    D, F, K = p["w_fc"].shape[0], p["filter_size"], p["conv_k"]
    w1 = p["w1"][:F].view(F, K, D).permute(0, 2, 1).contiguous()     # (F, D, K)
    w2 = p["w2"][:, :F].contiguous()
    b = {n: p[n].to(bf) for n in ("b_qkv", "b_fc", "b2")}
    b["b1"] = p["b1"][:F].to(bf)

    def run(x, valid):
        B, T, _ = x.shape
        keep = valid[..., None]
        q, k, v = Fn.linear(x.to(bf), p["w_qkv"], b["b_qkv"]).view(
            B, T, 3, H, D // H).permute(2, 0, 3, 1, 4)
        o = Fn.scaled_dot_product_attention(q, k, v, attn_mask=valid[:, None, None, :])
        a = Fn.linear(o.transpose(1, 2).reshape(B, T, D), p["w_fc"], b["b_fc"])
        x1 = torch.where(keep, Fn.layer_norm(a.float() + x.float(), (D,), p["ln1_w"],
                                             p["ln1_b"]), 0.0)
        h = torch.relu(Fn.conv1d(x1.to(bf).transpose(1, 2), w1, b["b1"],
                                 padding=(K - 1) // 2)).transpose(1, 2)
        y = Fn.linear(h, w2, b["b2"])
        return torch.where(keep, Fn.layer_norm(y.float() + x1, (D,), p["ln2_w"],
                                               p["ln2_b"]), 0.0)
    return run


def phase_kernel():
    import torch
    from metatts_torch.ops.fftblock import (STAGES, fused_fft_block,
                                            fused_fft_block_plain,
                                            fused_fft_block_stage)

    s = BASE_SHAPE
    H = s["H"]
    gen = torch.Generator().manual_seed(0)
    p = _block(s["D"], s["H"], s["F"], s["K"], gen).fused_params()
    composite = composite_block(p, H)
    results = {}
    # the decoder's T (mel_cap) at the batches of 8 and 1, the encoder's
    # text bucket of the batch of 8, and a short call
    for B, T, lens in ((8, 1000, [1000, 777, 0, 1000, 500, 999, 1, 64]),
                       (1, 1000, [777]),
                       (8, 160, [160, 101, 0, 160, 77, 1, 159, 33]),
                       (8, 64, [64, 50, 0, 64, 33, 1, 63, 17])):
        x, valid, err, rel = check_block(p, B, T, H, lens, gen)
        call = lambda: fused_fft_block(p, x, valid, H)
        ms = call_ms(call)
        dev_ms = graph_ms(call, tag="kernel")
        xb = x.to(torch.bfloat16)
        ms_bf16 = call_ms(lambda: fused_fft_block(p, xb, valid, H,
                                                  out_dtype=torch.bfloat16))
        plain_ms = cuda_ms(lambda: fused_fft_block_plain(p, x, valid, H),
                           iters=5, warmup=1)
        comp = composite(x, valid)
        comp_rel = ((comp - fused_fft_block_plain(p, x, valid, H)).abs().max()
                    / comp.abs().max()).item()
        composite_ms = call_ms(lambda: composite(x, valid))
        bound_ms, bound_by, flops, nbytes = block_bound(B, T, **s)
        print(f"[kernel] B={B} T={T}: kernel {ms:.4f} ms a call (fp32 in/out; "
              f"bf16 in/out {ms_bf16:.4f} ms), device {dev_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; library composite {composite_ms:.4f} ms (rel "
              f"{comp_rel:.2e} vs plain); bound {bound_ms:.4f} ms ({bound_by}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
              f"{flops / ms / 1e9:.1f} TFLOP/s a call, "
              f"{flops / dev_ms / 1e9:.1f} on the device")
        results[(B, T)] = dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                               device_ms=dev_ms, ms_bf16=ms_bf16,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, composite_ms=composite_ms)
    # where the time of a call at (8, 1000) goes: each stage's launch alone
    # on the scratch the last call left, device time in a CUDA graph
    x, valid = torch.randn(8, 1000, s["D"], generator=gen).cuda(), \
        torch.ones(8, 1000, dtype=torch.bool, device="cuda")
    fused_fft_block(p, x, valid, H)
    stages = {st: graph_ms(lambda: fused_fft_block_stage(p, x, valid, H, st),
                           tag="kernel") for st in STAGES}
    print("[kernel] stages at B=8 T=1000 (device ms, fp32 in/out): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f}")
    results[(8, 1000)]["stages_ms"] = stages
    # the serving mode: bf16 in, bf16 out, as _run asks
    check_block(p, 8, 1000, H, [1000, 777, 0, 1000, 500, 999, 1, 64], gen,
                bf16=True)
    # widths the gate admits beyond the base model's: three and four heads
    # of 128, D=1024 (LayerNorm through fp32 scratch), d_k=4 with F=1020
    for D, Hw, F in ((384, 3, 1536), (512, 4, 2048), (1024, 8, 4096),
                     (256, 64, 1020)):
        pw = _block(D, Hw, F, s["K"], gen).fused_params()
        check_block(pw, 2, 100, Hw, [100, 37], gen)
    return results


def _engine(device="cuda"):
    import torch
    from metatts_torch import config as C
    from metatts_torch.models.fastspeech2 import FastSpeech2
    from metatts_torch.models.vocoder import Vocoder
    from metatts_torch.serve import SynthesisEngine

    pcfg, mcfg, acfg = C.base_configs()
    stats = {"pitch": [-2.0, 8.0, 0.0, 1.0], "energy": [-1.5, 8.0, 0.0, 1.0]}
    gen = torch.Generator().manual_seed(0)
    model = FastSpeech2(pcfg, mcfg, acfg, stats, n_speakers=8, generator=gen)
    with torch.no_grad():
        # random init predicts log-durations near 0, i.e. ~0 frames; a bias of
        # 2.0 gives round(exp(2 +- ~0.6) - 1) = 5-8 frames per symbol on average
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(2.0)
    vocoder = Vocoder(mcfg, n_mels=80, generator=gen, device=device)
    return SynthesisEngine(model, pcfg, mcfg, acfg, vocoder=vocoder,
                           device=device)


WAV_ATOL = 100    # int16 counts: tests/test_torch_serve.py's bf16-compute serving bound


def phase_tf32():
    """Serving with PyTorch's global flags at their defaults, where cuDNN
    runs fp32 convolutions (the MelGAN vocoder's) in TF32, against the same
    engine on the CPU in fp32: the largest differences of the mels and the
    int16 wavs; then the vocoder alone on the card's mels with TF32 on and
    off against the CPU.  Random weights give quiet wavs, so the vocoder's
    gap is also taken relative to its peak and scaled to full scale, the
    stricter reading, which must stay within serving's WAV_ATOL for
    PyTorch's default to stay.  Runs before main() turns TF32 off."""
    import numpy as np
    import torch
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if flags != (False, True):
        raise AssertionError(f"the TF32 flags are not PyTorch's defaults: {flags}")
    texts, speakers = SENTENCES[:2], [0, 1]
    eng, cpu = _engine("cuda"), _engine("cpu")
    got = eng.synthesize(texts, speakers=speakers, mel_cap=1000)
    ref = cpu.synthesize(texts, speakers=speakers, mel_cap=1000)
    for i, ((w, m), (rw, rm)) in enumerate(zip(got, ref)):
        n, nw = min(len(m), len(rm)), min(len(w), len(rw))
        if not (np.isfinite(m).all() and m.shape[1] == rm.shape[1] == 80 and n > 0):
            raise AssertionError(f"sentence {i}: mels {m.shape} / {rm.shape}, not finite")
        print(f"[tf32] sentence {i}, synthesize on the card (default flags) vs the CPU: "
              f"{len(m)} / {len(rm)} mel frames; max |mel diff| "
              f"{np.abs(m[:n] - rm[:n]).max():.3e}; max |int16 wav diff| "
              f"{np.abs(w[:nw].astype(np.int32) - rw[:nw]).max()} (peak "
              f"{np.abs(rw).max()}); the acoustic model runs in bf16 on both, where "
              f"TF32 does not apply, and a duration that rounds the other way "
              f"shifts the frames after it")

    def wave(engine, mel, tf32):
        """The vocoder's float waveform (full scale 1)."""
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with torch.no_grad():
                net = engine.vocoder.net
                return net(mel.to(next(net.parameters()).device)).cpu().double()
        finally:
            torch.backends.cudnn.allow_tf32 = True

    gap, peak = {True: 0.0, False: 0.0}, 0.0
    for _, m in got:
        mel = torch.from_numpy(m)[None]
        base = wave(cpu, mel, False)
        peak = max(peak, base.abs().max().item())
        for tf32 in (True, False):
            gap[tf32] = max(gap[tf32], (wave(eng, mel, tf32) - base).abs().max().item())
    full = {k: v / peak * 32767 for k, v in gap.items()}
    print(f"[tf32] the vocoder alone on the card's mels vs the CPU in fp32: max |wav diff| "
          f"{gap[True] * 32768:.2f} int16 counts with TF32 (PyTorch's default), "
          f"{gap[False] * 32768:.2f} without, on a peak of {peak * 32768:.1f}; relative to "
          f"the peak and scaled to full scale {full[True]:.1f} / {full[False]:.2f} counts "
          f"(serving's bound {WAV_ATOL})")
    if not full[True] <= WAV_ATOL:
        raise AssertionError("TF32 moves the vocoder's wavs beyond serving's bound: "
                             "the port's entry points must turn it off")


def phase_serve():
    import numpy as np
    import torch
    from metatts_torch.data.collate import collate_batch
    from metatts_torch.models import transformer
    from metatts_torch.ops.fftblock import fused_fft_block, fused_fft_block_plain

    eng = _engine()
    n_layers = 4 + 6
    batches = [SENTENCES[:8], SENTENCES[3:4], SENTENCES[4:8]]
    speakers = [[i % 8 for i in range(len(b))] for b in batches]

    # the main path, counted
    fused_fft_block.launches = 0
    outs = []
    for texts, spk in zip(batches, speakers):
        before = fused_fft_block.launches
        outs.append(eng.synthesize(texts, speakers=spk, mel_cap=1000))
        if fused_fft_block.launches - before != n_layers:
            raise AssertionError(
                f"synthesize launched the fused kernel "
                f"{fused_fft_block.launches - before} times, not {n_layers}")
    launches = fused_fft_block.launches

    audio_s = 0.0
    for texts, out in zip(batches, outs):
        if len(out) != len(texts):
            raise AssertionError("synthesize returned the wrong count")
        for wav, mel in out:
            if wav.dtype != np.int16 or len(wav) != mel.shape[0] * eng.hop:
                raise AssertionError(f"wav {wav.dtype} {len(wav)} vs mel "
                                     f"{mel.shape}")
            if mel.shape[1] != 80 or not np.isfinite(mel).all():
                raise AssertionError(f"mel {mel.shape} not finite / not 80 bins")
            if not 0 < mel.shape[0] <= 1000:
                raise AssertionError(f"mel length {mel.shape[0]}")
            audio_s += len(wav) / eng.sr
    print(f"[serve] 3 request batches (8, 1, 4 sentences): {launches} fused "
          f"kernel launches; mel lengths "
          f"{[[m.shape[0] for _, m in o] for o in outs]}")

    # a teacher-forced forward through the kernel against the same forward
    # through the plain version (same weights, same card)
    rng = np.random.RandomState(0)
    samples = []
    for i, n in enumerate((37, 64, 12)):
        d = rng.randint(1, 9, size=n).astype(np.int32)
        samples.append({"id": str(i), "speaker": i, "raw_text": "",
                        "text": rng.randint(1, 360, size=n).astype(np.int32),
                        "mel": rng.randn(int(d.sum()), 80).astype(np.float32),
                        "pitch": rng.randn(n).astype(np.float32),
                        "energy": rng.randn(n).astype(np.float32),
                        "duration": d})
    batch = collate_batch(samples)[0].to("cuda")
    with torch.no_grad():
        got = eng.model(batch, fused_infer=True).postnet_mel
        transformer.fused_fft_block = fused_fft_block_plain
        try:
            ref = eng.model(batch, fused_infer=True).postnet_mel
        finally:
            transformer.fused_fft_block = fused_fft_block
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"[serve] teacher-forced postnet mel, kernel vs plain: rel {rel:.3e}")
    if not (rel < 2e-2 and torch.isfinite(got).all()):
        raise AssertionError("the forward through the kernel disagrees with "
                             "the forward through the plain version")

    for texts, spk in zip(batches, speakers):
        eng.synthesize(texts, speakers=spk, mel_cap=1000)        # warm-up
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            out = eng.synthesize(texts, speakers=spk, mel_cap=1000)
        ms = 1e3 * (time.perf_counter() - t0) / reps
        sec = sum(len(w) for w, _ in out) / eng.sr
        print(f"[serve] batch of {len(texts)}: {ms:.2f} ms per synthesize, "
              f"{sec:.2f} s of audio, real-time factor {ms / 1e3 / sec:.5f}")
    breakdown(eng, batches[0], speakers[0])
    return launches


def breakdown(eng, texts, speakers, reps=3):
    """Where one synthesize's time goes: acoustic model (and the fused
    blocks inside it, by CUDA events) against the vocoder (with the copy of
    the wavs to the host)."""
    import numpy as np
    import torch
    from metatts_torch.data.collate import collate_batch
    from metatts_torch.models import transformer
    from metatts_torch.ops.fftblock import fused_fft_block
    from metatts_torch.text import text_to_sequence

    events = []

    def timed(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fused_fft_block(*a, **k)
        end.record()
        events.append((start, end))
        return out

    cleaners = eng.pcfg["preprocessing"]["text"]["text_cleaners"]
    samples = [{"id": str(i), "speaker": s, "raw_text": t,
                "text": np.asarray(text_to_sequence(t, cleaners), np.int32)}
               for i, (t, s) in enumerate(zip(texts, speakers))]
    batch = collate_batch(samples, with_mels=False)[0]
    model_s = voc_s = 0.0
    transformer.fused_fft_block = timed
    try:
        with torch.no_grad():
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = eng.model(batch.to("cuda"), teacher_forced=False,
                                max_mel_len=1000, fused_infer=True)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eng.vocoder.infer(out.postnet_mel,
                                  lengths=out.mel_lens.cpu().numpy() * eng.hop)
                t2 = time.perf_counter()
                model_s += t1 - t0
                voc_s += t2 - t1
    finally:
        transformer.fused_fft_block = fused_fft_block
    block_ms = sum(s.elapsed_time(e) for s, e in events) / reps
    print(f"[serve] breakdown, batch of {len(texts)} (text bucket "
          f"{batch.texts.shape[1]}): acoustic model {1e3 * model_s / reps:.2f} ms "
          f"(of which {len(events) // reps} fused blocks {block_ms:.2f} ms), "
          f"vocoder + copy to host {1e3 * voc_s / reps:.2f} ms")


# ---------------------------------------------------------------- flash

FLASH_SHAPES = ((10, 896, 128, "bfloat16"), (10, 128, 128, "bfloat16"),
                (4, 77, 128, "float32"),
                # the baseline step's width: B=80 utterances x 2 heads
                (160, 896, 128, "bfloat16"), (160, 128, 128, "bfloat16"),
                # the fp32 path on the EER experiment's query forward: 5
                # queries x 2 heads of d_k 16, 48 mel frames and 16 symbols
                (10, 48, 16, "float32"), (10, 16, 16, "float32"))
# held against the plain versions but not timed: the serving cap (no
# multiple of the 64-row tiles), a short ragged T, and a head width that is
# a multiple of 8 and not of 16 (TMA zero-fills the tiles' columns past D)
FLASH_CHECKS = ((10, 1000, 128, "bfloat16"), (4, 77, 128, "bfloat16"),
                (4, 77, 72, "bfloat16"))


def flash_bound(BH, T, D, dtype, backward):
    """(bound_ms, bound_by, flops, bytes) of one flash call: each input read
    once, each output written once.  Forward: q k^T and P v; backward:
    q k^T, dv, dp, dq, dk (the recomputed P included)."""
    e = 2 if dtype == "bfloat16" else 4
    flops = (10 if backward else 4) * BH * T * T * D
    if backward:   # q, k, v, mask, out, lse, dout in; dq, dk, dv out
        nbytes = 3 * BH * T * D * e + BH * T * 4 + BH * T * D * 4 + BH * T * 4 \
            + BH * T * D * 4 + 3 * BH * T * D * e
    else:          # q, k, v, mask in; out, lse out
        nbytes = 3 * BH * T * D * e + BH * T * 4 + BH * T * D * 4 + BH * T * 4
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def _flash_inputs(BH, T, D, dtype, gen):
    import torch
    q, k, v = (torch.randn(BH, T, D, generator=gen) * s for s in (0.5, 0.5, 1.0))
    lens = torch.randint(1, T + 1, (BH,), generator=gen)
    lens[0], lens[1], lens[2] = T, max(1, T // 3), 0   # full, padded, empty
    mask = (torch.arange(T)[None, :] < lens[:, None]).float()
    do = torch.randn(BH, T, D, generator=gen)
    dt = getattr(torch, dtype)
    return ([x.to(dt).cuda() for x in (q, k, v)], mask.cuda(), do.cuda())


def check_flash(BH, T, D, dtype, gen):
    """Both kernels against their plain versions on one input; raises on
    disagreement.  Tolerances of tests/test_pallas_attention.py and, in
    bf16, the tighter FLASH_BF16_* limits.  In bf16 the kernels must also
    repeat their outputs bit for bit (they use no atomics)."""
    import torch
    from metatts_torch.ops import attention as A
    (q, k, v), mask, do = _flash_inputs(BH, T, D, dtype, gen)
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, mask)
    grads = A.flash_attention_bwd(q, k, v, mask, ref, ref_lse, do)
    ref_grads = A.flash_attention_bwd_plain(q, k, v, mask, ref, ref_lse, do)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    g_err = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref_grads)]
    g_rel = [e / (b.float().abs().max().item() + 1e-9) for e, b in zip(g_err, ref_grads)]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, lse, *grads))
    same = True
    if dtype == "bfloat16":
        out2, lse2 = A.flash_attention_fwd(q, k, v, mask)
        grads2 = A.flash_attention_bwd(q, k, v, mask, ref, ref_lse, do)
        same = (torch.equal(out, out2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
    if dtype == "float32":
        ok = (bool(torch.allclose(out, ref, atol=2e-5, rtol=1e-4))
              and bool(torch.allclose(lse, ref_lse, atol=2e-5, rtol=1e-4))
              and all(bool(torch.allclose(a, b, atol=5e-4, rtol=1e-3))
                      for a, b in zip(grads, ref_grads)))
        tol = "out atol 2e-5 rtol 1e-4, grads atol 5e-4 rtol 1e-3"
    else:
        ok = (err < 3e-2 and lse_err < 3e-2 and max(g_rel) < 0.05
              and err < FLASH_BF16_OUT and lse_err < FLASH_BF16_LSE
              and max(g_rel) < FLASH_BF16_GRAD_REL)
        tol = (f"out max abs < 3e-2, grads rel < 0.05; tighter: out < {FLASH_BF16_OUT:g}, "
               f"lse < {FLASH_BF16_LSE:g}, grads rel < {FLASH_BF16_GRAD_REL:g}")
    print(f"[flash] BH={BH} T={T} D={D} {dtype}: out max_abs_err {err:.3e} lse "
          f"{lse_err:.3e}; dq/dk/dv max_abs_err "
          f"{', '.join(f'{e:.3e}' for e in g_err)} rel "
          f"{', '.join(f'{r:.3e}' for r in g_rel)}; finite {finite}"
          f"{'; repeated calls bit-identical ' + str(same) if dtype == 'bfloat16' else ''}"
          f" ({tol})")
    if not (ok and finite and same):
        raise AssertionError(f"flash attention disagrees with its plain version "
                             f"at BH={BH} T={T} D={D} {dtype}")
    return (q, k, v), mask, do, ref, ref_lse, err, max(g_err)


def phase_flash():
    import torch
    import torch.nn.functional as F
    from metatts_torch.ops import attention as A

    gen = torch.Generator().manual_seed(1)
    results = {}
    for BH, T, D, dtype in FLASH_SHAPES:
        (q, k, v), mask, do, o, lse, f_err, b_err = check_flash(BH, T, D, dtype, gen)
        fwd = lambda: A.flash_attention_fwd(q, k, v, mask)
        bwd = lambda: A.flash_attention_bwd(q, k, v, mask, o, lse, do)
        fwd_ms, bwd_ms = call_ms(fwd), call_ms(bwd)
        fwd_dev, bwd_dev = graph_ms(fwd, tag="flash"), graph_ms(bwd, tag="flash")
        if fwd_dev is None or bwd_dev is None:
            raise AssertionError(f"no device time for the flash kernels at BH={BH} "
                                 f"T={T} D={D} {dtype}")
        fwd_plain = cuda_ms(lambda: A.flash_attention_fwd_plain(q, k, v, mask),
                            iters=5, warmup=1)
        bwd_plain = cuda_ms(lambda: A.flash_attention_bwd_plain(q, k, v, mask, o, lse, do),
                            iters=5, warmup=1)
        # yardstick, never on the port's path: the same masked attention in
        # one PyTorch call, forward, and its backward alone
        bias = ((mask - 1.0) * 1e9)[:, None, :].to(q.dtype)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        sout = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias)
        dos = do.to(q.dtype)
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(sout, (qs, ks, vs), dos,
                                                       retain_graph=True))
        fb = flash_bound(BH, T, D, dtype, False)
        bb = flash_bound(BH, T, D, dtype, True)
        print(f"[flash] BH={BH} T={T} D={D} {dtype}: forward kernel {fwd_ms:.4f} ms a "
              f"call, device {fwd_dev:.4f} ms; plain {fwd_plain:.4f} ms, bound {fb[0]:.4f} ms "
              f"({fb[1]}; {fb[2] / 1e9:.2f} GFLOP, {fb[3] / 1e6:.2f} MB), sdpa "
              f"{sdpa_fwd:.4f} ms; {fb[2] / fwd_ms / 1e9:.1f} TFLOP/s a call, "
              f"{fb[2] / fwd_dev / 1e9:.1f} on the device")
        print(f"[flash] BH={BH} T={T} D={D} {dtype}: backward kernel {bwd_ms:.4f} ms a "
              f"call, device {bwd_dev:.4f} ms; plain {bwd_plain:.4f} ms, bound {bb[0]:.4f} ms "
              f"({bb[1]}; {bb[2] / 1e9:.2f} GFLOP, {bb[3] / 1e6:.2f} MB), sdpa backward "
              f"{sdpa_bwd:.4f} ms; {bb[2] / bwd_ms / 1e9:.1f} TFLOP/s a call, "
              f"{bb[2] / bwd_dev / 1e9:.1f} on the device")
        results[(BH, T, D, dtype)] = dict(
            fwd=dict(max_abs_err=f_err, ms=fwd_ms, device_ms=fwd_dev, plain_ms=fwd_plain,
                     bound_ms=fb[0], bound_by=fb[1], library_ms=sdpa_fwd),
            bwd=dict(max_abs_err=b_err, ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain,
                     bound_ms=bb[0], bound_by=bb[1], library_ms=sdpa_bwd))
    for BH, T, D, dtype in FLASH_CHECKS:
        check_flash(BH, T, D, dtype, gen)
    # a width the kernels do not take raises instead of running another version
    x = torch.zeros(2, 32, 136, device="cuda")
    try:
        A.flash_attention_fwd(x, x, x, torch.ones(2, 32, device="cuda"))
    except ValueError as e:
        print(f"[flash] D=136 refused: {e}")
    else:
        raise AssertionError("flash_attention_fwd ran a D=136 input")
    return results


# ---------------------------------------------------------------- mel

MEL = dict(n_fft=1024, hop=256, win_length=1024, sr=22050, n_mels=80)
MEL_SHAPES = ((16, 220500), (1, 220500))      # 16 and 1 utterances of 10 s
MEL_ATOL = 1e-4                               # tests/test_pallas_melspec.py
EN_TOL = 1e-4
# other parameters the kernel takes (every n_fft it has a path for, a hop
# that is no multiple of 32, a centred window, 128 bands), at small sizes
MEL_OTHER = (dict(n_fft=256, hop=64, win_length=256, n_mels=40),
             dict(n_fft=512, hop=128, win_length=400, n_mels=80),
             dict(n_fft=1024, hop=200, win_length=800, n_mels=128),
             dict(n_fft=2048, hop=300, win_length=2048, n_mels=80))


def mel_bound(B, T, n_fft=1024, hop=256, win_length=1024, sr=22050, n_mels=80):
    """(bound_ms, bound_by, flops, bytes) of one log-mel call, from the least
    work the function needs: per frame the window, a real FFT of n_fft points
    (2.5 n_fft log2 n_fft FLOP), power, magnitude and energy of the cutoff
    bins, the filterbank's nonzero weights and the log clamp, against the
    fp32 peak outside the tensor cores; audio in, window and nonzero weights
    once, log-mel and energy out."""
    from metatts_torch.ops.stft import mel_filterbank
    nnz = int((mel_filterbank(sr, n_fft, n_mels) != 0).sum())
    frames = B * (T // hop + 1)
    cutoff = n_fft // 2 + 1
    per_frame = (win_length + 2.5 * n_fft * math.log2(n_fft) + 5 * cutoff + 1
                 + 2 * nnz + 2 * n_mels)
    flops = frames * per_frame
    nbytes = 4 * (B * T + win_length + nnz + frames * (n_mels + 1))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def graph_ms(fn, iters=20, tag="mel"):
    """Device time of one call without the host's enqueue: ``iters`` calls
    captured in one CUDA graph, replayed after a warm-up replay.  None where
    the call cannot be captured."""
    import torch
    try:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"[{tag}] CUDA graph capture failed ({str(e)[:120]}): device time "
              "not measured")
        return None
    return cuda_ms(g.replay, iters=10, warmup=1) / iters


def library_mel(y, cfg):
    """The yardstick, never on the port's path: the same function through
    cuFFT (``torch.stft``), abs, the mel product, log clamp and norm."""
    import torch
    from metatts_torch.ops.melspec import _constants
    c = _constants(cfg["n_fft"], cfg["win_length"], cfg["sr"], cfg["n_mels"], 0.0, None,
                   y.device)
    window = torch.hann_window(cfg["win_length"], periodic=True, device=y.device)

    def run():
        spec = torch.stft(y, cfg["n_fft"], hop_length=cfg["hop"],
                          win_length=cfg["win_length"], window=window, center=True,
                          pad_mode="reflect", return_complex=True)
        mag = spec.abs()                                        # (B, cutoff, F)
        mel = torch.log(torch.clamp(c["mel"].T @ mag, min=1e-5))
        return mel, torch.linalg.vector_norm(mag, dim=1)
    return run


def check_mel(y, name, cfg=MEL):
    """Kernel against plain version on one input; raises on disagreement.
    Prints where the worst log-mel error sits (utterance, band, frame) and
    the plain version's log-mel there.  Returns (max abs err of log-mel, of
    energy, the kernel's log-mel)."""
    import numpy as np
    import torch
    from metatts_torch.ops.melspec import (fused_mel_spectrogram,
                                           fused_mel_spectrogram_plain)
    mel, en = fused_mel_spectrogram(y, **cfg)
    ref, ref_en = fused_mel_spectrogram_plain(y, **cfg)
    torch.cuda.synchronize()
    ok = (mel.shape == ref.shape and en.shape == ref_en.shape
          and bool(torch.isfinite(mel).all() and torch.isfinite(en).all()))
    gap = (mel - ref).abs() if ok else torch.full((1, 1, 1), math.inf)
    err = gap.max().item()
    en_err = (en - ref_en).abs().max().item() if ok else math.inf
    b, m, f = (int(i) for i in np.unravel_index(int(gap.argmax()), tuple(gap.shape)))
    where = f"utterance {b}, band {m}, frame {f}, plain log-mel {ref[b, m, f].item():.4f}" \
        if ok else "shapes differ or not finite"
    ok = (ok and err <= MEL_ATOL
          and bool(torch.allclose(en, ref_en, rtol=EN_TOL, atol=EN_TOL)))
    print(f"[mel] {name} B={y.shape[0]} T={y.shape[1]}: log-mel max_abs_err {err:.3e} "
          f"(atol {MEL_ATOL:g}) at {where}; energy max_abs_err {en_err:.3e} (rtol and "
          f"atol {EN_TOL:g}), shape {tuple(mel.shape)}")
    if not ok:
        raise AssertionError(f"fused_mel_spectrogram disagrees with its plain version "
                             f"on {name} B={y.shape[0]} T={y.shape[1]}")
    return err, en_err, mel


def quiet_tone(T, sr, freqs):
    """One utterance per frequency: a -60 dBFS tone (peak 1e-3) over one half
    of T samples and exact silence over the other, bins near the clamp."""
    import numpy as np
    t = np.arange(T) / sr
    y = np.zeros((len(freqs), T), np.float32)
    for i, f in enumerate(freqs):
        half = slice(0, T // 2) if i % 2 else slice(T // 2, T)
        y[i, half] = 1e-3 * np.sin(2 * np.pi * f * t[half])
    return y


def phase_mel():
    import numpy as np
    import torch
    from metatts_torch.ops.melspec import (fused_mel_spectrogram,
                                           fused_mel_spectrogram_plain)

    rng = np.random.RandomState(3)
    results = {}
    for B, T in MEL_SHAPES:
        y = torch.from_numpy(rng.uniform(-0.8, 0.8, (B, T)).astype(np.float32)).cuda()
        err, en_err, _ = check_mel(y, "noise")
        call = lambda: fused_mel_spectrogram(y, **MEL)
        ms = cuda_ms(call)
        dev_ms = graph_ms(call)
        plain_ms = cuda_ms(lambda: fused_mel_spectrogram_plain(y, **MEL), iters=5, warmup=1)
        lib = library_mel(y, MEL)
        lib_mel, lib_en = lib()
        ref, ref_en = fused_mel_spectrogram_plain(y, **MEL)
        lib_err = (lib_mel - ref).abs().max().item()
        library_ms = cuda_ms(lib)
        bound_ms, bound_by, flops, nbytes = mel_bound(B, T, **MEL)
        dev = "not measured" if dev_ms is None else (
            f"{dev_ms:.4f} ms ({100 * bound_ms / dev_ms:.1f}% of the bound)")
        print(f"[mel] B={B} T={T}: kernel {ms:.4f} ms a call ({100 * bound_ms / ms:.1f}% of "
              f"the bound; CUDA events over back-to-back calls, the host's enqueue "
              f"included), device time in a CUDA graph {dev}; plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB), torch.stft route {library_ms:.4f} ms (its log-mel "
              f"vs plain max_abs_err {lib_err:.3e}); kernel / torch.stft route "
              f"{ms / library_ms:.3f}")
        if not ms < library_ms:
            raise AssertionError(f"the log-mel kernel ({ms:.4f} ms) is not faster than "
                                 f"the torch.stft route ({library_ms:.4f} ms) at B={B}")
        results[(B, T)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                               device_ms=dev_ms)
    # silence maps to log(1e-5) everywhere (tests/test_pallas_melspec.py:20-25)
    _, _, mel = check_mel(torch.zeros(3, 1000, device="cuda"), "silence")
    sil = (mel - math.log(1e-5)).abs().max().item()
    print(f"[mel] silence: max |log-mel - log(1e-5)| {sil:.3e}")
    if sil > 1e-5:
        raise AssertionError("silence does not map to log(1e-5)")
    # bins near the clamp: -60 dBFS tones and silence, 10 s each
    check_mel(torch.from_numpy(quiet_tone(220500, MEL["sr"], (440.0, 3100.0))).cuda(),
              "quiet")
    # a length that is no multiple of hop
    check_mel(torch.from_numpy(rng.uniform(-0.8, 0.8, (1, 220501)).astype(np.float32)).cuda(),
              "noise")
    # 300 samples: the 512-sample pad reflects more than once
    check_mel(torch.from_numpy(rng.uniform(-0.8, 0.8, (2, 300)).astype(np.float32)).cuda(),
              "short")
    for cfg in MEL_OTHER:
        cfg = dict(MEL, **cfg)
        check_mel(torch.from_numpy(rng.uniform(-0.8, 0.8, (2, 22050)).astype(np.float32)).cuda(),
                  "n_fft {n_fft} hop {hop} win {win_length} mels {n_mels}".format(**cfg), cfg)
    return results


# ---------------------------------------------------------------- adam

# the benchmark's base configuration (perfbench/configs/metatts-libritts-base.json):
# 216 leaves, 34.94 M fp32 parameters
ADAM_SPEAKERS = 1151
# (global norm of the step's gradients, the leaf left without a gradient):
# clipped, not clipped, clipped with a None gradient
ADAM_STEPS = ((4.0, None), (0.5, None), (2.0, "encoder.src_word_emb.weight"))
ADAM_LR = 1e-3          # a constant rate, so that every step moves the weights
ADAM_NORM_TOL = 1e-6    # the norm's sum in another order than PyTorch's


def adam_bound(n):
    """(the function's least ms, its bytes; the kernel's own bytes) of a step
    over ``n`` fp32 parameters: g, p, mu and nu read and p, mu and nu written
    once (the kernel reads g a second time for the norm)."""
    nbytes = 7 * 4 * n
    return 1e3 * nbytes / PEAK_BYTES, nbytes, 8 * 4 * n


ADAM_BASE_LAUNCHES = 4  # an optimizer step over 216 leaves: a norm, its sum, 2 updates


def _adam_zero():
    from metatts_torch.ops import adam
    adam.fused_adam.launches = 0


def _adam_check(system, steps, where, per_step=None):
    """Raise unless ``system``'s optimizer ran ``steps`` steps on its kernel
    (``ops/adam.py``) since ``_adam_zero``: its table's launches (at most 8;
    ``per_step`` where given) each.  Returns the launches counted."""
    from metatts_torch.ops import adam
    table = system.optimizer._table
    each = None if table is None else table.launches
    got = adam.fused_adam.launches
    if each is None or each > 8 or (per_step is not None and each != per_step) \
            or got != steps * each:
        raise AssertionError(f"{where}: NoamAdam launched {got} kernels over {steps} "
                             f"optimizer steps, not {steps} x {per_step or each}")
    return got


def phase_adam():
    """NoamAdam's kernel (``ops/adam.py``) at the base configuration's leaves
    against the per-leaf loop fed the kernel's norm, bit for bit; its
    repeats; its time against its byte bound.  Returns the kernels entry."""
    import copy
    import torch
    from metatts_torch import config as C
    from metatts_torch.algorithms import get_system
    from metatts_torch.ops import adam
    from metatts_torch.train.optim import NoamAdam

    pcfg, mcfg, acfg = C.base_configs()
    system = get_system("baseline")(pcfg, copy.deepcopy(mcfg), C.TRAIN_DEFAULTS,
                                    dict(copy.deepcopy(acfg), type="baseline"),
                                    n_speakers=ADAM_SPEAKERS, seed=0, device="cuda")
    start = {n: p.detach().clone() for n, p in system.params.items()}
    del system
    n_el = sum(p.numel() for p in start.values())
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = []
    for norm, drop in ADAM_STEPS:
        g = {n: torch.randn(p.shape, generator=gen, device="cuda") for n, p in start.items()}
        scale = norm / torch.sqrt(sum((x * x).sum() for x in g.values()))
        steps.append({n: None if n == drop else x * scale for n, x in g.items()})
    schedule = lambda step: torch.tensor(ADAM_LR, dtype=torch.float32)

    def optimizer(weight_decay):
        tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
        tcfg["optimizer"]["weight_decay"] = weight_decay
        params = {n: t.clone() for n, t in start.items()}
        return params, NoamAdam(params, mcfg, tcfg, schedule=schedule)

    def state(params, opt):
        return [dict(params), dict(opt.mu), dict(opt.nu)]

    for wd in (C.TRAIN_DEFAULTS["optimizer"]["weight_decay"], 0.01):
        runs = []
        for run in range(2):
            params, opt = optimizer(wd)
            ref_params, ref = optimizer(wd)
            for k, grads in enumerate(steps):
                before = adam.fused_adam.launches
                opt.step(params, grads)
                launches = adam.fused_adam.launches - before
                g_norm = opt._table.scratch[0].clone()
                dense = ref._dense(grads)
                loop_norm = torch.sqrt(sum((g * g).sum() for g in dense.values()))
                clip = not bool(g_norm < ref.clip)
                ref.count += 1
                ref._update(ref_params, dense, g_norm, clip, *ref._scalars(ref.count))
                torch.cuda.synchronize()
                gap = abs(g_norm.item() - loop_norm.item()) / loop_norm.item()
                differ = [sum(int((a[n] != b[n]).sum()) for n in a)
                          for a, b in zip(state(params, opt), state(ref_params, ref))]
                moved = sum(int((params[n] != start[n]).sum()) for n in start)
                if run == 0:
                    print(f"[adam] weight_decay {wd}, step {k + 1}: g_norm {g_norm.item():.7g} "
                          f"(loop {loop_norm.item():.7g}, rel {gap:.2e}), clipped {clip}, "
                          f"{launches} launches for {len(start)} leaves; elements that differ "
                          f"from the loop fed the kernel's norm: p {differ[0]}, mu "
                          f"{differ[1]}, nu {differ[2]} of {n_el}; {moved} weights moved")
                if (any(differ) or gap > ADAM_NORM_TOL or launches != opt._table.launches
                        or launches > 8 or clip != (ADAM_STEPS[k][0] >= ref.clip)
                        or moved < n_el // 2):
                    raise AssertionError(f"NoamAdam's kernel disagrees with the per-leaf loop "
                                         f"at weight_decay {wd}, step {k + 1}")
            runs.append(state(params, opt))
        same = all(torch.equal(a[n], b[n]) for a, b in zip(*runs) for n in a)
        print(f"[adam] weight_decay {wd}: two runs from one start bit for bit: {same}")
        if not same:
            raise AssertionError("NoamAdam's kernel does not repeat itself")

    # times at the base configuration's leaves and the first step's gradients
    params, opt = optimizer(0.0)
    grads = steps[0]
    opt.step(params, grads)
    table = opt._table
    c1, c2, lr = opt._scalars(opt.count + 1)
    kw = dict(clip=opt.clip, b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=0.0, lr=lr,
              c1=c1, c2=c2)
    call = lambda: adam.fused_adam(table, grads, **kw)
    ms = call_ms(call)
    dev_ms = graph_ms(call, tag="adam")
    host = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step(params, grads)
        host.append(1e3 * (time.perf_counter() - t0))
    host_ms = sorted(host)[len(host) // 2]

    def loop():
        dense = opt._dense(grads)
        g_norm = torch.sqrt(sum((g * g).sum() for g in dense.values()))
        opt._update(params, dense, g_norm, not bool(g_norm < opt.clip), c1, c2, lr)
    plain_ms = cuda_ms(loop, iters=5, warmup=1)
    bound, nbytes, kbytes = adam_bound(n_el)
    print(f"[adam] {len(start)} leaves, {n_el} parameters: a step's host time "
          f"(enqueue, median of 50) {host_ms:.4f} ms; a call {ms:.4f} ms, device "
          f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms (CUDA graph of 20); the "
          f"per-leaf loop {plain_ms:.4f} ms a call; bound {bound:.4f} ms (bytes, "
          f"{nbytes / 1e9:.3f} GB; the kernel moves {kbytes / 1e9:.3f} GB)"
          + (f": {100 * bound / dev_ms:.1f}% of it" if dev_ms else ""))
    if dev_ms is None or dev_ms > 2 * bound:
        raise AssertionError(f"NoamAdam's kernel: device time {dev_ms} ms, over twice its "
                             f"bound {bound:.4f} ms")
    return {"name": "fused_adam", "route": "cuda", "source": "metatts_torch/csrc/adam.cu",
            "replaces": None, "ms": ms, "device_ms": dev_ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None,
            "shape": f"{len(start)} leaves, {n_el} fp32 parameters (the base configuration)"}


# ---------------------------------------------------------------- preprocess

PP_SPEAKERS, PP_UTTERANCES = 4, 8
# LibriTTS train-clean-100's mean utterance length: 53.78 h over 33,236
# utterances (Zen et al., "LibriTTS", Interspeech 2019, Table 1).  Only the
# mean is published; the spread around it (uniform over 1.0-10.65 s, then
# scaled so the corpus meets the mean exactly) is this script's own choice.
PP_MEAN_S = 53.78 * 3600 / 33236
PP_SPREAD_S = (1.0, 10.65)
PP_PHONES = ["AH0", "B", "IY1", "K", "S", "T", "AE1", "N", "D", "OW1", "L", "M"]


def _textgrid(path, intervals):
    """A long-form MFA-style TextGrid with one ``phones`` tier."""
    xmax = intervals[-1][1]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0.0", f"xmax = {xmax}", "tiers? <exists>", "size = 1",
             "item []:", "\titem [1]:", '\t\tclass = "IntervalTier"',
             '\t\tname = "phones"', "\t\txmin = 0.0", f"\t\txmax = {xmax}",
             f"\t\tintervals: size = {len(intervals)}"]
    for i, (s, e, p) in enumerate(intervals):
        lines += [f"\t\tintervals [{i + 1}]:", f"\t\t\txmin = {s}",
                  f"\t\t\txmax = {e}", f'\t\t\ttext = "{p}"']
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _utterance(rng, n, sr, f0):
    """One synthetic utterance of ``n`` samples at ``sr``: a harmonic tone
    at ``f0`` with vibrato, loud and quiet phones and a little noise,
    silences at both ends -> (float32 wav, ``phones`` intervals in s)."""
    import numpy as np
    t = np.arange(n) / sr
    f = f0 * (1 + 0.06 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t))
    ph = 2 * np.pi * np.cumsum(f) / sr
    wav = 0.3 * np.sin(ph) + 0.12 * np.sin(2 * ph) + 0.05 * np.sin(3 * ph)
    wav *= 0.25 + 0.75 * np.abs(np.sin(np.pi * rng.uniform(0.7, 2.0) * t))
    wav += 0.005 * rng.randn(n)
    lead, tail = 0.15, 0.2
    wav[: int(lead * sr)] = 0.002 * rng.randn(int(lead * sr))
    wav[n - int(tail * sr):] = 0.002 * rng.randn(int(tail * sr))
    intervals, start = [(0.0, lead, "sil")], lead
    while start < n / sr - tail - 0.05:
        end = min(start + rng.uniform(0.06, 0.16), n / sr - tail)
        intervals.append((start, end, PP_PHONES[rng.randint(len(PP_PHONES))]
                          if rng.rand() > 0.08 else "sp"))
        start = end
    intervals[-1] = intervals[-1][:2] + (PP_PHONES[0],)
    intervals.append((start, n / sr, "sil"))
    return wav.astype(np.float32), intervals


def make_corpus(root, sr, seed=0):
    """A synthetic corpus from a seed: speakers x utterances at 22.05 kHz
    whose mean length is LibriTTS train-clean-100's (``PP_MEAN_S``), each a
    harmonic tone with the speaker's f0 (``_utterance``) with a ``phones``
    TextGrid.  Returns (raw dir, seconds of audio)."""
    import numpy as np
    from metatts_torch.preprocess.audio_io import save_wav
    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw")
    lengths = rng.uniform(*PP_SPREAD_S, PP_SPEAKERS * PP_UTTERANCES)
    lengths *= PP_MEAN_S / lengths.mean()
    seconds = 0.0
    for s in range(PP_SPEAKERS):
        spk, f0 = f"spk{s}", 95.0 + 45.0 * s
        for u in range(PP_UTTERANCES):
            base = f"{spk}_{u:03d}"
            n = int(lengths[s * PP_UTTERANCES + u] * sr)
            wav, intervals = _utterance(rng, n, sr, f0)
            d = os.path.join(raw, "train", spk)
            os.makedirs(d, exist_ok=True)
            save_wav(os.path.join(d, base + ".wav"), wav, sr)
            with open(os.path.join(d, base + ".lab"), "w") as fh:
                fh.write("a synthetic sentence")
            _textgrid(os.path.join(root, "TextGrid", spk, base + ".TextGrid"), intervals)
            seconds += n / sr
    return raw, seconds


def phase_preprocess():
    import shutil
    import tempfile
    import numpy as np
    import torch
    from metatts_torch import config as C
    from metatts_torch.data.collate import collate_batch
    from metatts_torch.data.dataset import TTSDataset
    from metatts_torch.models.fastspeech2 import FastSpeech2
    from metatts_torch.models.loss import fastspeech2_loss
    from metatts_torch.ops import melspec
    from metatts_torch.preprocess.pitch import f0_backend
    from metatts_torch.preprocess.preprocessor import Preprocessor

    pcfg, mcfg, acfg = C.base_configs()
    sr = pcfg["preprocessing"]["audio"]["sampling_rate"]
    root = tempfile.mkdtemp(prefix="pp_smoke_")
    try:
        t0 = time.perf_counter()
        raw, audio_s = make_corpus(root, sr)
        out = os.path.join(root, "card")
        shutil.copytree(os.path.join(root, "TextGrid"), os.path.join(out, "TextGrid"))
        cfg = C.deep_merge(pcfg, {"path": {"raw_path": raw, "preprocessed_path": out},
                                  "subsets": {"train": "train", "val": "train",
                                              "test": "train"}})
        print(f"[preprocess] corpus: {PP_SPEAKERS} speakers x {PP_UTTERANCES} utterances, "
              f"{audio_s:.1f} s of audio at {sr} Hz, written in "
              f"{time.perf_counter() - t0:.2f} s")
        if f0_backend() != "native-dio":
            raise AssertionError(f"F0 backend {f0_backend()}, not native-dio")

        # the main path, counted; CUDA events around each mel call
        pre = Preprocessor(cfg, device="cuda")
        mel_call, events = pre.stft.mel_spectrogram, []

        def timed(y):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = mel_call(y)
            end.record()
            events.append((start, end))
            return res

        pre.stft.mel_spectrogram = timed
        melspec.fused_mel_spectrogram.launches = 0
        t0 = time.perf_counter()
        outs = pre.build_from_path()
        wall = time.perf_counter() - t0
        launches = melspec.fused_mel_spectrogram.launches
        lines = outs["train"]
        if launches != len(lines) or not lines:
            raise AssertionError(f"{launches} mel kernel launches for {len(lines)} "
                                 f"utterances written")
        card_ms = sum(s.elapsed_time(e) for s, e in events)

        n_ref = 0
        for line in lines:
            base, spk, text, _ = line.split("|")
            load = lambda sub, kind: np.load(os.path.join(out, sub, f"{spk}-{kind}-{base}.npy"))
            dur, mel = load("duration", "duration"), load("mel", "mel")
            pitch, energy = load("pitch", "pitch"), load("energy", "energy")
            ref = load("spk_ref_mel_slices", "mel")
            n_ph = len(text.strip("{}").split())
            if not (mel.shape == (int(dur.sum()), 80) and dur.shape == (n_ph,)
                    and pitch.shape == energy.shape == (n_ph,)
                    and ref.ndim == 3 and ref.shape[0] >= 1 and ref.shape[1:] == (160, 40)
                    and all(np.isfinite(a).all() for a in (mel, pitch, energy, ref))):
                raise AssertionError(f"{base}: mel {mel.shape}, duration {dur.shape} "
                                     f"(sum {dur.sum()}), pitch {pitch.shape}, energy "
                                     f"{energy.shape}, ref slices {ref.shape}")
            n_ref += ref.shape[0]
        with open(os.path.join(out, "stats.json")) as f:
            stats = json.load(f)
        with open(os.path.join(out, "speakers.json")) as f:
            speakers = json.load(f)
        if not (len(stats["pitch"]) == len(stats["energy"]) == 4
                and all(math.isfinite(v) for v in stats["pitch"] + stats["energy"])
                and sorted(speakers.values()) == list(range(PP_SPEAKERS))):
            raise AssertionError(f"stats {stats}, speakers {speakers}")
        sec = pre.seconds
        n = len(lines)
        print(f"[preprocess] Preprocessor(device='cuda').build_from_path: {n} utterances "
              f"in {wall:.2f} s, {n / wall:.2f} utterances/s, {audio_s / wall:.1f} s of "
              f"audio per wall second; {launches} mel kernel launches; {n_ref} reference "
              f"slices; stats pitch {stats['pitch']}, energy {stats['energy']}")
        print(f"[preprocess] per utterance: load {1e3 * sec['load'] / n:.2f} ms, F0 on the "
              f"host {1e3 * sec['f0'] / n:.2f} ms, mel {1e3 * sec['mel'] / n:.2f} ms "
              f"(the mel call on the card's clock {card_ms / n:.3f} ms, CUDA events "
              f"around it, the host's enqueue included), reference slices "
              f"{1e3 * sec['ref'] / n:.2f} ms, file writes {1e3 * sec['save'] / n:.2f} ms")

        # three utterances again: on the card and on the CPU (conv-DFT path),
        # unnormalised artifacts side by side
        picks = [lines[0], lines[len(lines) // 2], lines[-1]]
        gaps = {"mel": 0.0, "energy": 0.0, "pitch": 0.0}
        worst = "none"
        for dev in ("cuda", "cpu"):
            d = os.path.join(root, "again", dev)
            shutil.copytree(os.path.join(root, "TextGrid"), os.path.join(d, "TextGrid"))
            again = Preprocessor(C.deep_merge(cfg, {"path": {"preprocessed_path": d}}),
                                 device=dev)
            for sub in ("mel", "pitch", "energy", "duration", "spk_ref_mel_slices"):
                os.makedirs(os.path.join(d, sub))
            for line in picks:
                base, spk = line.split("|")[:2]
                again.process_utterance(os.path.join(raw, "train"), spk, base)
        for line in picks:
            base, spk = line.split("|")[:2]
            for kind in gaps:
                a, b = (np.load(os.path.join(root, "again", dev, kind,
                                             f"{spk}-{kind}-{base}.npy"))
                        for dev in ("cuda", "cpu"))
                if a.shape != b.shape:
                    raise AssertionError(f"{base} {kind}: {a.shape} on the card, "
                                         f"{b.shape} on the CPU")
                d = np.abs(a - b)
                if kind == "mel" and d.size and float(d.max()) > gaps["mel"]:
                    f, m = np.unravel_index(int(d.argmax()), d.shape)
                    worst = (f"{base}, frame {f}, band {m}, log-mel on the CPU "
                             f"{float(b[f, m]):.4f}")
                gaps[kind] = max(gaps[kind], float(d.max()) if d.size else 0.0)
        print(f"[preprocess] card vs CPU on 3 utterances, max abs: mel "
              f"{gaps['mel']:.3e} (at {worst}), energy {gaps['energy']:.3e}, pitch "
              f"{gaps['pitch']:.3e} (atol {MEL_ATOL:g})")
        if max(gaps.values()) > MEL_ATOL:
            raise AssertionError("the card's artifacts disagree with the CPU's")

        # the corpus read back feeds a teacher-forced forward and loss
        ds = TTSDataset("train.txt", cfg)
        batch, _ = collate_batch([ds[i] for i in range(0, len(ds), 4)])
        model = FastSpeech2(cfg, mcfg, acfg, stats, n_speakers=PP_SPEAKERS,
                            generator=torch.Generator().manual_seed(0)).cuda().eval()
        batch = batch.to("cuda")
        with torch.no_grad():
            losses = fastspeech2_loss(batch, model(batch), cfg)
        vals = [float(v) for v in losses]
        print(f"[preprocess] TTSDataset -> collate_batch ({batch.texts.shape[0]} "
              f"utterances, text {batch.texts.shape[1]}, mel {batch.mels.shape[1]}) -> "
              f"teacher-forced FastSpeech2 (base config) on the card: losses "
              + ", ".join(f"{k} {v:.4f}" for k, v in zip(losses._fields, vals)))
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite losses {vals}")
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    # the corpus stays for the test phase; main() removes it
    return launches, (root, cfg, stats)


# ---------------------------------------------------------------- train

SHOTS, QUERIES, SRC_LEN, MEL_LEN, INNER_STEPS, EPISODES = 5, 5, 128, 896, 5, 1
N_SPEAKERS = 256
TIMED_STEPS = 3


def episode_batch(rng, E, B, L, T, n_mels, n_speakers):
    """Synthetic episodes stacked on a leading axis E, made as ``bench.py``
    makes them: durations 1 .. T // L - 1 per symbol, mel length their sum
    (at most T), random mels, pitch, energy, symbols and one speaker id per
    utterance."""
    import numpy as np
    import torch
    from metatts_torch.data.collate import Batch
    fields = []
    for _ in range(E):
        d = rng.randint(1, max(2, T // L), size=(B, L)).astype(np.int32)
        fields.append((
            rng.randint(0, n_speakers, (B,)).astype(np.int32),
            rng.randint(1, 360, (B, L)).astype(np.int32),
            np.full((B,), L, np.int32),
            rng.randn(B, T, n_mels).astype(np.float32),
            np.minimum(d.sum(1), T).astype(np.int32),
            rng.randn(B, L).astype(np.float32),
            rng.randn(B, L).astype(np.float32),
            d))
    return Batch(*(torch.from_numpy(np.stack(f)) for f in zip(*fields)))


def rel_l2(a, b):
    """||a - b|| / ||b|| over all tensors of two name -> gradient dicts."""
    names = [n for n in b if b[n] is not None]
    num = sum(float(((a[n] - b[n]).double() ** 2).sum()) for n in names)
    den = sum(float((b[n].double() ** 2).sum()) for n in names)
    return math.sqrt(num / den)


def top_gaps(a, b, n=4):
    """The n tensors with the largest ||a - b||, with ||b||."""
    gaps = sorted(((float((a[k] - b[k]).double().norm()), float(b[k].double().norm()), k)
                   for k in b if b[k] is not None), reverse=True)[:n]
    return ", ".join(f"{k} {d:.3g} of {r:.3g}" for d, r, k in gaps)


def through_flash(plain, fn):
    """fn() with the flash wrappers (plain=False) or with their plain
    versions swapped in (plain=True)."""
    from metatts_torch.ops import attention as A
    kernels = (A.flash_attention_fwd, A.flash_attention_bwd)
    if plain:
        A.flash_attention_fwd = A.flash_attention_fwd_plain
        A.flash_attention_bwd = A.flash_attention_bwd_plain
    try:
        return fn()
    finally:
        A.flash_attention_fwd, A.flash_attention_bwd = kernels


def with_einsum(sys_, fn):
    """fn() with the model's default attention einsum (bf16 scores and
    softmax at the base config, as the JAX package rounds) instead of flash."""
    stacks = (sys_.model.encoder, sys_.model.decoder)
    impls = [m.attn_impl for m in stacks]
    for m in stacks:
        m.attn_impl = "einsum"
    try:
        return fn()
    finally:
        for m, impl in zip(stacks, impls):
            m.attn_impl = impl


def device_profile(fn):
    """fn() under torch.profiler: (its wall ms, synchronised, the CUDA
    events of ``key_averages()``, each event's self device-time attribute)."""
    import torch
    from torch.profiler import ProfilerActivity
    from metatts_torch.utils.profiling import profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if events and hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    return wall, events, attr


def profile_step(system, sup, qry):
    """Device time of one meta step by kernel name (torch.profiler), and
    the step's wall time; the share of the wall time the card was idle."""
    wall, events, attr = device_profile(lambda: system.train_step(sup, qry))
    busy = sum(getattr(e, attr) for e in events) / 1e3
    if busy == 0.0:
        print("[train] profile: no device time in the trace (not measured)")
        return
    print(f"[train] profile of one step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(kernel time summed), idle share {max(0.0, 1 - busy / wall):.3f}; "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:10]:
        print(f"[train]   {getattr(e, attr) / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")


# ------------------------------------------------------- repeat (train)

# aten ops whose CUDA kernels PyTorch documents as not repeating bit for bit
# at its default settings (``torch.use_deterministic_algorithms``); the
# census below also names any other op that, run twice on the same inputs,
# gives two results
DOCUMENTED_NONDETERMINISTIC = frozenset((
    "scatter_add", "scatter_add_", "scatter", "scatter_", "scatter_reduce",
    "scatter_reduce_", "index_add", "index_add_", "index_copy", "index_copy_",
    "index_put[accumulate]", "index_put_[accumulate]", "_index_put_impl_[accumulate]",
    "put_", "histc", "bincount", "embedding_bag", "_embedding_bag_backward",
    "convolution[cudnn]", "convolution_backward[cudnn]", "cudnn_convolution",
    "cudnn_batch_norm_backward",
    "_cudnn_rnn_backward"))
# ops whose outputs are not results (uninitialised memory, host reads, views
# that share their input's storage), left out of the census' replay
CENSUS_SKIP = ("empty", "new_empty", "_efficientzerotensor", "resize_", "set_",
               "record_stream", "_local_scalar_dense", "detach", "lift_fresh", "alias")


def _length_regulate_gather(x, durations, max_mel_len):
    """The length regulator as the port had it before its steps repeated
    themselves: one gather of each frame's phoneme (its backward a
    scatter-add), frames past sum(d) zeroed.  The reference of the train
    phase's bit-for-bit check and of its census of that formulation."""
    import torch
    cum = torch.cumsum(durations, dim=-1)
    t = torch.arange(max_mel_len, dtype=cum.dtype, device=cum.device)
    idx = (t[None, :, None] >= cum[:, None, :]).sum(-1).clamp(0, durations.shape[-1] - 1)
    valid = t[None, :] < cum[:, -1:]
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=x.dtype, device=x.device))
    return out, durations.sum(-1).clamp(max=max_mel_len).to(torch.int32)


@contextlib.contextmanager
def _previous_steps():
    """Within the block the training steps run as the port ran them before
    they repeated themselves ("previously" in the smoke's lines): the
    gather length regulator, embeddings as an index (``F.embedding``), and
    cuDNN at the process's settings (its default algorithms, fp32 compute
    included)."""
    import torch
    from metatts_torch.algorithms import flags as FL
    from metatts_torch.models import nn as L
    from metatts_torch.models import variance_adaptor as VA
    saved = VA.length_regulate, FL.step_flags, L.Embedding.forward
    VA.length_regulate = _length_regulate_gather
    FL.step_flags = lambda mcfg: contextlib.nullcontext()
    L.Embedding.forward = torch.nn.Embedding.forward
    try:
        yield
    finally:
        VA.length_regulate, FL.step_flags, L.Embedding.forward = saved


@contextlib.contextmanager
def _cudnn_in_steps():
    """Within the block a step keeps cuDNN at the process's setting (with
    its deterministic algorithms) where ``step_flags`` would take it out of
    fp32 compute: the earlier phases' "with cuDNN's convolutions" readings."""
    import torch
    from metatts_torch.algorithms import flags as FL
    saved = FL.step_flags

    @contextlib.contextmanager
    def deterministic_only(mcfg):
        cudnn = torch.backends.cudnn
        old, cudnn.deterministic = cudnn.deterministic, True
        try:
            yield
        finally:
            cudnn.deterministic = old
    FL.step_flags = deterministic_only
    try:
        yield
    finally:
        FL.step_flags = saved


def _bits(t):
    """``t`` as integers of its width (NaN-safe bit comparison)."""
    import torch
    return t.view({4: torch.int32, 2: torch.int16, 8: torch.int64}.get(t.element_size(), t.dtype)) \
        if t.is_floating_point() else t


def _same_bits(a, b):
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def census(fn, replay=True, names=()):
    """fn() with every aten op it dispatches (its backward's too) run twice
    on the same inputs: name -> (calls, calls whose two results differ in a
    bit), for each op that differed, that PyTorch documents as not
    repeating on the card, or that ``names`` holds.  Random draws,
    ``CENSUS_SKIP``, elementwise ops and views run once; without
    ``replay`` every op does, and only the calls are counted."""
    import collections
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    def differ(a, b):
        """A 0-d tensor, on the device, nonzero where two results differ in
        a bit (read once fn() has run: no synchronisation per op)."""
        flags = [torch.ne(_bits(x), _bits(y)).any() for x, y in
                 zip(tree_flatten(a)[0], tree_flatten(b)[0])
                 if isinstance(x, torch.Tensor) and x.layout == torch.strided
                 and x.device.type != "meta" and not x._is_zerotensor()
                 and not y._is_zerotensor() and x.numel()]
        return torch.stack(flags).any() if flags else None

    class Replay(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls, self.flags = collections.Counter(), []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func._schema.name.split("::")[-1]
            if (torch.Tag.nondeterministic_seeded in func.tags
                    or name.startswith(CENSUS_SKIP)):
                return func(*args, **kwargs)
            if name.startswith(("index_put", "_index_put_impl")) and (
                    kwargs.get("accumulate") or (len(args) > 3 and args[3] is True)):
                name += "[accumulate]"
            if (name in ("convolution", "convolution_backward") and args[0].is_cuda
                    and torch.backends.cudnn.enabled and not torch.backends.cudnn.deterministic):
                name += "[cudnn]"
            self.calls[name] += 1
            if not replay or torch.Tag.pointwise in func.tags or (
                    not func._schema.is_mutable
                    and any(r.alias_info is not None for r in func._schema.returns)):
                # elementwise, or a view of its input: the same bits every time
                return func(*args, **kwargs)
            if func._schema.is_mutable:
                clone = lambda t: t.clone() if isinstance(t, torch.Tensor) else t
                again = tree_map(clone, (args, kwargs))
                out = func(*args, **kwargs)
                func(*again[0], **again[1])
                flag = differ((args, kwargs), again)
            else:
                out = func(*args, **kwargs)
                flag = differ(out, func(*args, **kwargs))
            if flag is not None:
                self.flags.append((name, flag))
            return out

    mode = Replay()
    with mode:
        fn()
    counts = collections.Counter(name for name, flag in mode.flags if bool(flag))
    return {k: (n, counts[k]) for k, n in sorted(mode.calls.items())
            if counts[k] or k in DOCUMENTED_NONDETERMINISTIC or k in names}


def warned_ops(fn):
    """The messages PyTorch raises for ops that have no deterministic
    implementation, from fn() under ``use_deterministic_algorithms(True,
    warn_only=True)`` (ops that have one switch to it silently, which is
    what ``census`` is for)."""
    import warnings
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(".")[0][:120] for w in caught
                   if "deterministic" in str(w.message)})


def _step_outputs(out):
    """(LossValues or a loss, name -> gradient), or the name -> tensor dict
    that ``adapt_first_order`` returns -> one name -> tensor dict."""
    if isinstance(out, dict):
        return {n: t.detach() for n, t in out.items()}
    losses, grads = out
    flat = {f"loss.{i}": v.detach() for i, v in enumerate(
        losses if isinstance(losses, tuple) else (losses,))}
    flat.update((n, g.detach()) for n, g in grads.items() if g is not None)
    return flat


def repeat_gap(fn):
    """(rel L2 between two calls' losses and gradients, whether they are
    equal bit for bit)."""
    import torch
    a, b = _step_outputs(fn()), _step_outputs(fn())
    torch.cuda.synchronize()
    return rel_l2(a, b), a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)


def _eer_draw(device):
    """The EER experiment's configs (``EER_RUN``'s widths, fp32), its
    corpus, and the first draw of ``run_experiment``'s data stream at seed
    0 (the stream, then an episode batch of ``EER_META_BATCH`` train
    speakers (5 + 5) and the baseline's flat batch of 40, on ``device``)."""
    import numpy as np
    from metatts_torch.data.synthetic import SyntheticVoices
    from metatts_torch.experiments.meta_advantage import _configs
    mcfg_args = (EER_RUN["n_mels"], 5, 1e-3, 1e-3, EER_META_BATCH, 5, 5, EER_RUN["saving_steps"])
    cfgs = _configs(*mcfg_args, hidden=EER_RUN["hidden"])
    corpus = SyntheticVoices(EER_RUN["n_train"] + EER_RUN["n_test"], n_mels=EER_RUN["n_mels"],
                             seed=0)
    rng = np.random.RandomState(1)
    spk = rng.choice(range(EER_RUN["n_train"]), size=EER_META_BATCH, replace=False)
    sup, qry = corpus.meta_batch(spk, 5, 5, rng, device)
    batch = corpus.batch(list(rng.choice(range(EER_RUN["n_train"]), size=EER_META_BATCH * 10)),
                         rng, device)
    return cfgs, corpus, rng, sup, qry, batch


def _eer_system(kind, cfgs, device):
    import copy
    from metatts_torch.algorithms import get_system
    from metatts_torch.data.synthetic import STATS
    pcfg, mcfg, tcfg, acfg = cfgs
    return get_system(kind)(pcfg, copy.deepcopy(mcfg), tcfg, dict(copy.deepcopy(acfg), type=kind),
                            stats=STATS, n_speakers=EER_RUN["n_train"] + EER_RUN["n_test"],
                            seed=7, device=device)


REPEAT_BASELINE_B = 80     # the baseline step's batch (bench_torch.py's)


def check_repeats(system, sup, qry):
    """The train phase's repeat checks (see the module docstring); returns
    the ops found before."""
    import copy
    import numpy as np
    import torch
    from metatts_torch.algorithms.base import episode
    from metatts_torch.algorithms.baseline import BaselineSystem
    from metatts_torch.algorithms.imaml import IMAMLSystem
    from metatts_torch.data.collate import map_batch

    seed = 1234
    n_mels = system.pcfg["preprocessing"]["mel"]["n_mel_channels"]
    ia = copy.deepcopy(system.acfg)
    ia.update(name="imaml_emb_vad", type="imaml")
    ia["adapt"]["imaml"] = {"reg_param": IMAML_REG, "cg_steps": IMAML_CG_STEPS}
    imaml = IMAMLSystem(system.pcfg, system.mcfg, system.tcfg, ia, n_speakers=N_SPEAKERS,
                        seed=0, device="cuda")
    base = BaselineSystem(system.pcfg, system.mcfg, system.tcfg,
                          dict(system.acfg, type="baseline"), n_speakers=N_SPEAKERS, seed=0,
                          device="cuda")
    batch80 = episode(episode_batch(np.random.RandomState(2), 1, REPEAT_BASELINE_B, SRC_LEN,
                                    MEL_LEN, n_mels, N_SPEAKERS), 0).to("cuda")
    cfgs, _, _, e_sup, e_qry, e_batch = _eer_draw("cuda")
    e_meta, e_base = _eer_system("meta", cfgs, "cuda"), _eer_system("baseline", cfgs, "cuda")
    one = lambda b: map_batch(lambda t: t[:1], b)
    # (tag, the step, what the census of the previous formulation runs: the
    # step, its first episode, or None: the step with its calls counted, not
    # replayed, where a replay of every op at T=896 would cost ~15 s)
    base_bf16 = lambda: base._train_step(batch80, seed)
    base_fp32 = lambda: e_base._train_step(e_batch, seed)

    def test_step(s, sup_e):
        """One step of the test stage's entry point on the support set:
        the adapted weights it returns (no flags set here)."""
        return lambda: s.adaptor.adapt_first_order(
            s.params, sup_e, steps=1, lr=s.acfg["adapt"]["test"]["lr"], train=True, seed=seed)
    test_bf16 = test_step(system, episode(sup, 0))
    test_fp32 = test_step(e_meta, episode(e_sup, 0))
    cases = (
        ("meta step, bf16, train workload",
         lambda: system._meta_train_step(sup, qry, seed), None),
        ("meta step, fp32, EER config", lambda: e_meta._meta_train_step(e_sup, e_qry, seed),
         lambda: e_meta._meta_train_step(one(e_sup), one(e_qry), seed)),
        (f"baseline step, bf16, B={REPEAT_BASELINE_B}", base_bf16, base_bf16),
        ("baseline step, fp32, EER config", base_fp32, base_fp32),
        ("iMAML step, bf16, train workload", lambda: imaml._train_step(sup, qry, seed), None),
        ("test step (adapt_first_order), bf16", test_bf16, test_bf16),
        ("test step (adapt_first_order), fp32, EER config", test_fp32, test_fp32),
    )
    found, failed = {}, []
    for tag, fn, replayed in cases:
        t0 = time.perf_counter()
        with _previous_steps():
            gap_b, same_b = repeat_gap(fn)
            before = census(fn, replay=False) if replayed is None else census(replayed)
            warned = warned_ops(fn)
        gap, same = repeat_gap(fn)
        # now: any op found before, or documented, that the step still calls
        left = census(fn, replay=False, names=found.keys() | before.keys())
        for k, v in before.items():
            found.setdefault(k, []).append(tag)
        how = ("calls counted" if replayed is None else "each op run twice" + (
            "" if replayed is fn else ", on the first episode"))
        print(f"[train] repeat: {tag}: previously two calls rel L2 {gap_b:.3e} "
              f"(bit for bit: {same_b}), non-deterministic ops ({how}) "
              f"{', '.join(f'{k} {d}/{n}' for k, (n, d) in before.items()) or 'none'}, "
              f"PyTorch's warnings {warned or 'none'}; now two calls rel L2 {gap:.3e} "
              f"(bit for bit: {same}), non-deterministic ops "
              f"{', '.join(f'{k} {d}/{n}' for k, (n, d) in left.items()) or 'none'} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not same or left:
            failed.append(tag)
    if failed:
        raise AssertionError(f"training steps that do not repeat themselves: {failed}")
    print(f"[train] repeat: the non-deterministic ops the training steps had previously: "
          + "; ".join(f"{k} in {len(v)} of {len(cases)} steps" for k, v in found.items())
          + "; none is left, and each step repeats itself bit for bit")
    return found


def check_length_regulator(sup):
    """``length_regulate`` (the one-hot product) on the card against the
    gather version, bit for bit, in fp32 and bf16: the train workload's
    durations, the same with a third of them 0, and tripled (past T, so
    truncated at T)."""
    import torch
    from metatts_torch.ops.length_regulator import length_regulate
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = sup.d_targets[0].to("cuda")
    keep = torch.rand(d.shape, generator=gen, device="cuda") > 1 / 3
    results = []
    for tag, dd in (("workload", d), ("zeros", d * keep), ("truncated", 3 * d)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(d.shape[0], d.shape[1], BASE_SHAPE["D"], generator=gen,
                            device="cuda").to(dt)
            got, got_len = length_regulate(x, dd, MEL_LEN)
            ref, ref_len = _length_regulate_gather(x, dd, MEL_LEN)
            results.append((f"{tag} {str(dt)[6:]}", _same_bits(got, ref)
                            and torch.equal(got_len, ref_len)))
    print(f"[train] length_regulate (one-hot product) vs the gather version on the card, "
          f"B={d.shape[0]}, L={d.shape[1]}, T={MEL_LEN}, H={BASE_SHAPE['D']}: "
          + ", ".join(f"{t} {'bit for bit' if ok else 'DIFFERENT'}" for t, ok in results))
    if not all(ok for _, ok in results):
        raise AssertionError("length_regulate differs from the gather version")

IMAML_CG_WARM = 20        # baseline steps at the EER config before the CG check


def _cg_taken(fn):
    """(fn(), per ``tree_cg`` call the number of iterations that stepped:
    p'Ap > 1e-20, the rest frozen)."""
    from metatts_torch.algorithms import imaml as IM
    taken, tree_cg = [], IM.tree_cg

    def counting(matvec, b, iters):
        n = 0

        def mv(p):
            nonlocal n
            ap = matvec(p)
            n += bool(IM._dot(p, ap) > 1e-20)
            return ap
        x = tree_cg(mv, b, iters)
        taken.append(n)
        return x
    IM.tree_cg = counting
    try:
        return fn(), taken
    finally:
        IM.tree_cg = tree_cg


def check_imaml_cg():
    """The fp32 iMAML hypergradient where CG steps: at the EER config after
    ``IMAML_CG_WARM`` baseline steps, through the flash kernels against
    their plain versions under deterministic algorithms."""
    import torch
    cfgs, corpus, rng, sup, qry, _ = _eer_draw("cuda")
    cfgs[3]["adapt"]["imaml"] = {"reg_param": IMAML_REG, "cg_steps": IMAML_CG_STEPS}
    base = _eer_system("baseline", cfgs, "cuda")
    for _ in range(IMAML_CG_WARM):
        base.train_step(corpus.batch(list(rng.choice(range(EER_RUN["n_train"]),
                                                      size=EER_META_BATCH * 10)), rng, "cuda"))
    imaml = _eer_system("imaml", cfgs, "cuda")
    imaml.model.load_state_dict(base.model.state_dict())
    step = lambda: imaml._train_step(sup, qry, 4321)
    (_, g_k), taken_k = _deterministic(lambda: _cg_taken(lambda: through_flash(False, step)))
    (_, g_p), taken_p = _deterministic(lambda: _cg_taken(lambda: through_flash(True, step)))
    (_, g_p2), _ = _deterministic(lambda: _cg_taken(lambda: through_flash(True, step)))
    gap, floor = rel_l2(g_k, g_p), rel_l2(g_p2, g_p)
    modules = imaml.adaptor.modules
    adapted = {n: g_p[n] for n in g_p if n.split(".")[0] in modules}
    a_norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in adapted.values()))
    print(f"[imaml] fp32 hypergradient where CG steps (the EER config, hidden 32, after "
          f"{IMAML_CG_WARM} baseline steps, {EER_META_BATCH} episodes, CG {IMAML_CG_STEPS} at "
          f"reg {IMAML_REG:g}; deterministic algorithms): CG steps taken per episode "
          f"{taken_k} (plain versions {taken_p}); the adapted modules' hypergradient norm "
          f"{a_norm:.4g}; through the kernels' fp32 path vs the plain versions rel L2 "
          f"{gap:.3e} (tolerance {META_GRAD_TOL_F32:g}); the plain versions again {floor:.3e}")
    if not (sum(taken_k) >= 1 and taken_k == taken_p and gap < META_GRAD_TOL_F32
            and floor == 0.0 and a_norm > 0
            and all(torch.isfinite(g).all() for g in g_k.values())):
        raise AssertionError("the iMAML hypergradient where CG steps disagrees with the "
                             "plain versions, or CG took no step")


def phase_train():
    import copy
    import torch
    from metatts_torch import config as C
    from metatts_torch.algorithms.meta import MetaSystem, episode
    from metatts_torch.ops import attention as A

    pcfg, mcfg, acfg = C.base_configs()
    acfg["adapt"]["train"].update(shots=SHOTS, queries=QUERIES, steps=INNER_STEPS)
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    system = MetaSystem(pcfg, mcfg, tcfg, acfg, n_speakers=N_SPEAKERS, seed=0,
                        device="cuda")
    sup, qry = _train_workload(pcfg["preprocessing"]["mel"]["n_mel_channels"])
    n_layers = (mcfg["transformer"]["encoder_layer"]
                + mcfg["transformer"]["decoder_layer"])
    frames = int(sup.mel_lens.sum()) * INNER_STEPS + int(qry.mel_lens.sum())

    bn = {k: v.clone() for k, v in system.model.state_dict().items() if "running" in k}
    before = {n: p.detach().clone() for n, p in system.params.items()}

    # gradients through the kernels against the same computation through
    # the plain versions: same weights, batch and dropout seed
    seed = 1234
    through = through_flash

    def query_grad(sys_):      # one training forward + backward of the query set
        params = sys_.params
        total, _ = sys_._supervised_loss(params, episode(qry, 0), seed, True)
        return dict(zip(params, torch.autograd.grad(total, list(params.values()),
                                                    allow_unused=True)))

    # fp32 compute: the kernels' fp32 path, where only the order of sums differs
    system32 = MetaSystem(pcfg, _fp32(mcfg), tcfg, acfg, n_speakers=N_SPEAKERS, seed=0,
                          device="cuda")
    system32.model.train()
    gap32 = rel_l2(through(False, lambda: query_grad(system32)),
                   through(True, lambda: query_grad(system32)))
    # the meta-gradient at fp32 compute (the kernels' fp32 path; the bf16
    # kernels are held at kernel level by the flash phase), with PyTorch's
    # deterministic algorithms, so that the plain step repeats itself exactly
    meta32 = lambda: system32._meta_train_step(sup, qry, seed)
    (loss32_k, grads32_k), (loss32_p, grads32_p), (_, grads32_p2) = _deterministic(
        lambda: [through(False, meta32), through(True, meta32), through(True, meta32)])
    _, grads32_pd = through(True, meta32)      # PyTorch's default algorithms
    meta_gap32, floor32 = rel_l2(grads32_k, grads32_p), rel_l2(grads32_p2, grads32_p)
    loss_gap32 = (abs(float(loss32_k.total) - float(loss32_p.total))
                  / abs(float(loss32_p.total)))
    print(f"[train] meta-gradient at fp32 compute (deterministic algorithms) through "
          f"the kernels' fp32 path vs the plain versions: rel L2 {meta_gap32:.3e} "
          f"(tolerance {META_GRAD_TOL_F32:g}); the plain versions again {floor32:.3e}; "
          f"query loss rel {loss_gap32:.3e}; the plain versions at PyTorch's default "
          f"algorithms vs deterministic {rel_l2(grads32_pd, grads32_p):.3e}")
    print(f"[train]   largest fp32 gaps: {top_gaps(grads32_k, grads32_p)}")
    if not (meta_gap32 < META_GRAD_TOL_F32 and floor32 == 0.0 and loss_gap32 < 1e-5
            and all(torch.isfinite(g).all() for g in grads32_k.values() if g is not None)):
        raise AssertionError("the fp32 meta-gradient through the kernels disagrees with "
                             "the plain versions")
    del system32, grads32_k, grads32_p, grads32_p2, grads32_pd
    system.model.train()
    g_k = through(False, lambda: query_grad(system))
    g_p = through(True, lambda: query_grad(system))
    g_e = with_einsum(system, lambda: query_grad(system))
    gap, gap_e = rel_l2(g_k, g_p), rel_l2(g_e, g_p)
    print(f"[train] query-set gradient (one training forward and backward), kernels "
          f"vs plain versions: fp32 rel L2 {gap32:.3e} (tolerance {GRAD_TOL_F32:g}); "
          f"bf16 rel L2 {gap:.3e} (tolerance {GRAD_TOL:g}), and einsum attention "
          f"(bf16 scores and softmax) vs the plain versions {gap_e:.3e}")
    print(f"[train]   largest bf16 gaps: {top_gaps(g_k, g_p)}")
    if not (gap32 < GRAD_TOL_F32 and gap < GRAD_TOL):
        raise AssertionError("the gradient through the kernels disagrees with the "
                             "plain versions")
    meta = lambda: system._meta_train_step(sup, qry, seed)
    loss_k, grads_k = through(False, meta)
    loss_p, grads_p = through(True, meta)
    _, grads_e = with_einsum(system, meta)
    gap, gap_e = rel_l2(grads_k, grads_p), rel_l2(grads_e, grads_p)
    loss_gap = abs(float(loss_k.total) - float(loss_p.total)) / abs(float(loss_p.total))
    print(f"[train] meta-gradient through the kernels vs plain versions: rel L2 "
          f"{gap:.3e} (tolerance {META_GRAD_TOL:g}); the same step with einsum "
          f"attention on the query (bf16 scores and softmax) vs the plain versions: "
          f"{gap_e:.3e}; query loss rel {loss_gap:.3e}")
    print(f"[train]   largest gaps: {top_gaps(grads_k, grads_p)}")
    if not (gap < META_GRAD_TOL and loss_gap < 1e-3
            and all(torch.isfinite(g).all() for g in grads_k.values() if g is not None)):
        raise AssertionError("the meta-gradient through the kernels disagrees with "
                             "the plain versions")
    for n, p in system.params.items():
        if not torch.equal(p, before[n]):
            raise AssertionError(f"computing a meta-gradient changed {n}")
    check_length_regulator(sup)

    # the main path, counted: one warm-up step, then timed steps
    system.train_step(sup, qry)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_attention_fwd.launches = A.flash_attention_bwd.launches = 0
    _adam_zero()
    losses = []
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        f0, b0 = A.flash_attention_fwd.launches, A.flash_attention_bwd.launches
        losses.append(system.train_step(sup, qry))
        f1, b1 = A.flash_attention_fwd.launches - f0, A.flash_attention_bwd.launches - b0
        if (f1, b1) != (n_layers, n_layers):
            raise AssertionError(f"a meta step launched {f1} flash forward and {b1} "
                                 f"backward kernels, not {n_layers} each")
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    launches = (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches,
                _adam_check(system, TIMED_STEPS, "[train]", ADAM_BASE_LAUNCHES))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    totals = [float(l.total) for l in losses]
    if not all(math.isfinite(float(v)) for l in losses for v in l):
        raise AssertionError(f"non-finite losses {losses}")
    moved = sum(not torch.equal(p, before[n]) for n, p in system.params.items())
    if moved < len(before) // 2:
        raise AssertionError(f"only {moved} of {len(before)} parameters moved")
    for k, v in bn.items():
        if not torch.equal(v, system.model.state_dict()[k]):
            raise AssertionError(f"the meta step wrote the BatchNorm buffer {k}")
    profile_step(system, sup, qry)
    # the first-order validation entry point (flash in the inner loop too)
    val = system.validation_step(episode(sup, 0), episode(qry, 0))
    if not all(math.isfinite(float(v)) for v in val):
        raise AssertionError(f"non-finite validation losses {val}")
    print(f"[train] MetaSystem.validation_step (first order): total loss "
          f"{float(val.total):.4f}")
    # the same step as the port ran it previously (``_previous_steps``),
    # timed in this call after a warm-up
    with _previous_steps():
        system.train_step(sup, qry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            system.train_step(sup, qry)
        torch.cuda.synchronize()
    ms_before = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    print(f"[train] MetaSystem.train_step, base config, E={EPISODES}, {SHOTS} support + "
          f"{QUERIES} query, L={SRC_LEN}, T={MEL_LEN}, {INNER_STEPS} inner steps "
          f"(custom-HVP): {ms:.2f} ms per step, {frames} mel frames per step, "
          f"{frames / ms * 1e3:.1f} mel frames/s, peak memory {peak:.2f} GiB; "
          f"flash launches {launches[0]} forward + {launches[1]} backward, NoamAdam's "
          f"kernel {launches[2]}, over {TIMED_STEPS} steps; total loss {', '.join(f'{t:.4f}' for t in totals)}; "
          f"{moved} of {len(before)} parameter tensors moved; BatchNorm buffers "
          f"unchanged; the step as previously (gather length regulator, embeddings by index, "
          f"cuDNN's default algorithms) {ms_before:.2f} ms ({card_line()})")
    check_repeats(system, sup, qry)
    return launches


# ---------------------------------------------------------------- test

TEST_TASKS = 2                         # full 100-step tasks through Trainer.test
# the flash kernels' function names in csrc/flash_attention.cu
FLASH_KERNELS = ("fwd_bf16", "bwd_prep_bf16", "bwd_bf16", "bwd_delta", "fwd_f32",
                 "bwd_dq_f32", "bwd_dkdv_f32")
TEST_BATCHED_SAVING = [5, 10]          # the batched run's saving steps (a depth cut)
EVAL_TOL = 2e-2                        # the serve phase's kernel-vs-plain bound


def _wavs(folder):
    """name -> samples of every wav in ``folder``."""
    from scipy.io import wavfile
    return {f: wavfile.read(os.path.join(folder, f))[1]
            for f in sorted(os.listdir(folder)) if f.endswith(".wav")}


def _check_task_files(result, task, steps, n_queries):
    """The task's CSV (the JAX package's columns, one row per saving step)
    and its recon + per-step synth wavs (non-empty int16)."""
    import csv
    import numpy as np
    from metatts_torch.train.saver import CSV_COLUMNS
    with open(os.path.join(result, "csv", "Testing", "step_last", f"{task}.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["ft_step"] + CSV_COLUMNS[1:] or [r[0] for r in rows[1:]] != \
            [str(s) for s in steps]:
        raise AssertionError(f"{task}: CSV {rows}")
    wavs = _wavs(os.path.join(result, "audio", "Testing", "step_last", task))
    synth = [f for f in wavs if ".synth." in f]
    recon = [f for f in wavs if f.endswith(".recon.wav")]
    if (len(recon), len(synth)) != (n_queries, n_queries * len(steps)) or not all(
            w.dtype == np.int16 and w.size > 0 for w in wavs.values()):
        raise AssertionError(f"{task}: wavs {[(f, w.dtype, w.size) for f, w in wavs.items()]}")
    return len(wavs)


def phase_test(corpus):
    """The test stage at the base configuration on the preprocess phase's
    corpus; see the module docstring."""
    import copy
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from metatts_torch.utils.profiling import profile
    from metatts_torch import config as C
    from metatts_torch.algorithms.adapt import episode_speaker_args
    from metatts_torch.algorithms.base import episode
    from metatts_torch.algorithms.meta import MetaSystem
    from metatts_torch.data.collate import collate_episode
    from metatts_torch.data.datamodule import BaselineDataModule
    from metatts_torch.models import transformer
    from metatts_torch.models.vocoder import Vocoder
    from metatts_torch.ops import attention as A
    from metatts_torch.ops.fftblock import fused_fft_block, fused_fft_block_plain
    from metatts_torch.serve import SynthesisEngine
    from metatts_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from metatts_torch.train.loop import Trainer

    root, cfg, stats = corpus
    pcfg0, mcfg, acfg = C.base_configs()
    # the datamodule's val sampler (unused here) draws training tasks of 5 +
    # 5 utterances, more than a speaker of the corpus has: cut its queries
    acfg["adapt"]["train"]["queries"] = PP_UTTERANCES - acfg["adapt"]["train"]["shots"]
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    test_cfg = acfg["adapt"]["test"]
    steps = [0] + test_cfg["saving_steps"]
    out_dir = os.path.join(root, "test_stage")
    n_layers = mcfg["transformer"]["encoder_layer"] + mcfg["transformer"]["decoder_layer"]
    n_dec = mcfg["transformer"]["decoder_layer"]
    card = card_line()
    vocoder = Vocoder(mcfg, n_mels=80, device="cuda")

    def system_for(pcfg, acfg_, n_speakers, seed, stats_=None):
        sys_ = MetaSystem(pcfg, mcfg, tcfg, acfg_, stats_, n_speakers=n_speakers,
                          seed=seed, device="cuda")
        with torch.no_grad():   # random init predicts ~0 frames, as in _engine
            sys_.model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(2.0)
        return sys_

    # checkpoint round trip: save, then SynthesisEngine.from_checkpoint
    src = system_for(pcfg0, acfg, 8, 0)
    path = os.path.join(out_dir, "ckpt", "seed0.msgpack")
    save_checkpoint(path, src.model, 0)
    eng = SynthesisEngine(src.model, pcfg0, mcfg, acfg, vocoder=vocoder, device="cuda")
    loaded = SynthesisEngine.from_checkpoint(path, pcfg0, mcfg, acfg, n_speakers=8,
                                             device="cuda")
    speakers = list(range(len(SENTENCES)))
    a = eng.synthesize(SENTENCES, speakers=speakers, mel_cap=1000)
    b = loaded.synthesize(SENTENCES, speakers=speakers, mel_cap=1000)
    if not all(np.array_equal(wa, wb) and np.array_equal(ma, mb)
               for (wa, ma), (wb, mb) in zip(a, b)):
        raise AssertionError("the engine from the checkpoint does not synthesize the "
                             "source engine's wavs bit for bit")
    small = system_for(pcfg0, acfg, 4, 1)
    save_checkpoint(os.path.join(out_dir, "ckpt", "4rows.msgpack"), small.model, 3)
    big = system_for(pcfg0, acfg, 8, 0).model
    init_rows = big.speaker_emb.model.weight.detach().clone()
    opt, step, report = load_checkpoint(os.path.join(out_dir, "ckpt", "4rows.msgpack"), big)
    table = big.speaker_emb.model.weight.detach()
    want = "resized /speaker_emb/table: (4, 256) -> (8, 256) (copied 4 rows)"
    if not (step == 3 and report == [want] and opt is None
            and torch.equal(table[:4], small.model.speaker_emb.model.weight.detach())
            and torch.equal(table[4:], init_rows[4:])):
        raise AssertionError(f"checkpoint surgery: step {step}, report {report}")
    print(f"[test] checkpoint: save_checkpoint -> SynthesisEngine.from_checkpoint, "
          f"{len(SENTENCES)} sentences synthesized bit for bit as the source engine; "
          f"a 4-speaker checkpoint into 8 rows: {report[0]!r}")
    del src, eng, loaded, small, big

    # the test stage through Trainer.test: TEST_TASKS tasks of 100 steps
    with open(os.path.join(cfg["path"]["preprocessed_path"], "speakers.json")) as f:
        n_speakers = len(json.load(f))
    system = system_for(cfg, acfg, n_speakers, 0, stats)
    dm = BaselineDataModule([cfg], tcfg, acfg, log_dir=os.path.join(out_dir, "log"))
    dm.setup()
    first, last = [], []
    tasks_of = system.test_adapt_tasks

    def recording(*args, **kw):
        for item in tasks_of(*args, **kw):
            first.append(item[2][0][1])
            last.append(item[2][-1][1])
            yield item
    system.test_adapt_tasks = recording
    trainer = Trainer(system, dm, tcfg, output_dir=out_dir, exp_name="seq",
                      vocoder=vocoder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counted
    A.flash_attention_fwd.launches = A.flash_attention_bwd.launches = 0
    fused_fft_block.launches = 0
    t0 = time.perf_counter()
    results = trainer.test(max_tasks=TEST_TASKS, tasks_per_label=1, task_batch=1)
    torch.cuda.synchronize()
    task_s = (time.perf_counter() - t0) / TEST_TASKS
    launches = (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches,
                fused_fft_block.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mode = system.snapshot_mode
    system.test_adapt_tasks = tasks_of
    n_steps = test_cfg["steps"]
    want = (TEST_TASKS * n_steps * n_layers, TEST_TASKS * n_steps * n_dec,
            TEST_TASKS * (2 * len(steps) + 1) * n_layers)
    if launches != want:
        raise AssertionError(f"Trainer.test launched {launches} flash forward, flash "
                             f"backward and fused kernels, not {want}")
    if sorted(results) != [f"test_{i:03d}" for i in range(TEST_TASKS)]:
        raise AssertionError(f"tasks {sorted(results)}")
    modules = system.adaptor.modules
    for tid, rows in results.items():
        vals = [float(v) for _, lv in rows for v in lv]
        if [ft for ft, _ in rows] != steps or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{tid}: rows {rows}")
    for f, l in zip(first, last):
        moved = [k for k in f if not torch.equal(f[k], l[k])]
        if not moved or any(k.split(".")[0] not in modules for k in moved):
            raise AssertionError(f"the step-{n_steps} snapshot moved {moved}")
    result = os.path.join(out_dir, "result", "seq")
    n_wavs = sum(_check_task_files(result, tid, steps, test_cfg["queries"])
                 for tid in results)
    print(f"[test] Trainer.test, base config, {TEST_TASKS} tasks ({test_cfg['shots']}-shot / "
          f"{test_cfg['queries']}-query from the preprocess corpus), {n_steps} first-order "
          f"steps each, saving steps {test_cfg['saving_steps']}: {task_s:.2f} s per task "
          f"(adaptation, {len(steps)} evaluations, recon + {len(steps)} syntheses, files); "
          f"launches {launches[0]} "
          f"flash forward ({launches[0] // (TEST_TASKS * n_steps)} per inner step), "
          f"{launches[1]} flash backward ({launches[1] // (TEST_TASKS * n_steps)} per inner "
          f"step: the decoder's; the encoder is frozen and precedes the speaker embedding), "
          f"{launches[2]} fused ({launches[2] // TEST_TASKS} per task); {n_wavs} wavs, "
          f"CSV rows at {steps}; total loss "
          + ", ".join(f"{float(r[0][1].total):.2f} -> {float(r[-1][1].total):.2f}"
                      for r in results.values())
          + f"; peak memory {peak:.2f} GiB; snapshots kept on the {mode} ({card})")

    # again with test_task_batch 2: test_adapt_batched over stacked episodes
    acfg_b = copy.deepcopy(acfg)
    acfg_b["adapt"]["test"]["saving_steps"] = TEST_BATCHED_SAVING
    system_b = system_for(cfg, acfg_b, n_speakers, 0, stats)
    batched, shapes = system_b.test_adapt_batched, []

    def record_batched(*args, **kw):
        rows_E, snaps_E = batched(*args, **kw)
        shapes.append(([tuple(v.shape) for _, lv in rows_E for v in lv],
                       {k: tuple(v.shape) for k, v in snaps_E[-1][1].items()}))
        return rows_E, snaps_E
    system_b.test_adapt_batched = record_batched
    res_b = Trainer(system_b, dm, dict(tcfg, test_task_batch=2), output_dir=out_dir,
                    exp_name="batched", vocoder=vocoder).test(max_tasks=2, tasks_per_label=1)
    params = system_b.params
    if not (len(shapes) == 1 and set(shapes[0][0]) == {(2,)} and shapes[0][1] == {
            k: (2,) + tuple(v.shape) for k, v in params.items()}):
        raise AssertionError(f"test_adapt_batched shapes {shapes}")
    for tid, rows in res_b.items():
        if [ft for ft, _ in rows] != [0] + TEST_BATCHED_SAVING or not all(
                math.isfinite(float(v)) for _, lv in rows for v in lv):
            raise AssertionError(f"batched {tid}: rows {rows}")
        _check_task_files(os.path.join(out_dir, "result", "batched"), tid,
                          [0] + TEST_BATCHED_SAVING, test_cfg["queries"])
    print(f"[test] Trainer.test with test_task_batch 2 (saving steps "
          f"{TEST_BATCHED_SAVING}): one test_adapt_batched call, losses {shapes[0][0][0]} "
          f"a field, snapshot tensors (2, ...); every episode's rows finite")
    del system_b

    # the first task's episode, for the checks and timings below
    sup_s, qry_s = next(iter(dm.test_episodes(1)))[1]
    sup_b, qry_b, _, _ = collate_episode([sup_s], [qry_s])
    sup, qry = episode(sup_b, 0).to("cuda"), episode(qry_b, 0).to("cuda")
    lr, seed = test_cfg["lr"], 4321

    # a first-order support gradient through the kernels against the plain
    # versions (the adapted modules only), bf16 and fp32
    def fo_grad(sys_):
        params = {k: v.detach().requires_grad_(k.split(".")[0] in modules)
                  for k, v in sys_.params.items()}
        names = [k for k, v in params.items() if v.requires_grad]
        total, _ = sys_._supervised_loss(params, sup, seed, True)
        return dict(zip(names, torch.autograd.grad(total, [params[k] for k in names],
                                                   allow_unused=True)))
    f0, b0 = A.flash_attention_fwd.launches, A.flash_attention_bwd.launches
    g_k = through_flash(False, lambda: fo_grad(system))
    step_launches = (A.flash_attention_fwd.launches - f0, A.flash_attention_bwd.launches - b0)
    g_p = through_flash(True, lambda: fo_grad(system))
    system32 = MetaSystem(cfg, dict(mcfg, compute_dtype="float32",
                                    activation_dtype="float32",
                                    attention_scores_dtype="float32"),
                          tcfg, acfg, stats, n_speakers=n_speakers, seed=0, device="cuda")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        g32_k = through_flash(False, lambda: fo_grad(system32))
        g32_p = through_flash(True, lambda: fo_grad(system32))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    del system32
    gap, gap32 = rel_l2(g_k, g_p), rel_l2(g32_k, g32_p)
    print(f"[test] first-order support gradient (adapted modules), kernels vs plain "
          f"versions: bf16 rel L2 {gap:.3e} (tolerance {GRAD_TOL:g}), fp32 under "
          f"deterministic algorithms {gap32:.3e} (tolerance {GRAD_TOL_F32:g}); "
          f"{step_launches[0]} flash forward and {step_launches[1]} backward launches")
    print(f"[test]   largest bf16 gaps: {top_gaps(g_k, g_p)}")
    if not (gap < GRAD_TOL and gap32 < GRAD_TOL_F32 and step_launches == (n_layers, n_dec)
            and all(torch.isfinite(g).all() for g in g_k.values() if g is not None)):
        raise AssertionError("the first-order gradient through the kernels disagrees "
                             "with the plain versions")

    # two snapshot evaluations back to back through the kernel, against the
    # same evaluations through the plain version (the fused packs follow)
    qry_c = qry._replace(speaker_args=episode_speaker_args(sup.speaker_args,
                                                           qry.speaker_args))

    @torch.no_grad()
    def evaluate(params):
        return system.adaptor.forward(params, qry_c, train=False, average_spk_emb=True,
                                      fused_infer=True).postnet_mel
    p0 = system._start_params()
    p5 = system._adapt_chunk(p0, sup, 5, lr, seed)
    k0, k5 = evaluate(p0), evaluate(p5)
    transformer.fused_fft_block = fused_fft_block_plain
    try:
        r0, r5 = evaluate(p0), evaluate(p5)
    finally:
        transformer.fused_fft_block = fused_fft_block
    rels = [((k - r).abs().max() / r.abs().max()).item() for k, r in ((k0, r0), (k5, r5))]
    print(f"[test] snapshot evaluations at steps 0 and 5, back to back, kernel vs plain: "
          f"postnet mel rel {rels[0]:.3e} / {rels[1]:.3e} (tolerance {EVAL_TOL:g}); the two "
          f"snapshots' outputs differ by {(k5 - k0).abs().max().item():.3e}")
    if not (max(rels) < EVAL_TOL and not torch.equal(k0, k5)
            and torch.isfinite(k5).all()):
        raise AssertionError("a snapshot evaluation through the kernel disagrees with "
                             "the plain version")

    # timings: an inner step, a snapshot evaluation, adapt_speaker(100) +
    # synthesize, and the flash kernels' share of one profiled inner step
    system._adapt_chunk(p0, sup, 1, lr, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system._adapt_chunk(p0, sup, 10, lr, seed)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 10
    t0 = time.perf_counter()
    for _ in range(5):
        float(system._eval_query(p5, sup, qry, True).total)
    eval_ms = 1e3 * (time.perf_counter() - t0) / 5
    base = SynthesisEngine(system.model, cfg, mcfg, acfg, vocoder=vocoder, device="cuda")
    texts = [s["text"] for s in qry_s]
    spk = [s["speaker"] for s in qry_s]
    before = base.synthesize(texts, speakers=spk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adapted = base.adapt_speaker(sup)
    after = adapted.synthesize(texts, speakers=spk)
    rtf_s = time.perf_counter() - t0
    audio_s = sum(len(w) for w, _ in after) / base.sr
    if not (all(np.isfinite(m).all() and m.size for _, m in after) and any(
            m.shape != mb.shape or not np.array_equal(m, mb)
            for (_, m), (_, mb) in zip(after, before))):
        raise AssertionError("adapt_speaker's engine synthesizes nothing new")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system._adapt_chunk(p0, sup, 1, lr, seed)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if events and hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    busy = sum(getattr(e, attr) for e in events) / 1e3
    flash = [e for e in events if any(n in e.key for n in FLASH_KERNELS)]
    flash_ms = sum(getattr(e, attr) for e in flash) / 1e3
    share = (f"{flash_ms:.3f} of {busy:.2f} ms of device time "
             f"({100 * flash_ms / busy:.1f}%, {sum(e.count for e in flash)} flash kernels "
             f"in {sum(e.count for e in events)}), the host's clock {prof_ms:.2f} ms"
             if busy and flash else "not measured (no flash kernel in the trace)")
    print(f"[test] timings ({card}): {task_s:.2f} s per {n_steps}-step task; {step_ms:.2f} ms per "
          f"inner step ({test_cfg['shots']} support utterances, mel bucket "
          f"{sup.mels.shape[1]}); {eval_ms:.2f} ms per snapshot evaluation (fused); "
          f"adapt_speaker({n_steps}) + synthesize {rtf_s:.2f} s for {audio_s:.2f} s of "
          f"audio, real-time factor {rtf_s / audio_s:.4f}; peak memory {peak:.2f} GiB; "
          f"snapshot mode '{mode}' (auto); flash kernels in one profiled inner step {share}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:6]:
        print(f"[test]   {getattr(e, attr) / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    return launches


# ---------------------------------------------------------------- fit

FIT_STEPS, FIT_EVERY = 6, 3      # total_step; val, synth and save cadence (a depth cut)
META_FIT_STEPS, META_FIT_EPISODES = 2, 2   # the meta run (a depth cut: the recipe's 8)
FIT_TIMED = 5                    # baseline steps timed after the run


def _flash_counts():
    from metatts_torch.ops import attention as A
    return A.flash_attention_fwd.launches, A.flash_attention_bwd.launches


def _counted(fn, log):
    """fn, appending to ``log`` the flash launches of each call."""
    def run(*args, **kw):
        f0, b0 = _flash_counts()
        out = fn(*args, **kw)
        f1, b1 = _flash_counts()
        log.append((f1 - f0, b1 - b0))
        return out
    return run


def _opt_state(system):
    """A copy of the optimizer's moments and count, the step counter and
    the weights."""
    opt = system.optimizer
    return ({n: t.clone() for n, t in opt.mu.items()}, {n: t.clone() for n, t in opt.nu.items()},
            opt.count, system.global_step, {n: p.detach().clone() for n, p in system.params.items()})


def _same_state(a, b):
    """Two ``_opt_state`` copies equal bit for bit."""
    import torch
    return a[2:4] == b[2:4] and all(
        a[i].keys() == b[i].keys() and all(torch.equal(a[i][k], b[i][k]) for k in a[i])
        for i in (0, 1, 4))


def _events(log_dir):
    """name -> last value of the metrics in a run's events.jsonl."""
    out = {}
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "metrics":
                out.update(rec["metrics"])
    return out


def phase_fit(corpus):
    """Training runs at the base configuration on the preprocess phase's
    corpus; see the module docstring."""
    import copy
    import csv
    import numpy as np
    import torch
    from metatts_torch import config as C
    from metatts_torch.algorithms import get_system
    from metatts_torch.data.datamodule import get_datamodule
    from metatts_torch.models.vocoder import Vocoder
    from metatts_torch.ops import attention as A
    from metatts_torch.ops import melspec
    from metatts_torch.ops.fftblock import fused_fft_block
    from metatts_torch.train.loop import Trainer
    from metatts_torch.utils.profiling import StepTimer

    root, cfg, stats = corpus
    _, mcfg, _ = C.base_configs()
    base = copy.deepcopy(C.ALGORITHM_DEFAULTS)     # config/algorithm/base_emb_vad.yaml
    meta = C.deep_merge(C.ALGORITHM_DEFAULTS, C.META_EMB_VAD)
    for acfg in (base, meta):
        # the val sampler draws tasks of 5 + 5 utterances, more than a
        # speaker of the corpus has: cut its queries, as the test phase does
        acfg["adapt"]["train"]["queries"] = PP_UTTERANCES - acfg["adapt"]["train"]["shots"]
    meta["adapt"]["train"]["meta_batch_size"] = META_FIT_EPISODES
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)         # config/train/base.yaml: batch 80
    tcfg["step"].update(total_step=FIT_STEPS, log_step=1, val_step=FIT_EVERY,
                        synth_step=FIT_EVERY, save_step=FIT_EVERY)
    B = tcfg["optimizer"]["batch_size"]
    out_dir = os.path.join(root, "fit")
    with open(os.path.join(cfg["path"]["preprocessed_path"], "speakers.json")) as f:
        n_speakers = len(json.load(f))
    n_layers = mcfg["transformer"]["encoder_layer"] + mcfg["transformer"]["decoder_layer"]
    n_dec = mcfg["transformer"]["decoder_layer"]
    inner = base["adapt"]["train"]["steps"]
    card = card_line()
    vocoder = Vocoder(mcfg, n_mels=80, device="cuda")

    def build(acfg, tcfg_, exp, seed=0):
        system = get_system(acfg["type"])(cfg, mcfg, tcfg_, acfg, stats,
                                          n_speakers=n_speakers, seed=seed, device="cuda")
        with torch.no_grad():   # random init predicts ~0 frames, as in _engine
            system.model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(2.0)
        dm = get_datamodule(acfg["type"])([cfg], tcfg_, acfg,
                                          log_dir=os.path.join(out_dir, "log", exp))
        dm.setup()
        # one frozen val task a speaker (the JAX package's default is 4; a depth cut)
        dm.val_sampler.prefetch_tasks(1, dm.log_dir, "val")
        return system, dm, Trainer(system, dm, tcfg_, output_dir=out_dir, exp_name=exp,
                                   vocoder=vocoder)

    # the baseline run: Trainer.fit at batch 80, every step's and every
    # validation task's flash launches counted, the optimizer kept at step 3
    system, dm, trainer = build(base, tcfg, "baseline")
    n_tasks = len(dm.val_sampler.labels)
    bn = {k: v.clone() for k, v in system.model.state_dict().items() if "running" in k}
    step_log, val_log, saved = [], [], []
    own_step, own_val = system.train_step, system.validation_step
    train_step = _counted(own_step, step_log)

    def step_and_keep(batch):
        losses = train_step(batch)
        if system.global_step == FIT_EVERY:
            saved.append(_opt_state(system))
        return losses
    system.train_step = step_and_keep
    system.validation_step = _counted(system.validation_step, val_log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counted
    A.flash_attention_fwd.launches = A.flash_attention_bwd.launches = 0
    fused_fft_block.launches = melspec.fused_mel_spectrogram.launches = 0
    _adam_zero()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _flash_counts()
    others = (fused_fft_block.launches, melspec.fused_mel_spectrogram.launches)
    adam_launches = _adam_check(system, FIT_STEPS, "[fit]", ADAM_BASE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    system.train_step, system.validation_step = own_step, own_val

    n_val = FIT_STEPS // FIT_EVERY
    per_step, per_task = (n_layers, n_layers), ((inner + 1) * n_layers, inner * n_dec)
    # each validation adds its first task's sample (the same adaptation and
    # query forward), each synth step a teacher-forced and a free forward
    want = (FIT_STEPS * n_layers + n_val * (n_tasks + 1) * per_task[0] + n_val * 2 * n_layers,
            FIT_STEPS * n_layers + n_val * (n_tasks + 1) * per_task[1])
    if not (step_log == [per_step] * FIT_STEPS and val_log == [per_task] * (n_val * n_tasks)
            and launches == want and others == (0, 0)):
        raise AssertionError(f"Trainer.fit launched flash (forward, backward) {step_log} per "
                             f"step, {val_log} per val task, {launches} in all, fused and "
                             f"mel {others}; want {per_step}, {per_task}, {want}, (0, 0)")
    log_dir = os.path.join(out_dir, "log", "baseline")
    with open(os.path.join(log_dir, "train.csv")) as f:
        rows = list(csv.reader(f))[1:]
    losses = [[float(v) for v in r[1:]] for r in rows]
    if [int(r[0]) for r in rows] != list(range(1, FIT_STEPS + 1)) or not all(
            math.isfinite(v) for r in losses for v in r):
        raise AssertionError(f"train.csv rows {rows}")
    moved = [k for k, v in bn.items() if not torch.equal(v, system.model.state_dict()[k])]
    if len(moved) != len(bn):
        raise AssertionError(f"the baseline steps moved {len(moved)} of {len(bn)} BatchNorm "
                             f"buffers")
    result = os.path.join(out_dir, "result", "baseline")
    ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt", "baseline")))
    want_ckpts = sorted(["last.ckpt"] + [f"step_{s}.ckpt"
                                         for s in range(FIT_EVERY, FIT_STEPS + 1, FIT_EVERY)])
    n_wavs = 0
    for s in range(FIT_EVERY, FIT_STEPS + 1, FIT_EVERY):
        for split, names in (("Validation", ("reconstructed", "synthesized")),
                             ("Training", ("recon", "synth"))):
            wavs = _wavs(os.path.join(result, "audio", split, "step_last", f"step_{s}"))
            if sorted(wavs) != [f"sample.{n}.wav" for n in names] or not all(
                    w.dtype == np.int16 and w.size > 0 for w in wavs.values()):
                raise AssertionError(f"{split} step {s}: wavs {[(k, w.size) for k, w in wavs.items()]}")
            n_wavs += len(wavs)
    val_csvs = sorted(os.listdir(os.path.join(result, "csv", "Validation", "step_last")))
    if ckpts != want_ckpts or val_csvs != [f"val_{i:03d}.csv" for i in range(n_tasks)]:
        raise AssertionError(f"checkpoints {ckpts}, val CSVs {val_csvs}")
    ev = _events(log_dir)
    print(f"[fit] Trainer.fit, baseline (base_emb_vad), base config, batch {B} drawn with "
          f"replacement from the corpus's {len(dm.train_set)} utterances, {FIT_STEPS} steps, "
          f"val / synth / save every {FIT_EVERY} ({n_tasks} val tasks, one a speaker): "
          f"{fit_s:.2f} s; flash launches {launches[0]} forward + {launches[1]} backward "
          f"({per_step} a step, {per_task} a val task); total loss "
          + ", ".join(f"{r[0]:.3f}" for r in losses)
          + f"; fused and mel launches {others}; {len(moved)} BatchNorm buffers moved; {ckpts}, {n_wavs} wavs, "
          f"{len(val_csvs)} val CSVs; the run's [profile]: step mean "
          f"{ev['profile/final_mean_ms']:.1f} ms, p95 {ev['profile/final_p95_ms']:.1f} ms, "
          f"e2e {ev['profile/e2e_steps_per_sec']:.3f} steps/s incl val/synth/ckpt; peak "
          f"memory {peak:.2f} GiB ({card})")

    # resume from step_3.ckpt: a second Trainer to step 6 (no validation)
    tcfg_r = copy.deepcopy(tcfg)
    tcfg_r["step"].update(val_step=10 * FIT_STEPS, synth_step=0)
    resumed, _, trainer_r = build(base, tcfg_r, "resume", seed=1)
    first, resumed_losses = [], []
    step_r = resumed.train_step

    def check_then_step(batch):
        if not first:
            first.append(_same_state(_opt_state(resumed), saved[0]))
        out = step_r(batch)
        resumed_losses.append(float(out.total))
        return out
    resumed.train_step = check_then_step
    trainer_r.fit(resume_from=os.path.join(out_dir, "ckpt", "baseline",
                                           f"step_{FIT_EVERY}.ckpt"))
    if not (first == [True] and len(resumed_losses) == FIT_STEPS - FIT_EVERY
            and all(math.isfinite(v) for v in resumed_losses)):
        raise AssertionError(f"the resumed run: state equal to the saved one {first}, "
                             f"losses {resumed_losses}")
    print(f"[fit] resumed from step_{FIT_EVERY}.ckpt: Adam moments, counts, global_step "
          f"and weights equal the run's at step {FIT_EVERY} bit for bit; total loss at steps "
          f"{FIT_EVERY + 1}-{FIT_STEPS} " + ", ".join(f"{v:.3f}" for v in resumed_losses))
    shutil.rmtree(os.path.join(out_dir, "ckpt"), ignore_errors=True)
    del resumed, trainer_r, saved

    # gradients of one batch-80 baseline step through the kernels against
    # the plain versions: bf16, and fp32 under deterministic algorithms
    batch = next(dm.train_batches(B))[0].to("cuda")
    seed = 4321

    def grad(sys_):
        sys_.model.train()
        params = sys_.params
        total, _ = sys_._supervised_loss(params, batch, seed, True)
        return dict(zip(params, torch.autograd.grad(total, list(params.values()),
                                                    allow_unused=True)))
    f0 = _flash_counts()
    g_k = through_flash(False, lambda: grad(system))
    grad_launches = tuple(b - a for a, b in zip(f0, _flash_counts()))
    g_p = through_flash(True, lambda: grad(system))
    system32 = get_system("baseline")(cfg, dict(mcfg, compute_dtype="float32",
                                                activation_dtype="float32",
                                                attention_scores_dtype="float32"),
                                      tcfg, base, stats, n_speakers=n_speakers, seed=0,
                                      device="cuda")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        g32_k = through_flash(False, lambda: grad(system32))
        g32_p = through_flash(True, lambda: grad(system32))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    del system32
    gap, gap32 = rel_l2(g_k, g_p), rel_l2(g32_k, g32_p)
    L_text, T_mel = batch.texts.shape[1], batch.mels.shape[1]
    print(f"[fit] gradient of one baseline step (B={B}, L={L_text}, T={T_mel}; flash at "
          f"BH={B * mcfg['transformer']['decoder_head']}), kernels vs plain versions: bf16 "
          f"rel L2 {gap:.3e} (tolerance {GRAD_TOL:g}), fp32 under deterministic algorithms "
          f"{gap32:.3e} (tolerance {GRAD_TOL_F32:g}); {grad_launches[0]} flash forward and "
          f"{grad_launches[1]} backward launches")
    print(f"[fit]   largest bf16 gaps: {top_gaps(g_k, g_p)}")
    if not (gap < GRAD_TOL and gap32 < GRAD_TOL_F32 and grad_launches == per_step
            and all(torch.isfinite(g).all() for g in g_k.values() if g is not None)):
        raise AssertionError("the baseline gradient through the kernels disagrees with "
                             "the plain versions")
    del g_k, g_p, g32_k, g32_p

    # the baseline step's time on one batch, then one profiled step
    timer = StepTimer()
    system.train_step(batch)
    torch.cuda.synchronize()
    for _ in range(FIT_TIMED):
        with timer:
            system.train_step(batch)
            torch.cuda.synchronize()
    st = timer.stats()
    frames = int(batch.mel_lens.sum())
    wall, events, attr = device_profile(lambda: system.train_step(batch))
    busy = sum(getattr(e, attr) for e in events) / 1e3
    flash = [e for e in events if any(n in e.key for n in FLASH_KERNELS)]
    flash_ms = sum(getattr(e, attr) for e in flash) / 1e3
    prof = (f"wall {wall:.1f} ms, device busy {busy:.1f} ms (kernel time summed), idle "
            f"share {max(0.0, 1 - busy / wall):.3f}; {sum(e.count for e in events)} kernel "
            f"launches; flash {flash_ms:.3f} ms ({100 * flash_ms / busy:.2f}%, "
            f"{sum(e.count for e in flash)} kernels)"
            if busy and flash else "not measured (no device time or no flash kernel in the "
            "trace)")
    print(f"[fit] BaselineSystem.train_step, B={B}, L={L_text}, T={T_mel} ({frames} mel "
          f"frames): mean {st['mean_ms']:.2f} ms, p95 {st['p95_ms']:.2f} ms over "
          f"{st['steps']} synchronised steps, {frames / st['mean_ms'] * 1e3:.1f} mel frames/s "
          f"({card}); profile of one step: {prof}")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:8]:
        print(f"[fit]   {getattr(e, attr) / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")
    del system, trainer, dm

    # the meta run: Trainer.fit of the meta system, validation at its end
    tcfg_m = copy.deepcopy(tcfg)
    tcfg_m["step"].update(total_step=META_FIT_STEPS, val_step=META_FIT_STEPS,
                          synth_step=META_FIT_STEPS, save_step=META_FIT_STEPS)
    msys, mdm, mtrainer = build(meta, tcfg_m, "meta")
    m_steps, m_vals = [], []
    msys.train_step = _counted(msys.train_step, m_steps)
    msys.validation_step = _counted(msys.validation_step, m_vals)
    t0 = time.perf_counter()
    mtrainer.fit()
    torch.cuda.synchronize()
    meta_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "log", "meta", "train.csv")) as f:
        mrows = list(csv.reader(f))[1:]
    n_mtasks = len(mdm.val_sampler.labels)
    if not (m_steps == [(META_FIT_EPISODES * n_layers,) * 2] * META_FIT_STEPS
            and m_vals == [per_task] * n_mtasks and len(mrows) == META_FIT_STEPS
            and all(math.isfinite(float(v)) for r in mrows for v in r[1:])
            and os.path.exists(os.path.join(out_dir, "ckpt", "meta",
                                            f"step_{META_FIT_STEPS}.ckpt"))):
        raise AssertionError(f"the meta run: launches {m_steps} a step, {m_vals} a val "
                             f"task, train.csv {mrows}")
    print(f"[fit] Trainer.fit, meta (meta_emb_vad), {META_FIT_EPISODES} episodes a step, "
          f"{META_FIT_STEPS} steps, validation at step {META_FIT_STEPS} ({n_mtasks} tasks): "
          f"{meta_s:.2f} s; flash {m_steps[0]} a step, {m_vals[0]} a val task; total loss "
          + ", ".join(f"{float(r[1]):.3f}" for r in mrows))
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches + others + (adam_launches,)


# ---------------------------------------------------------------- imaml

IMAML_CG_STEPS, IMAML_REG = 5, 0.5     # config/algorithm/imaml_emb_vad.yaml


def _deterministic(fn):
    """fn() under PyTorch's deterministic algorithms."""
    import torch
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def _fp32(mcfg):
    return dict(mcfg, compute_dtype="float32", activation_dtype="float32",
                attention_scores_dtype="float32")


def _train_workload(n_mels):
    """The train phase's episode (E=1, 5 + 5 utterances, L=128, T=896) on
    the card, from seed 0."""
    import numpy as np
    rng = np.random.RandomState(0)
    sup = episode_batch(rng, EPISODES, SHOTS, SRC_LEN, MEL_LEN, n_mels, N_SPEAKERS)
    qry = episode_batch(rng, EPISODES, QUERIES, SRC_LEN, MEL_LEN, n_mels, N_SPEAKERS)
    return sup.to("cuda"), qry.to("cuda")


def _profile_line(tag, fn):
    """One profiled call of fn: wall, device busy, idle share, launches and
    the flash kernels' share."""
    wall, events, attr = device_profile(fn)
    busy = sum(getattr(e, attr) for e in events) / 1e3
    flash = sum(getattr(e, attr) for e in events
                if any(n in e.key for n in FLASH_KERNELS)) / 1e3
    if busy == 0.0:
        return f"{tag}: no device time in the trace (not measured)"
    return (f"{tag}: wall {wall:.1f} ms, device busy {busy:.1f} ms (kernel time summed), "
            f"idle share {max(0.0, 1 - busy / wall):.3f}; {sum(e.count for e in events)} "
            f"kernel launches; flash {flash:.3f} ms")


def phase_imaml():
    """``IMAMLSystem.train_step`` at the base configuration's full width and
    depth with imaml_emb_vad's adapt settings on the train phase's
    workload; see the module docstring."""
    import copy
    import torch
    from metatts_torch import config as C
    from metatts_torch.algorithms.base import episode
    from metatts_torch.algorithms.imaml import IMAMLSystem
    from metatts_torch.ops import attention as A

    pcfg, mcfg, acfg = C.base_configs()          # meta_emb_vad's adapt block
    acfg.update(name="imaml_emb_vad", type="imaml")
    acfg["adapt"]["imaml"] = {"reg_param": IMAML_REG, "cg_steps": IMAML_CG_STEPS}
    acfg["adapt"]["train"].update(shots=SHOTS, queries=QUERIES, steps=INNER_STEPS)
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    n_mels = pcfg["preprocessing"]["mel"]["n_mel_channels"]
    sup, qry = _train_workload(n_mels)
    n_layers = mcfg["transformer"]["encoder_layer"] + mcfg["transformer"]["decoder_layer"]
    card = card_line()
    seed = 1234

    # the fp32 hypergradient through the kernels against the plain versions
    sys32 = IMAMLSystem(pcfg, _fp32(mcfg), tcfg, acfg, n_speakers=N_SPEAKERS, seed=0,
                        device="cuda")
    step32 = lambda: sys32._train_step(sup, qry, seed)
    loss_k, g_k = _deterministic(lambda: through_flash(False, step32))
    loss_p, g_p = _deterministic(lambda: through_flash(True, step32))
    _, g_p2 = _deterministic(lambda: through_flash(True, step32))
    gap, floor = rel_l2(g_k, g_p), rel_l2(g_p2, g_p)
    loss_gap = abs(float(loss_k.total) - float(loss_p.total)) / abs(float(loss_p.total))
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in g_p.values()))
    nonzero = sum(bool(g.abs().sum() > 0) for g in g_p.values())
    print(f"[imaml] fp32 hypergradient (deterministic algorithms, after the NaN-zeroing "
          f"and the clip at {tcfg['optimizer']['grad_clip_thresh']:g}: norm {norm:.4g}, "
          f"{nonzero} of {len(g_p)} tensors nonzero) "
          f"through the kernels' fp32 path vs the plain versions: rel L2 {gap:.3e} "
          f"(tolerance {IMAML_GRAD_TOL_F32:g}); the plain versions again {floor:.3e}; "
          f"query loss rel {loss_gap:.3e}")
    print(f"[imaml]   largest fp32 gaps: {top_gaps(g_k, g_p)}")
    # where such a gap comes from: the adapted modules' share (lr * reg * x,
    # 0 when CG's first step meets p'Ap <= 0 and freezes), the one-pass
    # query gradient's own gap on the same tensors, and the L1 mel losses'
    # residuals whose sign the kernels' rounding flips
    modules = acfg["adapt"]["modules"]
    adapted = [n for n in g_p if n.split(".")[0] in modules]
    others = [n for n in g_p if n.split(".")[0] not in modules]
    a_norm = math.sqrt(sum(float((g_p[n].double() ** 2).sum()) for n in adapted))
    q0 = episode(qry, 0)

    def query_grad():
        params = sys32.params
        total, _ = sys32._supervised_loss(params, q0, seed, True)
        return dict(zip(params, torch.autograd.grad(total, list(params.values()),
                                                    allow_unused=True)))

    def residuals():
        with torch.no_grad():
            out = sys32.adaptor.forward(sys32.params, q0, train=True, seed=seed)
            keep = out.mel_valid[..., None].expand_as(out.mel)
            tgt = q0.mels[:, :out.mel.shape[1]]
            return [(o - tgt)[keep] for o in (out.mel, out.postnet_mel)]

    _, g_e = _deterministic(lambda: with_einsum(sys32, step32))
    d_k = _deterministic(lambda: through_flash(False, query_grad))
    d_p = _deterministic(lambda: through_flash(True, query_grad))
    r_k = _deterministic(lambda: through_flash(False, residuals))
    r_p = _deterministic(lambda: through_flash(True, residuals))
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(r_k, r_p))
    print(f"[imaml]   the adapted modules' hypergradient norm {a_norm:.4g} (of "
          f"{len(adapted)} tensors); the one-pass fp32 query gradient, kernels vs plain: "
          f"rel L2 {rel_l2(d_k, d_p):.3e} over every tensor, "
          f"{rel_l2({n: d_k[n] for n in others}, {n: d_p[n] for n in others}):.3e} over "
          f"the {len(others)} frozen ones; L1 mel residuals of one query forward whose "
          f"sign the kernels flip: {flips} of {sum(r.numel() for r in r_p)}; the same "
          f"hypergradient with einsum attention on the query vs the plain versions "
          f"{rel_l2(g_e, g_p):.3e}")
    if not (gap < IMAML_GRAD_TOL_F32 and floor == 0.0 and loss_gap < 1e-5
            and all(torch.isfinite(g).all() for g in g_k.values())):
        raise AssertionError("the fp32 iMAML hypergradient through the kernels disagrees "
                             "with the plain versions")
    del sys32, g_k, g_p, g_p2, g_e, d_k, d_p
    check_imaml_cg()

    # the main path, counted: one warm-up step, then timed steps
    system = IMAMLSystem(pcfg, mcfg, tcfg, acfg, n_speakers=N_SPEAKERS, seed=0,
                         device="cuda")
    before = {n: p.detach().clone() for n, p in system.params.items()}
    system.train_step(sup, qry)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_attention_fwd.launches = A.flash_attention_bwd.launches = 0
    log, losses = [], []
    step = _counted(system.train_step, log)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        losses.append(step(sup, qry))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    launches = _flash_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = (EPISODES * n_layers, EPISODES * n_layers)
    if log != [want] * TIMED_STEPS:
        raise AssertionError(f"iMAML steps launched {log} flash forward / backward "
                             f"kernels, not {want} each")
    if not all(math.isfinite(float(v)) for l in losses for v in l):
        raise AssertionError(f"non-finite iMAML losses {losses}")
    # a CG step along negative curvature is frozen (alpha 0), which can leave
    # the adapted modules' hypergradient at 0: only the frozen ones then move
    moved = sum(not torch.equal(p, before[n]) for n, p in system.params.items())
    if not moved:
        raise AssertionError("no parameter moved")
    prof = _profile_line("profile of one step", lambda: system.train_step(sup, qry))
    print(f"[imaml] IMAMLSystem.train_step, base config, E={EPISODES}, {SHOTS} support + "
          f"{QUERIES} query, L={SRC_LEN}, T={MEL_LEN}, {INNER_STEPS} first-order inner "
          f"steps, {IMAML_CG_STEPS} CG steps, reg {IMAML_REG:g}: {ms:.2f} ms per step "
          f"(mean of {TIMED_STEPS}), peak memory {peak:.2f} GiB ({card}); flash "
          f"{log[0][0]} forward + {log[0][1]} backward a step; total loss "
          f"{', '.join(f'{float(l.total):.4f}' for l in losses)}; {moved} of {len(before)} "
          f"parameter tensors moved; {prof}")
    return launches


HVP_TIMED = 2         # meta steps timed in each HVP mode


def phase_hvp_fwd():
    """The train phase's meta step with ``model.hvp_mode="fwd"`` (one
    forward-mode JVP of the full support gradient per inner step) against
    ``"rev"``; see the module docstring."""
    import copy
    import torch
    from metatts_torch import config as C
    from metatts_torch.algorithms.meta import MetaSystem

    pcfg, mcfg, acfg = C.base_configs()
    acfg["adapt"]["train"].update(shots=SHOTS, queries=QUERIES, steps=INNER_STEPS)
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    sup, qry = _train_workload(pcfg["preprocessing"]["mel"]["n_mel_channels"])
    seed, card = 1234, card_line()

    def system(mode, fp32=False):
        m = dict(_fp32(mcfg) if fp32 else mcfg, hvp_mode=mode)
        return MetaSystem(pcfg, m, tcfg, acfg, n_speakers=N_SPEAKERS, seed=0, device="cuda")

    grads = {}
    for mode in ("rev", "fwd"):
        s = system(mode, fp32=True)
        grads[mode] = _deterministic(lambda: s._meta_train_step(sup, qry, seed))
        del s
    gap = rel_l2(grads["fwd"][1], grads["rev"][1])
    loss_gap = abs(float(grads["fwd"][0].total) - float(grads["rev"][0].total))
    print(f"[hvp_fwd] fp32 meta-gradient (deterministic algorithms), hvp_mode fwd vs rev: "
          f"rel L2 {gap:.3e} (tolerance {META_GRAD_TOL_F32:g}); query loss gap {loss_gap:.3e}")
    print(f"[hvp_fwd]   largest gaps: {top_gaps(grads['fwd'][1], grads['rev'][1])}")
    if not (gap < META_GRAD_TOL_F32 and loss_gap == 0.0
            and all(g is None or torch.isfinite(g).all() for g in grads["fwd"][1].values())):
        raise AssertionError("the forward-over-reverse HVP's meta-gradient disagrees with "
                             "the reverse-over-reverse one")
    del grads
    times = {}
    for mode in ("rev", "fwd"):
        s = system(mode)
        s.train_step(sup, qry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HVP_TIMED):
            s.train_step(sup, qry)
        torch.cuda.synchronize()
        times[mode] = 1e3 * (time.perf_counter() - t0) / HVP_TIMED
        del s
    print(f"[hvp_fwd] MetaSystem.train_step at the train phase's workload ({card}): "
          f"hvp_mode rev {times['rev']:.2f} ms, fwd {times['fwd']:.2f} ms per step (mean of "
          f"{HVP_TIMED} after one warm-up each, same call)")


# ---------------------------------------------------------------- dvec

META_MODULES = ("speaker_emb", "variance_adaptor", "decoder", "mel_linear", "postnet")
DVEC_QUERIES = 3     # 5 support + 3 query: the 8 utterances a speaker of the corpus has
DVEC_TEST_STEPS = [5, 10]     # the scratch_encoder test task's saving steps (a depth cut)


def phase_dvec(corpus):
    """The GE2E d-vector speaker modes on the preprocess phase's corpus
    with its reference slices; see the module docstring."""
    import copy
    import torch
    from metatts_torch import config as C
    from metatts_torch.algorithms.base import System, episode
    from metatts_torch.algorithms.meta import MetaSystem
    from metatts_torch.data.datamodule import MetaDataModule
    from metatts_torch.models.speaker_encoder import ge2e_dims
    from metatts_torch.ops.fftblock import fused_fft_block

    root, cfg, stats = corpus
    _, mcfg, _ = C.base_configs()
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    with open(os.path.join(cfg["path"]["preprocessed_path"], "speakers.json")) as f:
        n_speakers = len(json.load(f))
    n_layers = mcfg["transformer"]["encoder_layer"] + mcfg["transformer"]["decoder_layer"]
    n_dec = mcfg["transformer"]["decoder_layer"]
    card = card_line()
    modes = {   # config/algorithm/meta_encoder.yaml, dvec.yaml, scratch_encoder.yaml
        "encoder": META_MODULES, "dvec": META_MODULES[1:], "scratch_encoder": META_MODULES}

    def acfg_for(mode):
        acfg = C.deep_merge(C.ALGORITHM_DEFAULTS, C.META_EMB_VAD)
        acfg["name"] = {"encoder": "meta_encoder"}.get(mode, mode)
        acfg["adapt"].update(speaker_emb=mode, modules=list(modes[mode]))
        acfg["adapt"]["train"].update(queries=DVEC_QUERIES, meta_batch_size=EPISODES)
        return acfg

    def system_for(mode, cls=MetaSystem, fp32=False):
        sys_ = cls(cfg, _fp32(mcfg) if fp32 else mcfg, tcfg, acfg_for(mode), stats,
                   n_speakers=n_speakers, seed=0, device="cuda")
        with torch.no_grad():   # random init predicts ~0 frames, as in _engine
            sys_.model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(2.0)
        return sys_

    dm = MetaDataModule([cfg], tcfg, acfg_for("encoder"),
                        log_dir=os.path.join(root, "dvec", "log"), spk_refer_wav=True)
    dm.setup()
    sup, qry = (b.to("cuda") for b in next(dm.train_episode_batches(EPISODES))[:2])
    ref, valid = sup.speaker_args
    mel_c, hidden, _, layers = ge2e_dims(mcfg)
    shots = dm.acfg["adapt"]["train"]["shots"]
    if not (ref.shape[0] == EPISODES and ref.shape[1] == shots
            and tuple(ref.shape[3:]) == (160, mel_c) and valid.dtype == torch.bool
            and bool(valid[..., 0].all())):
        raise AssertionError(f"d-vector speaker args {tuple(ref.shape)}, {tuple(valid.shape)}")
    shape = (f"E={EPISODES}, {shots} + {DVEC_QUERIES} utterances, L={sup.texts.shape[-1]}, "
             f"T={sup.mels.shape[2]}, {ref.shape[2]} reference slices of 160 x {mel_c} "
             f"({int(valid.sum())} valid in the support), {layers} x LSTM-{hidden}")
    seed = 1234
    counts = [0, 0]

    # the encoder mode's fp32 meta-gradient through the kernels vs plain
    sys32 = system_for("encoder", fp32=True)
    meta32 = lambda: sys32._meta_train_step(sup, qry, seed)
    loss_k, g_k = _deterministic(lambda: through_flash(False, meta32))
    loss_p, g_p = _deterministic(lambda: through_flash(True, meta32))
    gap = rel_l2(g_k, g_p)
    loss_gap = abs(float(loss_k.total) - float(loss_p.total)) / abs(float(loss_p.total))
    lstm = [n for n in g_p if n.startswith("speaker_emb.")]
    print(f"[dvec] encoder mode, fp32 meta-gradient (deterministic algorithms) through "
          f"the kernels' fp32 path vs the plain versions: rel L2 {gap:.3e} (tolerance "
          f"{META_GRAD_TOL_F32:g}); query loss rel {loss_gap:.3e}; the GE2E network's "
          f"{len(lstm)} tensors' gradient norm "
          f"{math.sqrt(sum(float((g_p[n].double() ** 2).sum()) for n in lstm)):.4g}")
    if not (gap < META_GRAD_TOL_F32 and loss_gap < 1e-5 and lstm
            and all(g is None or torch.isfinite(g).all() for g in g_k.values())):
        raise AssertionError("the encoder mode's meta-gradient through the kernels "
                             "disagrees with the plain versions")
    del sys32, g_k, g_p

    # the main path of each mode, counted
    for mode in ("encoder", "dvec"):
        system = system_for(mode)
        before = {n: p.detach().clone() for n, p in system.params.items()}
        log = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = _counted(system.train_step, log)(sup, qry)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        changed = {n for n, p in system.params.items() if not torch.equal(p, before[n])}
        net = {n for n in before if n.startswith("speaker_emb.")}
        ok_net = not (changed & net) if mode == "dvec" else net <= changed
        if not (log == [(EPISODES * n_layers,) * 2] and ok_net and len(changed) > len(before) // 2
                and all(math.isfinite(float(v)) for v in losses)):
            raise AssertionError(f"{mode} step: launches {log}, {len(changed)} of "
                                 f"{len(before)} tensors moved, the network's "
                                 f"{len(changed & net)} of {len(net)}, losses {losses}")
        counts = [c + n for c, n in zip(counts, log[0])]
        print(f"[dvec] MetaSystem.train_step, {mode} mode (second order, {INNER_STEPS} "
              f"inner steps), {shape}: {ms:.2f} ms (the mode's first step, {card}); flash "
              f"{log[0][0]} + {log[0][1]}; total loss {float(losses.total):.4f}; "
              f"{len(changed)} of {len(before)} tensors moved, of the GE2E network's "
              f"{len(net)}: {len(changed & net)}")
        del system

    # one first-order test task in scratch_encoder mode
    system = system_for("scratch_encoder", cls=System)
    sup1, qry1 = episode(sup, 0), episode(qry, 0)
    log = []
    fused0 = fused_fft_block.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, snaps = _counted(system.test_adapt, log)(sup1, qry1, ft_steps=DVEC_TEST_STEPS)
    torch.cuda.synchronize()
    task_s = time.perf_counter() - t0
    n_steps = DVEC_TEST_STEPS[-1]
    fused = fused_fft_block.launches - fused0
    net = [n for n in snaps[0][1] if n.startswith("speaker_emb.")]
    if not (log == [(n_layers * n_steps, n_dec * n_steps)]
            and fused == n_layers * len(rows)
            and [ft for ft, _ in rows] == [0] + DVEC_TEST_STEPS
            and all(math.isfinite(float(v)) for _, l in rows for v in l)
            and not all(torch.equal(snaps[-1][1][n], snaps[0][1][n]) for n in net)):
        raise AssertionError(f"scratch_encoder test task: launches {log}, fused {fused}, "
                             f"rows {rows}")
    counts = [c + n for c, n in zip(counts, log[0])]
    print(f"[dvec] System.test_adapt, scratch_encoder mode (first order, {n_steps} steps, "
          f"evaluations at {[0] + DVEC_TEST_STEPS}): {task_s:.2f} s ({card}); flash "
          f"{log[0][0]} + {log[0][1]}, fused {fused}; query loss "
          + ", ".join(f"{float(l.total):.4f}" for _, l in rows))
    return tuple(counts)


# ---------------------------------------------------------------- lang

LANG_SPEAKERS = ("103", "1034", "1040", "1069")   # LibriTTS train-clean-100 speaker ids
LANG_SR_IN = 24000        # LibriTTS's rate; prepare_align resamples to the config's
LANG_EPISODES = 2         # meta_lang_codebook.yaml's meta_batch_size is 8: a depth cut
LANG_QUERIES = 3          # 5 support + 3 query: the 8 utterances a speaker of the corpus has
LANG_FIT_STEPS = 2
SSL_DIM = 256             # meta_lang_codebook.yaml's representation_dim (SSL features)
SSL_TIMED = 3             # steps timed with and without the codebook, interleaved


def make_libritts_corpus(root, seed=1):
    """The preprocess phase's corpus shape in LibriTTS's layout, from a
    seed: ``corpus/train-clean-100/<speaker>/<chapter>/<base>.wav`` at 24
    kHz with ``<base>.normalized.txt``, and the MFA-style TextGrids under
    ``pp/TextGrid``.  Returns (corpus dir, seconds of audio)."""
    import numpy as np
    from metatts_torch.preprocess.audio_io import save_wav
    rng = np.random.RandomState(seed)
    corpus = os.path.join(root, "corpus")
    lengths = rng.uniform(*PP_SPREAD_S, len(LANG_SPEAKERS) * PP_UTTERANCES)
    lengths *= PP_MEAN_S / lengths.mean()
    seconds = 0.0
    for s, spk in enumerate(LANG_SPEAKERS):
        chapter = str(1240 + s)
        d = os.path.join(corpus, "train-clean-100", spk, chapter)
        os.makedirs(d, exist_ok=True)
        for u in range(PP_UTTERANCES):
            base = f"{spk}_{chapter}_{u:06d}_000000"
            n = int(lengths[s * PP_UTTERANCES + u] * LANG_SR_IN)
            wav, intervals = _utterance(rng, n, LANG_SR_IN, 100.0 + 40.0 * s)
            save_wav(os.path.join(d, base + ".wav"), wav, LANG_SR_IN)
            with open(os.path.join(d, base + ".normalized.txt"), "w") as fh:
                fh.write(f"A synthetic sentence, number {u + 1}.\n")
            _textgrid(os.path.join(root, "pp", "TextGrid", spk, base + ".TextGrid"), intervals)
            seconds += n / LANG_SR_IN
    return corpus, seconds


def _picked_rows(att_banks, phn_ref):
    """The ``emb_banks`` rows the hard codebook picks for the non-zero,
    non-PAD rows of each episode's ``phn_ref``."""
    import torch
    picked = set()
    for ref in phn_ref:
        rows = torch.nonzero(ref.abs().sum(1) > 0).flatten()
        rows = rows[rows > 0]
        sim = (torch.nn.functional.normalize(ref[rows], dim=1)
               @ torch.nn.functional.normalize(att_banks, dim=1).T)
        picked |= set(sim.argmax(1).tolist())
    return sorted(picked)


def _flash_zero():
    from metatts_torch.ops import attention as A
    A.flash_attention_fwd.launches = A.flash_attention_bwd.launches = 0


def phase_lang():
    """Cross-lingual meta-training with the codebook phoneme embedding,
    from a raw LibriTTS-layout corpus; see the module docstring."""
    import copy
    import tempfile
    import numpy as np
    import torch
    from scipy.io import wavfile
    from metatts_torch import config as C
    from metatts_torch.__main__ import load_configs, main as cli_main, parse_args
    from metatts_torch.algorithms.meta import MetaSystem
    from metatts_torch.data.datamodule import MetaDataModule
    from metatts_torch.data.lang_episodes import episode_phoneme_representation
    from metatts_torch.ops import melspec
    from metatts_torch.preprocess.prepare_align import prepare_align
    from metatts_torch.preprocess.preprocessor import Preprocessor
    from metatts_torch.train import checkpoint as ck
    from metatts_torch.train import loop

    pcfg, mcfg, _ = C.base_configs()
    n_mels = pcfg["preprocessing"]["mel"]["n_mel_channels"]
    sr = pcfg["preprocessing"]["audio"]["sampling_rate"]
    acfg = C.load_algorithm_config(os.path.join(HERE, "config", "algorithm",
                                                "meta_lang_codebook.yaml"))
    # the built-in featurizer's phoneme-averaged log-mels are n_mels wide;
    # the config's 256 is the width of SSL features, which are not here
    acfg["adapt"]["phoneme_emb"]["representation_dim"] = n_mels
    acfg["adapt"]["train"].update(queries=LANG_QUERIES, meta_batch_size=LANG_EPISODES)
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    n_layers = mcfg["transformer"]["encoder_layer"] + mcfg["transformer"]["decoder_layer"]
    card = card_line()
    counts = [0, 0, 0]            # flash forward, flash backward, mel: the main path's
    root = tempfile.mkdtemp(prefix="lang_smoke_")
    try:
        # a raw corpus -> prepare_align -> Preprocessor with representations
        t0 = time.perf_counter()
        corpus, audio_s = make_libritts_corpus(root)
        write_s = time.perf_counter() - t0
        cfg = C.deep_merge(pcfg, {
            "dataset": "LibriTTS",
            "path": {"corpus_path": corpus, "raw_path": os.path.join(root, "raw"),
                     "preprocessed_path": os.path.join(root, "pp")},
            "preprocessing": {"representation": {"enabled": True}},
            "subsets": {"train": "train-clean-100", "val": "train-clean-100",
                        "test": "train-clean-100"}})
        t1 = time.perf_counter()
        n_utts = prepare_align(cfg)
        align_s = time.perf_counter() - t1
        n_want = len(LANG_SPEAKERS) * PP_UTTERANCES
        rate, first = wavfile.read(os.path.join(
            root, "raw", "train-clean-100", LANG_SPEAKERS[0],
            f"{LANG_SPEAKERS[0]}_1240_000000_000000.wav"))
        if not (n_utts == n_want and rate == sr and first.dtype == np.int16
                and int(np.abs(first).max()) == 32767):
            raise AssertionError(f"prepare_align wrote {n_utts} utterances; the first "
                                 f"at {rate} Hz, {first.dtype}, peak {np.abs(first).max()}")
        pre = Preprocessor(cfg, device="cuda")
        melspec.fused_mel_spectrogram.launches = 0
        t1 = time.perf_counter()
        lines = pre.build_from_path()["train-clean-100"]
        pp_s = time.perf_counter() - t1
        mel_launches = melspec.fused_mel_spectrogram.launches
        if mel_launches != len(lines) or len(lines) != n_want:
            raise AssertionError(f"{mel_launches} mel kernel launches for {len(lines)} "
                                 f"utterances written, {n_want} in the corpus")
        counts[2] += mel_launches
        for line in lines:
            base, spk, text, _ = line.split("|")
            rep = np.load(os.path.join(root, "pp", "representation",
                                       f"{spk}-representation-{base}.npy"))
            if not (rep.shape == (len(text.strip("{}").split()), n_mels)
                    and np.isfinite(rep).all()):
                raise AssertionError(f"{base}: representation {rep.shape}")
        sec = pre.seconds
        print(f"[lang] corpus: {len(LANG_SPEAKERS)} speakers x {PP_UTTERANCES} utterances "
              f"in LibriTTS's layout, {audio_s:.1f} s of audio at {LANG_SR_IN} Hz, written "
              f"in {write_s:.2f} s; prepare_align {align_s:.2f} s "
              f"({n_utts} utterances resampled to {sr} Hz); Preprocessor(device='cuda') "
              f"with representations {pp_s:.2f} s: {mel_launches} mel kernel launches for "
              f"{len(lines)} utterances; per stage s: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sec.items()))

        # language episodes
        with open(os.path.join(root, "pp", "stats.json")) as f:
            stats = json.load(f)
        dm = MetaDataModule([cfg], tcfg, acfg, log_dir=os.path.join(root, "log"))
        dm.setup()
        sup, qry, sup_m, qry_m, phn_ref = next(dm.train_episode_batches(LANG_EPISODES))
        index = {b: i for i, b in enumerate(dm.train_set.basename)}
        for e in range(LANG_EPISODES):
            sup_ids = set(sup.texts[e][sup.texts[e] > 0].tolist())
            qry_ids = set(qry.texts[e][qry.texts[e] > 0].tolist())
            host = episode_phoneme_representation(
                [dm.train_set[index[i]] for i in sup_m[e].ids])
            if not (qry_ids <= sup_ids and np.array_equal(phn_ref[e].numpy(), host)
                    and set(np.flatnonzero(np.abs(host).sum(1)).tolist()) == sup_ids):
                raise AssertionError(f"episode {e}: query phonemes {sorted(qry_ids - sup_ids)} "
                                     f"not in the support, or phn_ref is not the host's")
        shape = (f"E={LANG_EPISODES}, {sup.texts.shape[1]} + {qry.texts.shape[1]} utterances, "
                 f"L={sup.texts.shape[-1]}, T={sup.mels.shape[2]}")
        print(f"[lang] MetaDataModule language episodes ({shape}): every query phoneme in "
              f"its support; phn_ref {tuple(phn_ref.shape)} equals the host recomputation, "
              f"{int((phn_ref.abs().sum(-1) > 0).sum())} phoneme rows set")
        sup, qry, phn_ref = sup.to("cuda"), qry.to("cuda"), phn_ref.to("cuda")

        def system_for(acfg_, fp32=False, n_speakers=len(LANG_SPEAKERS)):
            return MetaSystem(cfg, _fp32(mcfg) if fp32 else mcfg, tcfg, acfg_, stats,
                              n_speakers=n_speakers, seed=0, device="cuda")

        # the fp32 meta-gradient, the codebook's included, kernels vs plain
        cb = "phn_emb_generator.emb_banks"
        seed = 1234
        sys32 = system_for(acfg, fp32=True)
        meta32 = lambda: sys32._meta_train_step(sup, qry, seed, phn_ref)
        (loss_k, g_k), (loss_p, g_p) = _deterministic(
            lambda: [through_flash(False, meta32), through_flash(True, meta32)])
        gap, gap_cb = rel_l2(g_k, g_p), rel_l2({cb: g_k[cb]}, {cb: g_p[cb]})
        loss_gap = abs(float(loss_k.total) - float(loss_p.total)) / abs(float(loss_p.total))
        picked = _picked_rows(sys32.params["phn_emb_generator.att_banks"].detach(), phn_ref)
        unpicked = sorted(set(range(g_k[cb].shape[0])) - set(picked))
        print(f"[lang] fp32 meta-gradient (deterministic algorithms) through the kernels' "
              f"fp32 path vs the plain versions: rel L2 {gap:.3e}, emb_banks {gap_cb:.3e} "
              f"(tolerance {META_GRAD_TOL_F32:g}); query loss rel {loss_gap:.3e}; "
              f"{len(picked)} of {g_k[cb].shape[0]} codebook rows picked, emb_banks "
              f"gradient norm {float(g_k[cb].norm()):.4g}")
        if not (gap < META_GRAD_TOL_F32 and gap_cb < META_GRAD_TOL_F32 and loss_gap < 1e-5
                and picked and unpicked
                and all(g is None or torch.isfinite(g).all() for g in g_k.values())
                and not g_k[cb][unpicked].any() and not g_p[cb][unpicked].any()
                and bool((g_k[cb][picked].abs().sum(1) > 0).all())
                and g_k["encoder.src_word_emb.weight"] is None):
            raise AssertionError("the lang meta-gradient through the kernels disagrees with "
                                 "the plain versions, or reaches the wrong codebook rows")
        del sys32, g_k, g_p

        # the main path: one meta step at base width, then a profiled one
        system = system_for(acfg)
        before = {n: p.detach().clone() for n, p in system.params.items()}
        picked = _picked_rows(system.params["phn_emb_generator.att_banks"].detach(), phn_ref)
        log = []
        torch.cuda.synchronize()
        _flash_zero()
        _adam_zero()
        t0 = time.perf_counter()
        losses = _counted(system.train_step, log)(sup, qry, phn_ref)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        _adam_check(system, 1, "[lang]")
        moved = (system.params[cb] != before[cb]).any(1)
        moved_rows = torch.nonzero(moved).flatten().tolist()
        if not (log == [(LANG_EPISODES * n_layers,) * 2] and moved_rows == picked
                and torch.equal(system.params["encoder.src_word_emb.weight"],
                                before["encoder.src_word_emb.weight"])
                and all(math.isfinite(float(v)) for v in losses)):
            raise AssertionError(f"lang step: launches {log}, codebook rows moved "
                                 f"{moved_rows}, picked {picked}, losses {losses}")
        counts = [c + n for c, n in zip(counts, log[0] + (0,))]
        log = []
        _flash_zero()
        prof = _profile_line("profiled step", lambda: _counted(system.train_step, log)(
            sup, qry, phn_ref))
        counts = [c + n for c, n in zip(counts, log[0] + (0,))]
        print(f"[lang] MetaSystem.train_step with the {acfg['adapt']['phoneme_emb']['size']}"
              f"-entry hard codebook, base config, {shape}, {INNER_STEPS} inner steps "
              f"(custom-HVP): {ms:.2f} ms (the first step, {card}); flash {log[0][0]} + "
              f"{log[0][1]} in the profiled step; {len(moved_rows)} codebook rows moved, the "
              f"picked ones; total loss {float(losses.total):.4f}; {prof}")
        del system

        # the config's representation_dim (SSL features) on the train
        # phase's episode shape, with phn_ref from a seed, against the same
        # meta step without the codebook, steps interleaved in one call
        acfg_ssl = copy.deepcopy(acfg)
        acfg_ssl["adapt"]["phoneme_emb"]["representation_dim"] = SSL_DIM
        acfg_spk = copy.deepcopy(acfg_ssl)
        acfg_spk["adapt"].update(type="spk", phoneme_emb={"type": "embedding",
                                                          "refresh": False})
        system = system_for(acfg_ssl, n_speakers=N_SPEAKERS)
        plain_sys = system_for(acfg_spk, n_speakers=N_SPEAKERS)
        sup_w, qry_w = _train_workload(n_mels)
        rng = np.random.RandomState(2)
        ref_w = np.zeros((EPISODES, 361, SSL_DIM), np.float32)
        for e in range(EPISODES):
            ids = np.unique(sup_w.texts[e].cpu().numpy())
            ref_w[e, ids[ids > 0]] = rng.randn(int((ids > 0).sum()), SSL_DIM)
        ref_w = torch.from_numpy(ref_w).cuda()
        before = system.params[cb].detach().clone()
        system.train_step(sup_w, qry_w, ref_w)                 # warm-up at this shape
        plain_sys.train_step(sup_w, qry_w)
        times, log = {"lang": [], "meta": []}, []
        for _ in range(SSL_TIMED):
            for tag, run in (("lang", lambda: _counted(system.train_step, log)(
                    sup_w, qry_w, ref_w)), ("meta", lambda: plain_sys.train_step(sup_w, qry_w))):
                torch.cuda.synchronize()
                if tag == "lang":
                    _flash_zero()
                t0 = time.perf_counter()
                losses = run()
                torch.cuda.synchronize()
                times[tag].append(1e3 * (time.perf_counter() - t0))
                if not all(math.isfinite(float(v)) for v in losses):
                    raise AssertionError(f"{tag} step: losses {losses}")
        if not (log == [(EPISODES * n_layers,) * 2] * SSL_TIMED
                and not torch.equal(system.params[cb], before)):
            raise AssertionError(f"representation_dim {SSL_DIM} steps: launches {log}")
        counts = [c + sum(n[i] for n in log) if i < 2 else c for i, c in enumerate(counts)]
        ms_lang, ms_meta = (sum(times[k]) / SSL_TIMED for k in ("lang", "meta"))
        print(f"[lang] MetaSystem.train_step at representation_dim {SSL_DIM}, the train "
              f"phase's episode (E={EPISODES}, {SHOTS} + {QUERIES} utterances, L={SRC_LEN}, "
              f"T={MEL_LEN}), {SSL_TIMED} steps interleaved with the same meta step without "
              f"the codebook ({card}): {ms_lang:.2f} ms against {ms_meta:.2f} ms, "
              f"{ms_lang / ms_meta:.3f}x (lang " + ", ".join(f"{t:.2f}" for t in times["lang"])
              + "; meta " + ", ".join(f"{t:.2f}" for t in times["meta"]) + f"); flash "
              f"{log[0][0]} + {log[0][1]} a step")
        del system, plain_sys

        # a short run through the CLI's entry point, then its checkpoint back
        import yaml
        files = {}
        for name, tree in (("pp", cfg), ("algorithm", acfg), ("train", {"step": {
                "total_step": LANG_FIT_STEPS, "log_step": 1, "val_step": 1000,
                "save_step": LANG_FIT_STEPS, "synth_step": 1000}})):
            files[name] = os.path.join(root, f"{name}.yaml")
            with open(files[name], "w") as f:
                yaml.safe_dump(tree, f)
        out = os.path.join(root, "out")
        args = parse_args(["-s", "train", "-p", files["pp"], "-m",
                           os.path.join(HERE, "config", "model", "base.yaml"), "-t",
                           os.path.join(HERE, "config", "train", "base.yaml"), files["train"],
                           "-a", files["algorithm"], "-e", "lang", "--output_dir", out,
                           "--no_synth"])
        runs, fit = [], loop.Trainer.fit

        def fit_and_keep(self, *a, **kw):
            runs.append({n: p.detach().clone() for n, p in self.system.params.items()
                         if n.startswith("phn_emb_generator.")})
            runs.append(fit(self, *a, **kw))
            return runs[-1]

        loop.Trainer.fit = fit_and_keep
        log = []
        try:
            torch.cuda.synchronize()
            _flash_zero()
            t0 = time.perf_counter()
            _counted(cli_main, log)(args, load_configs(args))
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        finally:
            loop.Trainer.fit = fit
        init, trained = runs
        want = LANG_FIT_STEPS * LANG_EPISODES * n_layers
        if log != [(want, want)]:
            raise AssertionError(f"-s train: flash launches {log}, not {want} each")
        counts = [c + n for c, n in zip(counts, log[0] + (0,))]
        fresh = MetaSystem(*load_configs(args), stats, n_speakers=len(LANG_SPEAKERS),
                           seed=7, device="cuda")
        opt_state, step, report = ck.load_checkpoint(
            os.path.join(out, "ckpt", "lang", "last.ckpt"), fresh.model)
        if report or opt_state is None or step != LANG_FIT_STEPS:
            raise AssertionError(f"last.ckpt: step {step}, report {report}")
        fresh.optimizer.load_state_tree(opt_state, fresh.model)
        same = all(torch.equal(fresh.params[n], trained.params[n])
                   and torch.equal(fresh.optimizer.mu[n], trained.optimizer.mu[n])
                   and torch.equal(fresh.optimizer.nu[n], trained.optimizer.nu[n])
                   for n in init)
        moved = [n for n in init if not torch.equal(trained.params[n], init[n])]
        if not (same and fresh.optimizer.count == trained.optimizer.count == LANG_FIT_STEPS
                and moved == [cb]
                and bool(trained.optimizer.mu[cb].any())):
            raise AssertionError(f"the codebook or its moments did not come back from "
                                 f"last.ckpt bit for bit, or moved {moved}")
        print(f"[lang] python -m metatts_torch -s train (meta_lang_codebook.yaml at "
              f"representation_dim {n_mels}, {LANG_EPISODES} episodes a step, base model and "
              f"train configs) for {LANG_FIT_STEPS} steps on the phase's corpus: "
              f"{fit_s:.1f} s with the checkpoints ({card}); flash {log[0][0]} + {log[0][1]}; "
              f"emb_banks moved; last.ckpt read back: the codebook, its Adam moments and "
              f"the count bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return tuple(counts)


# ---------------------------------------------------------------- eval

EVAL_NPZ = os.path.join(HERE, "examples", "meta_advantage_eer", "ge2e_scratch.npz")
EVAL_GE2E_STEPS = 20          # scratch GE2E steps on the card (a depth cut)
EVAL_GE2E_SPEAKERS = 4        # a batch's speakers: the corpus has 4 (the default is 8)
EVAL_GE2E_CHECK = 3           # its first losses held against the CPU
EVAL_TIMED_EVERY = 4          # every 4th of the 46 wavs timed a wav (a depth cut)
EVAL_DVEC_TOL = 1e-4          # d-vectors, card vs CPU, max abs
EVAL_REL_TOL = 1e-4           # scratch losses and scores, card vs CPU, relative
# wav2vec2-base (facebook/wav2vec2-base's config; convert_wav2vec2_pt's layout)
W2V2_BASE = dict(conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=128,
                 num_conv_pos_embedding_groups=16, num_attention_heads=12,
                 num_hidden_layers=12)
W2V2_KERNELS, W2V2_CONV, W2V2_HIDDEN, W2V2_FFN = (10, 3, 3, 3, 3, 2, 2), 512, 768, 3072


def _uniform(rng, shape, fan):
    import numpy as np
    return (rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)


def write_cnn_blstm_npz(path, seed):
    """Random MOSNet / MBNet mean-net weights at their published widths in
    the converters' layout (``tools/convert_torch_weights.py``
    ``convert_mosnet_h5`` / ``convert_mbnet_pt``: HWIO convs of 16-128
    channels, a Keras-layout BLSTM of 128 over 4 x 128 features, dense
    256 -> 128 -> 1)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    z, c_in = {}, 1
    for i in range(12):
        c_out = (16, 32, 64, 128)[i // 3]
        z[f"conv{i}.kernel"] = _uniform(rng, (3, 3, c_in, c_out), 9 * c_in)
        z[f"conv{i}.bias"] = _uniform(rng, (c_out,), 9 * c_in)
        c_in = c_out
    for d in ("fwd", "bwd"):
        z[f"blstm.{d}.kernel"] = _uniform(rng, (512, 512), 512)
        z[f"blstm.{d}.recurrent"] = _uniform(rng, (128, 512), 128)
        z[f"blstm.{d}.bias"] = _uniform(rng, (512,), 128)
    z["dense1.kernel"], z["dense1.bias"] = _uniform(rng, (256, 128), 256), _uniform(rng, (128,), 256)
    z["frame.kernel"], z["frame.bias"] = _uniform(rng, (128, 1), 128), _uniform(rng, (1,), 128)
    np.savez(path, **z)
    return path


def write_wav2vec2_npz(path, seed, head):
    """Random wav2vec2-base weights in ``convert_wav2vec2_pt``'s layout (the
    config as a JSON entry, WIO convs without bias, GroupNorm on conv 0,
    (in, out) linears, the positional conv's weight norm folded), with or
    without a (768, 1) regression head."""
    import numpy as np
    rng = np.random.RandomState(seed)
    C, H, F, K = W2V2_CONV, W2V2_HIDDEN, W2V2_FFN, W2V2_BASE["num_conv_pos_embeddings"]
    g = W2V2_BASE["num_conv_pos_embedding_groups"]
    z = {"config": np.asarray(json.dumps(W2V2_BASE))}
    c_in = 1
    for i, k in enumerate(W2V2_KERNELS):
        z[f"conv{i}.kernel"] = _uniform(rng, (k, c_in, C), k * c_in)
        c_in = C
    norms = {"conv0.gn": C, "fp_ln": C, "enc_ln": H}
    z["proj.kernel"], z["proj.bias"] = _uniform(rng, (C, H), C), _uniform(rng, (H,), C)
    z["pos_conv.kernel"] = _uniform(rng, (K, H // g, H), K * H // g)
    z["pos_conv.bias"] = _uniform(rng, (H,), K * H // g)
    for i in range(W2V2_BASE["num_hidden_layers"]):
        for nm in ("q", "k", "v", "out"):
            z[f"layer{i}.attn.{nm}.kernel"] = _uniform(rng, (H, H), H)
            z[f"layer{i}.attn.{nm}.bias"] = _uniform(rng, (H,), H)
        z[f"layer{i}.ff_in.kernel"] = _uniform(rng, (H, F), H)
        z[f"layer{i}.ff_in.bias"] = _uniform(rng, (F,), H)
        z[f"layer{i}.ff_out.kernel"] = _uniform(rng, (F, H), F)
        z[f"layer{i}.ff_out.bias"] = _uniform(rng, (H,), F)
        norms.update({f"layer{i}.ln": H, f"layer{i}.final_ln": H})
    for name, d in norms.items():
        z[f"{name}.scale"] = (1 + 0.1 * rng.randn(d)).astype(np.float32)
        z[f"{name}.bias"] = (0.1 * rng.randn(d)).astype(np.float32)
    if head:
        z["head.kernel"], z["head.bias"] = _uniform(rng, (H, 1), H), _uniform(rng, (1,), H)
    np.savez(path, **z)
    return path


def _pair_tolerance(card_cache, cpu_cache):
    """The EER/AUC tolerance of the card's rows against the CPU's, from the
    real speakers' d-vectors both runs cached: one pair's step, 1 / min(#same
    pairs, #different pairs), for each pair the card's rounding can reorder
    against a pair of the other class (a score within twice the largest
    card-vs-CPU score gap of one of the other class), plus one.  Where no
    pair is that close this is one pair's step.  -> (tolerance, score gap,
    pairs that can reorder, pairs)."""
    import numpy as np
    from metatts_torch.evaluation.similarity import pair_similarity

    def groups(cache):
        return {os.path.basename(f)[len("real_"):-len("_dvector.npy")]: np.load(f)
                for f in sorted(glob.glob(os.path.join(cache, "real_*_dvector.npy")))}
    (s_card, d_card), (s_cpu, d_cpu) = (pair_similarity(groups(c))
                                        for c in (card_cache, cpu_cache))
    gap = max(np.abs(s_card - s_cpu).max(), np.abs(d_card - d_cpu).max())

    def near(a, b):
        b = np.sort(b)
        lo = np.searchsorted(b, a - 2 * gap, side="left")
        return int((np.searchsorted(b, a + 2 * gap, side="right") > lo).sum())
    k = near(s_cpu, d_cpu) + near(d_cpu, s_cpu)
    n = min(len(s_cpu), len(d_cpu))
    return (k + 1) / n, float(gap), k, len(s_cpu) + len(d_cpu)


def _rows_close(card, cpu, tol, tag):
    """eer.txt rows of the card against the CPU's: the same labels, EER /
    AUC rows within ``tol`` (``_pair_tolerance``), centroid similarities
    within two units of their 4th decimal, NaN where the other is NaN."""
    if [r[0] for r in card] != [r[0] for r in cpu]:
        raise AssertionError(f"[eval] {tag}: labels {card} vs {cpu}")
    worst = 0.0
    for (label, a), (_, b) in zip(card, cpu):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            if not (math.isnan(a) and math.isnan(b)):
                raise AssertionError(f"[eval] {tag}: {label} {a} vs {b}")
            continue
        row_tol = 2e-4 if "_centroid" in label else tol
        worst = max(worst, abs(a - b))
        if abs(a - b) > row_tol:
            raise AssertionError(f"[eval] {tag}: {label} card {a} vs CPU {b} "
                                 f"(tolerance {row_tol:g})")
    return worst


def phase_eval(corpus):
    """Offline evaluation of the test phase's result tree and the corpus's
    real wavs through ``python -m metatts_torch.evaluate``'s functions; see
    the module docstring."""
    import tempfile
    import warnings
    import numpy as np
    import torch
    from metatts_torch.evaluate import discover_ft_steps, mos_rows, run_matrix
    from metatts_torch.evaluation import mos as M
    from metatts_torch.evaluation.dvector import DVectorEncoder
    from metatts_torch.evaluation.ge2e_scratch import (save_ge2e_npz, train_ge2e,
                                                       utterance_partial)
    from metatts_torch.evaluation.mbnet import MBNetMean
    from metatts_torch.evaluation.mosnet import MOSNet
    from metatts_torch.evaluation.wav2vec2 import Wav2Vec2Scorer, encode
    from metatts_torch.preprocess.audio_io import load_wav

    root = corpus[0]
    card = card_line()
    real_dir = os.path.join(root, "raw", "train")
    tree = os.path.join(root, "test_stage", "result", "seq")
    descs = glob.glob(os.path.join(root, "test_stage", "log", "test_descriptions.json"))
    ft_steps = discover_ft_steps(tree, "step_last")
    real = sorted(glob.glob(os.path.join(real_dir, "*", "*.wav")))
    synth = sorted(glob.glob(os.path.join(tree, "audio", "Testing", "step_last", "*", "*.wav")))
    if not (len(real) == PP_SPEAKERS * PP_UTTERANCES and synth and descs and ft_steps):
        raise AssertionError(f"[eval] inputs: {len(real)} real wavs, {len(synth)} test wavs, "
                             f"descriptions {descs}, FT steps {ft_steps}")
    matrix = {"corpus": "smoke", "real_dir": real_dir, "n_sample": PP_UTTERANCES,
              "step_list": ["step_last"], "ft_step_list": ft_steps,
              "modes": {"seq": {"dir": tree, "descriptions": descs[0]}}}
    wavs = [load_wav(f) for f in real + synth]
    timed = wavs[::EVAL_TIMED_EVERY]
    check = [load_wav(f) for f in (real[0], synth[0], synth[-1])]
    work = tempfile.mkdtemp(prefix="eval_smoke_")
    try:
        # the scratch GE2E, trained on the card on the corpus's partials
        by_spk = {}
        for f in real:
            by_spk.setdefault(os.path.basename(os.path.dirname(f)), []).append(
                utterance_partial(*load_wav(f)))
        partials = {s: np.stack(p) for s, p in by_spk.items()}
        kw = dict(n_speakers_per_batch=EVAL_GE2E_SPEAKERS, m_utts_per_speaker=4, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, trace = train_ge2e(partials, steps=EVAL_GE2E_STEPS, device="cuda", **kw)
        torch.cuda.synchronize()
        ge2e_s = (time.perf_counter() - t0) / EVAL_GE2E_STEPS
        _, trace_cpu = train_ge2e(partials, steps=EVAL_GE2E_CHECK, device="cpu", **kw)
        gaps = [abs(a - b) / abs(b) for a, b in zip(trace, trace_cpu)]
        scratch = save_ge2e_npz(params, os.path.join(work, "ge2e_scratch_smoke.npz"))
        print(f"[eval] scratch GE2E at resemblyzer's width (3 x LSTM-256, 40 mel) on the "
              f"corpus's {len(real)} partials, {EVAL_GE2E_SPEAKERS} speakers x 4 a batch: "
              f"{EVAL_GE2E_STEPS} steps, {ge2e_s:.4f} s a step ({card}); loss "
              f"{trace[0]:.4f} -> {min(trace):.4f} (best); first {EVAL_GE2E_CHECK} losses "
              f"card vs CPU rel {max(gaps):.3e} (tolerance {EVAL_REL_TOL:g})")
        if not (len(trace) == EVAL_GE2E_STEPS and all(map(math.isfinite, trace))
                and len(gaps) == EVAL_GE2E_CHECK and max(gaps) < EVAL_REL_TOL):
            raise AssertionError(f"[eval] scratch GE2E: card {trace[:EVAL_GE2E_CHECK]} vs "
                                 f"CPU {trace_cpu}")

        # d-vectors and eer.txt rows, three encoders
        for tag, weights in (("random", None), ("ge2e_scratch.npz", EVAL_NPZ),
                             ("scratch", scratch)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # the random init's warning
                enc = DVectorEncoder(weights, require_weights=weights is not None,
                                     device="cuda")
                enc_cpu = DVectorEncoder(weights, device="cpu")
                t0 = time.perf_counter()
                rows = run_matrix(matrix, out=os.path.join(work, tag), dvector_weights=weights,
                                  device="cuda")
                matrix_s = time.perf_counter() - t0
                with contextlib.redirect_stdout(io.StringIO()):    # printed by the card's
                    rows_cpu = run_matrix(matrix, out=os.path.join(work, tag + "_cpu"),
                                          dvector_weights=weights, device="cpu")
            enc.embed_utterance(*wavs[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for w in timed:
                enc.embed_utterance(*w)
            dvec_s = (time.perf_counter() - t0) / len(timed)
            vecs = [enc.embed_utterance(*w) for w in wavs[:4] + wavs[-2:]]
            _, events, _ = device_profile(lambda: enc.embed_utterance(*wavs[0]))
            launches = sum(e.count for e in events if not e.key.startswith(("Memcpy", "Memset")))
            gap = max(float(np.abs(enc_cpu.embed_utterance(*w) - v).max())
                      for w, v in zip(wavs[:4] + wavs[-2:], vecs))
            tol, score_gap, n_near, n_pairs = _pair_tolerance(
                os.path.join(work, tag, "cache"), os.path.join(work, tag + "_cpu", "cache"))
            worst = _rows_close(rows, rows_cpu, tol, tag)
            real_row = [float(v) for label, v in rows if label == "real"]
            nan_rows = [label for label, v in rows if math.isnan(float(v))]
            width = enc.net.linear.weight.shape[0]
            print(f"[eval] d-vectors, {tag} GE2E (embed {width}, calibrated "
                  f"{enc.calibrated}): {dvec_s:.4f} s a wav over {len(timed)} wavs, "
                  f"{launches} kernel launches a wav ({wavs[0][0].size / wavs[0][1]:.2f} s of "
                  f"audio), "
                  f"run_matrix {matrix_s:.2f} s ({card}); card vs CPU d-vectors max abs "
                  f"{gap:.3e} (tolerance {EVAL_DVEC_TOL:g}), pair scores {score_gap:.3e}; "
                  f"rows worst {worst:.4g} (EER tolerance {tol:.4g}: {n_near} of {n_pairs} "
                  f"pairs within twice that score gap of a pair of the other class, "
                  f"plus one); real EER {real_row}")
            if not (gap < EVAL_DVEC_TOL and len(real_row) == 1
                    and math.isfinite(real_row[0]) and len(vecs[0]) == width
                    and all(np.isfinite(v).all() for v in vecs)):
                raise AssertionError(f"[eval] {tag}: d-vectors {gap}, rows {rows}")
            if nan_rows:
                print(f"[eval]   NaN rows (a speaker group of the test tree holds one wav, so "
                      f"it forms no same-speaker pair, as in the JAX package; not a "
                      f"failure): {', '.join(nan_rows)}")

        # MOS scorers at their published widths on random weights
        paths = {"mosnet": write_cnn_blstm_npz(os.path.join(work, "mosnet.npz"), 1),
                 "mbnet": write_cnn_blstm_npz(os.path.join(work, "mbnet.npz"), 2),
                 "w2v2_head": write_wav2vec2_npz(os.path.join(work, "w2v2_head.npz"), 3, True),
                 "w2v2": write_wav2vec2_npz(os.path.join(work, "w2v2.npz"), 3, False)}
        for w2v2, want in (("w2v2_head", ["mbnet", "mosnet", "spectral_proxy", "wav2vec2"]),
                           ("w2v2", ["spectral_proxy", "wav2vec2"])):
            if w2v2 == "w2v2":      # the headless wav2vec2 again, without the CNN-BLSTMs
                for name in ("mbnet", "mosnet"):
                    M._SCORERS.pop(name)
            t0 = time.perf_counter()
            rows = mos_rows(real_dir, tree, "step_last", PP_UTTERANCES * PP_SPEAKERS,
                            mosnet_weights=paths["mosnet"] if len(want) == 4 else None,
                            mbnet_weights=paths["mbnet"] if len(want) == 4 else None,
                            wav2vec2_weights=paths[w2v2], out_dir=None, device="cuda")
            rows_s = time.perf_counter() - t0
            names = M.available_scorers()
            vals = [float(v.split()[0]) for _, v in rows]
            if names != want or len(rows) != len(names) * (2 + len(ft_steps)) or not all(
                    map(math.isfinite, vals)):
                raise AssertionError(f"[eval] mos_rows ({w2v2}): {names}, {rows}")
            print(f"[eval] mos_rows with wav2vec2 {'with' if w2v2 == 'w2v2_head' else 'without'}"
                  f" a head: {len(rows)} rows in {rows_s:.2f} s ({card}): "
                  + "; ".join(f"{label} {v}" for label, v in rows))
        scorers = {"mosnet": lambda d: MOSNet(paths["mosnet"], device=d),
                   "mbnet": lambda d: MBNetMean(paths["mbnet"], device=d),
                   "wav2vec2 (head)": lambda d: Wav2Vec2Scorer(paths["w2v2_head"], device=d),
                   "wav2vec2 (proxy)": lambda d: Wav2Vec2Scorer(paths["w2v2"], device=d)}
        audio_s = sum(w.size / sr for w, sr in timed) / len(timed)
        for name, make in scorers.items():
            scorer, scorer_cpu = make("cuda"), make("cpu")
            scorer.score(*wavs[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for w in timed:
                scorer.score(*w)
            per_wav = (time.perf_counter() - t0) / len(timed)
            got = [scorer.score(*w) for w in check]
            want = [scorer_cpu.score(*w) for w in check]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            print(f"[eval] {name}: {per_wav:.4f} s a wav over {len(timed)} wavs (mean "
                  f"{audio_s:.2f} s of audio; {card}); card vs CPU on {len(check)} wavs rel "
                  f"{rel:.3e} (tolerance {EVAL_REL_TOL:g}); scores {[f'{g:.5f}' for g in got]}")
            if not (rel < EVAL_REL_TOL and all(map(math.isfinite, got))):
                raise AssertionError(f"[eval] {name}: card {got} vs CPU {want}")
            if name == "wav2vec2 (proxy)":
                # the norm proxy saturates at 5 (the last LayerNorm's output
                # norm is ~sqrt(768)), so hold the hidden states themselves
                x = torch.from_numpy(np.asarray(check[0][0][None], np.float32))
                with torch.no_grad():
                    h = encode(scorer.params, x.to(scorer.device)).cpu()
                    h_cpu = encode(scorer_cpu.params, x)
                h_rel = float((h - h_cpu).abs().max() / h_cpu.abs().max())
                print(f"[eval]   wav2vec2-base hidden states {tuple(h.shape)}, card vs CPU "
                      f"rel {h_rel:.3e} (tolerance {EVAL_REL_TOL:g})")
                if not h_rel < EVAL_REL_TOL:
                    raise AssertionError(f"[eval] wav2vec2 hidden states rel {h_rel}")
            del scorer, scorer_cpu
        t0 = time.perf_counter()
        for w in timed:
            M.score("spectral_proxy", *w)
        print(f"[eval] spectral_proxy (host numpy): "
              f"{(time.perf_counter() - t0) / len(timed):.4f} s a wav over {len(timed)} wavs")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- synth_eer

# examples/meta_advantage_eer/results.json's config (the JAX run: hidden 32,
# 1 layer, 8 mels, 4 episodes of 5 + 5, 5 inner steps at lr 1e-3), cut in
# depth (PERF.md section 4)
EER_RUN = dict(outer_steps=4, n_train=8, n_test=2, n_mels=8, hidden=32, layers=1,
               saving_steps=(5, 10), episodes_per_speaker=1, eval_queries=4,
               ge2e_hidden=128, ge2e_steps=10, enroll_utts=4, gl_iters=8)
EER_META_BATCH = 4
EER_WIDE = dict(hidden=256, n_mels=80)    # one step of each arm and a test task
JAX_EER = os.path.join(HERE, "examples", "meta_advantage_eer")


def _launch_counts():
    from metatts_torch.ops import attention as A
    from metatts_torch.ops.fftblock import fused_fft_block
    return (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches,
            fused_fft_block.launches)


@contextlib.contextmanager
def _instrumented(targets, log):
    """Within the block, each ``(owner, attribute, tag)`` of ``targets``
    appends ``(seconds, (flash fwd, flash bwd, fused) launches)`` of every
    call to ``log[tag]``, synchronised on both sides."""
    import torch
    saved = []
    for owner, name, tag in targets:
        fn = getattr(owner, name)

        def run(*a, _fn=fn, _tag=tag, **kw):
            torch.cuda.synchronize()
            c0, t0 = _launch_counts(), time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            log.setdefault(_tag, []).append(
                (time.perf_counter() - t0, tuple(b - a for a, b in zip(c0, _launch_counts()))))
            return out
        saved.append((owner, name, fn))
        setattr(owner, name, run)
    try:
        yield log
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _eer_labels(path):
    with open(path) as f:
        return [line.split()[0] for line in f if len(line.split()) == 2]


def _first_step_gap(kind, mcfg_args, cudnn):
    """The rel L2 gap between the first outer step's gradient of arm
    ``kind`` on the card (cuDNN's convolutions, or PyTorch's own where
    ``cudnn`` is false) and on the CPU, from the same weights and draw, in
    fp32, dropout off, deterministic algorithms; and both total losses."""
    import copy
    import numpy as np
    import torch
    from metatts_torch.algorithms import get_system
    from metatts_torch.data.synthetic import STATS, SyntheticVoices
    from metatts_torch.experiments.meta_advantage import _configs
    from metatts_torch.models import nn as L
    n_spk = EER_RUN["n_train"] + EER_RUN["n_test"]
    pcfg, mcfg, tcfg, acfg = _configs(*mcfg_args, hidden=EER_RUN["hidden"])
    acfg["type"] = kind
    corpus = SyntheticVoices(n_spk, n_mels=EER_RUN["n_mels"], seed=0)
    rng = np.random.RandomState(1)     # run_experiment's data stream, seed 0
    spk = rng.choice(range(EER_RUN["n_train"]), size=EER_META_BATCH, replace=False)
    sup, qry = corpus.meta_batch(spk, 5, 5, rng)
    batch = corpus.batch(list(rng.choice(range(EER_RUN["n_train"]), size=EER_META_BATCH * 10)),
                         rng)
    out = []
    dropout, L.dropout = L.dropout, lambda x, rate, train, generator: x
    try:
        for device in ("cuda", "cpu"):
            s = get_system(kind)(pcfg, copy.deepcopy(mcfg), tcfg, copy.deepcopy(acfg),
                                 stats=STATS, n_speakers=n_spk, seed=7, device=device)
            seed = s.next_rng()

            def step():
                if kind == "meta":
                    return s._meta_train_step(sup.to(device), qry.to(device), seed)
                s.model.train()
                params = s.params
                total, losses = s._supervised_loss(params, batch.to(device), seed, True,
                                                   update_bn_state=True)
                return losses, dict(zip(params, torch.autograd.grad(
                    total, list(params.values()), allow_unused=True)))
            torch.backends.cudnn.enabled = cudnn or device == "cpu"
            try:
                with _cudnn_in_steps() if cudnn else contextlib.nullcontext():
                    losses, g = _deterministic(step)
            finally:
                torch.backends.cudnn.enabled = True
            out.append((float(losses.total),
                        {n: v.detach().cpu() for n, v in g.items() if v is not None}))
    finally:
        L.dropout = dropout
    return rel_l2(out[0][1], out[1][1]), out[0][0], out[1][0]


def phase_synth_eer():
    """The meta-vs-baseline EER experiment on the card; see the module
    docstring."""
    import copy
    import tempfile
    import numpy as np
    import torch
    from metatts_torch.algorithms import get_system
    from metatts_torch.algorithms.base import System
    from metatts_torch.algorithms.baseline import BaselineSystem
    from metatts_torch.algorithms.meta import MetaSystem
    from metatts_torch.data.synthetic import STATS, SyntheticMelVocoder, SyntheticVoices
    from metatts_torch.experiments import meta_advantage as MA
    from metatts_torch.experiments import meta_eer as ME
    from metatts_torch.experiments.meta_advantage import _configs

    card = card_line()
    nl, n_dec = 2 * EER_RUN["layers"], EER_RUN["layers"]
    steps, rows = max(EER_RUN["saving_steps"]), len(EER_RUN["saving_steps"]) + 1
    mcfg_args = (EER_RUN["n_mels"], 5, 1e-3, 1e-3, EER_META_BATCH, 5, 5, EER_RUN["saving_steps"])

    # the first outer step of each arm, card against CPU, held with
    # PyTorch's own CUDA convolutions: at this init the meta-gradient moves
    # by 4e-5 with the CPU's thread count alone, and by 6.3e-4 where cuDNN
    # picks its fp32 convolution algorithms (PERF.md section 6), which is
    # printed beside it
    for kind in ("meta", "baseline"):
        gap, card_loss, cpu_loss = _first_step_gap(kind, mcfg_args, cudnn=False)
        gap_cudnn = _first_step_gap(kind, mcfg_args, cudnn=True)[0]
        print(f"[synth_eer] first {kind} step at the JAX run's width, fp32, dropout off, "
              f"deterministic algorithms: gradient card vs CPU rel L2 {gap:.3e} (tolerance "
              f"{META_GRAD_TOL_F32:g}; {gap_cudnn:.3e} with cuDNN's convolutions, not held); "
              f"total loss {card_loss:.7f} vs {cpu_loss:.7f}")
        if not (gap < META_GRAD_TOL_F32
                and abs(card_loss - cpu_loss) <= META_GRAD_TOL_F32 * abs(cpu_loss)):
            raise AssertionError(f"the first {kind} step on the card disagrees with the CPU")

    # the main path: the whole experiment at the cut depth, counted
    work = tempfile.mkdtemp(prefix="synth_eer_smoke_")
    log = {}
    targets = [(MetaSystem, "train_step", "meta"), (BaselineSystem, "train_step", "baseline"),
               (System, "test_adapt", "test_task"), (ME, "_synthesize", "synth"),
               (SyntheticMelVocoder, "__call__", "vocoder")]
    try:
        _flash_zero()
        from metatts_torch.ops.fftblock import fused_fft_block
        fused_fft_block.launches = 0
        t0 = time.perf_counter()
        get_system_ = MA.get_system

        def seeded(kind):
            # a duration bias of log 3 (~2 frames a phone): after 4 outer
            # steps the predictor gives 0 frames, an empty wav, which has no
            # d-vector
            def build(*a, **kw):
                s = get_system_(kind)(*a, **kw)
                with torch.no_grad():
                    s.model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
                        math.log(3.0))
                return s
            return build
        MA.get_system = seeded
        try:
            with _instrumented(targets, log):
                result = ME.run_eer_experiment(out_dir=work, device="cuda", verbose=True,
                                               meta_batch=EER_META_BATCH, **EER_RUN)
        finally:
            MA.get_system = get_system_
        wall = time.perf_counter() - t0
        total = _launch_counts()
        with open(os.path.join(JAX_EER, "results.json")) as f:
            jax_result = json.load(f)
        with open(os.path.join(work, "loss_results.json")) as f:
            traces = json.load(f)["traces"]
        with open(os.path.join(work, "timing.json")) as f:
            stages = json.load(f)
        fts = {str(ft) for ft in (0,) + tuple(EER_RUN["saving_steps"])}
        want_labels = [lab for lab in _eer_labels(os.path.join(JAX_EER, "eval", "eer.txt"))
                       if "FTstep" not in lab or lab.split("FTstep")[1].split("_")[0] in fts]
        got_labels = _eer_labels(os.path.join(work, "eval", "eer.txt"))
        values = [result["real_eer"]] + list(result["recon_eer"].values()) + [
            v for t in result["eer_table"].values() for v in t.values()] + [
            d["mean"] for s in result["loss_summary"].values() for d in s.values()]
        tree = [os.path.join(work, "result", arm, "audio", "Testing", "step_last",
                             f"test_{i:03d}", f"qry{j:02d}.{tag}.wav")
                for arm in ("meta", "baseline") for i in range(EER_RUN["n_test"])
                for j in range(EER_RUN["eval_queries"])
                for tag in ["recon"] + [f"step_last-FTstep_{ft}.synth"
                                        for ft in (0,) + EER_RUN["saving_steps"]]]
        tree += [os.path.join(work, n) for n in (
            "ckpt_meta.msgpack", "ckpt_baseline.msgpack", "ge2e_scratch.npz", "matrix.yaml",
            os.path.join("log", "meta", "test_descriptions.json"),
            os.path.join("log", "baseline", "test_descriptions.json"))]
        missing = [p for p in tree if not os.path.exists(p)]
        if not (result.keys() == jax_result.keys()
                and result["config"].keys() == jax_result["config"].keys()
                and got_labels == want_labels and not missing
                and all(v is not None and math.isfinite(v) for v in values)):
            raise AssertionError(f"[synth_eer] keys {sorted(result)}, labels {got_labels}, "
                                 f"missing {missing[:4]}, values {values}")

        # launches: every call of each kind, then the whole run
        expect = {"meta": (EER_META_BATCH * nl, EER_META_BATCH * nl, 0),
                  "baseline": (nl, nl, 0),
                  "test_task": (nl * steps + nl * rows, n_dec * steps, 0),
                  "synth": (nl, 0, 0)}
        for tag, want in expect.items():
            got = {c for _, c in log[tag]}
            if got != {want}:
                raise AssertionError(f"[synth_eer] {tag} launches {got}, expected {want}")
        probes = sum(len(traces[f"{arm}_plain"]) for arm in ("meta", "baseline"))
        summed = [sum(c[i] for tag in expect for _, c in log[tag]) + (probes * nl if i == 0 else 0)
                  for i in range(3)]
        if list(total) != summed:
            raise AssertionError(f"[synth_eer] run launches {total}, the calls' {summed}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    mean = lambda tag: 1e3 * sum(t for t, _ in log[tag]) / len(log[tag])
    n_wavs = sum(1 for _ in log["vocoder"])
    print(f"[synth_eer] run_eer_experiment at the JAX run's widths ({EER_RUN}), {wall:.1f} s "
          f"({card}): meta step {mean('meta'):.1f} ms ({len(log['meta'])} steps, flash "
          f"{log['meta'][0][1][:2]} a step), baseline step {mean('baseline'):.1f} ms "
          f"(flash {log['baseline'][0][1][:2]}), test task {mean('test_task'):.1f} ms "
          f"({steps} steps: {mean('test_task') / steps:.2f} ms a step with its "
          f"{rows} evaluations; flash {log['test_task'][0][1][:2]}), a synthesis forward "
          f"{mean('synth'):.2f} ms, a vocoder call {mean('vocoder'):.1f} ms "
          f"({n_wavs} calls); run launches flash {total[0]} + {total[1]}, fused {total[2]}")
    print(f"[synth_eer] stage seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    print(f"[synth_eer] EER at the cut depth (not a result): "
          + "; ".join(f"{arm} " + " ".join(f"{ft}:{v:.4f}" for ft, v in t.items())
                      for arm, t in result["eer_table"].items())
          + f"; real {result['real_eer']:.4f}")
    counts = list(total)

    # one step of each arm and one test task with synthesis at hidden 256,
    # 80 mels: flash at d_k 128, every evaluation and synthesis fused
    wide_args = (EER_WIDE["n_mels"],) + mcfg_args[1:]
    pcfg, mcfg, tcfg, acfg = _configs(*wide_args, hidden=EER_WIDE["hidden"])
    corpus = SyntheticVoices(10, n_mels=EER_WIDE["n_mels"], seed=0)
    rng = np.random.RandomState(1)
    sup, qry = corpus.meta_batch(rng.choice(range(8), size=EER_META_BATCH, replace=False),
                                 5, 5, rng, "cuda")
    batch = corpus.batch(list(rng.choice(range(8), size=EER_META_BATCH * 10)), rng, "cuda")
    wide_log = {}
    work = tempfile.mkdtemp(prefix="synth_eer_wide_")
    try:
        systems = {}
        for kind in ("meta", "baseline"):
            a = dict(acfg, type=kind)
            systems[kind] = get_system(kind)(pcfg, copy.deepcopy(mcfg), tcfg, a, stats=STATS,
                                             n_speakers=10, seed=7, device="cuda")
        with torch.no_grad():   # random init predicts ~0 frames, as in _engine
            systems["baseline"].model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(2.0)
        voc = SyntheticMelVocoder(n_mels=EER_WIDE["n_mels"], n_iters=EER_RUN["gl_iters"],
                                  device="cuda")
        episode = corpus.episode(8, 5, EER_RUN["eval_queries"], rng, "cuda")
        with _instrumented(targets, wide_log):
            systems["meta"].train_step(sup, qry)      # the first step: lazy initialisation
            systems["meta"].train_step(sup, qry)
            systems["baseline"].train_step(batch)
            systems["baseline"].train_step(batch)
            ME._synthesize_result_tree(systems["baseline"], voc, [episode], work,
                                       os.path.join(work, "log"), [8], verbose=False)
        wavs = glob.glob(os.path.join(work, "audio", "Testing", "step_last", "test_000", "*.wav"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    expect = {"meta": (EER_META_BATCH * nl, EER_META_BATCH * nl, 0), "baseline": (nl, nl, 0),
              "test_task": (nl * steps, n_dec * steps, nl * rows), "synth": (0, 0, nl)}
    for tag, want in expect.items():
        got = {c for _, c in wide_log[tag]}
        if got != {want}:
            raise AssertionError(f"[synth_eer] hidden 256: {tag} launches {got}, expected {want}")
    if len(wavs) != EER_RUN["eval_queries"] * (rows + 1):
        raise AssertionError(f"[synth_eer] hidden 256: {len(wavs)} wavs")
    wide_counts = [sum(c[i] for tag in expect for _, c in wide_log[tag]) for i in range(3)]
    print(f"[synth_eer] hidden 256, 2 heads, 80 mels ({card}): meta step "
          f"{1e3 * wide_log['meta'][1][0]:.1f} ms (first {1e3 * wide_log['meta'][0][0]:.1f}), "
          f"baseline step {1e3 * wide_log['baseline'][1][0]:.1f} ms, test task "
          f"{wide_log['test_task'][0][0]:.2f} s ({steps} steps, {rows} fused evaluations), "
          f"synthesis forward {1e3 * wide_log['synth'][-1][0]:.2f} ms, vocoder call "
          f"{1e3 * wide_log['vocoder'][-1][0]:.1f} ms ({EER_RUN['eval_queries']} wavs); "
          f"launches flash {wide_counts[0]} + {wide_counts[1]}, fused {wide_counts[2]}")
    return tuple(c + w for c, w in zip(counts, wide_counts))


# ---------------------------------------------------------- meta_drift

DRIFT_RUN = dict(n_train=32, n_test=8, n_mels=8, hidden=32, layers=1, seed=0)  # the JAX run's
DRIFT_WARM = 50           # outer steps of run_experiment's meta arm on the card first
DRIFT_STEPS = 10          # then outer steps held card against CPU
DRIFT_FACTOR, DRIFT_FLOOR = 10.0, 1e-7


def _cpu_mask_dropout(x, rate, train, generator):
    """``models.nn.dropout`` with its keep mask drawn on the CPU from a
    generator seeded as the one it is given, then moved to ``x``'s device:
    on the CPU the port's own masks, on the card the same masks."""
    import torch
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    g = torch.Generator().manual_seed(generator.initial_seed())
    mask = (torch.rand(x.shape, generator=g) < keep).to(x.device)
    scale = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def _snapshot(system):
    """A meta system's configs and state on the CPU: weights and BatchNorm
    buffers, Adam's moments and count, the step and the seed chain."""
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    return dict(cfgs=(system.pcfg, system.mcfg, system.tcfg, system.acfg, system.stats,
                      system.model.speaker_emb.model.weight.shape[0]),
                model=cpu(system.model.state_dict()), mu=cpu(system.optimizer.mu),
                nu=cpu(system.optimizer.nu), count=system.optimizer.count,
                step=system.global_step, rng=system._rng.get_state())


def _restore(snap, device):
    """The meta system of a ``_snapshot`` on ``device``."""
    import copy
    from metatts_torch.algorithms.meta import MetaSystem
    pcfg, mcfg, tcfg, acfg, stats, n_speakers = snap["cfgs"]
    s = MetaSystem(pcfg, copy.deepcopy(mcfg), tcfg, copy.deepcopy(acfg), stats=stats,
                   n_speakers=n_speakers, seed=7, device=device)
    s.model.load_state_dict({k: v.to(device) for k, v in snap["model"].items()})
    s.optimizer.mu = {n: t.to(device).clone() for n, t in snap["mu"].items()}
    s.optimizer.nu = {n: t.to(device).clone() for n, t in snap["nu"].items()}
    s.optimizer.count, s.global_step = snap["count"], snap["step"]
    s._rng.set_state(snap["rng"])
    return s


def drift_cpu(state, out):
    """The ``meta_drift`` phase's CPU trajectory at 1 thread, in a process
    of its own (``chip_smoke.py --drift-cpu <state> <out>``), so that it
    runs beside the card's and the all-thread one."""
    import torch
    sys.path.insert(0, HERE)
    from metatts_torch.models import nn as L
    torch.set_num_threads(1)
    snap = torch.load(state, weights_only=False)
    L.dropout = _cpu_mask_dropout
    t0 = time.perf_counter()
    traj = _trajectory(_restore(snap, "cpu"), snap["episodes"], "cpu")
    torch.save((traj, time.perf_counter() - t0), out)


def _trajectory(system, episodes, device):
    """``DRIFT_STEPS`` outer steps (``train_step``'s two halves, so that the
    gradient is kept): per step (total loss, meta-gradient, weights) on the
    CPU."""
    out = []
    for sup, qry in episodes:
        losses, grads = system._meta_train_step(sup.to(device), qry.to(device),
                                                system.next_rng())
        system.apply_updates(grads)
        out.append((float(losses.total),
                    {n: g.detach().cpu() for n, g in grads.items() if g is not None},
                    {n: p.detach().cpu().clone() for n, p in system.params.items()}))
    return out


def drift_start():
    """Start the ``meta_drift`` phase's work (``drift_run``) in a process of
    its own, beside the phases that follow; ``phase_meta_drift`` collects
    it.  Returns (the process, its work directory, its start time)."""
    import tempfile
    work = tempfile.mkdtemp(prefix="meta_drift_")
    with open(os.path.join(work, "log.txt"), "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--meta-drift",
                                 work], stdout=log, stderr=subprocess.STDOUT)
    return proc, work, time.perf_counter()


def drift_run(work):
    """The ``meta_drift`` phase's work (``chip_smoke.py --meta-drift
    <work>``): the meta arm of ``run_experiment`` trained ``DRIFT_WARM``
    outer steps on the card, then ``DRIFT_STEPS`` more on the card, on the
    CPU at the machine's thread count and, in a process of its own, at 1
    thread, from the same state and on the same episodes, with the CPU's
    dropout masks on every side; the trajectories go to ``<work>/result.pt``."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from metatts_torch.experiments import meta_advantage as MA
    from metatts_torch.models import nn as L
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = MA.run_experiment(outer_steps=DRIFT_WARM, saving_steps=(1,), episodes_per_speaker=1,
                            eval_queries=2, log_every=DRIFT_WARM, verbose=False,
                            algorithms=("meta",), keep_systems=True, device="cuda", **DRIFT_RUN)
    warm_s = time.perf_counter() - t0
    system, corpus = out["_systems"]["meta"], out["_corpus"]
    rng = np.random.RandomState(DRIFT_RUN["seed"] + 11)
    episodes = [corpus.meta_batch(rng.choice(out["_train_speakers"], size=EER_META_BATCH,
                                             replace=False), 5, 5, rng)
                for _ in range(DRIFT_STEPS)]
    snap = _snapshot(system)
    state, traj_1 = os.path.join(work, "state.pt"), os.path.join(work, "cpu1.pt")
    torch.save(dict(snap, episodes=episodes), state)
    L.dropout = _cpu_mask_dropout
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--drift-cpu", state,
                             traj_1])
    try:
        t1 = time.perf_counter()
        on_card = _trajectory(system, episodes, "cuda")
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        again = _trajectory(_restore(snap, "cpu"), episodes, "cpu")
        cpu_n_s = time.perf_counter() - t1
        if proc.wait(timeout=900):
            raise AssertionError(f"[meta_drift] the 1-thread CPU run failed ({proc.returncode})")
        on_cpu, cpu_s = torch.load(traj_1, weights_only=False)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    torch.save(dict(card=on_card, cpu_1=on_cpu, cpu_n=again, warm_s=warm_s, card_s=card_s,
                    cpu_s=cpu_s, cpu_n_s=cpu_n_s, threads=torch.get_num_threads()),
               os.path.join(work, "result.pt"))


def phase_meta_drift(started):
    """The card's meta-training trajectory against the CPU's at the EER
    experiment's config, from the process ``drift_start`` started; see the
    module docstring."""
    import torch
    proc, work, t0 = started
    card = card_line()
    try:
        if proc.wait(timeout=900):
            with open(os.path.join(work, "log.txt")) as f:
                print(f.read()[-4000:])
            raise AssertionError(f"[meta_drift] its process failed ({proc.returncode})")
        r = torch.load(os.path.join(work, "result.pt"), weights_only=False)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    threads = r["threads"]
    print(f"[meta_drift] the meta arm of run_experiment at the JAX run's config "
          f"({DRIFT_RUN}, 4 episodes of 5 + 5, 5 inner steps, fp32) after {DRIFT_WARM} outer "
          f"steps on the card ({r['warm_s']:.1f} s, {card}), then {DRIFT_STEPS} outer steps on "
          f"the card, on the CPU at 1 thread and at {threads}, from the same state, on the same "
          f"episodes, dropout on with the CPU's masks ({r['card_s']:.1f} / {r['cpu_s']:.1f} / "
          f"{r['cpu_n_s']:.1f} s; the 1-thread run in a process of its own beside the other "
          f"two; all in a process beside the eval to ddp phases, "
          f"{time.perf_counter() - t0:.1f} s from its start to here):")
    bad = []
    for k, ((lc, gc, pc), (l1, g1, p1), (ln, gn, pn)) in enumerate(
            zip(r["card"], r["cpu_1"], r["cpu_n"])):
        gap, noise = rel_l2(pc, p1), rel_l2(pn, p1)
        bound = DRIFT_FACTOR * max(noise, DRIFT_FLOOR)
        print(f"[meta_drift]   step {DRIFT_WARM + k + 1}: weights rel L2 card vs CPU {gap:.3e}, "
              f"CPU {threads} vs 1 thread {noise:.3e} (bound {bound:.3e}); meta-gradient "
              f"{rel_l2(gc, g1):.3e}, {rel_l2(gn, g1):.3e}; total loss card {lc:.6f}, "
              f"CPU {l1:.6f} / {ln:.6f}")
        if not (gap <= bound and math.isfinite(lc)):
            bad.append(DRIFT_WARM + k + 1)
    if len(r["card"]) != DRIFT_STEPS or bad:
        raise AssertionError(f"[meta_drift] the card's weights leave {DRIFT_FACTOR:g}x the "
                             f"CPU's own gap at steps {bad}")


# ---------------------------------------------------------------- ddp

DDP_WORLD = 2
DDP_CASES = ("meta", "baseline", "imaml")
DDP_TOL = 2e-4            # tests/test_parallel.py's loss rtol and parameter atol
DDP_L, DDP_T = 32, 256    # symbols and mel frames of an utterance


def _ddp_batches():
    """(support, query) of 2 episodes of 2 + 2 utterances, and a flat batch
    of 4 whose halves hold different numbers of valid frames and symbols."""
    import numpy as np
    from metatts_torch.data.collate import map_batch
    rng = np.random.RandomState(0)
    n_mels = 80
    sup = episode_batch(rng, DDP_WORLD, 2, DDP_L, DDP_T, n_mels, N_SPEAKERS)
    qry = episode_batch(rng, DDP_WORLD, 2, DDP_L, DDP_T, n_mels, N_SPEAKERS)
    flat = map_batch(lambda t: t[0].clone(), episode_batch(rng, 1, 4, DDP_L, DDP_T, n_mels,
                                                           N_SPEAKERS))
    flat.d_targets[2:, :] = 0
    flat.d_targets[2:, :DDP_L // 2] = 1
    flat.src_lens[2:] = DDP_L // 2
    flat.mel_lens[2:] = DDP_L // 2
    return sup, qry, flat


def ddp_case(case, distributed, cudnn=True):
    """One training step of ``case`` at the base configuration in fp32,
    under deterministic algorithms, on the card, with cuDNN's convolutions
    or (``cudnn`` false) PyTorch's own; sharded over the process group when
    ``distributed``.  Returns (total loss, name -> parameter on the CPU,
    flash launches, name -> the optimizer's gradient on the CPU)."""
    import copy
    import torch
    from metatts_torch import config as C
    from metatts_torch.algorithms import get_system
    pcfg, mcfg, acfg = C.base_configs()
    acfg = C.deep_merge(acfg, {"type": case, "adapt": {"train": {
        "shots": 2, "queries": 2, "meta_batch_size": DDP_WORLD}}})
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    system = get_system(case)(pcfg, _fp32(mcfg), tcfg, acfg, n_speakers=N_SPEAKERS,
                              seed=0, device="cuda")
    if distributed and system.enable_distributed() is None:
        raise AssertionError("enable_distributed found no process group")
    sup, qry, flat = _ddp_batches()
    grads, apply = {}, system.apply_updates

    def record(g):      # the gradient the optimizer gets (summed over ranks)
        grads.update({n: v.detach().cpu() for n, v in g.items() if v is not None})
        _adam_zero()
        apply(g)
        _adam_check(system, 1, f"[ddp] {case}", ADAM_BASE_LAUNCHES)
    system.apply_updates = record
    _flash_zero()
    args = (flat,) if case == "baseline" else (sup, qry)
    torch.backends.cudnn.enabled = cudnn
    try:
        with _cudnn_in_steps() if cudnn else contextlib.nullcontext():
            losses = _deterministic(lambda: system.train_step(*args))
    finally:
        torch.backends.cudnn.enabled = True
    return (float(losses.total), {n: p.detach().cpu() for n, p in system.params.items()},
            _launch_counts()[:2], grads)


def ddp_rank(rank, store, out):
    """One of the ``ddp`` phase's ranks: gloo over a file store, the card
    as device 0 (NCCL refuses two ranks on one device)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=DDP_WORLD)
    try:
        torch.save({(case, cudnn): ddp_case(case, True, cudnn) for case in DDP_CASES
                    for cudnn in (True, False)}, out)
    finally:
        dist.destroy_process_group()


def phase_ddp():
    """Two ranks on the one card over gloo against one process; see the
    module docstring."""
    import tempfile
    import torch
    card = card_line()
    work = tempfile.mkdtemp(prefix="ddp_smoke_")
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-rank",
                                   str(r), os.path.join(work, "store"),
                                   os.path.join(work, f"rank{r}.pt")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for r in range(DDP_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"[ddp] rank {r} exited {p.returncode}:\n{text[-3000:]}")
        ranks_s = time.perf_counter() - t0
        got = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(DDP_WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # loss and parameters held with cuDNN's convolutions and with PyTorch's
    # own; the gradient with PyTorch's own, since at this init the
    # gradient amplifies the rounding of cuDNN's batch-size-dependent
    # algorithm choice (a rank convolves half the batch), which is printed
    counts = [0, 0]
    n_layers = 10
    for case in DDP_CASES:
        g_gaps = {}
        for cudnn in (True, False):
            t0 = time.perf_counter()
            want_loss, want_params, _, want_grads = ddp_case(case, False, cudnn)
            one_s = time.perf_counter() - t0
            for r, res in enumerate(got):
                loss, params, launches, grads = res[(case, cudnn)]
                gap = max(float((params[n] - want_params[n]).abs().max()) for n in want_params)
                g_gap = rel_l2(grads, want_grads)
                g_gaps[cudnn] = max(g_gaps.get(cudnn, 0.0), g_gap)
                if not (abs(loss - want_loss) <= DDP_TOL * abs(want_loss) and gap <= DDP_TOL
                        and grads.keys() == want_grads.keys()
                        and (cudnn or g_gap <= DDP_TOL)
                        and launches == (n_layers, n_layers)):
                    raise AssertionError(
                        f"[ddp] {case} rank {r} (cuDNN {cudnn}): loss {loss} vs {want_loss}, "
                        f"parameters max abs {gap:.3e}, gradient rel L2 {g_gap:.3e} "
                        f"({top_gaps(grads, want_grads)}), launches {launches}")
                counts = [c + n for c, n in zip(counts, launches)]
            if not all(torch.equal(got[0][(case, cudnn)][1][n], got[1][(case, cudnn)][1][n])
                       for n in want_params):
                raise AssertionError(f"[ddp] {case} (cuDNN {cudnn}): the ranks' parameters differ")
        print(f"[ddp] {case} step, base width fp32, {DDP_WORLD} ranks over gloo on one card vs "
              f"one process ({card}): loss {got[0][(case, False)][0]:.6f} vs {want_loss:.6f}, "
              f"parameters max abs {max(float((got[0][(case, False)][1][n] - want_params[n]).abs().max()) for n in want_params):.3e}, "
              f"the optimizer's gradient rel L2 {g_gaps[False]:.3e} (tolerance {DDP_TOL:g}; "
              f"{g_gaps[True]:.3e} with cuDNN's convolutions, not held); ranks identical; "
              f"flash a rank {got[0][(case, False)][2]} a step; one process {one_s:.1f} s")
    print(f"[ddp] both ranks, start to end: {ranks_s:.1f} s; NCCL across cards is not "
          f"exercised here (one card)")
    return tuple(counts)


def with_time(phase, note=""):
    """One phase, with its wall time (and ``note`` after it)."""
    t0 = time.perf_counter()
    out = phase()
    print(f"[time] {getattr(phase, 'func', phase).__name__[len('phase_'):]}: "
          f"{time.perf_counter() - t0:.1f} s{note}")
    return out


CONTENDED = " (contended: beside meta_drift's processes)"


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "metatts_torch")):
        print("chip_smoke: the metatts_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # cuBLAS's setting for deterministic algorithms (the train phase's fp32
    # meta-gradient check), read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with_time(phase_build)
    with_time(phase_tf32)          # at PyTorch's default flags
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = with_time(phase_kernel)
    flash = with_time(phase_flash)
    mel = with_time(phase_mel)
    adam_entry = with_time(phase_adam)
    mel_launches, corpus = with_time(phase_preprocess)
    try:
        launches = with_time(phase_serve)
        flash_launches = with_time(phase_train)
        imaml_launches = with_time(phase_imaml)
        with_time(phase_hvp_fwd)
        test_launches = with_time(functools.partial(phase_test, corpus))
        drift = drift_start()
        print("[meta_drift] started: the phases eval, fit, dvec, lang, synth_eer and ddp run "
              "beside its processes (the card, a host thread each, and for ~1 minute all of "
              "the host's threads), so their timings are contended and not comparable with a "
              "run in which they run alone; their [time] lines say so")
        try:
            with_time(functools.partial(phase_eval, corpus), CONTENDED)
            fit_launches = with_time(functools.partial(phase_fit, corpus), CONTENDED)
            dvec_launches = with_time(functools.partial(phase_dvec, corpus), CONTENDED)
            lang_launches = with_time(phase_lang, CONTENDED)
            eer_launches = with_time(phase_synth_eer, CONTENDED)
            ddp_launches = with_time(phase_ddp, CONTENDED)
            with_time(functools.partial(phase_meta_drift, drift))
        finally:
            if drift[0].poll() is None:
                drift[0].kill()
                drift[0].wait()
            shutil.rmtree(drift[1], ignore_errors=True)
    finally:
        shutil.rmtree(corpus[0], ignore_errors=True)

    k = kern[(8, 1000)]
    entry = {
        "name": "fused_fft_block", "route": "cuda",
        "source": "metatts_torch/csrc/fftblock.cu",
        "replaces": "metatts_tpu/ops/pallas/fftblock.py:93",
        "launches": launches,
        **{n: k[n] for n in ("max_abs_err", "max_rel_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "device_ms", "ms_bf16",
                             "composite_ms", "stages_ms")},
        "library_ms": None,
        "test_launches": test_launches[2], "fit_launches": fit_launches[2],
        "synth_eer_launches": eer_launches[2],
        "shape": "B=8 T=1000 D=256 H=2 F=1024 K=9 fp32 in/out",
        **{f"{n}_{B}x{T}": kern[(B, T)][n] for B, T in ((1, 1000), (8, 160), (8, 64))
           for n in ("ms", "device_ms", "bound_ms")},
    }
    main_shape, text_shape = flash[FLASH_SHAPES[0]], flash[FLASH_SHAPES[1]]
    wide = {"bh160": flash[FLASH_SHAPES[3]], "bh160_t128": flash[FLASH_SHAPES[4]],
            "f32_t77": flash[FLASH_SHAPES[2]], "f32_eer_t48": flash[FLASH_SHAPES[5]],
            "f32_eer_t16": flash[FLASH_SHAPES[6]]}
    entries = [entry]
    for i, (name, line) in enumerate((("flash_attention_fwd", 95),
                                      ("flash_attention_bwd", 129))):
        way = "fwd" if i == 0 else "bwd"
        entries.append({
            "name": name, "route": "cuda",
            "source": "metatts_torch/csrc/flash_attention.cu",
            "replaces": f"metatts_tpu/ops/pallas/attention.py:{line}",
            "launches": flash_launches[i], "test_launches": test_launches[i],
            "fit_launches": fit_launches[i], "imaml_launches": imaml_launches[i],
            "dvec_launches": dvec_launches[i], "lang_launches": lang_launches[i],
            "synth_eer_launches": eer_launches[i], "ddp_launches": ddp_launches[i],
            **main_shape[way],
            "shape": "BH=10 T=896 D=128 bf16",
            **{f"{n}_t128": text_shape[way][n]
               for n in ("ms", "device_ms", "bound_ms", "library_ms")},
            **{f"{n}_{tag}": shape[way][n] for tag, shape in wide.items()
               for n in ("ms", "device_ms", "bound_ms", "library_ms")},
        })
    entries.append({
        "name": "fused_mel_spectrogram", "route": "cuda",
        "source": "metatts_torch/csrc/melspec.cu",
        "replaces": "metatts_tpu/ops/pallas/melspec.py:81",
        "launches": mel_launches, "fit_launches": fit_launches[3],
        "lang_launches": lang_launches[2], **mel[MEL_SHAPES[0]],
        "shape": "B=16 T=220500 n_fft=1024 hop=256 mels=80 fp32",
        **{k + "_b1": mel[MEL_SHAPES[1]][k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms")},
    })
    entries.append({**adam_entry, "launches": flash_launches[2],
                    "fit_launches": fit_launches[4]})
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:     # a rank of the ddp phase
        ddp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--meta-drift"]:   # the meta_drift phase's work
        drift_run(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--drift-cpu"]:    # its 1-thread CPU run
        drift_cpu(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
