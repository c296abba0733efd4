#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. build   -- compiles ``metatts_torch/csrc/fftblock.cu``,
              ``flash_attention.cu`` and ``melspec.cu`` (with the shared
              ``hopper.cuh``) for sm_90a, one nvcc each, and the native
              F0/FLAC library (``csrc/world.cpp``, ``csrc/flac.cpp``, g++),
              all in parallel;
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
              slice's shapes, bf16 (BH=10, D=128, T=896 and T=128) and a
              ragged fp32 case (T=77), then in bf16 at T=1000 (the serving
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
              PyTorch's default algorithms);
              ms per step, mel frames/s, peak memory; then one first-order
              ``validation_step``;
8. report  -- one JSON line of kernels, then the card's name and power
              limit, then the result line.

It exits with an error and prints no result where no CUDA device is
available, or where the ``metatts_torch`` package is not beside it.
"""

import json
import math
import os
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
# versions repeats itself exactly, and the kernels move it by 7.2e-6 (only
# the order of their sums differs), so 1e-4 leaves 14x.  With PyTorch's
# default algorithms the step does not repeat itself: the same step through
# the plain versions differs from its deterministic run by ~3e-2 (atomics in
# backward kernels, amplified by the second-order meta-gradient; the train
# phase prints it), which is what the bf16 bound above has to absorb.
META_GRAD_TOL_F32 = 1e-4
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


KERNEL_SOURCES = ("fftblock", "flash_attention", "melspec")


def phase_build():
    from metatts_torch.ops import _build, attention, fftblock, melspec
    from metatts_torch.preprocess import pitch
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as pool:
        host = pool.submit(_build.build_host, "world", pitch.SOURCES)
        list(pool.map(_build.build, KERNEL_SOURCES))
        host.result()
    fftblock._lib()
    attention._lib()
    melspec._lib()
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
                (4, 77, 128, "float32"))
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


def make_corpus(root, sr, seed=0):
    """A synthetic corpus from a seed: speakers x utterances at 22.05 kHz
    whose mean length is LibriTTS train-clean-100's (``PP_MEAN_S``), each a
    harmonic tone with the speaker's f0 (vibrato, loud and quiet phones, a
    little noise), with silences at both ends and a ``phones`` TextGrid.
    Returns (raw dir, seconds of audio)."""
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
            t = np.arange(n) / sr
            f = f0 * (1 + 0.06 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t))
            ph = 2 * np.pi * np.cumsum(f) / sr
            wav = 0.3 * np.sin(ph) + 0.12 * np.sin(2 * ph) + 0.05 * np.sin(3 * ph)
            wav *= 0.25 + 0.75 * np.abs(np.sin(np.pi * rng.uniform(0.7, 2.0) * t))
            wav += 0.005 * rng.randn(n)
            lead, tail = 0.15, 0.2
            wav[: int(lead * sr)] = 0.002 * rng.randn(int(lead * sr))
            wav[n - int(tail * sr):] = 0.002 * rng.randn(int(tail * sr))
            d = os.path.join(raw, "train", spk)
            os.makedirs(d, exist_ok=True)
            save_wav(os.path.join(d, base + ".wav"), wav.astype(np.float32), sr)
            with open(os.path.join(d, base + ".lab"), "w") as fh:
                fh.write("a synthetic sentence")
            intervals, start = [(0.0, lead, "sil")], lead
            while start < n / sr - tail - 0.05:
                end = min(start + rng.uniform(0.06, 0.16), n / sr - tail)
                intervals.append((start, end, PP_PHONES[rng.randint(len(PP_PHONES))]
                                  if rng.rand() > 0.08 else "sp"))
                start = end
            intervals[-1] = intervals[-1][:2] + (PP_PHONES[0],)
            intervals.append((start, n / sr, "sil"))
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
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


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


def profile_step(system, sup, qry):
    """Device time of one meta step by kernel name (torch.profiler), and
    the step's wall time; the share of the wall time the card was idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.train_step(sup, qry)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attr = "self_device_time_total" if events and hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    busy = sum(getattr(e, attr) for e in events) / 1e3
    if busy == 0.0:
        print("[train] profile: no device time in the trace (not measured)")
        return
    print(f"[train] profile of one step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(kernel time summed), idle share {max(0.0, 1 - busy / wall):.3f}; "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:10]:
        print(f"[train]   {getattr(e, attr) / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")


def phase_train():
    import copy
    import numpy as np
    import torch
    from metatts_torch import config as C
    from metatts_torch.algorithms.meta import MetaSystem, episode
    from metatts_torch.ops import attention as A

    pcfg, mcfg, acfg = C.base_configs()
    acfg["adapt"]["train"].update(shots=SHOTS, queries=QUERIES, steps=INNER_STEPS)
    tcfg = copy.deepcopy(C.TRAIN_DEFAULTS)
    system = MetaSystem(pcfg, mcfg, tcfg, acfg, n_speakers=N_SPEAKERS, seed=0,
                        device="cuda")
    n_mels = pcfg["preprocessing"]["mel"]["n_mel_channels"]
    rng = np.random.RandomState(0)
    sup = episode_batch(rng, EPISODES, SHOTS, SRC_LEN, MEL_LEN, n_mels, N_SPEAKERS).to("cuda")
    qry = episode_batch(rng, EPISODES, QUERIES, SRC_LEN, MEL_LEN, n_mels, N_SPEAKERS).to("cuda")
    n_layers = (mcfg["transformer"]["encoder_layer"]
                + mcfg["transformer"]["decoder_layer"])
    frames = int(sup.mel_lens.sum()) * INNER_STEPS + int(qry.mel_lens.sum())

    bn = {k: v.clone() for k, v in system.model.state_dict().items() if "running" in k}
    before = {n: p.detach().clone() for n, p in system.params.items()}

    # gradients through the kernels against the same computation through
    # the plain versions: same weights, batch and dropout seed
    seed = 1234
    kernels = (A.flash_attention_fwd, A.flash_attention_bwd)

    def through(plain, fn):
        if plain:
            A.flash_attention_fwd = A.flash_attention_fwd_plain
            A.flash_attention_bwd = A.flash_attention_bwd_plain
        try:
            return fn()
        finally:
            A.flash_attention_fwd, A.flash_attention_bwd = kernels

    def query_grad(sys_):      # one training forward + backward of the query set
        params = sys_.params
        total, _ = sys_._supervised_loss(params, episode(qry, 0), seed, True)
        return dict(zip(params, torch.autograd.grad(total, list(params.values()),
                                                    allow_unused=True)))

    def with_einsum(sys_, fn):
        stacks = (sys_.model.encoder, sys_.model.decoder)
        impls = [m.attn_impl for m in stacks]
        for m in stacks:
            m.attn_impl = "einsum"
        try:
            return fn()
        finally:
            for m, impl in zip(stacks, impls):
                m.attn_impl = impl

    # fp32 compute: the kernels' fp32 path, where only the order of sums differs
    system32 = MetaSystem(pcfg, dict(mcfg, compute_dtype="float32",
                                     activation_dtype="float32",
                                     attention_scores_dtype="float32"),
                          tcfg, acfg, n_speakers=N_SPEAKERS, seed=0, device="cuda")
    system32.model.train()
    gap32 = rel_l2(through(False, lambda: query_grad(system32)),
                   through(True, lambda: query_grad(system32)))
    # the meta-gradient at fp32 compute (the kernels' fp32 path; the bf16
    # kernels are held at kernel level by the flash phase), with PyTorch's
    # deterministic algorithms, so that the plain step repeats itself exactly
    meta32 = lambda: system32._meta_train_step(sup, qry, seed)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        loss32_k, grads32_k = through(False, meta32)
        loss32_p, grads32_p = through(True, meta32)
        _, grads32_p2 = through(True, meta32)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
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

    # the main path, counted: one warm-up step, then timed steps
    system.train_step(sup, qry)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_attention_fwd.launches = A.flash_attention_bwd.launches = 0
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
    launches = (A.flash_attention_fwd.launches, A.flash_attention_bwd.launches)
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
    print(f"[train] MetaSystem.train_step, base config, E={EPISODES}, {SHOTS} support + "
          f"{QUERIES} query, L={SRC_LEN}, T={MEL_LEN}, {INNER_STEPS} inner steps "
          f"(custom-HVP): {ms:.2f} ms per step, {frames} mel frames per step, "
          f"{frames / ms * 1e3:.1f} mel frames/s, peak memory {peak:.2f} GiB; "
          f"flash launches {launches[0]} forward + {launches[1]} backward over "
          f"{TIMED_STEPS} steps; total loss {', '.join(f'{t:.4f}' for t in totals)}; "
          f"{moved} of {len(before)} parameter tensors moved; BatchNorm buffers "
          f"unchanged")
    return launches


def with_time(phase):
    """One phase, with its wall time."""
    t0 = time.perf_counter()
    out = phase()
    print(f"[time] {phase.__name__[len('phase_'):]}: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


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
    mel_launches = with_time(phase_preprocess)
    launches = with_time(phase_serve)
    flash_launches = with_time(phase_train)

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
        "shape": "B=8 T=1000 D=256 H=2 F=1024 K=9 fp32 in/out",
        **{f"{n}_{B}x{T}": kern[(B, T)][n] for B, T in ((1, 1000), (8, 160), (8, 64))
           for n in ("ms", "device_ms", "bound_ms")},
    }
    main_shape, text_shape = flash[FLASH_SHAPES[0]], flash[FLASH_SHAPES[1]]
    entries = [entry]
    for i, (name, line) in enumerate((("flash_attention_fwd", 95),
                                      ("flash_attention_bwd", 129))):
        way = "fwd" if i == 0 else "bwd"
        entries.append({
            "name": name, "route": "cuda",
            "source": "metatts_torch/csrc/flash_attention.cu",
            "replaces": f"metatts_tpu/ops/pallas/attention.py:{line}",
            "launches": flash_launches[i], **main_shape[way],
            "shape": "BH=10 T=896 D=128 bf16",
            **{f"{n}_t128": text_shape[way][n]
               for n in ("ms", "device_ms", "bound_ms", "library_ms")},
        })
    entries.append({
        "name": "fused_mel_spectrogram", "route": "cuda",
        "source": "metatts_torch/csrc/melspec.cu",
        "replaces": "metatts_tpu/ops/pallas/melspec.py:81",
        "launches": mel_launches, **mel[MEL_SHAPES[0]],
        "shape": "B=16 T=220500 n_fft=1024 hop=256 mels=80 fp32",
        **{k + "_b1": mel[MEL_SHAPES[1]][k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms")},
    })
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
