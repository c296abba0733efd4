#!/usr/bin/env python3
"""Where the fused FFT-block kernel's time goes, and what its choices buy,
on a CUDA card.

    python3 tools/fftblock_ablate.py

Builds copies of ``metatts_torch/csrc/fftblock.cu`` with one choice
changed (the GEMM tile shape forced, the LayerNorm GEMMs' tile, the
attention's exponential) or one part cut out (the GEMM main loops, the
epilogues; the outputs of a cut copy are wrong, only its time counts) and
times each against the kernel as it is, at
the serving path's call shapes: B=8 and B=1 at T=1000 (the decoder), B=8
at T=160 (the encoder's text bucket) and B=8 at T=64, D=256, 2 heads,
F=1024, k=9, bf16 in and out.  Each time is device time: 20 launches
captured in one CUDA graph, replayed after a warm-up, the host's enqueue
left out, for the whole call and for each stage alone.  The unchanged
kernel is timed first and last, so the spread between the two says how
far apart two variants must be to differ.  Each variant's output is
compared with the unchanged kernel's.  Prints the card's name and power
limit.
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_PICK = "  if (best == 0) return launch_gemm<2, 1, 256>(A, W, g, st);"
# variant -> [(text in fftblock.cu, its replacement)]
VARIANTS = {
    "as is": [],
    "GEMM tiles 128x256 forced": [(_PICK, "  best = 0;\n" + _PICK)],
    "GEMM tiles 128x128 forced": [(_PICK, "  best = 1;\n" + _PICK)],
    "GEMM tiles 64x128 forced": [(_PICK, "  best = 2;\n" + _PICK)],
    "LayerNorm GEMMs at D=256 in 128x256 tiles": [
        ("    case 256: return launch_gemm<1, 2, 128>(A, W, g, st);",
         "    case 256: return launch_gemm<2, 1, 256>(A, W, g, st);")],
    "attention 2^x by exp2f (subnormals kept)": [
        ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);")],
    # cuts: the output is wrong, only the time counts
    "GEMM main loops cut": [("const int kb = g.kc / 64, nk = g.taps * kb;",
                             "const int kb = g.kc / 64, nk = 0 * g.taps * kb;")],
    "LayerNorm epilogue cut": [("  if (g.mode == EPI_LN) {\n    // a warp a row",
                                "  if (g.mode == EPI_LN) return;\n"
                                "  if (g.mode == EPI_LN) {\n    // a warp a row")],
    "QKV and ReLU epilogues cut": [("  if (n < g.N) {\n    const float4 b0",
                                    "  if (n < 0) {\n    const float4 b0")],
}
SHAPES = ((8, 1000), (1, 1000), (8, 160), (8, 64))
D, H, F, K = 256, 2, 1024, 9


def variant_source(src, edits, name):
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is not in fftblock.cu")
        src = src.replace(old, new)
    return src


def build_all():
    from metatts_torch.ops import _build
    with open(os.path.join(_build.CSRC, "fftblock.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(out, exist_ok=True)
    paths = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        path = os.path.join(out, f"fftblock_v{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, edits, name))
        paths[name] = (f"fftblock_v{i}", path)
    with ThreadPoolExecutor(len(paths)) as pool:
        return dict(zip(paths, pool.map(lambda p: _build.build(*p), paths.values())))


def load(path):
    from metatts_torch.ops.fftblock import _SIGNATURES
    lib = ctypes.CDLL(path)
    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def device_ms(fn, iters=20):
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (10 * iters)


def main():
    import torch
    from metatts_torch.models import nn as L
    from metatts_torch.models.transformer import FFTBlock
    from metatts_torch.ops import fftblock as FB
    if not torch.cuda.is_available():
        print("fftblock_ablate: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = {name: load(path) for name, path in build_all().items()}
    gen = torch.Generator().manual_seed(0)
    blk = FFTBlock(D, H, F, [K, 1])
    L.reset_parameters(blk, gen)
    p = blk.cuda().eval().fused_params()
    bf = torch.bfloat16
    inputs = {(B, T): (torch.randn(B, T, D, generator=gen).to(bf).cuda(),
                       torch.ones(B, T, dtype=torch.bool, device="cuda"))
              for B, T in SHAPES}
    ref = {}
    order = list(VARIANTS) + ["as is"]
    own_lib = FB._lib
    try:
        for i, name in enumerate(order):
            FB._lib = lambda lib=libs[name]: lib
            tag = " (again)" if i == len(order) - 1 else ""
            for shape, (x, valid) in inputs.items():
                call = lambda: FB.fused_fft_block(p, x, valid, H, out_dtype=bf)
                y = call().float()
                diff = (y - ref.setdefault(shape, y)).abs().max().item()
                stages = {s: device_ms(lambda: FB.fused_fft_block_stage(
                    p, x, valid, H, s, out_dtype=bf)) for s in FB.STAGES}
                print(f"[ablate] B={shape[0]} T={shape[1]}: {name}{tag}: call "
                      f"{device_ms(call):.5f} ms; "
                      + ", ".join(f"{s} {t:.5f}" for s, t in stages.items())
                      + f"; max |diff| to as is {diff:.3e}")
    finally:
        FB._lib = own_lib
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
