#!/usr/bin/env python3
"""Where the log-mel kernel's time goes, on a CUDA card.

    python3 tools/melspec_ablate.py

Builds copies of ``metatts_torch/csrc/melspec.cu`` with one stage cut out
or one setting changed (the outputs of a cut copy are wrong; only its time
counts), and times each against the kernel as it is, at 16 and at 1
utterance of 10 s (n_fft 1024, hop 256, 80 mels).  Each time is device
time: 20 calls of the C launcher captured in one CUDA graph, replayed 10
times after a warm-up, the host's enqueue left out.  The unchanged kernel
is timed first and last, so the spread between the two says how far apart
two variants must be to differ.  Prints the card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# variant -> [(text in melspec.cu, its replacement)]
VARIANTS = {
    "as is": [],
    "no mel product": [("for (int j = 0; j < cnt; ++j) acc", "for (int j = 0; j < 0; ++j) acc")],
    "no passes after the first, no split step": [
        ("for (int ps = 1; ps < L8; ++ps) {", "for (int ps = 1; ps < 1; ++ps) {"),
        ("if constexpr (REM > 1) {", "if constexpr (false) {"),
        ("const float2 a = za[q], c = zb[q];",
         "const float2 a = make_float2(0.f, 0.f), c = a;")],
    "no audio read from device memory": [("v = __ldg(yb + j);", "v = (float)(j & 7);")],
    "no log-mel stores": [("if (f < n_frames) out_mel", "if (f < 0) out_mel")],
    "launch bounds (256, 3)": [("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 3)")],
    "launch bounds (256, 2)": [("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 2)")],
    "filterbank read from device memory through L1, not staged": [
        ("const int first = bands_s[3 * m], cnt = bands_s[3 * m + 1];",
         "const int first = __ldg(bands + 3 * m), cnt = __ldg(bands + 3 * m + 1);"),
        ("const float* wm = w_s + bands_s[3 * m + 2];",
         "const float* wm = weights + __ldg(bands + 3 * m + 2);")],
}
SHAPES = ((16, 220500), (1, 220500))
MEL = dict(n_fft=1024, hop=256, win_length=1024, sr=22050, n_mels=80)


def variant_source(src, edits, name):
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is not in melspec.cu")
        src = src.replace(old, new)
    return src


def build_all():
    from metatts_torch.ops import _build
    with open(os.path.join(_build.CSRC, "melspec.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(out, exist_ok=True)
    paths = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        path = os.path.join(out, f"melspec_v{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, edits, name))
        paths[name] = (f"melspec_v{i}", path)
    nvcc = _build._nvcc()
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(
            lambda p: _build._compile(p[0], nvcc, _build.NVCC_FLAGS, [p[1]]),
            paths.values())))
    return libs


def load(path):
    from metatts_torch.ops.melspec import _SIGNATURES
    lib = ctypes.CDLL(path)
    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def device_ms(lib, y, c, mel, en, iters=20):
    import torch
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    B, T = y.shape

    def call():
        err = lib.mtts_melspec(ptr(y), ptr(c["tables"]), ptr(c["bands"]), ptr(c["weights"]),
                               ptr(mel), ptr(en), B, T, MEL["n_fft"], MEL["hop"],
                               MEL["n_mels"], c["weights"].numel(),
                               ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(lib.mtts_melspec_error_string(err).decode())
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            call()
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
    import numpy as np
    import torch
    from metatts_torch.ops.melspec import _kernel_tables
    if not torch.cuda.is_available():
        print("melspec_ablate: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = {name: load(path) for name, path in build_all().items()}
    c = _kernel_tables(MEL["n_fft"], MEL["win_length"], MEL["sr"], MEL["n_mels"], 0.0, None,
                       "cuda")
    rng = np.random.RandomState(3)
    order = list(VARIANTS) + ["as is"]
    for B, T in SHAPES:
        y = torch.from_numpy(rng.uniform(-0.8, 0.8, (B, T)).astype(np.float32)).cuda()
        frames = T // MEL["hop"] + 1
        mel = torch.empty(B, MEL["n_mels"], frames, device="cuda")
        en = torch.empty(B, frames, device="cuda")
        for i, name in enumerate(order):
            ms = device_ms(libs[name], y, c, mel, en)
            tag = " (again)" if i == len(order) - 1 else ""
            print(f"[ablate] B={B} T={T}: {name}{tag}: {ms:.5f} ms")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
