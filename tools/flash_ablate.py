#!/usr/bin/env python3
"""Where the flash-attention kernels' time goes, and what their choices
buy, on a CUDA card.

    python3 tools/flash_ablate.py

Device time: builds copies of ``metatts_torch/csrc/flash_attention.cu``
with one choice changed (one block an SM instead of two, by asking for
more shared memory than two blocks can have) or one part cut out (the
forward's first pass, the backward's dQ or dK/dV role, the backward's main
launch; the outputs of a cut copy are wrong, only its time counts) and
times the forward and the backward of each against the kernels as they
are, at the meta step's shapes: BH=10, D=128, bf16, T=896 (the decoder)
and T=128 (the encoder).  Each time is device time: 20 calls captured in
one CUDA graph, replayed after a warm-up, the host's enqueue left out.
The unchanged kernels are timed first and last, so the spread between the
two says how far apart two variants must be to differ.

Host time: a call at T=128 is set by the host's enqueue, so the same
script times the parts of one call on the host's clock (mean over 200
calls without a synchronisation in between): the wrapper, its input
checks, its output allocations, the stream lookup, the C call alone (the
tensor maps and the launches), the C call of a copy whose launches are cut
(the tensor maps alone) and a C call that returns at once (ctypes).
Prints the card's name and power limit.
"""

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_FWD_LAUNCH = "    fwd_bf16<<<dim3((T + ROWS - 1) / ROWS, BH), WG_THREADS, FWD_SMEM, stream>>>(\n" \
              "        qm, km, vm, mask, out, lse, T, D, scale);"
_BWD_LAUNCH = "    bwd_bf16<<<dim3((T + ROWS - 1) / ROWS, BH, 2), WG_THREADS, BWD_SMEM, stream>>>("
_PREP_LAUNCH = "    bwd_prep_bf16<<<(rows + 15) / 16, 256, 0, stream>>>("
# variant -> [(text in flash_attention.cu, its replacement)]
VARIANTS = {
    "as is": [],
    "one block an SM": [
        ("constexpr int FWD_SMEM = 1024 +", "constexpr int FWD_SMEM = 48 * 1024 + 1024 +"),
        ("constexpr int BWD_SMEM = 1024 +", "constexpr int BWD_SMEM = 48 * 1024 + 1024 +")],
    # cuts: the output is wrong, only the time counts
    "forward pass 1 cut": [("const int n1 = (T + 127) / 128,", "const int n1 = 0 * T,")],
    "backward dQ role cut": [("  const bool keys = blockIdx.z == 0;",
                              "  if (blockIdx.z) return;\n  const bool keys = true;")],
    "backward dK/dV role cut": [("  const bool keys = blockIdx.z == 0;",
                                 "  if (!blockIdx.z) return;\n  const bool keys = false;")],
    "backward main launch cut (the prologue alone)": [(_BWD_LAUNCH, "    if (0) " + _BWD_LAUNCH[4:])],
    "launches cut (host: tensor maps and checks only)": [
        (_FWD_LAUNCH, "    if (0) " + _FWD_LAUNCH[4:]), (_BWD_LAUNCH, "    if (0) " + _BWD_LAUNCH[4:]),
        (_PREP_LAUNCH, "    if (0) " + _PREP_LAUNCH[4:])],
}
SHAPES = (896, 128)
BH, D = 10, 128


def build_all():
    from metatts_torch.ops import _build
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(out, exist_ok=True)
    paths = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in flash_attention.cu")
            text = text.replace(old, new)
        path = os.path.join(out, f"flash_attention_v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        paths[name] = (f"flash_attention_v{i}", path)
    with ThreadPoolExecutor(len(paths)) as pool:
        return dict(zip(paths, pool.map(lambda p: _build.build(*p), paths.values())))


def load(path):
    import ctypes
    from metatts_torch.ops.attention import _SIGNATURES
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


def host_us(fn, n=200):
    """Mean host time of ``fn`` over ``n`` calls (no synchronisation in
    between; the card keeps up at T=128), after 20 warm-up calls."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def inputs(T, gen):
    import torch
    q, k, v = (torch.randn(BH, T, D, generator=gen).to(torch.bfloat16).cuda() for _ in range(3))
    lens = torch.randint(1, T + 1, (BH,), generator=gen)
    mask = (torch.arange(T)[None, :] < lens[:, None]).float().cuda()
    do = torch.randn(BH, T, D, generator=gen).cuda()
    return q, k, v, mask, do


def host_parts(A, libs, q, k, v, mask, do):
    import torch
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    dev = q.device
    T = q.shape[1]
    scale = A.kernel_scale(D)
    o, l = torch.empty_like(out), torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    at = (BH * T * 4 + 255) // 256 * 256
    scratch = torch.empty(at + BH * T * D * 2, dtype=torch.uint8, device=dev)
    ws = scratch.data_ptr()
    ptr = [t.data_ptr() for t in (q, k, v, mask, o, l)]
    bptr = [t.data_ptr() for t in (q, k, v, mask, out, lse, do)]
    stream = A._stream(dev)

    def c_fwd(lib):
        return lambda: lib.mtts_flash_fwd(*ptr, BH, T, D, 1, scale, stream)

    def c_bwd(lib):
        return lambda: lib.mtts_flash_bwd(*bptr, ws, ws + at, dq.data_ptr(), dk.data_ptr(),
                                          dv.data_ptr(), BH, T, D, 1, scale, stream)

    own, cut = libs["as is"], libs["launches cut (host: tensor maps and checks only)"]
    parts = {
        "forward wrapper": lambda: A.flash_attention_fwd(q, k, v, mask),
        "backward wrapper": lambda: A.flash_attention_bwd(q, k, v, mask, out, lse, do),
        "input checks (_cuda_inputs)": lambda: A._cuda_inputs("f", q, k, v, mask),
        "forward outputs (2 torch.empty)": lambda: (
            torch.empty(BH, T, D, device=dev), torch.empty(BH, T, device=dev)),
        "backward outputs (3 torch.empty_like)": lambda: tuple(
            torch.empty_like(t) for t in (q, k, v)),
        "stream lookup": lambda: A._stream(dev),
        "C forward call (3 tensor maps, 1 launch)": c_fwd(own),
        "C forward call, launch cut (3 tensor maps)": c_fwd(cut),
        "C backward call (4 tensor maps, 2 launches)": c_bwd(own),
        "C backward call, launches cut (4 tensor maps)": c_bwd(cut),
        "C call returning at once (ctypes)": lambda: own.mtts_flash_fwd(
            *ptr, BH, T, 0, 1, scale, stream),
    }
    for name, fn in parts.items():
        print(f"[host] T={T}: {name}: {host_us(fn):.2f} us")


def main():
    import torch
    from metatts_torch.ops import attention as A
    if not torch.cuda.is_available():
        print("flash_ablate: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = {name: load(path) for name, path in build_all().items()}
    gen = torch.Generator().manual_seed(0)
    data = {T: inputs(T, gen) for T in SHAPES}
    stats = {T: A.flash_attention_fwd_plain(*data[T][:4]) for T in SHAPES}
    ref = {}
    order = [n for n in VARIANTS if not n.startswith("launches cut")] + ["as is"]
    own_lib = A._lib
    try:
        for i, name in enumerate(order):
            A._lib = lambda lib=libs[name]: lib
            tag = " (again)" if i == len(order) - 1 else ""
            for T, (q, k, v, mask, do) in data.items():
                o, lse = stats[T]
                fwd = lambda: A.flash_attention_fwd(q, k, v, mask)
                bwd = lambda: A.flash_attention_bwd(q, k, v, mask, o, lse, do)
                y = torch.cat([fwd()[0].flatten()] + [g.float().flatten() for g in bwd()])
                diff = (y - ref.setdefault(T, y)).abs().max().item()
                print(f"[ablate] T={T}: {name}{tag}: forward {device_ms(fwd):.5f} ms, "
                      f"backward {device_ms(bwd):.5f} ms (device); max |diff| to as is "
                      f"{diff:.3e}")
        A._lib = lambda: libs["as is"]
        for T in SHAPES:
            host_parts(A, libs, *data[T])
    finally:
        A._lib = own_lib
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
