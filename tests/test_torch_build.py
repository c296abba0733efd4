"""Port: the native build's cache key.  A library's file name hashes its
source, the shared CUDA headers of ``metatts_torch/csrc/`` (``hopper.cuh``:
the PTX helpers and the tensor-map encoder of the fused-block and flash
kernels) and the flags, so an edited header rebuilds every kernel library
instead of reusing a stale one.  No compiler runs here: ``subprocess.run``
is replaced by one that writes an empty library."""

import os
import subprocess

from metatts_torch.ops import _build


def _fake_compiler(monkeypatch, calls):
    def run(cmd, capture_output, text):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")
    monkeypatch.setattr(_build.subprocess, "run", run)


def test_edited_header_rebuilds(tmp_path, monkeypatch):
    src, hdr = tmp_path / "k.cu", tmp_path / "h.cuh"
    src.write_text('#include "h.cuh"\n')
    hdr.write_text("// one\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    calls = []
    _fake_compiler(monkeypatch, calls)
    build = lambda: _build._compile("k", "nvcc", ["-O3"], [str(src)], [str(hdr)])
    first = build()
    assert build() == first and len(calls) == 1          # unchanged: reused
    hdr.write_text("// two\n")
    second = build()
    assert second != first and os.path.exists(second) and len(calls) == 2
    assert str(hdr) not in calls[-1]                      # hashed, not compiled


def test_kernel_builds_hash_the_shared_header(monkeypatch):
    seen = {}
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_compile", lambda name, compiler, flags, sources, headers:
                        seen.update(flags=flags, sources=sources, headers=headers))
    _build.build("flash_attention")
    assert os.path.join(_build.CSRC, "hopper.cuh") in seen["headers"]
    assert seen["sources"] == [os.path.join(_build.CSRC, "flash_attention.cu")]
    assert seen["flags"][-2:] == ["-I", _build.CSRC]      # copies elsewhere find it too
