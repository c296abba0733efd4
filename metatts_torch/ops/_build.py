"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``csrc/build/`` (listed in
``.gitignore``).  The library's file name carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs = {}
# seconds each library took to build in this process (0.0 when it was
# already built before the process started)
build_seconds = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name):
    """Compile ``csrc/<name>.cu`` if needed; return the library's path."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        build_seconds.setdefault(name, 0.0)
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def load(name, signatures):
    """Build and load ``csrc/<name>.cu``; ``signatures`` maps each C function
    to ``(restype, argtypes)``.  Returns the ctypes library, cached."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib
