"""Build the port's native sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``csrc/build/`` (listed in
``.gitignore``).  Host C++ shared with the TPU package (the repository's
``csrc/``: native F0 and FLAC) is compiled by ``g++`` with that directory's
Makefile flags into the same build directory.  A library's file name
carries a hash of its sources and flags, so an edited source is rebuilt and
an unchanged one is reused.  Nothing is built when a module is imported.
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
SHARED_CSRC = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]

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


def _compile(name, compiler, flags, sources):
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        build_seconds.setdefault(name, 0.0)
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", tmp, *sources],
                          capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed on {', '.join(sources)}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def build(name):
    """Compile ``csrc/<name>.cu`` if needed; return the library's path."""
    return _compile(name, _nvcc(), NVCC_FLAGS, [os.path.join(CSRC, name + ".cu")])


def build_host(name, sources):
    """Compile host C++ ``sources`` (file names in the repository's shared
    ``csrc/``) with g++ if needed; return the library's path."""
    return _compile(name, os.environ.get("CXX", "g++"), HOST_FLAGS,
                    [os.path.join(SHARED_CSRC, s) for s in sources])


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
