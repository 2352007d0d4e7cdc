"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
for ``sm_90a`` into a shared library under ``pinot_tpu_torch/_build/``
(listed in ``.gitignore``), at first use, then loaded with ``ctypes``. The
library's file name carries a hash of its source, so an edited kernel is
rebuilt and a stale one is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "engine", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (library path, nvcc output) of builds made by this process
BUILD_LOGS: Dict[str, Tuple[str, str]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return path


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists;
    returns the library path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOGS[name] = (out, proc.stdout + proc.stderr)
    return out


def ptxas_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, stack frame and spills
    of each kernel) for ``csrc/<name>.cu``: the build's own where this
    process built it, else a compile to a throwaway library."""
    got = BUILD_LOGS.get(name)
    if got is not None:
        return got[1]
    src = os.path.join(CSRC, f"{name}.cu")
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(tmp, "lib.so"), src],
            capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return proc.stdout + proc.stderr


def load_library(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name))
            _declare(name, lib)
            _loaded[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    if name == "fused_scan":
        lib.fused_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.fused_scan_launch.restype = ctypes.c_int
        lib.fused_scan_many_launch.argtypes = [ctypes.c_void_p,
                                               ctypes.c_void_p]
        lib.fused_scan_many_launch.restype = ctypes.c_int
        lib.fused_scan_grid.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.fused_scan_grid.restype = ctypes.c_int
        lib.fused_scan_error_string.argtypes = [ctypes.c_int]
        lib.fused_scan_error_string.restype = ctypes.c_char_p
