"""Build and load the package's hand-written CUDA kernels.

Each kernel source under `orb_slam2_2021_tpu_torch/csrc/` exposes a plain
`extern "C"` launcher. At first use it is compiled with nvcc for sm_90a into
a shared library under `orb_slam2_2021_tpu_torch/_build/` (named by the
source's content hash, so an edited source is rebuilt) and loaded with
ctypes. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


class CudaKernel:
    """One hand-written kernel: its source, its C launcher, and a count of
    launches that its Python wrapper increments each time it launches it."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def build(self):
        """Compile (if needed) and load; returns the ctypes launcher."""
        if self._fn is not None:
            return self._fn
        src = os.path.join(CSRC_DIR, self.source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = os.path.splitext(self.source)[0]
        lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source} (exit {res.returncode}):\n"
                    f"{res.stdout}\n{res.stderr}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn
