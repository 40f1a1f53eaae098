"""Build and load the package's hand-written CUDA kernels.

Each kernel source under `orb_slam2_2021_tpu_torch/csrc/` exposes a plain
`extern "C"` launcher. At first use it is compiled with nvcc for sm_90a into
a shared library under `orb_slam2_2021_tpu_torch/_build/` (named by the
source's content hash, so an edited source is rebuilt) and loaded with
ctypes. Nothing here runs at import time. Building is serialized by one
lock, so threads that reach a cold kernel together compile and load it once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import defaultdict
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_BUILD_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


class CudaKernel:
    """One hand-written kernel: its source (a file name under csrc/, or an
    absolute path), its C launcher, and a count of launches that its Python
    wrapper adds to (`count`) each time it launches it, in all and per
    calling thread (async mode runs the lane, the mapping worker and the
    global-BA thread at once)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.launches_by_thread: Dict[str, int] = defaultdict(int)
        self._count_lock = threading.Lock()
        self._fn = None

    def count(self):
        """One launch, by the calling thread."""
        with self._count_lock:
            self.launches += 1
            self.launches_by_thread[threading.current_thread().name] += 1

    def reset_counts(self):
        with self._count_lock:
            self.launches = 0
            self.launches_by_thread.clear()

    def library_path(self) -> str:
        """The shared library this source and NVCC_FLAGS build into."""
        src = os.path.join(CSRC_DIR, self.source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")

    def build(self):
        """Compile (if needed) and load; returns the ctypes launcher."""
        if self._fn is not None:
            return self._fn
        with _BUILD_LOCK:
            if self._fn is None:
                lib_path = self.library_path()
                if not os.path.exists(lib_path):
                    _compile(os.path.join(CSRC_DIR, self.source), lib_path)
                fn = getattr(_load(lib_path), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn


def _start_compile(src: str, lib_path: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, src, tmp, lib_path


def _finish_compile(proc, src: str, tmp: str, lib_path: str):
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {os.path.basename(src)} (exit {proc.returncode}):\n"
                           f"{out}\n{err}")
    os.replace(tmp, lib_path)


def _compile(src: str, lib_path: str):
    _finish_compile(*_start_compile(src, lib_path))


def build_all(kernels: Sequence["CudaKernel"]):
    """Build the libraries `kernels` need, one nvcc a source, all started
    together, then load each launcher."""
    with _BUILD_LOCK:
        jobs = {}
        for kern in kernels:
            lib_path = kern.library_path()
            if lib_path not in jobs and not os.path.exists(lib_path):
                jobs[lib_path] = _start_compile(os.path.join(CSRC_DIR, kern.source), lib_path)
        for job in jobs.values():
            _finish_compile(*job)
    for kern in kernels:
        kern.build()


def _load(lib_path: str):
    return ctypes.CDLL(lib_path)
