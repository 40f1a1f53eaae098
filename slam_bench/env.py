"""The process environment of a run, set before numpy or torch is imported.

One thread for each host math pool (OpenMP, MKL, OpenBLAS): the lane and
the mapping worker are Python threads that launch device work, and with
the pools at their defaults two runs of one seed on an 8-core H100 host
differed in frame rate by up to a fifth; at one thread they varied less. Every build and kernel cache sits inside the checkout,
at a fixed path (the port builds its own kernels into its package's
_build/).
"""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def set_process_env():
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE, sub)
