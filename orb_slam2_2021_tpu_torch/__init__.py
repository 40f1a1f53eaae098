"""PyTorch/CUDA port of the stereo tracking lane of `orb_slam2_2021_tpu`.

The JAX package beside this one is the reference: every module here mirrors
its counterpart there and is held against it by the `tests/test_torch_*.py`
parity tests on the CPU. Host-side code that imports no JAX (configuration,
map store, synthetic world, trajectory metrics) is shared by import, not
copied.

The one Pallas kernel of the reference (the packed-descriptor Hamming
matrix) is a hand-written CUDA kernel here (`csrc/hamming.cu`), built with
nvcc at first use; everything else is plain PyTorch.
"""

import torch

# Full float32 everywhere: the reference pins HIGHEST precision on every
# geometry and optimizer contraction (orb_slam2_2021_tpu/xmath.py), and TF32
# would round those products to 10-bit mantissas.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
