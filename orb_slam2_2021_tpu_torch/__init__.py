"""PyTorch/CUDA port of `orb_slam2_2021_tpu`, the SLAM engine beside it.

The JAX package is the reference: every module here mirrors its counterpart
there and is held against it by the `tests/test_torch_*.py` parity tests on
the CPU. Nothing of the JAX package is imported: the host-side code (config,
map store, synthetic worlds, persistence, trajectory metrics) has its own
copies here; only the packaged vocabulary files are read from the reference
package's data folder, by path.

The one Pallas kernel of the reference (the packed-descriptor Hamming
matrix) is a hand-written CUDA kernel here (`csrc/hamming.cu`), and the
vocabulary builder's k-medians runs on three more (`csrc/vocab.cu`), each
source built with nvcc at first use; everything else is plain PyTorch. The
entry points run on the card unless the caller passes device="cpu".
"""

import torch

# Full float32 everywhere: the reference pins HIGHEST precision on every
# geometry and optimizer contraction (orb_slam2_2021_tpu/xmath.py), and TF32
# would round those products to 10-bit mantissas.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} asked for, but no CUDA card is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
