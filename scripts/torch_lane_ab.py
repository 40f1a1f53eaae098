"""The tracking lane's drive from one checkout of the repo, for comparing two
commits on one card.

    python3 scripts/torch_lane_ab.py TREE

Runs `chip_smoke.drive_kitti` (System(kitti_stereo_config(),
enable_mapping=False) over 30 rendered KITTI-width frames) with TREE's
chip_smoke.py and package, and prints its per-frame host-clock line. Run
it for two trees in turns (A, B, B, A) in one call: host-clock times of
this launch-bound path follow the host CPU, so only turns within one call
compare.
"""

import os
import sys

tree = os.path.abspath(sys.argv[1])
os.chdir(tree)
sys.path.insert(0, tree)

import torch  # noqa: E402

import chip_smoke  # noqa: E402

if not torch.cuda.is_available():
    raise SystemExit("needs a CUDA card")
print(f"tree {tree}", flush=True)
chip_smoke.drive_kitti(torch.device("cuda:0"))
