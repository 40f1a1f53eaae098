"""PlaceRecognition bundle: vocabulary + device tree + keyframe database
(counterpart of orb_slam2_2021_tpu/place/bundle.py).

The packaged vocabularies are read by path from the reference package's
`data/` folder; nothing of that package is imported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from .kf_database import KeyFrameDatabase
from .vocab import BinaryVocabulary, load_orbvoc_text, vocab_transform

# Data, not code: the 22 MB of vocabulary files stay in one place in the repo
# rather than in a second copy beside the port.
_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "orb_slam2_2021_tpu", "data")
PACKAGED_VOCAB_L6 = os.path.join(_DATA, "vocab_k10_L6.npz")     # 10^6 words
PACKAGED_VOCAB = os.path.join(_DATA, "vocab_k10_L5.npz")
PACKAGED_VOCAB_SMALL = os.path.join(_DATA, "vocab_k10_L4.npz")


class PlaceRecognition:
    """The vocabulary, its tree as int32 words (uploaded once per device it
    is used on, first to `device`: the card unless the caller passes "cpu")
    and the keyframe database."""

    def __init__(self, voc: BinaryVocabulary, device="cuda"):
        self.voc = voc
        self.kfdb = KeyFrameDatabase(voc)
        self._trees = {}
        self.tree(resolve_device(device))

    def tree(self, device) -> torch.Tensor:
        """The [n_nodes, 8] int32 tree on `device`."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._trees:
            words = np.ascontiguousarray(self.voc.node_desc, np.uint32).view(np.int32)
            self._trees[device] = torch.from_numpy(words).to(device)
        return self._trees[device]

    def transform(self, desc, valid):
        """[N, 8] int32 descriptors -> [N] int32 word ids, on their device."""
        return vocab_transform(self.tree(desc.device), desc, valid, self.voc.k, self.voc.L)

    @staticmethod
    def load_default(device="cuda") -> Optional["PlaceRecognition"]:
        for path in (PACKAGED_VOCAB_L6, PACKAGED_VOCAB, PACKAGED_VOCAB_SMALL):
            path = os.path.abspath(path)
            if os.path.exists(path):
                return PlaceRecognition(BinaryVocabulary.load(path), device)
        return None

    @staticmethod
    def from_file(path: str, device="cuda") -> "PlaceRecognition":
        """`.txt` loads a DBoW2 text vocabulary, anything else the npz
        checkpoint."""
        if path.endswith(".txt"):
            return PlaceRecognition(load_orbvoc_text(path), device)
        return PlaceRecognition(BinaryVocabulary.load(path), device)
