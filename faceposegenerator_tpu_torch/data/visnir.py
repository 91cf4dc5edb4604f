"""VIS+NIR 4-channel (RGBN) data (port of `faceposegenerator_tpu/data/visnir.py`).

Behavioral rebuild of the reference's 4-channel pipeline copies
(`FR_training/utils/dataset.py` `ArcBiFaceGANDataset_VISNIR`,
`verification_4channel.py`, `utils_callbacks_4channel.py:7`): paired VIS
(RGB) and NIR images merge into an RGBN tensor, the NIR channel from the
file of the same name in a parallel directory. Verification over RGBN bins
is the standard protocol with a 4-channel backbone
(`fr.init_train_state(backbone_cfg=IResNetConfig(in_channels=4))`; the
port's `evaluation.verification` is channel-agnostic).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .fr_dataset import FlatDirDataset, _load_image


class VISNIRDataset(FlatDirDataset):
    """Flat dir of VIS images + parallel NIR dir with the same file names.

    Yields (S, S, 4) RGBN tensors in [-1, 1], labels from the file-name
    prefix as in the 3-channel dataset; where a NIR file is missing, the
    NIR channel is the VIS mean. Augmentation applies to all four channels
    at once."""

    def __init__(self, vis_root: str, nir_root: str, image_size: int = 112, augment=None, seed: int = 0):
        super().__init__(vis_root, image_size, augment, seed)
        self.nir_root = nir_root

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        name = self.files[i]
        vis = _load_image(os.path.join(self.root, name), self.image_size)
        nir_path = os.path.join(self.nir_root, name)
        if os.path.exists(nir_path):
            nir = _load_image(nir_path, self.image_size)[..., :1]
        else:
            nir = vis.mean(axis=-1, keepdims=True).astype(np.uint8)
        rgbn = np.concatenate([vis, nir], axis=-1)
        if self.augment is not None:
            rgbn = self.augment(rgbn, self.rng)
        x = rgbn.astype(np.float32) / 255.0
        return (x - 0.5) / 0.5, self.label_map[self.labels[i]]


def load_bin_4channel(vis_bin: str, nir_bin: str, image_size: int = 112):
    """Paired VIS/NIR verification bins → (N, S, S, 4) uint8 + issame
    (`verification_4channel.py` load path)."""
    from ..evaluation.verification import load_bin

    vis, issame = load_bin(vis_bin, image_size)
    nir, issame2 = load_bin(nir_bin, image_size)
    assert len(issame) == len(issame2)
    return np.concatenate([vis, nir[..., :1]], axis=-1), issame
