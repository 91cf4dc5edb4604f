"""Experiment trackers (port of `faceposegenerator_tpu/core/trackers.py`).

The reference's Accelerate/tensorboard tracking (`train_ID-Booth.py:511,
912,1171-1174`, image logging in `log_validation` at `:183-186`): scalars
and images to TensorBoard where it is installed, and scalars always to
`scalars.jsonl`, so a run stays readable without TensorBoard.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class Tracker:
    """log_scalars(step, {...}) + log_images(step, tag, (N, H, W, 3) in [0, 1])."""

    def __init__(self, log_dir: str, backend: str = "auto"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        if backend in ("auto", "tensorboard"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                if backend == "tensorboard":
                    raise
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def log_scalars(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            v = float(v)
            rec[k] = v
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_images(self, step: int, tag: str, images: np.ndarray):
        images = np.asarray(images)
        if self._tb is not None:
            for i, img in enumerate(images):
                self._tb.add_image(f"{tag}/{i}", img.transpose(2, 0, 1), step)
        else:
            from PIL import Image

            d = os.path.join(self.log_dir, "images")
            os.makedirs(d, exist_ok=True)
            for i, img in enumerate(images):
                Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                    os.path.join(d, f"{tag}_{step}_{i}.png"))

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
