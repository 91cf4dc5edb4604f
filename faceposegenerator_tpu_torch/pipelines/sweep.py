"""Image grids of the synthesis sweep (port of
`faceposegenerator_tpu/pipelines/sweep.py:100`, `save_image_grid`). The
rest of the sweep (prompt grid × identities × model variants) is not yet
ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_image_grid(images: np.ndarray, path: str, per_row: Optional[int] = None):
    """Tile (N, H, W, 3) images ([0, 1] float or uint8) into one PNG grid,
    `per_row` to a row (all N by default), written with PIL."""
    from PIL import Image

    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = (np.clip(images, 0.0, 1.0) * 255).astype(np.uint8)
    n, h, w, _ = images.shape
    per_row = per_row or n
    rows = -(-n // per_row)
    grid = np.zeros((rows * h, per_row * w, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, per_row)
        grid[r * h: (r + 1) * h, c * w: (c + 1) * w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)
