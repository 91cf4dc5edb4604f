"""Dataset-wide detect/align/crop sweep (port of
`faceposegenerator_tpu/data/align_driver.py:23-77`; the detector is the
port's MTCNN, on the card).

Behavioral rebuild of `utils/detect_align_crop_data.py` (L5 layer): for each
generated-dataset tree `<root>/<model>/<identity>/<img>`, pad 50% per side,
detect with MTCNN, similarity-warp the 5 landmarks to the ArcFace 112²
template, and write flat `FR_DATASETS/<model>/<consecutive_id>_<img>.jpg`
files (the FR label convention, `:122,249-251`) plus `missing_images.json`
for detection failures (`:266-268`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .align import norm_crop, pad_image
from .dreambooth import _natural_key, list_images


def align_images(
    input_root: str,
    output_root: str,
    detector,
    image_size: int = 112,
    pad_fraction: float = 0.5,
) -> Dict[str, List[str]]:
    """Align every `<input_root>/<identity>/<img>` into flat
    `<output_root>/<id_index>_<img>` files. Returns missing-image report."""
    from PIL import Image

    os.makedirs(output_root, exist_ok=True)
    missing: List[str] = []
    identities = sorted(
        (d for d in os.listdir(input_root) if os.path.isdir(os.path.join(input_root, d))),
        key=_natural_key,
    )
    for id_index, ident in enumerate(identities):
        src = os.path.join(input_root, ident)
        for name in list_images(src):
            img = np.asarray(Image.open(os.path.join(src, name)).convert("RGB"))
            padded, px, py = pad_image(img, pad_fraction)
            det = detector.detect(padded, landmarks=True)
            boxes, probs, points = det if len(det) == 3 else (det[0], det[1], None)
            if boxes is None or points is None or len(points) == 0:
                missing.append(os.path.join(ident, name))
                continue
            aligned = norm_crop(padded, np.asarray(points[0], np.float32), image_size)
            out_name = f"{id_index}_{os.path.splitext(name)[0]}.jpg"
            Image.fromarray(aligned.astype(np.uint8)).save(
                os.path.join(output_root, out_name)
            )
    report = {"missing_images": missing}
    with open(os.path.join(output_root, "missing_images.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def align_dataset_sweep(
    generated_root: str,
    output_root: str,
    detector,
    models: Optional[List[str]] = None,
    **kw,
):
    """Per-model sweep: `<generated_root>/<model>/<id>/<img>` →
    `<output_root>/<model>/` flat trees (the reference's per-dataset loop)."""
    models = models or sorted(os.listdir(generated_root))
    reports = {}
    for model in models:
        src = os.path.join(generated_root, model)
        if not os.path.isdir(src):
            continue
        reports[model] = align_images(src, os.path.join(output_root, model), detector, **kw)
    return reports
