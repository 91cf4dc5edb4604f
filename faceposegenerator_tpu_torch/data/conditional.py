"""Flat ↔ conditional dataset layout converters (port of
`faceposegenerator_tpu/data/conditional.py`).

Behavioral rebuild of `Evaluation/convert_to_conditional_dataset_for_
evaluation.ipynb` (cell 0): flat `<id>_<img>` files into per-ID subfolders
for class-conditional evaluation (per-class Vendi and the like), and the
inverse for FR training.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict

_IMAGES = (".jpg", ".jpeg", ".png")


def flat_to_conditional(flat_dir: str, out_dir: str, copy: bool = True) -> Dict[str, int]:
    """`<flat>/<id>_<img>.jpg` → `<out>/<id>/<id>_<img>.jpg`; returns the
    count of files an ID."""
    os.makedirs(out_dir, exist_ok=True)
    counts: Dict[str, int] = {}
    op = shutil.copy if copy else shutil.move
    for f in sorted(os.listdir(flat_dir)):
        if not f.lower().endswith(_IMAGES):
            continue
        ident = f.split("_")[0]
        d = os.path.join(out_dir, ident)
        os.makedirs(d, exist_ok=True)
        op(os.path.join(flat_dir, f), os.path.join(d, f))
        counts[ident] = counts.get(ident, 0) + 1
    return counts


def conditional_to_flat(cond_dir: str, out_dir: str, copy: bool = True) -> int:
    """`<cond>/<id>/<img>` → `<out>/<id>_<img>` (the FR label convention; a
    name that already starts with `<id>_` keeps it). Returns the file count."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    op = shutil.copy if copy else shutil.move
    for ident in sorted(os.listdir(cond_dir)):
        d = os.path.join(cond_dir, ident)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if not f.lower().endswith(_IMAGES):
                continue
            name = f if f.startswith(f"{ident}_") else f"{ident}_{f}"
            op(os.path.join(d, f), os.path.join(out_dir, name))
            n += 1
    return n
