"""Augmentation policies for FR training (port of
`faceposegenerator_tpu/data/augment.py`, numpy and PIL as there: the same
`np.random.Generator` gives bit-equal images; the FastAutoAugment tables are
the port's own copy of `faa_policies.json`).

The subset the reference configs actually use
(`FR_training/utils/augmentation.py:115-148` `get_conventional_aug_policy`
with `FR_config.py:47`): "hf" (horizontal flip p=0.5) and "ra_n_m"
(RandAugment with n ops at magnitude m, from the torchvision-forked
`rand_augment.py`). Ops are implemented with PIL — host-side preprocessing.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np


def _pil(img):
    from PIL import Image

    return Image.fromarray(img)


def _np(img):
    return np.asarray(img, np.uint8)


# Each op: (name, fn(PIL, magnitude_fraction) -> PIL)

def _shear_x(img, frac):
    from PIL import Image
    return img.transform(img.size, Image.Transform.AFFINE, (1, 0.3 * frac, 0, 0, 1, 0))


def _shear_y(img, frac):
    from PIL import Image
    return img.transform(img.size, Image.Transform.AFFINE, (1, 0, 0, 0.3 * frac, 1, 0))


def _translate_x(img, frac):
    from PIL import Image
    return img.transform(img.size, Image.Transform.AFFINE, (1, 0, frac * img.size[0] * 0.45, 0, 1, 0))


def _translate_y(img, frac):
    from PIL import Image
    return img.transform(img.size, Image.Transform.AFFINE, (1, 0, 0, 0, 1, frac * img.size[1] * 0.45))


def _rotate(img, frac):
    return img.rotate(30.0 * frac)


def _color(img, frac):
    from PIL import ImageEnhance

    return ImageEnhance.Color(img).enhance(1.0 + 0.9 * frac)


def _contrast(img, frac):
    from PIL import ImageEnhance

    return ImageEnhance.Contrast(img).enhance(1.0 + 0.9 * frac)


def _brightness(img, frac):
    from PIL import ImageEnhance

    return ImageEnhance.Brightness(img).enhance(1.0 + 0.9 * frac)


def _sharpness(img, frac):
    from PIL import ImageEnhance

    return ImageEnhance.Sharpness(img).enhance(1.0 + 0.9 * frac)


def _posterize(img, frac):
    from PIL import ImageOps

    return ImageOps.posterize(img, max(1, 8 - int(abs(frac) * 4)))


def _solarize(img, frac):
    from PIL import ImageOps

    return ImageOps.solarize(img, int(255 - abs(frac) * 255))


def _autocontrast(img, frac):
    from PIL import ImageOps

    return ImageOps.autocontrast(img)


def _equalize(img, frac):
    from PIL import ImageOps

    return ImageOps.equalize(img)


RA_OPS: List = [
    ("Identity", lambda img, f: img),
    ("ShearX", _shear_x),
    ("ShearY", _shear_y),
    ("TranslateX", _translate_x),
    ("TranslateY", _translate_y),
    ("Rotate", _rotate),
    ("Color", _color),
    ("Contrast", _contrast),
    ("Brightness", _brightness),
    ("Sharpness", _sharpness),
    ("Posterize", _posterize),
    ("Solarize", _solarize),
    ("AutoContrast", _autocontrast),
    ("Equalize", _equalize),
]


def rand_augment(num_ops: int = 4, magnitude: int = 16, num_magnitude_bins: int = 31):
    """RandAugment(n, m): apply n random ops at signed magnitude m/30."""

    def apply(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        pil = _pil(img)
        for _ in range(num_ops):
            _, op = RA_OPS[rng.integers(0, len(RA_OPS))]
            frac = magnitude / (num_magnitude_bins - 1)
            if rng.random() < 0.5:
                frac = -frac
            pil = op(pil, frac)
        return _np(pil)

    return apply


def horizontal_flip(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return img[:, ::-1] if rng.random() < 0.5 else img


def gaussian_blur(sigma_range=(0.1, 2.0), p: float = 0.5):
    """Random Gaussian blur — the one MoCo component on the reference's live
    path (`moco/loader.py` GaussianBlur via `augmentation.py:21`)."""

    def apply(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.random() >= p:
            return img
        from PIL import Image, ImageFilter

        sigma = rng.uniform(*sigma_range)
        return _np(_pil(img).filter(ImageFilter.GaussianBlur(radius=sigma)))

    return apply


def get_aug_policy(name: str, faa_file: Optional[str] = None) -> Callable:
    """Dispatcher mirroring `get_conventional_aug_policy`: "hf", "ra_4_16",
    "gan" (hf alias), "hf+ra_4_16"."""
    name = name.lower()
    if name in ("hf", "gan", "flip"):
        return horizontal_flip
    if name.startswith("ra_"):
        _, n, m = name.split("_")
        ra = rand_augment(int(n), int(m))

        def combined(img, rng):
            return ra(horizontal_flip(img, rng), rng)

        return combined
    if name in ("blur", "moco_blur"):
        blur = gaussian_blur()

        def blur_hf(img, rng):
            return blur(horizontal_flip(img, rng), rng)

        return blur_hf
    if name.startswith("faa"):
        # FastAutoAugment policy tables — published tuned constants
        # (`FR_training/utils/FAA_policy.py:238,441`, themselves adapted
        # from rpmcruz/autoaugment) — ship as a parsed JSON artifact
        # (faa_policies.json: "casia" = IResNet50CasiaPolicy's 50
        # subpolicies, "imgnet" = ReducedImageNetPolicy's 498), so
        # `faa_casia`/`faa_imgnet` work out of the box. FAA_POLICY_FILE /
        # faa_file still override with an external FAA_policy.py.
        path = faa_file or os.environ.get("FAA_POLICY_FILE")
        which = "casia" if "casia" in name else "imgnet"
        policies = load_faa_policies(path, which)
        faa = faa_augment(policies)

        def faa_hf(img, rng):
            # reference order: flip + FAA (`augmentation.py:75-85`)
            return faa(horizontal_flip(img, rng), rng)

        return faa_hf
    raise ValueError(f"unknown augmentation policy {name!r}")


# ---------------------------------------------------------------------------
# FastAutoAugment shim: parse the reference's policy tables, apply with our
# PIL op set (`FR_training/utils/FAA_policy.py` Augmentation.__call__
# semantics: pick ONE random subpolicy; apply each (name, pr, level) op with
# probability pr at level∈[0,1] linearly mapped onto the AutoAugment ranges,
# `augment_list:197-222`; geometric ops mirror sign with prob 0.5).
# ---------------------------------------------------------------------------

# (low, high) AutoAugment ranges — published constants (category (b))
_FAA_RANGES = {
    "ShearX": (-0.3, 0.3),
    "ShearY": (-0.3, 0.3),
    "TranslateX": (-0.45, 0.45),
    "TranslateY": (-0.45, 0.45),
    "TranslateXAbs": (0.0, 10.0),
    "TranslateYAbs": (0.0, 10.0),
    "Rotate": (-30.0, 30.0),
    "AutoContrast": (0.0, 1.0),
    "Invert": (0.0, 1.0),
    "Equalize": (0.0, 1.0),
    "Solarize": (0.0, 256.0),
    "Posterize": (4.0, 8.0),
    "Posterize2": (0.0, 4.0),
    "Contrast": (0.1, 1.9),
    "Color": (0.1, 1.9),
    "Brightness": (0.1, 1.9),
    "Sharpness": (0.1, 1.9),
    "Cutout": (0.0, 0.2),
    "CutoutAbs": (0.0, 20.0),
}
_FAA_MIRRORED = {"ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
                 "TranslateXAbs", "TranslateYAbs"}


def load_faa_policies(path: Optional[str] = None, which: str = "casia"):
    """FAA policy tables: the bundled `faa_policies.json` artifact by
    default (parsed once from the published tables), or — given a `path` —
    extract the policy literals (`iresnet50_casia_policies` /
    `fa_resnet50_rimagenet`) from an external FAA_policy.py without
    importing it. Returns a list of subpolicies:
    [[(op, prob, level), ...], ...]."""
    import ast
    import json

    if path is None or path.endswith(".json"):
        if path is None:
            path = os.path.join(os.path.dirname(__file__), "faa_policies.json")
        with open(path) as f:
            tables = json.load(f)
        if which not in tables:
            raise ValueError(f"{which!r} not in {path} (has {sorted(tables)})")
        return tables[which]

    target = "iresnet50_casia_policies" if which == "casia" else "fa_resnet50_rimagenet"
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == target for t in node.targets
        ):
            return ast.literal_eval(node.value)
    raise ValueError(f"{target!r} not found in {path}")


def _faa_apply_one(img, name: str, level: float, rng: np.random.Generator):
    from PIL import Image, ImageEnhance, ImageOps

    lo, hi = _FAA_RANGES[name]
    v = level * (hi - lo) + lo
    if name in _FAA_MIRRORED and rng.random() > 0.5:
        v = -v
    pil = _pil(img)
    w, h = pil.size
    if name == "ShearX":
        out = pil.transform(pil.size, Image.AFFINE, (1, v, 0, 0, 1, 0))
    elif name == "ShearY":
        out = pil.transform(pil.size, Image.AFFINE, (1, 0, 0, v, 1, 0))
    elif name == "TranslateX":
        out = pil.transform(pil.size, Image.AFFINE, (1, 0, v * w, 0, 1, 0))
    elif name == "TranslateY":
        out = pil.transform(pil.size, Image.AFFINE, (1, 0, 0, 0, 1, v * h))
    elif name == "TranslateXAbs":
        out = pil.transform(pil.size, Image.AFFINE, (1, 0, v, 0, 1, 0))
    elif name == "TranslateYAbs":
        out = pil.transform(pil.size, Image.AFFINE, (1, 0, 0, 0, 1, v))
    elif name == "Rotate":
        out = pil.rotate(v)
    elif name == "AutoContrast":
        out = ImageOps.autocontrast(pil)
    elif name == "Invert":
        out = ImageOps.invert(pil)
    elif name == "Equalize":
        out = ImageOps.equalize(pil)
    elif name == "Solarize":
        out = ImageOps.solarize(pil, int(v))
    elif name == "Posterize":
        out = ImageOps.posterize(pil, max(1, int(v)))
    elif name == "Posterize2":
        out = ImageOps.posterize(pil, max(1, int(v)))
    elif name == "Contrast":
        out = ImageEnhance.Contrast(pil).enhance(v)
    elif name == "Color":
        out = ImageEnhance.Color(pil).enhance(v)
    elif name == "Brightness":
        out = ImageEnhance.Brightness(pil).enhance(v)
    elif name == "Sharpness":
        out = ImageEnhance.Sharpness(pil).enhance(v)
    elif name in ("Cutout", "CutoutAbs"):
        size = int(abs(v) * min(w, h)) if name == "Cutout" else int(abs(v))
        if size > 0:
            x0 = int(rng.integers(0, max(1, w - size)))
            y0 = int(rng.integers(0, max(1, h - size)))
            arr = _np(pil).copy()
            arr[y0 : y0 + size, x0 : x0 + size] = 125  # FAA gray fill
            out = _pil(arr)
        else:
            out = pil
    else:
        raise ValueError(f"unknown FAA op {name!r}")
    return _np(out)


def faa_augment(policies) -> Callable:
    """Policy applier mirroring `Augmentation.__call__` (FAA_policy.py:27-38)."""

    def apply(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        sub = policies[int(rng.integers(0, len(policies)))]
        for op_name, pr, level in sub:
            if rng.random() > pr:
                continue
            img = _faa_apply_one(img, op_name, float(level), rng)
        return img

    return apply
