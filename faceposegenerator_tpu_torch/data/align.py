"""Face alignment: a similarity transform to the ArcFace 112² template (port
of `faceposegenerator_tpu/data/align.py:31-103`).

Estimate a similarity transform from 5 detected landmarks to the insightface
ArcFace reference points (the 112×96 template shifted 8 px in x for
112×112) by the closed-form Umeyama algorithm, then warp-crop to 112². Host
numpy, as in the JAX package, which calls OpenCV for the two resamplings;
the port imports no cv2 and reproduces them:

  - `norm_crop` is `cv2.warpAffine(img, M, (S, S), borderValue=0)`: the
    inverse map of each output pixel centre in float64, bilinear over four
    taps, a tap outside the image 0, rounded half to even. OpenCV 5 samples
    at the exact position, as this does; OpenCV 4 rounds the position to
    1/32 px and its uint8 weights to 15 bits, which can move a value by a
    few codes at a sharp edge.
  - `bbox_crop_resize` is `cv2.resize(crop, (S, S))` (INTER_LINEAR):
    half-pixel centres, source positions clamped to the image, no
    antialias. For uint8 it follows OpenCV's fixed point: 11-bit weights,
    a horizontal pass in int32, the vertical pass as its vector code does
    it ((S0 >> 4)·b0 >> 16 + (S1 >> 4)·b1 >> 16 + 2) >> 2.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# insightface 5-point template for 112×96, x+8 → 112×112 (public constants;
# reference `utils/detect_align_crop_data.py:182-196`)
ARCFACE_TEMPLATE_112 = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Closed-form least-squares similarity transform (rotation+scale+shift)
    mapping src (N,2) onto dst (N,2). Returns a 2x3 affine matrix."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / n
    u, s, vt = np.linalg.svd(cov)
    sign = np.ones(d)
    if np.linalg.det(cov) < 0:
        sign[-1] = -1
    r = u @ np.diag(sign) @ vt
    var_s = (sc**2).sum() / n
    scale = (s * sign).sum() / var_s if var_s > 0 else 1.0
    t = mu_d - scale * r @ mu_s
    m = np.zeros((2, 3))
    m[:, :2] = scale * r
    m[:, 2] = t
    return m.astype(np.float32)


def estimate_norm(landmarks_5: np.ndarray, image_size: int = 112) -> np.ndarray:
    """5-landmark (5,2) -> 2x3 warp matrix onto the ArcFace template
    (reference `estimate_norm`, `utils/detect_align_crop_data.py:132-167`)."""
    assert landmarks_5.shape == (5, 2)
    dst = ARCFACE_TEMPLATE_112 * (image_size / 112.0)
    return umeyama_similarity(landmarks_5, dst)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """`cv2.invertAffineTransform` in float64."""
    m = np.asarray(m, np.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * det, m[0, 0] * det, -m[0, 1] * det, -m[1, 0] * det
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def _cast_like(values: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(values), info.min, info.max).astype(dtype)
    return values.astype(dtype)


def warp_affine(img: np.ndarray, m: np.ndarray, size: int) -> np.ndarray:
    """`cv2.warpAffine(img, m, (size, size), borderValue=0)`, bilinear."""
    a = _invert_affine(m)
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    xs = a[0, 0] * xx + a[0, 1] * yy + a[0, 2]
    ys = a[1, 0] * xx + a[1, 1] * yy + a[1, 2]
    x0, y0 = np.floor(xs).astype(np.int64), np.floor(ys).astype(np.int64)
    fx, fy = xs - x0, ys - y0
    src = img.astype(np.float64)
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return vals * (inside[..., None] if img.ndim == 3 else inside)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return _cast_like(top * (1 - fy) + bot * fy, img.dtype)


def norm_crop(img: np.ndarray, landmarks_5: np.ndarray, image_size: int = 112) -> np.ndarray:
    """Warp-crop an HWC uint8/float image to the aligned template
    (reference `norm_crop`, `utils/detect_align_crop_data.py:169-179`)."""
    m = estimate_norm(np.asarray(landmarks_5, np.float32), image_size)
    return warp_affine(img, m, image_size)


def pad_image(img: np.ndarray, fraction: float = 0.5) -> Tuple[np.ndarray, int, int]:
    """Zero-pad each side by `fraction` of the dimension — the reference pads
    50% before detection so MTCNN finds faces near borders
    (`utils/detect_align_crop_data.py:81-105`). Returns (padded, px, py)."""
    h, w = img.shape[:2]
    py, px = int(h * fraction), int(w * fraction)
    out = np.zeros((h + 2 * py, w + 2 * px) + img.shape[2:], img.dtype)
    out[py : py + h, px : px + w] = img
    return out, px, py


def _linear_taps(ssize: int, dsize: int):
    """OpenCV's INTER_LINEAR source index and fraction of each output
    position along one axis (computed in float32, clamped to the image)."""
    pos = ((np.arange(dsize) + 0.5) * (ssize / dsize) - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= ssize - 1
    frac[low | high] = 0
    i0 = np.where(low, 0, np.where(high, ssize - 1, i0))
    return i0, np.minimum(i0 + 1, ssize - 1), frac


def resize_linear(img: np.ndarray, out_size: int) -> np.ndarray:
    """`cv2.resize(img, (out_size, out_size))` of an HWC or HW image."""
    if img.ndim == 2:
        return resize_linear(img[..., None], out_size)[..., 0]
    h, w = img.shape[:2]
    x0, x1, fx = _linear_taps(w, out_size)
    y0, y1, fy = _linear_taps(h, out_size)
    if img.dtype == np.uint8:
        ax1 = np.rint(fx.astype(np.float64) * 2048).astype(np.int64)
        ax0 = np.rint((np.float32(1) - fx).astype(np.float64) * 2048).astype(np.int64)
        by1 = np.rint(fy.astype(np.float64) * 2048).astype(np.int64)
        by0 = np.rint((np.float32(1) - fy).astype(np.float64) * 2048).astype(np.int64)
        s = img.astype(np.int64)
        rows = s[:, x0] * ax0[None, :, None] + s[:, x1] * ax1[None, :, None]
        v = (((rows[y0] >> 4) * by0[:, None, None]) >> 16) + (((rows[y1] >> 4) * by1[:, None, None]) >> 16)
        return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    s = img.astype(np.float32)
    fxe, fye = fx[None, :, None], fy[:, None, None]
    rows = s[:, x0] * (1 - fxe) + s[:, x1] * fxe
    return (rows[y0] * (1 - fye) + rows[y1] * fye).astype(img.dtype)


def bbox_crop_resize(img: np.ndarray, bbox: np.ndarray, out_size: int = 112) -> np.ndarray:
    """Plain bbox crop + resize — the looser alignment used inside training
    and embed extraction (`train_ID-Booth.py:1088-1092`,
    `extract_ArcFace_embeds.py:55-68`)."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = [int(round(float(v))) for v in bbox[:4]]
    x0, y0 = max(0, x0), max(0, y0)
    x1, y1 = min(w, x1), min(h, y1)
    if x1 <= x0 or y1 <= y0:
        return resize_linear(img, out_size)
    return resize_linear(img[y0:y1, x0:x1], out_size)


def to_arcface_input(faces: np.ndarray) -> np.ndarray:
    """uint8 (B,112,112,3) -> fp32 [-1,1] NHWC ArcFace input (reference
    `preprocess_image_for_ArcFace`, `ArcFace_files/ArcFace_functions.py:14-25`)."""
    x = np.asarray(faces, np.float32) / 255.0
    return (x - 0.5) / 0.5
