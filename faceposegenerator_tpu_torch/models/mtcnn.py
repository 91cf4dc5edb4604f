"""MTCNN face-detection cascade, P-Net / R-Net / O-Net (port of
`faceposegenerator_tpu/models/mtcnn.py:41-632`).

The three small convnets run on the card, NHWC as in the JAX package; the
cascade around them (image pyramid scales, NMS, box regression, squaring,
landmarks) is host numpy, copied from the JAX package. Per pyramid scale one
call resizes the whole batch (`jax.image.resize`'s bilinear filter, widened
when it shrinks), normalises and runs P-Net; per later stage
one call gathers every candidate's crop from the batch on the card (the box
rounded half to even, zero outside the image, half-pixel bilinear) and runs
R-Net or O-Net. The JAX package pads the candidates to power-of-two buckets
in chunks of 2048 for XLA's compile cache; the port runs them in chunks of
at most `STAGE_CHUNK` for memory, which changes no result.

Weights: a JAX-layout tree (`init`'s keys; `convert_mtcnn_state_dict` makes
one from a facenet-pytorch state dict, `brightness_cascade_params` is the
hand-made bright-square detector), loaded by `bridge.jax_params`, or random
from a seed.

  P-Net: conv3x3×10 →PReLU→maxpool2→conv3x3×16→PReLU→conv3x3×32→PReLU
         → 1x1 heads: face prob (2), bbox reg (4)            [fully conv]
  R-Net: conv3x3×28→pool3s2→conv3x3×48→pool3s2→conv2x2×64→fc128
         → heads: prob (2), reg (4)                          [24×24 input]
  O-Net: conv3x3×32→pool3s2→conv3x3×64→pool3s2→conv3x3×64→pool2→conv2x2×128
         →fc256 → heads: prob (2), reg (4), landmarks (10)   [48×48 input]
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from .iresnet import prelu
from .layers import conv2d, materialize

STAGE_CHUNK = 4096


def _maxpool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """NHWC max pool in ceil mode: the last window may run over the bottom
    and right edges, which count as -inf (mtcnn.py:45-55)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s, ceil_mode=True).permute(0, 2, 3, 1)


def _flat_nchw(h: torch.Tensor) -> torch.Tensor:
    """facenet-pytorch flattens with a permute(0, 3, 2, 1): NHWC flattened
    (W, H, C)-major matches its fc weight layout (mtcnn.py:132-136)."""
    return h.permute(0, 2, 1, 3).reshape(h.shape[0], -1)


def _prob(cls: torch.Tensor) -> torch.Tensor:
    return torch.softmax(cls.float(), dim=-1)[..., 1]


class PNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 10, 3), nn.Parameter(torch.empty(10))
        self.conv2, self.prelu2 = nn.Conv2d(10, 16, 3), nn.Parameter(torch.empty(16))
        self.conv3, self.prelu3 = nn.Conv2d(16, 32, 3), nn.Parameter(torch.empty(32))
        self.cls = nn.Conv2d(32, 2, 1)
        self.reg = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        """(B, H, W, 3) normalised → (prob map (B, h, w), reg (B, h, w, 4))."""
        h = _maxpool(prelu(conv2d(x, self.conv1, padding=0), self.prelu1), 2, 2)
        h = prelu(conv2d(h, self.conv2, padding=0), self.prelu2)
        h = prelu(conv2d(h, self.conv3, padding=0), self.prelu3)
        return _prob(conv2d(h, self.cls, padding=0)), conv2d(h, self.reg, padding=0)


class RNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 28, 3), nn.Parameter(torch.empty(28))
        self.conv2, self.prelu2 = nn.Conv2d(28, 48, 3), nn.Parameter(torch.empty(48))
        self.conv3, self.prelu3 = nn.Conv2d(48, 64, 2), nn.Parameter(torch.empty(64))
        self.fc, self.prelu4 = nn.Linear(64 * 3 * 3, 128), nn.Parameter(torch.empty(128))
        self.cls = nn.Linear(128, 2)
        self.reg = nn.Linear(128, 4)

    def forward(self, x):
        h = _maxpool(prelu(conv2d(x, self.conv1, padding=0), self.prelu1), 3, 2)
        h = _maxpool(prelu(conv2d(h, self.conv2, padding=0), self.prelu2), 3, 2)
        h = prelu(conv2d(h, self.conv3, padding=0), self.prelu3)
        h = prelu(self.fc(_flat_nchw(h)), self.prelu4)
        return _prob(self.cls(h)), self.reg(h)


class ONet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 32, 3), nn.Parameter(torch.empty(32))
        self.conv2, self.prelu2 = nn.Conv2d(32, 64, 3), nn.Parameter(torch.empty(64))
        self.conv3, self.prelu3 = nn.Conv2d(64, 64, 3), nn.Parameter(torch.empty(64))
        self.conv4, self.prelu4 = nn.Conv2d(64, 128, 2), nn.Parameter(torch.empty(128))
        self.fc, self.prelu5 = nn.Linear(128 * 3 * 3, 256), nn.Parameter(torch.empty(256))
        self.cls = nn.Linear(256, 2)
        self.reg = nn.Linear(256, 4)
        self.lmk = nn.Linear(256, 10)

    def forward(self, x):
        h = _maxpool(prelu(conv2d(x, self.conv1, padding=0), self.prelu1), 3, 2)
        h = _maxpool(prelu(conv2d(h, self.conv2, padding=0), self.prelu2), 3, 2)
        h = _maxpool(prelu(conv2d(h, self.conv3, padding=0), self.prelu3), 2, 2)
        h = prelu(conv2d(h, self.conv4, padding=0), self.prelu4)
        h = prelu(self.fc(_flat_nchw(h)), self.prelu5)
        return _prob(self.cls(h)), self.reg(h), self.lmk(h)


class MTCNNNets(nn.Module):
    """The three nets under the JAX tree's keys {"pnet", "rnet", "onet"}."""

    def __init__(self, device=None, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        with torch.device("meta"):
            self.pnet, self.rnet, self.onet = PNet(), RNet(), ONet()
        materialize(self, device, torch.float32, torch.Generator(device=device).manual_seed(seed))


# ---------------------------------------------------------------------------
# cascade (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _nms(boxes: np.ndarray, scores: np.ndarray, thresh: float, method: str = "union"):
    order = scores.argsort()[::-1]
    keep = []
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        if method == "min":
            iou = inter / np.minimum(area[i], area[order[1:]])
        else:
            iou = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return np.asarray(keep, np.int64)


def _square(boxes):
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    cx = boxes[:, 0] + w / 2
    cy = boxes[:, 1] + h / 2
    out = boxes.copy()
    out[:, 0] = cx - side / 2
    out[:, 1] = cy - side / 2
    out[:, 2] = cx + side / 2
    out[:, 3] = cy + side / 2
    return out


def _norm(x):
    return (x - 127.5) / 128.0


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float64 weights of `jax.image.resize(...,
    "bilinear")` along one axis (jax `compute_weight_mat`): half-pixel
    centres, a triangle filter widened by in/out when shrinking, each
    column normalised, columns whose sample lies outside the input zero."""
    inv_scale = 1.0 / np.float64(np.float32(out_size / in_size))
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0.0)
    return np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0.0)


def pyramid_resize(imgs: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """NHWC bilinear resize as `jax.image.resize(..., "bilinear")` (the
    triangle filter widened when shrinking), as two contractions in float64
    rounded once to fp32: the card and the CPU give the same pyramid, so the
    P-Net scores that NMS orders differ between them by the nets' rounding
    only."""
    wh = torch.from_numpy(_resize_weights(imgs.shape[1], sh)).to(imgs.device)
    ww = torch.from_numpy(_resize_weights(imgs.shape[2], sw)).to(imgs.device)
    out = torch.einsum("bhwc,hH->bHwc", imgs.double(), wh)
    return torch.einsum("bHwc,wW->bHWc", out, ww).float()


def stage_crops(imgs: torch.Tensor, idx: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """(n, size, size, 3) crops of the boxes (n, 4) from images imgs[idx]:
    the box rounded half to even, the patch zero outside the image, resampled
    bilinearly with half-pixel centres (mtcnn.py:258-284)."""
    h, w = imgs.shape[1], imgs.shape[2]
    x1, y1, x2, y2 = torch.round(boxes).unbind(1)
    t = (torch.arange(size, dtype=torch.float32, device=imgs.device) + 0.5) / size
    ys = y1[:, None] + t[None, :] * (y2 - y1)[:, None] - 0.5
    xs = x1[:, None] + t[None, :] * (x2 - x1)[:, None] - 0.5
    yf, xf = torch.floor(ys), torch.floor(xs)
    wy = (ys - yf)[:, :, None, None]
    wx = (xs - xf)[:, None, :, None]
    y0, x0 = yf.long(), xf.long()
    b = idx[:, None, None]

    def tap(yi, xi):
        ok = ((yi >= 0) & (yi < h))[:, :, None] & ((xi >= 0) & (xi < w))[:, None, :]
        vals = imgs[b, yi.clamp(0, h - 1)[:, :, None], xi.clamp(0, w - 1)[:, None, :]]
        return vals * ok[..., None]

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


class MTCNN:
    """Cascade detector.

    detect(img) -> (boxes (N,4), probs (N,), landmarks (N,5,2)) or
    (None, None, None) — mirroring `mtcnn.detect(img, landmarks=...)`. Runs
    on `device` (the card unless "cpu")."""

    def __init__(
        self,
        params: Optional[Dict] = None,
        thresholds=(0.6, 0.7, 0.7),
        min_face_size: int = 20,
        factor: float = 0.709,
        device=None,
        seed: int = 0,
    ):
        from ..bridge.jax_params import load_jax_params

        self.device = resolve_device(device)
        self.nets = MTCNNNets(self.device, seed)
        if params is not None:
            load_jax_params(self.nets, params)
        self.thresholds = thresholds
        self.min_face_size = min_face_size
        self.factor = factor

    def _pyramid_scales(self, h, w):
        m = 12.0 / self.min_face_size
        min_side = min(h, w) * m
        scales = []
        s = m
        while min_side >= 12:
            scales.append(s)
            s *= self.factor
            min_side *= self.factor
        return scales

    def detect(self, img, landmarks: bool = False):
        """Single-image detection = batch-of-1 `detect_batch`."""
        res = self.detect_batch(np.asarray(img, np.float32)[None], landmarks=landmarks)
        if landmarks:
            return res[0][0], res[1][0], res[2][0]
        return res[0][0], res[1][0]

    @torch.no_grad()
    def _stage(self, net, imgs_dev, idx, boxes, size):
        outs = []
        for start in range(0, len(idx), STAGE_CHUNK):
            cidx = torch.from_numpy(idx[start : start + STAGE_CHUNK]).to(self.device)
            cboxes = torch.from_numpy(np.ascontiguousarray(boxes[start : start + STAGE_CHUNK, :4])).to(self.device)
            out = net(_norm(stage_crops(imgs_dev, cidx, cboxes, size)))
            outs.append([o.cpu().numpy() for o in out])
        return tuple(np.concatenate([o[k] for o in outs]) for k in range(len(outs[0])))

    @torch.no_grad()
    def detect_batch(self, imgs, landmarks: bool = False):
        """Batched detection over same-sized images (B, H, W, 3) in [0, 255],
        numpy or a tensor. The pyramid is shared by the batch and each stage
        runs as one call over all images' candidates (mtcnn.py:372-563).

        Returns (boxes, probs[, points]) as per-image lists; entries are
        None where no face survived — matching `detect`'s contract.
        """
        imgs_dev = torch.as_tensor(imgs).to(self.device, torch.float32)
        if imgs_dev.dim() != 4:
            raise ValueError("expected (B, H, W, C) image batch")
        B, h, w = imgs_dev.shape[:3]

        # ---- stage 1: P-Net over the shared pyramid, batched over images
        per_img = [[] for _ in range(B)]
        for scale in self._pyramid_scales(h, w):
            sh, sw = int(np.ceil(h * scale)), int(np.ceil(w * scale))
            if sh < 12 or sw < 12:
                continue
            prob, reg = self.nets.pnet(_norm(pyramid_resize(imgs_dev, sh, sw)))
            prob = prob.cpu().numpy()
            reg = reg.cpu().numpy()
            stride, cell = 2, 12
            for b in range(B):
                ys, xs = np.where(prob[b] > self.thresholds[0])
                if len(ys) == 0:
                    continue
                bb = np.stack(
                    [
                        (stride * xs) / scale,
                        (stride * ys) / scale,
                        (stride * xs + cell) / scale,
                        (stride * ys + cell) / scale,
                    ],
                    axis=1,
                )
                r = reg[b, ys, xs]
                scores = prob[b, ys, xs]
                keep = _nms(bb, scores, 0.5)
                per_img[b].append(
                    np.concatenate([bb[keep], scores[keep, None], r[keep]], axis=1)
                )

        def _none_result():
            nones = [None] * B
            return (nones, list(nones), list(nones)) if landmarks else (nones, list(nones))

        # per-image stage-1 NMS + regression + square
        cand = [None] * B
        for b in range(B):
            if not per_img[b]:
                continue
            boxes = np.concatenate(per_img[b])
            keep = _nms(boxes[:, :4], boxes[:, 4], 0.7)
            boxes = boxes[keep]
            bw = boxes[:, 2] - boxes[:, 0]
            bh = boxes[:, 3] - boxes[:, 1]
            reg_boxes = np.stack(
                [
                    boxes[:, 0] + boxes[:, 5] * bw,
                    boxes[:, 1] + boxes[:, 6] * bh,
                    boxes[:, 2] + boxes[:, 7] * bw,
                    boxes[:, 3] + boxes[:, 8] * bh,
                ],
                axis=1,
            )
            cand[b] = _square(reg_boxes)

        def _gathered_stage(boxes_per_img, size):
            """One stage over every image's candidates."""
            idx, boxes = [], []
            for b in range(B):
                if boxes_per_img[b] is not None and len(boxes_per_img[b]):
                    idx.append(np.full(len(boxes_per_img[b]), b, np.int64))
                    boxes.append(np.asarray(boxes_per_img[b][:, :4], np.float32))
            if not idx:
                return None, None
            idx = np.concatenate(idx)
            net = self.nets.rnet if size == 24 else self.nets.onet
            return idx, self._stage(net, imgs_dev, idx, np.concatenate(boxes), size)

        # ---- stage 2: R-Net, one call over all candidates
        idx, out = _gathered_stage(cand, 24)
        if idx is None:
            return _none_result()
        prob_all, reg_all = out
        for b in range(B):
            sel = idx == b
            if cand[b] is None or not sel.any():
                cand[b] = None
                continue
            boxes4, prob, reg = cand[b], prob_all[sel], reg_all[sel]
            mask = prob > self.thresholds[1]
            if not mask.any():
                cand[b] = None
                continue
            boxes4, prob, reg = boxes4[mask], prob[mask], reg[mask]
            keep = _nms(boxes4, prob, 0.7)
            boxes4, prob, reg = boxes4[keep], prob[keep], reg[keep]
            bw = boxes4[:, 2] - boxes4[:, 0]
            bh = boxes4[:, 3] - boxes4[:, 1]
            cand[b] = _square(
                np.stack(
                    [
                        boxes4[:, 0] + reg[:, 0] * bw,
                        boxes4[:, 1] + reg[:, 1] * bh,
                        boxes4[:, 2] + reg[:, 2] * bw,
                        boxes4[:, 3] + reg[:, 3] * bh,
                    ],
                    axis=1,
                )
            )

        # ---- stage 3: O-Net, one call over all survivors
        idx, out = _gathered_stage(cand, 48)
        if idx is None:
            return _none_result()
        prob_all, reg_all, lmk_all = out
        final_boxes, final_probs, final_points = [None] * B, [None] * B, [None] * B
        for b in range(B):
            sel = idx == b
            if cand[b] is None or not sel.any():
                continue
            boxes4, prob, reg, lmk = cand[b], prob_all[sel], reg_all[sel], lmk_all[sel]
            mask = prob > self.thresholds[2]
            if not mask.any():
                continue
            boxes4, prob, reg, lmk = boxes4[mask], prob[mask], reg[mask], lmk[mask]
            bw = boxes4[:, 2] - boxes4[:, 0]
            bh = boxes4[:, 3] - boxes4[:, 1]
            points = np.stack(
                [
                    boxes4[:, 0:1] + lmk[:, 0:5] * bw[:, None],
                    boxes4[:, 1:2] + lmk[:, 5:10] * bh[:, None],
                ],
                axis=2,
            )
            final = np.stack(
                [
                    boxes4[:, 0] + reg[:, 0] * bw,
                    boxes4[:, 1] + reg[:, 1] * bh,
                    boxes4[:, 2] + reg[:, 2] * bw,
                    boxes4[:, 3] + reg[:, 3] * bh,
                ],
                axis=1,
            )
            keep = _nms(final, prob, 0.7, method="min")
            final, prob, points = final[keep], prob[keep], points[keep]
            order = prob.argsort()[::-1]
            final_boxes[b] = final[order]
            final_probs[b] = prob[order]
            final_points[b] = points[order]
        if landmarks:
            return final_boxes, final_probs, final_points
        return final_boxes, final_probs


def convert_mtcnn_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """facenet-pytorch MTCNN state dict → the JAX-layout tree (numpy). Keys
    prefixed pnet./rnet./onet. with their layer names (conv1..., dense4/5/6...)."""

    def conv(prefix):
        return {"w": np.asarray(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0), "b": np.asarray(sd[f"{prefix}.bias"])}

    def fc(prefix):
        return {"w": np.asarray(sd[f"{prefix}.weight"]), "b": np.asarray(sd[f"{prefix}.bias"])}

    def pr(prefix):
        return np.asarray(sd[f"{prefix}.weight"]).reshape(-1)

    return {
        "pnet": {
            "conv1": conv("pnet.conv1"), "prelu1": pr("pnet.prelu1"),
            "conv2": conv("pnet.conv2"), "prelu2": pr("pnet.prelu2"),
            "conv3": conv("pnet.conv3"), "prelu3": pr("pnet.prelu3"),
            "cls": conv("pnet.conv4_1"), "reg": conv("pnet.conv4_2"),
        },
        "rnet": {
            "conv1": conv("rnet.conv1"), "prelu1": pr("rnet.prelu1"),
            "conv2": conv("rnet.conv2"), "prelu2": pr("rnet.prelu2"),
            "conv3": conv("rnet.conv3"), "prelu3": pr("rnet.prelu3"),
            "fc": fc("rnet.dense4"), "prelu4": pr("rnet.prelu4"),
            "cls": fc("rnet.dense5_1"), "reg": fc("rnet.dense5_2"),
        },
        "onet": {
            "conv1": conv("onet.conv1"), "prelu1": pr("onet.prelu1"),
            "conv2": conv("onet.conv2"), "prelu2": pr("onet.prelu2"),
            "conv3": conv("onet.conv3"), "prelu3": pr("onet.prelu3"),
            "conv4": conv("onet.conv4"), "prelu4": pr("onet.prelu4"),
            "fc": fc("onet.dense5"), "prelu5": pr("onet.prelu5"),
            "cls": fc("onet.dense6_1"), "reg": fc("onet.dense6_2"),
            "lmk": fc("onet.dense6_3"),
        },
    }


def brightness_cascade_params() -> Dict:
    """Deterministic hand-made weights (a JAX-layout numpy tree) that fire on
    a BRIGHT SQUARE: P-Net channel 0 averages brightness through the stack
    and the face logit is 50·feat−45 (prob≈1 only when the whole 12×12
    receptive field is bright); R-Net/O-Net always pass with zero regression
    and fixed landmark fractions (mtcnn.py:585-632). It exercises the whole
    cascade without facenet-pytorch's weights, and makes detection of
    synthetic bright-square faces deterministic."""
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731

    def conv(kh, kw, cin, cout, w=None, b=None):
        return {"w": z(kh, kw, cin, cout) if w is None else w, "b": z(cout) if b is None else b}

    def fc(cout, cin, b=None):
        return {"w": z(cout, cin), "b": z(cout) if b is None else b}

    w1 = z(3, 3, 3, 10)
    w1[:, :, :, 0] = 1.0 / 27.0  # channel 0 = brightness average
    w2 = z(3, 3, 10, 16)
    w2[:, :, 0, 0] = 1.0 / 9.0
    w3 = z(3, 3, 16, 32)
    w3[:, :, 0, 0] = 1.0 / 9.0
    wcls = z(1, 1, 32, 2)
    wcls[0, 0, 0, 1] = 50.0
    f32 = lambda *v: np.asarray(v, np.float32)  # noqa: E731
    pnet = {
        "conv1": conv(3, 3, 3, 10, w1), "prelu1": z(10),
        "conv2": conv(3, 3, 10, 16, w2), "prelu2": z(16),
        "conv3": conv(3, 3, 16, 32, w3), "prelu3": z(32),
        "cls": conv(1, 1, 32, 2, wcls, f32(0.0, -45.0)),
        "reg": conv(1, 1, 32, 4),
    }
    rnet = {
        "conv1": conv(3, 3, 3, 28), "prelu1": z(28),
        "conv2": conv(3, 3, 28, 48), "prelu2": z(48),
        "conv3": conv(2, 2, 48, 64), "prelu3": z(64),
        "fc": fc(128, 64 * 3 * 3), "prelu4": z(128),
        "cls": fc(2, 128, f32(0.0, 5.0)),  # always pass
        "reg": fc(4, 128),
    }
    onet = {
        "conv1": conv(3, 3, 3, 32), "prelu1": z(32),
        "conv2": conv(3, 3, 32, 64), "prelu2": z(64),
        "conv3": conv(3, 3, 64, 64), "prelu3": z(64),
        "conv4": conv(2, 2, 64, 128), "prelu4": z(128),
        "fc": fc(256, 128 * 3 * 3), "prelu5": z(256),
        "cls": fc(2, 256, f32(0.0, 5.0)),
        "reg": fc(4, 256),
        "lmk": fc(10, 256, f32(0.3, 0.7, 0.5, 0.3, 0.7, 0.3, 0.3, 0.5, 0.7, 0.7)),
    }
    return {"pnet": pnet, "rnet": rnet, "onet": onet}
