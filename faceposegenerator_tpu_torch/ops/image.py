"""Image ops (port of `faceposegenerator_tpu/ops/image.py:19-96`): the
differentiable crop of the ID-Booth identity branch, the resize and
normalisation before ArcFace, and the pipeline's uint8 quantize.

`crop_and_resize` samples a bilinear grid over each box, so its output shape
is fixed and its gradient flows back into the image (and from there through
the VAE decode into the LoRA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """Bilinear crop-and-resize, NHWC. images (B, H, W, C); boxes (B, 4) as
    (x0, y0, x1, y1) in pixels, clamped to [0, W-1] × [0, H-1]. Returns
    (B, out_size, out_size, C), differentiable into `images`."""
    b, h, w, _ = images.shape
    boxes = boxes.float()
    x0, x1 = boxes[:, 0].clamp(0, w - 1), boxes[:, 2].clamp(0, w - 1)
    y0, y1 = boxes[:, 1].clamp(0, h - 1), boxes[:, 3].clamp(0, h - 1)
    # the centres of out_size samples along each box edge
    t = (torch.arange(out_size, dtype=torch.float32, device=images.device) + 0.5) / out_size
    ys = y0[:, None] + t[None, :] * (y1 - y0)[:, None]  # (B, S)
    xs = x0[:, None] + t[None, :] * (x1 - x0)[:, None]
    yf, xf = torch.floor(ys), torch.floor(xs)
    wy = (ys - yf)[:, :, None, None]  # (B, S, 1, 1)
    wx = (xs - xf)[:, None, :, None]  # (B, 1, S, 1)
    yi0 = yf.long().clamp(0, h - 1)
    yi1 = (yi0 + 1).clamp(0, h - 1)
    xi0 = xf.long().clamp(0, w - 1)
    xi1 = (xi0 + 1).clamp(0, w - 1)
    bi = torch.arange(b, device=images.device)[:, None, None]

    def gather(yi, xi):  # (B, S, S, C)
        return images[bi, yi[:, :, None], xi[:, None, :]]

    top = gather(yi0, xi0) * (1 - wx) + gather(yi0, xi1) * wx
    bot = gather(yi1, xi0) * (1 - wx) + gather(yi1, xi1) * wx
    return top * (1 - wy) + bot * wy


def normalize_to_arcface(face: torch.Tensor) -> torch.Tensor:
    """[0, 255] face crop → [-1, 1] ArcFace input (image.py:92-96)."""
    return (face / 255.0 - 0.5) / 0.5


def resize_bilinear(images: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of NHWC images (image.py:72-80): to a square through
    the crop path, a box over the whole image; to any other shape as
    `jax.image.resize(..., "bilinear")` does, half-pixel centres with a
    triangle filter widened when shrinking (antialiased)."""
    b, h, w, _ = images.shape
    if out_hw[0] == out_hw[1]:
        boxes = torch.zeros((b, 4), device=images.device)  # filled on the card: no copy from the host
        boxes[:, 2], boxes[:, 3] = float(w - 1), float(h - 1)
        return crop_and_resize(images, boxes, out_hw[0])
    x = F.interpolate(images.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1)


def quantize_u8(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] float → uint8 on the images' device (image.py:83-89):
    round(x·255) (half to even, as jnp.round), clipped to [0, 255]."""
    return torch.round(images.float() * 255.0).clamp_(0, 255).to(torch.uint8)
