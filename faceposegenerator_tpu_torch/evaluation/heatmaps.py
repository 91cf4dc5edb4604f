"""FD-sensitivity heatmaps (port of `faceposegenerator_tpu/evaluation/heatmaps.py`).

Rebuild of `Evaluation/dgm-eval/dgm_eval/heatmaps/` (the `--heatmaps`
flag): which regions of a generated image push the Fréchet distance up. Two
mechanisms:

1. `GradCAM`, the reference's: the leave-one-out FD loss back-propagated to
   a late encoder layer; heatmap = Σ_c mean(grad²)_c · A_c. As in JAX, the
   encoder threads a functional `tap` to that layer, here one that keeps the
   activation A and adds a zero perturbation ε with requires_grad; the
   gradient with respect to ε is the hook gradient. Only the layers after
   the tap are in the backward: on the card, DINOv2's last layer runs K1
   with the log-sum-exp and K5, the 23 before it plain K1.
2. `make_heatmap_fn`: the input gradient of each sample's Mahalanobis
   distance to the real-feature Gaussian (every layer in the backward: K1
   with the log-sum-exp and K5 at each attention).

The loss's eigen-term is taken on the symmetric √C_r·C_g·√C_r with
`torch.linalg.eigvalsh`, as JAX takes it (heatmaps.py:71-81). Entry points
run on the card unless given `device="cpu"`.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..core.device import resolve_device


def fit_real_gaussian(reps_real: np.ndarray, eps: float = 1e-6, device=None):
    """(μ, Σ⁻¹) of the real features as fp32 tensors on `device`."""
    device = resolve_device(device)
    mu = reps_real.mean(axis=0)
    cov = np.cov(reps_real, rowvar=False) + eps * np.eye(reps_real.shape[1])
    prec = np.linalg.inv(cov)
    return (torch.as_tensor(mu, dtype=torch.float32, device=device),
            torch.as_tensor(prec, dtype=torch.float32, device=device))


def make_heatmap_fn(encode_fn: Callable, mu: torch.Tensor, precision: torch.Tensor, device=None):
    """encode_fn: differentiable (B, H, W, C) fp32 → (B, D). Returns
    heatmap_fn(images) → (scores (B,), heatmaps (B, H, W) in [0, 1]), tensors
    on `device` (the card unless told "cpu"); one forward and one backward
    a call."""
    device = resolve_device(device)
    mu, precision = mu.to(device), precision.to(device)

    def heatmap(images):
        x = torch.as_tensor(images, dtype=torch.float32, device=device).detach().requires_grad_(True)
        with torch.enable_grad():
            d = encode_fn(x) - mu[None]
            scores = torch.einsum("bi,ij,bj->b", d, precision, d)
            (grads,) = torch.autograd.grad(scores.sum(), x)
        sal = grads.abs().sum(dim=-1)  # (B, H, W)
        mx = sal.amax(dim=(1, 2), keepdim=True)
        return scores.detach(), sal / torch.clamp_min(mx, 1e-12)

    return heatmap


def w2_gaussian_loss(mu_real, cov_real_sqrt, tr_cov_real, mu_gen, cov_gen, eps=1e-12):
    """2-Wasserstein²(N(μ_r, C_r), N(μ_g, C_g)) with C_r constant
    (cov_real_sqrt = C_r^{1/2}); differentiable in (μ_g, C_g)."""
    mean_term = torch.sum(torch.square(mu_real - mu_gen))
    m = cov_real_sqrt @ cov_gen @ cov_real_sqrt
    ev = torch.linalg.eigvalsh((m + m.T) / 2.0)
    cov_term = tr_cov_real + torch.trace(cov_gen) - 2.0 * torch.sum(torch.sqrt(torch.abs(ev) + eps))
    return mean_term + cov_term


class GradCAM:
    """`gradcam.GradCAM` equivalent.

    encode_with_tap(images, tap) → (B, D) features, calling `tap` at the
    encoder's GradCAM target layer (the `make_*_gradcam_encoder`s)."""

    def __init__(self, encode_with_tap: Callable, reps_real: np.ndarray, reps_gen: np.ndarray, device=None):
        self.device = resolve_device(device)
        self._encode = encode_with_tap
        self.reps_gen = np.asarray(reps_gen, np.float64)
        mu = reps_real.mean(axis=0)
        cov = np.cov(reps_real, rowvar=False)
        w, v = np.linalg.eigh(cov)
        sqrt = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)  # noqa: E731
        self._mu_r, self._cov_r_sqrt, self._tr_cov_r = f32(mu), f32(sqrt), f32(np.trace(cov))

    def _loss_from_feats(self, feats, mean_gen, cov_gen, n):
        # update the gen statistics with the probed image (`gradcam.py:42-46`)
        mean = ((n - 1) / n) * mean_gen + (1.0 / n) * feats[0]
        d = feats - mean_gen[None]
        cov = ((n - 2) / (n - 1)) * cov_gen + (1.0 / n) * (d.T @ d)
        return w2_gaussian_loss(self._mu_r, self._cov_r_sqrt, self._tr_cov_r, mean, cov)

    def get_map(self, image: np.ndarray, idx: int):
        """image: (1, H, W, 3) preprocessed encoder input. Returns (heatmap
        (h, w) in [0, 1], delta_fid). One forward and one backward."""
        loo = np.delete(self.reps_gen, idx, axis=0)
        mean_gen = torch.as_tensor(loo.mean(axis=0), dtype=torch.float32, device=self.device)
        cov_gen = torch.as_tensor(np.cov(loo, rowvar=False), dtype=torch.float32, device=self.device)
        n = float(len(self.reps_gen))
        with torch.no_grad():
            original = float(w2_gaussian_loss(self._mu_r, self._cov_r_sqrt, self._tr_cov_r, mean_gen, cov_gen))
        captured = {}

        def tap(a):
            eps = torch.zeros(a.shape, dtype=torch.float32, device=a.device, requires_grad=True)
            captured["a"], captured["eps"] = a.detach().float(), eps
            return a + eps.to(a.dtype)

        x = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=self.device)
        with torch.enable_grad():
            feats = self._encode(x, tap).float()
            loss = self._loss_from_feats(feats, mean_gen, cov_gen, n)
            (grads,) = torch.autograd.grad(loss, captured["eps"])
        heat = self._heatmap(captured["a"].cpu().numpy(), grads.float().cpu().numpy())
        return heat, float(loss.detach()) - original

    @staticmethod
    def _heatmap(act: np.ndarray, grads: np.ndarray) -> np.ndarray:
        if act.ndim == 3:  # ViT (B, 1+N, D): drop CLS, fold tokens to a grid
            g = int(round((act.shape[1] - 1) ** 0.5))
            act = act[:, 1 : 1 + g * g].reshape(act.shape[0], g, g, -1)
            grads = grads[:, 1 : 1 + g * g].reshape(grads.shape[0], g, g, -1)
        # weights = per-channel mean of grad² (`gradcam.py:80-81`), NHWC here
        weights = np.mean(grads**2, axis=(1, 2), keepdims=True)
        heat = np.sum(weights * act, axis=-1)[0]
        lo, hi = heat.min(), heat.max()
        return (heat - lo) / max(hi - lo, 1e-12)


def make_inception_gradcam_encoder(model):
    """Tap at Mixed_7c (reference target 'blocks.3.2')."""

    def encode(images, tap):
        return model(images, tap=tap)

    return encode


def make_dinov2_gradcam_encoder(model):
    """Tap at the last layer's norm1 (reference target 'blocks.23.norm1' for
    both dinov2 and mae: the MAE ViT is this module)."""

    def encode(images, tap):
        return model.cls_feature(images, tap=tap)

    return encode


def make_swav_gradcam_encoder(model):
    """Tap at the final bottleneck output (reference target 'layer4.2')."""

    def encode(images, tap):
        return model(images, tap=tap).float()

    return encode


def make_clip_gradcam_encoder(model):
    """Tap at the last resblock's ln_1 (reference target
    'visual.transformer.resblocks.11.ln_1')."""

    def encode(images, tap):
        return model.cls_feature(images, tap=tap)

    return encode


def make_convnext_gradcam_encoder(model):
    """Tap at the last stage's final block (reference target
    'stages.3.blocks.2')."""

    def encode(images, tap):
        return model(images, tap=tap).float()

    return encode


def visualize_heatmaps(
    images: np.ndarray,
    reps_real: np.ndarray,
    reps_gen: np.ndarray,
    encode_with_tap: Callable,
    output_path: str,
    indices=None,
    per_row: int = 4,
    seed: int = 0,
    device=None,
):
    """`heatmaps.visualize_heatmaps` equivalent: sample images, compute
    FD-sensitivity GradCAMs, write an overlay grid PNG."""
    from ..pipelines.sweep import save_image_grid

    cam = GradCAM(encode_with_tap, reps_real, reps_gen, device=device)
    rnd = np.random.RandomState(seed)
    if indices is None:
        k = min(per_row * per_row, len(images))
        indices = rnd.choice(np.arange(len(images)), size=k, replace=False)
    tiles = []
    for idx in indices:
        img = images[int(idx)]
        heat, _ = cam.get_map(img[None], int(idx))
        u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8) if img.dtype != np.uint8 else img
        tiles.append(overlay_heatmap(u8, heat))
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    save_image_grid(np.stack(tiles), output_path, per_row=per_row)
    return indices


def overlay_heatmap(image: np.ndarray, heatmap: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """uint8 HWC image + (H, W) [0,1] heatmap -> red-overlay visualization."""
    h = np.asarray(heatmap)
    if h.shape != image.shape[:2]:
        from PIL import Image

        h = np.asarray(
            Image.fromarray((h * 255).astype(np.uint8)).resize(image.shape[:2][::-1])
        ) / 255.0
    overlay = image.astype(np.float32).copy()
    overlay[..., 0] = np.clip(overlay[..., 0] + alpha * 255 * h, 0, 255)
    return overlay.astype(np.uint8)
