"""AutoencoderKL (port of `faceposegenerator_tpu/models/vae.py:145-196`).

`decode` is on the sampling path and, differentiated, in the ID-Booth
identity branch; `encode_moments` and `sample_latents` start the train step.
Both mid blocks' single-head 512-channel attention goes through
`dot_product_attention`: K2 on the card (with the log-sum-exp, and K6 for
its backward, when a gradient is taken).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..ops.attention import dot_product_attention
from ..ops.lora import lora_dense
from ..ops.norms import group_norm
from .layers import Affine, conv2d, materialize
from .unet2d import upsample_nearest2x


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215


SD_VAE_CONFIG = VAEConfig()


class VAEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = Affine(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.norm2 = Affine(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = conv2d(group_norm(x, self.norm1.weight, self.norm1.bias, 32, 1e-6, "silu"), self.conv1)
        h = conv2d(group_norm(h, self.norm2.weight, self.norm2.bias, 32, 1e-6, "silu"), self.conv2)
        if self.conv_shortcut is not None:
            x = conv2d(x, self.conv_shortcut, padding=0)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = Affine(c)
        self.q = nn.Linear(c, c)
        self.k = nn.Linear(c, c)
        self.v = nn.Linear(c, c)
        self.out = nn.Linear(c, c)

    def forward(self, x, attn_impl: str = "auto"):
        """Single-head full-channel self-attention over spatial tokens (vae.py:72-89)."""
        b, h, w, c = x.shape
        t = group_norm(x, self.norm.weight, self.norm.bias, 32, 1e-6).reshape(b, h * w, c)
        q, k, v = (lora_dense(t, m.weight, m.bias).reshape(b, h * w, 1, c) for m in (self.q, self.k, self.v))
        o = dot_product_attention(q, k, v, impl=attn_impl).reshape(b, h * w, c)
        return x + lora_dense(o, self.out.weight, self.out.bias).reshape(b, h, w, c)


class VAEMid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.res1 = VAEResBlock(c, c)
        self.attn = VAEAttention(c)
        self.res2 = VAEResBlock(c, c)


class VAEUpBlock(nn.Module):
    def __init__(self, resnets, upsample):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.upsample = upsample


class VAEDownBlock(nn.Module):
    def __init__(self, resnets, downsample):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.downsample = downsample


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        C = list(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, C[0], 3)
        blocks, cin = [], C[0]
        for lvl, cout in enumerate(C):
            resnets = [VAEResBlock(cin if j == 0 else cout, cout) for j in range(cfg.layers_per_block)]
            blocks.append(VAEDownBlock(resnets, nn.Conv2d(cout, cout, 3) if lvl < len(C) - 1 else None))
            cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid = VAEMid(C[-1])
        self.norm_out = Affine(C[-1])
        self.conv_out = nn.Conv2d(C[-1], 2 * cfg.latent_channels, 3)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3)
        self.mid = VAEMid(rev[0])
        blocks, cin = [], rev[0]
        for lvl, cout in enumerate(rev):
            resnets = [VAEResBlock(cin if j == 0 else cout, cout) for j in range(cfg.layers_per_block + 1)]
            blocks.append(VAEUpBlock(resnets, nn.Conv2d(cout, cout, 3) if lvl < len(rev) - 1 else None))
            cin = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = Affine(cfg.block_out_channels[0])
        self.conv_out = nn.Conv2d(cfg.block_out_channels[0], cfg.in_channels, 3)


class AutoencoderKL(nn.Module):
    """The SD VAE: `encode_moments`/`sample_latents` and `decode`, NHWC."""

    def __init__(self, cfg: VAEConfig = SD_VAE_CONFIG, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        with torch.device("meta"):
            # the decoding half first, so its seeded weights do not depend on the encoder
            self.decoder = VAEDecoder(cfg)
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
            self.encoder = VAEEncoder(cfg)
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        materialize(self, device, dtype, torch.Generator(device=device).manual_seed(seed))

    def encode_moments(self, images: torch.Tensor, policy: Policy = DEFAULT_POLICY,
                       attn_impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
        """Images (B, H, W, 3) in [-1, 1] → (mean, logvar), each (B, H/8,
        W/8, 4) in fp32, logvar clipped to (-30, 20) (vae.py:145-166)."""
        enc = self.encoder
        x = conv2d(images.to(policy.compute_dtype), enc.conv_in)
        for block in enc.down_blocks:
            for rb in block.resnets:
                x = rb(x)
            if block.downsample is not None:
                # diffusers' VAE downsample pads asymmetrically: (0, 1) on H and W
                x = conv2d(F.pad(x, (0, 0, 0, 1, 0, 1)), block.downsample, stride=2, padding=0)
        x = enc.mid.res1(x)
        x = enc.mid.attn(x, attn_impl)
        x = enc.mid.res2(x)
        x = group_norm(x, enc.norm_out.weight, enc.norm_out.bias, 32, 1e-6, "silu")
        x = conv2d(x, enc.conv_out)
        x = conv2d(x, self.quant_conv, padding=0)
        mean, logvar = x.float().chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def sample_latents(self, moments, noise: torch.Tensor) -> torch.Tensor:
        """A draw from the diagonal Gaussian with the given N(0, 1) `noise`,
        times the scaling factor (vae.py:169-174)."""
        mean, logvar = moments
        return (mean + torch.exp(0.5 * logvar) * noise) * self.cfg.scaling_factor

    def decode(self, latents: torch.Tensor, policy: Policy = DEFAULT_POLICY,
               attn_impl: str = "auto") -> torch.Tensor:
        """Scaled latents (B, h, w, 4) → images (B, 8h, 8w, 3) in [-1, 1], fp32."""
        dec = self.decoder
        x = (latents / self.cfg.scaling_factor).to(policy.compute_dtype)
        x = conv2d(x, self.post_quant_conv, padding=0)
        x = conv2d(x, dec.conv_in)
        x = dec.mid.res1(x)
        x = dec.mid.attn(x, attn_impl)
        x = dec.mid.res2(x)
        for block in dec.up_blocks:
            for rb in block.resnets:
                x = rb(x)
            if block.upsample is not None:
                x = conv2d(upsample_nearest2x(x), block.upsample)
        x = group_norm(x, dec.norm_out.weight, dec.norm_out.bias, 32, 1e-6, "silu")
        return conv2d(x, dec.conv_out).float()
