"""txt2img sampler, exact path (port of `faceposegenerator_tpu/diffusion/sampler.py:59-406`):
CLIP on [uncond; cond] → S × (UNet on [x; x] → guidance → DDPM step) →
VAE decode → [0, 1].

The JAX package compiles this into one program; here it is an eager Python
loop whose step indices are host ints, so the loop never waits on the card.
Capturing it in a CUDA graph is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.precision import DEFAULT_POLICY, Policy
from ..models import clip_text, unet2d, vae
from .schedulers import DDPMSchedule


@dataclasses.dataclass(frozen=True)
class SamplerModels:
    """Configs of the three networks, and the attention impl they use."""

    text_cfg: clip_text.CLIPTextConfig = clip_text.SD21_TEXT_CONFIG
    unet_cfg: unet2d.UNetConfig = unet2d.SD21_UNET_CONFIG
    vae_cfg: vae.VAEConfig = vae.SD_VAE_CONFIG
    attn_impl: str = "auto"


@torch.inference_mode()
def sample(
    nets: dict,
    schedule: DDPMSchedule,
    input_ids: torch.Tensor,
    negative_input_ids: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    guidance_scale: float = 5.0,
    height: int = 512,
    width: int = 512,
    policy: Policy = DEFAULT_POLICY,
    attn_impl: str = "auto",
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    noise_override=None,
    return_trajectory: bool = False,
):
    """Generate (B, H, W, 3) fp32 images in [0, 1].

    nets: {"text_encoder": CLIPTextModel, "unet": UNet2DCondition,
    "vae": AutoencoderKL}. input_ids / negative_input_ids: (B, 77) token ids.
    lora: {"unet": tree or None, "text_encoder": tree or None}.
    noise_override: (S+1, B, h, w, 4), the initial latent at index 0 and
    step i's noise at index i+1 (sampler.py:93-95), replacing `generator`.
    return_trajectory: also return the latents after each step, (S, B, h, w, 4).
    """
    policy.configure_backends()
    unet = nets["unet"]
    device = unet.conv_in.weight.device
    B = input_ids.shape[0]
    h, w = height // 8, width // 8
    S = schedule.num_inference_steps
    lora = lora or {}
    if noise_override is not None:
        if not isinstance(noise_override, torch.Tensor):
            noise_override = torch.from_numpy(np.asarray(noise_override, np.float32))
        noise_override = noise_override.to(device=device, dtype=torch.float32)
        if noise_override.shape != (S + 1, B, h, w, 4):
            raise ValueError(f"noise_override {tuple(noise_override.shape)} != {(S + 1, B, h, w, 4)}")

    def noise(i):
        if noise_override is not None:
            return noise_override[i]
        return torch.randn((B, h, w, 4), generator=generator, device=device, dtype=torch.float32)

    ids = torch.cat([torch.as_tensor(negative_input_ids), torch.as_tensor(input_ids)]).to(device)
    ctx = nets["text_encoder"](ids, policy, lora=lora.get("text_encoder"), lora_scale=lora_scale)

    x = noise(0)
    traj = []
    for i in range(S):
        t = int(schedule.timesteps[i])
        eps = unet(torch.cat([x, x]), t, ctx, policy, lora=lora.get("unet"),
                   lora_scale=lora_scale, attn_impl=attn_impl)
        eps_u, eps_c = eps.chunk(2)
        x, _ = schedule.step(eps_u + guidance_scale * (eps_c - eps_u), i, x, noise(i + 1))
        if return_trajectory:
            traj.append(x)

    images = nets["vae"].decode(x, policy, attn_impl=attn_impl)
    images = (images * 0.5 + 0.5).clamp(0.0, 1.0)
    if return_trajectory:
        return images, torch.stack(traj)
    return images
