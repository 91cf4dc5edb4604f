"""StableDiffusionPipeline-style txt2img API (port of
`faceposegenerator_tpu/pipelines/txt2img.py:35-439`, the random-weight,
token-id surface):

    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    pipe.set_lora(lora)                      # factored adapters, swapped in place
    images = pipe(input_ids=ids, num_inference_steps=30, guidance_scale=5.0,
                  height=512, width=512, seed=identity_index)

`from_pretrained`, real-checkpoint loading and the BPE tokenizer wait until
the weight and vocab files are in the repository; `input_ids` are token ids.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..core.precision import Policy
from ..core.rng import sampler_generator
from ..diffusion.sampler import SamplerModels, sample
from ..diffusion.schedulers import SchedulerConfig, make_ddpm
from ..models.clip_text import CLIPTextModel
from ..models.unet2d import UNet2DCondition
from ..models.vae import AutoencoderKL


class StableDiffusionPipeline:
    def __init__(self, nets: dict, models: SamplerModels = SamplerModels(),
                 policy: Optional[Policy] = None,
                 scheduler_config: SchedulerConfig = SchedulerConfig()):
        self.nets = nets
        self.models = models
        dtype = nets["unet"].conv_in.weight.dtype
        self.policy = policy if policy is not None else Policy(param_dtype=dtype, compute_dtype=dtype)
        self.scheduler_config = scheduler_config
        self.scheduler_kind = "ddpm"
        self.lora = None
        self.lora_scale = 1.0

    @property
    def device(self) -> torch.device:
        return self.nets["unet"].conv_in.weight.device

    @classmethod
    def from_random(cls, seed: int = 0, models: SamplerModels = SamplerModels(),
                    dtype: torch.dtype = torch.float32, device=None, **kw):
        """Random-weight pipeline at `models`' widths, weights from `seed`,
        on the card unless `device` says otherwise."""
        device = resolve_device(device)
        nets = {
            "text_encoder": CLIPTextModel(models.text_cfg, device=device, dtype=dtype, seed=seed),
            "unet": UNet2DCondition(models.unet_cfg, device=device, dtype=dtype, seed=seed + 1),
            "vae": AutoencoderKL(models.vae_cfg, device=device, dtype=dtype, seed=seed + 2),
        }
        return cls(nets, models, **kw)

    def set_scheduler(self, kind: str):
        if kind == "dpm":
            raise NotImplementedError("the DPM-Solver++ scheduler is not yet ported")
        if kind != "ddpm":
            raise ValueError(f"unknown scheduler {kind!r}")
        self.scheduler_kind = kind

    def set_lora(self, lora: Optional[dict], scale: float = 1.0):
        """lora: {"unet": tree, "text_encoder": tree or None} in the layout
        of `models.unet2d.init_lora`; tensors on the pipeline's device."""
        self.lora = lora
        self.lora_scale = scale

    def unload_lora_weights(self):
        self.lora = None

    def __call__(self, *, input_ids, negative_input_ids=None, num_inference_steps: int = 30,
                 guidance_scale: float = 5.0, height: int = 512, width: int = 512,
                 seed: Optional[int] = None, noise_override=None, output_type: str = "np"):
        """Images (B, height, width, 3) in [0, 1]: a float32 numpy array for
        output_type "np", a tensor on the device for "pt"."""
        input_ids = torch.as_tensor(input_ids).long()
        if negative_input_ids is None:
            negative_input_ids = torch.zeros_like(input_ids)  # txt2img.py:330-331
        negative_input_ids = torch.as_tensor(negative_input_ids).long()
        if negative_input_ids.shape[0] == 1 and input_ids.shape[0] > 1:
            negative_input_ids = negative_input_ids.expand(input_ids.shape[0], -1)
        images = sample(
            self.nets, make_ddpm(self.scheduler_config, num_inference_steps),
            input_ids, negative_input_ids,
            generator=sampler_generator(seed if seed is not None else 0, self.device),
            guidance_scale=float(guidance_scale), height=height, width=width,
            policy=self.policy, attn_impl=self.models.attn_impl,
            lora=self.lora, lora_scale=self.lora_scale, noise_override=noise_override,
        )
        if output_type == "np":
            return images.cpu().numpy()
        if output_type == "pt":
            return images
        raise ValueError(f"unknown output_type {output_type!r}")
