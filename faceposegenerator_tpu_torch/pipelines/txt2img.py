"""StableDiffusionPipeline-style txt2img API (port of
`faceposegenerator_tpu/pipelines/txt2img.py:35-439`, the random-weight,
token-id surface):

    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    pipe.set_lora(lora)                      # factored adapters, swapped in place
    images = pipe(input_ids=ids, num_inference_steps=30, guidance_scale=5.0,
                  height=512, width=512, seed=identity_index)

and the turbo preset (`pipelines.presets`):

    kw = get_preset("turbo").apply(pipe, input_ids=calib_ids)  # dpm, w8a8+vae, calibration
    images = pipe(input_ids=ids, num_inference_steps=12, seed=s, **kw)

`from_pretrained`, real-checkpoint loading and the BPE tokenizer wait until
the weight and vocab files are in the repository; `input_ids` are token ids.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..core.device import resolve_device
from ..core.precision import Policy
from ..core.rng import sampler_generator
from ..diffusion.sampler import SamplerModels, sample
from ..diffusion.schedulers import SchedulerConfig, make_ddpm, make_dpm_solver
from ..models.clip_text import CLIPTextModel
from ..models.unet2d import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..ops import quant


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
        """Swap DDPM and DPM-Solver++ ("ddpm" / "dpm")."""
        if kind not in ("ddpm", "dpm"):
            raise ValueError(f"unknown scheduler {kind!r} (only 'ddpm'/'dpm')")
        self.scheduler_kind = kind

    def set_lora(self, lora: Optional[dict], scale: float = 1.0):
        """lora: {"unet": tree, "text_encoder": tree or None} in the layout
        of `models.unet2d.init_lora`; tensors on the pipeline's device."""
        self.lora = lora
        self.lora_scale = scale

    def unload_lora_weights(self):
        self.lora = None

    def quantize(self, mode: str = "w8a8", act_scale: Optional[float] = None):
        """Opt-in int8 weights (`ops/quant.py`), in place and for good on
        this pipeline: the UNet's dense layers run kernel K7 and its convs
        `qconv2d`, with dynamic activation scales until `calibrate_quant`
        (or a constant static `act_scale`). "w8a8+vae" also quantizes the VAE
        decoder body. LoRA deltas stay factored over the int8 base."""
        if mode not in ("w8a8", "w8a8+vae"):
            raise ValueError(f"unknown quantize mode {mode!r} (only 'w8a8'/'w8a8+vae')")
        quant.quantize_unet(self.nets["unet"], act_scale=act_scale)
        if mode.endswith("+vae"):
            quant.quantize_vae(self.nets["vae"], act_scale=act_scale)

    def tokenize(self, prompts: Union[str, List[str]]):
        raise ValueError("no tokenizer loaded; pass input_ids directly")

    @torch.inference_mode()
    def calibrate_quant(self, prompt: Union[str, List[str], None] = None, *, negative_prompt=None,
                        input_ids=None, negative_input_ids=None, steps: int = 4, seed: int = 0,
                        height: int = 512, width: int = 512, guidance_scale: float = 5.0,
                        margin: float = 1.1) -> dict:
        """Freeze static per-tensor activation scales (amax·margin/127) into
        every quantized site (txt2img.py:167-248): a `steps`-step DDPM CFG
        denoise without LoRA and one decode run under
        `quant.observe_act_scales`, with the generator of `seed`. Call after
        `quantize()`. Returns the observations."""
        if input_ids is None:
            input_ids = self.tokenize(prompt)
        input_ids, negative_input_ids = self._ids(input_ids, negative_input_ids)
        self.policy.configure_backends()
        nets, device = self.nets, self.device
        B, h, w = input_ids.shape[0], height // 8, width // 8
        sched = make_ddpm(self.scheduler_config, steps)
        ids = torch.cat([negative_input_ids, input_ids]).to(device)
        ctx = nets["text_encoder"](ids, self.policy)
        g = sampler_generator(seed, device)
        x = torch.randn((B, h, w, 4), generator=g, device=device, dtype=torch.float32)
        with quant.observe_act_scales() as calib:
            for i in range(steps):
                eps = nets["unet"](torch.cat([x, x]), int(sched.timesteps[i]), ctx, self.policy,
                                   attn_impl=self.models.attn_impl)
                eps_u, eps_c = eps.chunk(2)
                noise = torch.randn(x.shape, generator=g, device=device, dtype=torch.float32)
                x, _ = sched.step(eps_u + guidance_scale * (eps_c - eps_u), i, x, noise)
            nets["vae"].decode(x, self.policy, attn_impl=self.models.attn_impl)
        if not calib:
            raise ValueError("no quantized sites observed — call quantize() first")
        quant.freeze_act_scales({"unet": nets["unet"], "vae": nets["vae"]}, calib, margin=margin)
        return calib

    def save_quant_scales(self, path: str) -> int:
        """Write the static scales of the UNet and VAE sites as JSON, keyed by
        the JAX tree path (the JAX package's file format)."""
        return quant.save_act_scales({"unet": self.nets["unet"], "vae": self.nets["vae"]}, path)

    def load_quant_scales(self, path: str):
        """Attach saved static scales to this quantized pipeline; raises on
        layout drift."""
        quant.load_act_scales({"unet": self.nets["unet"], "vae": self.nets["vae"]}, path)

    @staticmethod
    def _ids(input_ids, negative_input_ids):
        input_ids = torch.as_tensor(input_ids).long()
        if negative_input_ids is None:
            negative_input_ids = torch.zeros_like(input_ids)  # txt2img.py:330-331
        negative_input_ids = torch.as_tensor(negative_input_ids).long()
        if negative_input_ids.shape[0] == 1 and input_ids.shape[0] > 1:
            negative_input_ids = negative_input_ids.expand(input_ids.shape[0], -1)
        return input_ids, negative_input_ids

    def __call__(self, *, input_ids, negative_input_ids=None, num_inference_steps: int = 30,
                 guidance_scale: float = 5.0, height: int = 512, width: int = 512,
                 seed: Optional[int] = None, noise_override=None, output_type: str = "np",
                 deepcache_interval: int = 1, deepcache_depth: int = 1,
                 cfg_interval: Optional[tuple] = None):
        """Images (B, height, width, 3) in [0, 1]: a float32 numpy array for
        output_type "np", a tensor on the device for "pt"."""
        input_ids, negative_input_ids = self._ids(input_ids, negative_input_ids)
        if self.scheduler_kind == "ddpm":
            sched = make_ddpm(self.scheduler_config, num_inference_steps)
        else:
            sched = make_dpm_solver(self.scheduler_config, num_inference_steps)
        images = sample(
            self.nets, sched, input_ids, negative_input_ids,
            generator=sampler_generator(seed if seed is not None else 0, self.device),
            guidance_scale=float(guidance_scale), height=height, width=width,
            policy=self.policy, scheduler=self.scheduler_kind, attn_impl=self.models.attn_impl,
            lora=self.lora, lora_scale=self.lora_scale, noise_override=noise_override,
            deepcache_interval=deepcache_interval, deepcache_depth=deepcache_depth,
            cfg_interval=None if cfg_interval is None else tuple(cfg_interval),
        )
        if output_type == "np":
            return images.cpu().numpy()
        if output_type == "pt":
            return images
        raise ValueError(f"unknown output_type {output_type!r}")
