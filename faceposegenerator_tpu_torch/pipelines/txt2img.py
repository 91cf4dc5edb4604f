"""StableDiffusionPipeline-style txt2img API (port of
`faceposegenerator_tpu/pipelines/txt2img.py:35-439`):

    pipe = StableDiffusionPipeline.from_pretrained(model_dir)   # diffusers SD2.1 directory
    pipe.load_lora_weights(ckpt_dir)                          # pytorch_lora_weights.safetensors
    images = pipe(prompt, negative_prompt=..., num_inference_steps=30,
                  guidance_scale=5.0, height=512, width=512, seed=identity_index)

`from_random(seed=0, dtype=...)` builds random weights instead; `input_ids=`
takes token ids in place of prompts; a per-call `lora=`/`lora_scale=`
overrides the pipeline's adapter and may be per-sample. The turbo preset
(`pipelines.presets`):

    kw = get_preset("turbo").apply(pipe)   # dpm, w8a8+vae, calibration by prompt
    images = pipe(prompts, num_inference_steps=12, seed=s, **kw)
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Union

import torch

from ..bridge.jax_params import load_jax_params
from ..bridge.torch_weights import configs_from_model_dir, load_sd21_params
from ..core.device import resolve_device
from ..core.precision import Policy
from ..core.rng import sampler_generator
from ..data.tokenizer import CLIPTokenizer
from ..diffusion.lora_io import load_lora_safetensors
from ..diffusion.parallel_sampler import sample_parallel
from ..diffusion.sampler import SamplerModels, sample, sample_data_parallel
from ..diffusion.schedulers import SchedulerConfig, make_ddpm, make_dpm_solver
from ..models.clip_text import CLIPTextModel
from ..models.unet2d import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..ops import quant
from ..ops.image import quantize_u8


class StableDiffusionPipeline:
    def __init__(self, nets: dict, models: SamplerModels = SamplerModels(),
                 policy: Optional[Policy] = None,
                 scheduler_config: SchedulerConfig = SchedulerConfig(), tokenizer=None, mesh=None):
        self.nets = nets
        self.models = models
        dtype = nets["unet"].conv_in.weight.dtype
        self.policy = policy if policy is not None else Policy(param_dtype=dtype, compute_dtype=dtype)
        self.scheduler_config = scheduler_config
        self.tokenizer = tokenizer
        self.scheduler_kind = "ddpm"
        self.lora = None
        self.lora_scale = 1.0
        self.mesh = None
        if mesh is not None:
            self.to_mesh(mesh)

    def to_mesh(self, mesh):
        """Serve this pipeline data-parallel over a `core.mesh.Mesh`
        (txt2img.py:43-70): every call's prompt batch shards over the mesh's
        "data" axis (`sampler.sample_data_parallel`), and every rank returns
        the whole batch. The weights and the LoRA are made equal on every
        rank here, once, from rank 0's (a broadcast, so every rank calls
        this); `set_lora` after it does the same for a new adapter, which
        swaps tensors only. The batch of a call must divide the data axis."""
        from ..core.mesh import replicate

        self.mesh = mesh
        replicate(mesh, self.nets)
        if self.lora is not None:
            replicate(mesh, self.lora)

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

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype: torch.dtype = torch.bfloat16,
                        models: Optional[SamplerModels] = None, policy: Optional[Policy] = None, device=None):
        """A local diffusers-format SD2.1 directory (txt2img.py:75-98): the
        configs from its own config.json files unless `models` is given, the
        weights of unet/, vae/ and text_encoder/ (safetensors or .bin) in
        `dtype` on the card unless `device` says otherwise, and the CLIP
        tokenizer when tokenizer/ exists."""
        device = resolve_device(device)
        if models is None:
            text_cfg, unet_cfg, vae_cfg = configs_from_model_dir(model_dir)
            models = SamplerModels(text_cfg=text_cfg, unet_cfg=unet_cfg, vae_cfg=vae_cfg)
        trees = load_sd21_params(model_dir)
        nets = {
            "text_encoder": CLIPTextModel(models.text_cfg, device=device, dtype=dtype),
            "unet": UNet2DCondition(models.unet_cfg, device=device, dtype=dtype),
            "vae": AutoencoderKL(models.vae_cfg, device=device, dtype=dtype),
        }
        for name, net in nets.items():
            load_jax_params(net, trees.pop(name))
        tok_dir = os.path.join(model_dir, "tokenizer")
        tokenizer = CLIPTokenizer.from_pretrained(tok_dir) if os.path.isdir(tok_dir) else None
        if policy is None:
            policy = Policy(param_dtype=dtype, compute_dtype=dtype)
        return cls(nets, models, policy, tokenizer=tokenizer)

    def set_scheduler(self, kind: str):
        """Swap DDPM and DPM-Solver++ ("ddpm" / "dpm")."""
        if kind not in ("ddpm", "dpm"):
            raise ValueError(f"unknown scheduler {kind!r} (only 'ddpm'/'dpm')")
        self.scheduler_kind = kind

    def set_lora(self, lora: Optional[dict], scale: float = 1.0):
        """lora: {"unet": tree, "text_encoder": tree or None} in the layout
        of `models.unet2d.init_lora`; tensors on the pipeline's device."""
        if lora is not None and self.mesh is not None:
            from ..core.mesh import replicate

            replicate(self.mesh, lora)
        self.lora = lora
        self.lora_scale = scale

    def load_lora_weights(self, path_or_dir: str, scale: float = 1.0):
        """A diffusers/peft LoRA checkpoint (`pytorch_lora_weights.safetensors`
        or its directory), UNet and text-encoder keys, on the pipeline's
        device in `policy.param_dtype`; modules the file lacks get zero pairs."""
        self.set_lora(load_lora_safetensors(path_or_dir, self.nets["unet"], self.nets["text_encoder"],
                                            dtype=self.policy.param_dtype), scale)

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

    def tokenize(self, prompts: Union[str, List[str]]) -> torch.Tensor:
        """(B, 77) token ids, a long tensor on the host."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer loaded; pass input_ids directly")
        return torch.from_numpy(self.tokenizer(prompts)).long()

    @torch.inference_mode()
    def calibrate_quant(self, prompt: Union[str, List[str], None] = None, *, negative_prompt=None,
                        input_ids=None, negative_input_ids=None, steps: int = 4, seed: int = 0,
                        height: int = 512, width: int = 512, guidance_scale: float = 5.0,
                        margin: float = 1.1) -> dict:
        """Freeze static per-tensor activation scales (amax·margin/127) into
        every quantized site (txt2img.py:167-248): a `steps`-step DDPM CFG
        denoise without LoRA and one decode run under
        `quant.observe_act_scales`, with the generator of `seed`. Call after
        `quantize()`. Returns the observations. It runs eagerly, as JAX runs
        it: the scales it freezes are host numbers that the sampler's graphs
        key on."""
        input_ids, negative_input_ids = self._ids(prompt, negative_prompt, input_ids, negative_input_ids)
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

    def _ids(self, prompt, negative_prompt, input_ids, negative_input_ids):
        """Prompt and negative ids as long tensors (txt2img.py:320-337): the
        prompts tokenized unless ids are given; without a negative, zeros
        when no tokenizer is loaded and "" tokenized for each row otherwise
        (SD2's "!" padding makes those ids nonzero); a one-row negative tiled
        to the batch."""
        if input_ids is None:
            input_ids = self.tokenize(prompt)
        input_ids = torch.as_tensor(input_ids).long()
        if negative_input_ids is None:
            if negative_prompt is None and self.tokenizer is None:
                negative_input_ids = torch.zeros_like(input_ids)
            else:
                if negative_prompt is None:
                    negative_prompt = [""] * input_ids.shape[0]
                negative_input_ids = self.tokenize(negative_prompt)
        negative_input_ids = torch.as_tensor(negative_input_ids).long()
        if negative_input_ids.shape[0] == 1 and input_ids.shape[0] > 1:
            negative_input_ids = negative_input_ids.expand(input_ids.shape[0], -1)
        return input_ids, negative_input_ids

    def __call__(self, prompt: Union[str, List[str], None] = None,
                 negative_prompt: Union[str, List[str], None] = None, *, num_inference_steps: int = 30,
                 guidance_scale: float = 5.0, height: int = 512, width: int = 512,
                 seed: Optional[int] = None, num_images_per_prompt: int = 1, input_ids=None,
                 negative_input_ids=None, output_type: str = "np", lora: Optional[dict] = None,
                 lora_scale=None, noise_override=None, decode_chunk: Optional[int] = None,
                 deepcache_interval: int = 1, deepcache_depth: int = 1, tome_ratio: float = 0.0,
                 tome_min_tokens: int = 4096, tome_ops: str = "attn", cfg_interval: Optional[tuple] = None,
                 parallel_window: int = 0, parallel_tolerance: float = 0.1):
        """Images (B, height, width, 3): in [0, 1] as a float32 numpy array
        for output_type "np" or a tensor on the device for "pt"; uint8 as a
        numpy array for "u8" or a tensor on the device for "pt_u8".

        `num_images_per_prompt` repeats each prompt's row (and its
        negative's) as `jnp.repeat` does. `lora`/`lora_scale` override the
        pipeline's adapter for this call; its leaves may carry a leading
        request axis (B, r, in)/(B, out, r) with a (B,) scale, slot b riding
        adapter b. `noise_override`: (S+1, B, h/8, w/8, 4) noise in place of
        the seed's. `decode_chunk`, `deepcache_*`, `tome_*` and
        `cfg_interval` go to `sampler.sample`. `parallel_window=W > 0` (DDPM
        only, no `cfg_interval`) samples parallel in time instead
        (`diffusion/parallel_sampler.py`, tolerance `parallel_tolerance`):
        the batch-1 latency lever (txt2img.py:309-317)."""
        if parallel_window > 0 and self.scheduler_kind != "ddpm":
            raise ValueError("parallel_window requires the ddpm scheduler")
        if parallel_window > 0 and cfg_interval is not None:
            raise ValueError("cfg_interval is not composable with parallel_window yet")
        input_ids, negative_input_ids = self._ids(prompt, negative_prompt, input_ids, negative_input_ids)
        if num_images_per_prompt > 1:
            input_ids = input_ids.repeat_interleave(num_images_per_prompt, dim=0)
            negative_input_ids = negative_input_ids.repeat_interleave(num_images_per_prompt, dim=0)
        if lora is None:
            scale = self.lora_scale
            lora = self.lora
        else:
            scale = 1.0 if lora_scale is None else lora_scale
        if lora is not None:
            lora = {"unet": lora.get("unet"), "text_encoder": lora.get("text_encoder")}
        if not isinstance(scale, (int, float)):
            scale = torch.as_tensor(scale, dtype=torch.float32, device=self.device)
            if scale.dim() == 0:
                scale = float(scale)
        if self.scheduler_kind == "ddpm":
            sched = make_ddpm(self.scheduler_config, num_inference_steps)
        else:
            sched = make_dpm_solver(self.scheduler_config, num_inference_steps)
        common = dict(generator=sampler_generator(seed if seed is not None else 0, self.device),
                      guidance_scale=float(guidance_scale), height=height, width=width, policy=self.policy,
                      attn_impl=self.models.attn_impl, lora=lora, lora_scale=scale, noise_override=noise_override,
                      tome_ratio=tome_ratio, tome_min_tokens=tome_min_tokens, tome_ops=tome_ops)
        if parallel_window > 0:
            images = sample_parallel(self.nets, sched, input_ids, negative_input_ids, window=parallel_window,
                                     tolerance=parallel_tolerance, mesh=self.mesh, **common)
        else:
            run = sample if self.mesh is None else functools.partial(sample_data_parallel, self.mesh)
            images = run(
                self.nets, sched, input_ids, negative_input_ids, scheduler=self.scheduler_kind,
                decode_chunk=decode_chunk, deepcache_interval=deepcache_interval, deepcache_depth=deepcache_depth,
                cfg_interval=None if cfg_interval is None else tuple(cfg_interval), **common,
            )
        if output_type == "np":
            return images.cpu().numpy()
        if output_type == "pt":
            return images
        if output_type in ("u8", "pt_u8"):
            u8 = quantize_u8(images)
            return u8.cpu().numpy() if output_type == "u8" else u8
        raise ValueError(f"unknown output_type {output_type!r}")
