"""ID-Booth LoRA fine-tuning: one train step (port of
`faceposegenerator_tpu/training/idbooth.py`).

The step is VAE encode → add noise → CLIP → UNet(LoRA) → instance MSE +
prior MSE → x̂0 → VAE decode → crop → ArcFace → identity or triplet loss →
backward → global-norm clip → AdamW on the LoRA only. The entry points
mirror the JAX package's, so a training loop builds a step the same way:

    trainable = init_trainable(seed, cfg, models, frozen["unet"])
    optimizer = make_optimizer(cfg, total_steps)
    opt_state = optimizer.init(trainable)
    step = make_train_step(cfg, models, optimizer, policy=policy)
    trainable, opt_state, metrics = step(trainable, opt_state, frozen, batch,
                                         train_step_generator(cfg.seed, i, device))

`frozen` holds the modules {"text_encoder", "unet", "vae", "arcface"}; their
parameters never receive gradients, and CLIP and the VAE encoder run under
`no_grad`. Every attention of the UNet and of the VAE decode runs
FlashAttention on the card: the K1/K2 forward with the log-sum-exp and the
K5/K6 backward. Where the JAX step is functional, this one updates the LoRA
tensors in place (AdamW's own update) and returns the same tree.

Gradient accumulation and text-encoder LoRA are not yet ported: those
options raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.precision import DEFAULT_POLICY, Policy
from ..diffusion.schedulers import DDPMSchedule, make_ddpm
from ..models import clip_text, iresnet, unet2d, vae
from ..ops.image import crop_and_resize, normalize_to_arcface


@dataclasses.dataclass
class IDBoothConfig:
    """Parameter surface of `configs/config_train_SD21.py`, as in the JAX
    package (idbooth.py:47-97)."""

    pretrained_model_name_or_path: str = "stabilityai/stable-diffusion-2-1-base"
    resolution: int = 512
    instance_prompt: str = "photo of sks person"
    class_prompt: str = "photo of a person"
    with_prior_preservation: bool = True
    num_class_images: int = 200
    prior_loss_weight: float = 1.0
    lora_rank: int = 4
    train_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = False
    # recompute the x̂0 → decode → crop → ArcFace branch in the backward
    # instead of keeping its activations (one more decode forward)
    remat_identity: bool = False
    # run the identity branch over sub-batches of this size, one after the
    # other; with remat_identity this divides the branch's activation peak
    identity_chunk: Optional[int] = None
    num_train_epochs: int = 32
    validation_epochs: int = 8
    checkpointing_epochs: int = 8
    checkpoints_total_limit: Optional[int] = None
    learning_rate: float = 1e-4
    scale_lr: bool = False
    lr_scheduler: str = "cosine"
    lr_warmup_steps: int = 0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    train_text_encoder: bool = False
    which_loss: str = ""  # "", "identity", "triplet_prior"
    timestep_loss_weighting: bool = True
    triplet_margin: float = 1.0
    seed: int = 0
    losses_to_test: Tuple[str, ...] = ("", "identity", "triplet_prior")
    num_validation_images: int = 4
    validation_prompt: str = "photo of sks person with blue hair"

    def replace(self, **kw) -> "IDBoothConfig":
        return dataclasses.replace(self, **kw)


# the reference's experiment-sweep folder naming (`train_ID-Booth.py:1299-1307`)
LOSS_TO_FOLDER = {"": "DreamBooth", "identity": "PortraitBooth", "triplet_prior": "ID-Booth"}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Model configs of the trainer."""

    text_cfg: clip_text.CLIPTextConfig = clip_text.SD21_TEXT_CONFIG
    unet_cfg: unet2d.UNetConfig = unet2d.SD21_UNET_CONFIG
    vae_cfg: vae.VAEConfig = vae.SD_VAE_CONFIG
    arcface_cfg: iresnet.IResNetConfig = iresnet.IResNetConfig()
    attn_impl: str = "auto"


def full_image_boxes(images: torch.Tensor):
    """Default detector stub: the whole image, always found."""
    b, h, w, _ = images.shape
    boxes = torch.tensor([[0.0, 0.0, float(w), float(h)]], device=images.device).expand(b, 4)
    return boxes, torch.ones(b, dtype=torch.bool, device=images.device)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list tree, in insertion order (None skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


class LoRAOptimizer:
    """`optax.chain(clip_by_global_norm(max_norm), adamw(schedule, ...))`
    over the LoRA tensors, on `torch.optim.AdamW` (whose decoupled weight
    decay and bias-corrected update are optax's `adamw`). The clip scales
    by max_norm/‖g‖ with no epsilon, and the learning rate of the k-th
    update is schedule(k - 1), as optax counts."""

    def __init__(self, schedule: Callable[[int], float], max_grad_norm: float,
                 betas: Tuple[float, float], eps: float, weight_decay: float):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay

    def init(self, trainable) -> dict:
        params = tree_leaves(trainable)
        adamw = torch.optim.AdamW(params, lr=self.schedule(0), betas=self.betas, eps=self.eps,
                                  weight_decay=self.weight_decay)
        return {"count": 0, "adamw": adamw}

    def update(self, grads: list, opt_state: dict, trainable) -> torch.Tensor:
        """Clip `grads` (one per leaf of `trainable`, in `tree_leaves`
        order) by their global norm and apply one AdamW update in place.
        Returns the global norm before clipping."""
        params = tree_leaves(trainable)
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} parameters")
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        # optax: t if ‖g‖ < max else (t / ‖g‖)·max, decided on the device
        factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
        for p, g in zip(params, grads):
            p.grad = (g * factor).to(p.dtype)
        adamw = opt_state["adamw"]
        for group in adamw.param_groups:
            group["lr"] = self.schedule(opt_state["count"])
        adamw.step()
        adamw.zero_grad(set_to_none=True)
        opt_state["count"] += 1
        return norm


def _cosine_schedule(lr: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule (init 0 under warmup, else lr)."""
    init = 0.0 if warmup_steps else lr
    alpha = 0.0 if lr == 0.0 else end_value / lr

    if decay_steps <= warmup_steps:
        raise ValueError(f"the cosine schedule needs decay_steps > warmup_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init + (lr - init) * count / warmup_steps
        c = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / (decay_steps - warmup_steps)))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule


def make_optimizer(cfg: IDBoothConfig, total_steps: int, num_replicas: int = 1) -> LoRAOptimizer:
    """AdamW over the LoRA with cosine decay and global-norm clipping
    (idbooth.py:128-164; LR scaled like Accelerate's scale_lr)."""
    if cfg.gradient_accumulation_steps > 1:
        raise NotImplementedError("gradient_accumulation_steps > 1 is not yet ported")
    lr = cfg.learning_rate
    if cfg.scale_lr:
        lr = lr * cfg.gradient_accumulation_steps * cfg.train_batch_size * num_replicas
    if cfg.lr_scheduler == "cosine":
        schedule = _cosine_schedule(lr, cfg.lr_warmup_steps, max(total_steps, 1))
    elif cfg.lr_scheduler == "constant":
        schedule = lambda count: lr  # noqa: E731
    else:
        raise ValueError(cfg.lr_scheduler)
    return LoRAOptimizer(schedule, cfg.max_grad_norm, (cfg.adam_beta1, cfg.adam_beta2),
                         cfg.adam_epsilon, cfg.adam_weight_decay)


def _cosine_sim(a, b, eps=1e-6):
    a32, b32 = a.float(), b.float()
    denom = torch.clamp(torch.linalg.norm(a32, dim=-1) * torch.linalg.norm(b32, dim=-1), min=eps)
    return (a32 * b32).sum(-1) / denom


def draw(latent_shape, n: int, num_train_timesteps: int, generator: torch.Generator, device) -> dict:
    """One step's random draws: the latent-sampling noise, the diffusion
    noise and the per-sample timesteps (fp32, fp32, int64)."""
    return {
        "latent_noise": torch.randn(latent_shape, generator=generator, device=device),
        "noise": torch.randn(latent_shape, generator=generator, device=device),
        "timesteps": torch.randint(0, num_train_timesteps, (n,), generator=generator, device=device),
    }


def make_loss_fn(cfg: IDBoothConfig, models: ModelBundle, schedule: DDPMSchedule,
                 policy: Policy = DEFAULT_POLICY, detect_fn: Callable = full_image_boxes):
    """loss_fn(trainable, frozen, batch, generator=None, draws=None) →
    (loss, metrics), a scalar tensor with its graph and detached scalars.

    batch: {"pixel_values": (n, H, W, 3) in [-1, 1], the [instance; class]
    concat under prior preservation; "input_ids": (n, 77) (or
    "encoder_hidden_states"); "gt_embeds": (n, F)}. `draws` ({"latent_noise",
    "noise", "timesteps"}) overrides the draws from `generator`."""
    T = schedule.num_train_timesteps
    if cfg.train_text_encoder:
        raise NotImplementedError("train_text_encoder=True is not yet ported")

    def loss_fn(trainable, frozen, batch, generator=None, draws=None):
        for net in frozen.values():
            net.requires_grad_(False)
        pix = batch["pixel_values"]
        n = pix.shape[0]
        b_inst = n // 2 if cfg.with_prior_preservation else n
        with torch.no_grad():  # the latent encode (train_ID-Booth.py:1001)
            moments = frozen["vae"].encode_moments(pix, policy)
        if draws is None:
            draws = draw(moments[0].shape, n, T, generator, pix.device)
        with torch.no_grad():
            latents = frozen["vae"].sample_latents(moments, draws["latent_noise"].to(pix.device))
            noise = draws["noise"].to(pix.device, torch.float32)
            timesteps = draws["timesteps"].to(pix.device)
            noisy = schedule.add_noise(latents, noise, timesteps)
            if "encoder_hidden_states" in batch:
                ctx = batch["encoder_hidden_states"].to(policy.compute_dtype)
            else:
                ctx = frozen["text_encoder"](batch["input_ids"], policy)

        pred = frozen["unet"](noisy, timesteps, ctx, policy, lora=trainable["unet_lora"],
                              attn_impl=models.attn_impl, remat=cfg.gradient_checkpointing)
        if pred.shape[-1] == 2 * latents.shape[-1]:  # variance-predicting UNets: the mean half
            pred = pred[..., : latents.shape[-1]]
        target = noise  # epsilon prediction (SD2.1-base)

        metrics = {}
        if cfg.with_prior_preservation:
            instance_loss = torch.mean(torch.square(pred[:b_inst] - target[:b_inst]))
            prior_loss = torch.mean(torch.square(pred[b_inst:] - target[b_inst:]))
            loss = instance_loss + cfg.prior_loss_weight * prior_loss
            metrics["prior_loss"] = prior_loss
        else:
            instance_loss = torch.mean(torch.square(pred - target))
            loss = instance_loss
        metrics["instance_loss"] = instance_loss

        if cfg.which_loss in ("identity", "triplet_prior"):
            t_inst = timesteps[:b_inst]
            x0 = schedule.pred_original(pred[:b_inst], t_inst, noisy[:b_inst])
            gt = batch["gt_embeds"]
            gt_inst = gt[:b_inst]
            gt_neg = gt[b_inst:] if cfg.with_prior_preservation else gt_inst

            def identity_sums(x0, gt_inst, gt_neg, t_inst):
                """(Σ mask·w·term, Σ mask) over these samples."""
                img = frozen["vae"].decode(x0, policy, attn_impl=models.attn_impl)
                img255 = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0) * 255.0
                boxes, found = detect_fn(img255)
                face = normalize_to_arcface(crop_and_resize(img255, boxes, 112))
                emb = frozen["arcface"](face, policy)
                w = torch.square(1.0 - t_inst.float() / T)
                if not cfg.timestep_loss_weighting:
                    w = torch.ones_like(w)
                mask = found.float()
                if cfg.which_loss == "identity":
                    term = 1.0 - _cosine_sim(emb, gt_inst)
                else:  # triplet_prior
                    d_ap = 1.0 - _cosine_sim(emb, gt_inst)
                    d_an = 1.0 - _cosine_sim(emb, gt_neg)
                    term = torch.clamp(d_ap - d_an + cfg.triplet_margin, min=0.0)
                return torch.sum(mask * w * term), torch.sum(mask)

            def branch(*args):
                if cfg.remat_identity:
                    return checkpoint(identity_sums, *args, use_reentrant=False)
                return identity_sums(*args)

            ck = cfg.identity_chunk
            if ck is not None and (ck <= 0 or ck > b_inst or b_inst % ck != 0):
                raise ValueError(
                    f"identity_chunk={ck} does not evenly divide the instance batch {b_inst}; "
                    "choose a divisor of the (instance) batch size or unset it"
                )
            ck = ck or b_inst
            num = den = 0.0
            for i in range(0, b_inst, ck):
                nu, de = branch(x0[i:i + ck], gt_inst[i:i + ck], gt_neg[i:i + ck], t_inst[i:i + ck])
                num, den = num + nu, den + de
            id_loss = num / torch.clamp(den, min=1.0)
            loss = loss + id_loss
            metrics["id_loss"] = id_loss

        metrics["loss"] = loss
        return loss, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def make_train_step(cfg: IDBoothConfig, models: ModelBundle, optimizer: LoRAOptimizer,
                    schedule: Optional[DDPMSchedule] = None, policy: Policy = DEFAULT_POLICY,
                    detect_fn: Callable = full_image_boxes):
    """Returns `train_step(trainable, opt_state, frozen, batch, generator=None,
    draws=None) -> (trainable, opt_state, metrics)`; metrics carry the loss
    terms and `grad_norm`, the global norm of the gradients before the clip."""
    if schedule is None:
        schedule = make_ddpm()
    loss_fn = make_loss_fn(cfg, models, schedule, policy, detect_fn)

    def train_step(trainable, opt_state, frozen, batch, generator=None, draws=None):
        loss, metrics = loss_fn(trainable, frozen, batch, generator, draws)
        params = tree_leaves(trainable)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics["grad_norm"] = optimizer.update(grads, opt_state, trainable)
        return trainable, opt_state, metrics

    return train_step


def init_trainable(generator, cfg: IDBoothConfig, models: ModelBundle,
                   unet: unet2d.UNet2DCondition, text_params=None) -> dict:
    """Fresh fp32 LoRA tensors that require grad: Gaussian A, zero B
    (`train_ID-Booth.py:676`), in the layout of `unet2d.init_lora`.
    `generator` is a torch.Generator on the UNet's device, or a seed."""
    if cfg.train_text_encoder:
        raise NotImplementedError("train_text_encoder=True is not yet ported")
    if isinstance(generator, int):
        generator = torch.Generator(device=unet.conv_in.weight.device).manual_seed(generator)
    lora = unet2d.init_lora(unet, rank=cfg.lora_rank, generator=generator, dtype=torch.float32)
    for leaf in tree_leaves(lora):
        leaf.requires_grad_(True)
    return {"unet_lora": lora}
