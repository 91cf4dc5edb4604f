"""ID-Booth LoRA fine-tuning: one train step (port of
`faceposegenerator_tpu/training/idbooth.py`).

The step is VAE encode → add noise → CLIP → UNet(LoRA) → instance MSE +
prior MSE → x̂0 → VAE decode → crop → ArcFace → identity or triplet loss →
backward → global-norm clip → AdamW on the LoRA only. The entry points
mirror the JAX package's, so a training loop builds a step the same way:

    trainable = init_trainable(seed, cfg, models, frozen["unet"], frozen["text_encoder"])
    optimizer = make_optimizer(cfg, total_steps)
    opt_state = optimizer.init(trainable)
    step = make_train_step(cfg, models, optimizer, policy=policy)
    trainable, opt_state, metrics = step(trainable, opt_state, frozen, batch,
                                         train_step_generator(cfg.seed, i, device))

`frozen` holds the modules {"text_encoder", "unet", "vae", "arcface"}; their
parameters never receive gradients, and the VAE encoder runs under
`no_grad`. CLIP runs under `no_grad` too, unless `train_text_encoder` is set
and the batch carries no precomputed `encoder_hidden_states`: then it runs
with its LoRA (`trainable["text_lora"]`, q, k, v and out of every layer) and
with gradients, and the optimizer updates both trees. Every attention of
the UNet and of the VAE decode runs FlashAttention on the card: the K1/K2
forward with the log-sum-exp and the K5/K6 backward; CLIP's causal
attention is plain torch, as in JAX. Where the JAX step is functional, this
one updates the LoRA tensors in place and returns the same tree.

`gradient_accumulation_steps=k > 1` has `optax.MultiSteps` semantics: the
gradients of k micro-steps are averaged, the clip and the AdamW update run
on the k-th, the parameters do not move in between, and the schedule
counts real updates only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.compile import jit, over_mesh
from ..core.config import ConfigBase
from ..core.precision import DEFAULT_POLICY, Policy
from ..core.tree import tree_leaves, tree_map
from ..diffusion.schedulers import DDPMSchedule, make_ddpm
from ..models import clip_text, iresnet, unet2d, vae
from ..ops.image import crop_and_resize, normalize_to_arcface


@dataclasses.dataclass
class IDBoothConfig(ConfigBase):
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
    boxes = torch.zeros((b, 4), device=images.device)  # filled on the card: no copy from the host
    boxes[:, 2], boxes[:, 3] = float(w), float(h)
    return boxes, torch.ones(b, dtype=torch.bool, device=images.device)


class LoRAOptimizer:
    """`optax.chain(clip_by_global_norm(max_norm), adamw(schedule, ...))`
    over the LoRA tensors, wrapped in `optax.MultiSteps(k)` when
    `accumulate=k > 1`. The AdamW update is PyTorch's (decoupled weight
    decay, bias-corrected moments), on `torch._foreach_*` ops. The clip
    computes t / ‖g‖ · max_norm where ‖g‖ ≥ max_norm, as optax does, and the
    learning rate of the n-th update is schedule(n - 1).

    The state is a tree of tensors and numbers, so a checkpoint holds it
    whole: {"count": the updates applied (AdamW's step), a 0-d int64 tensor
    on the parameters' device, "exp_avg" and "exp_avg_sq": AdamW's moments
    in the layout of the trainable tree}, and under accumulation
    {"mini_step": micro-steps since the last update, a host int, and
    "acc_grads": their running mean}. The learning rate and both bias
    corrections are fp32 device ops on `count`, as JAX's jitted optax
    computes them, so an update never reads the card and a captured train
    step replays it (`make_train_step`). A state restored with an int count
    (checkpoints written before the count moved to the card) is converted
    on its first update.

    Stacked mode (`update(..., per_identity=True)`): every leaf carries a
    leading identity axis of K independent fine-tunes that share one
    schedule; the global norm and the clip are per identity, AdamW is
    elementwise, and the returned norm has shape (K,)."""

    def __init__(self, schedule: Callable[[int], float], max_grad_norm: float,
                 betas: Tuple[float, float], eps: float, weight_decay: float, accumulate: int = 1):
        if accumulate < 1:
            raise ValueError(f"gradient accumulation over {accumulate} micro-steps")
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay
        self.accumulate = accumulate

    def init(self, trainable) -> dict:
        zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), trainable)  # noqa: E731
        device = tree_leaves(trainable)[0].device
        state = {"count": torch.zeros((), dtype=torch.int64, device=device), "exp_avg": zeros(), "exp_avg_sq": zeros()}
        if self.accumulate > 1:
            state.update(mini_step=0, acc_grads=zeros())
        return state

    @staticmethod
    def global_norm(grads: list, per_identity: bool = False) -> torch.Tensor:
        """sqrt(Σ g²) over every leaf; per slice of the leading axis in stacked mode."""
        if per_identity:
            return torch.sqrt(sum(g.float().square().flatten(1).sum(1) for g in grads))
        return torch.sqrt(sum(g.float().square().sum() for g in grads))

    @torch.no_grad()
    def update(self, grads: list, opt_state: dict, trainable, per_identity: bool = False) -> torch.Tensor:
        """Take `grads` (one per leaf of `trainable`, in `tree_leaves` order);
        on an update, clip by the global norm and apply AdamW in place.
        Returns the global norm of `grads`."""
        n = opt_state.get("mini_step", 0)
        apply = n == self.accumulate - 1 or self.accumulate == 1
        count_on_device(opt_state, tree_leaves(trainable)[0].device)
        norm = self.device_update(grads, opt_state, trainable, per_identity, apply, n)
        if self.accumulate > 1:
            opt_state["mini_step"] = 0 if apply else n + 1
        return norm

    @torch.no_grad()
    def device_update(self, grads: list, opt_state: dict, trainable, per_identity: bool, apply: bool,
                      n) -> torch.Tensor:
        """`update` without its host bookkeeping: the device work of micro-step
        `n` (a number, or a 0-d tensor on the card) of an accumulation, which
        applies the update iff `apply`. `opt_state["mini_step"]` is neither
        read nor written."""
        params = tree_leaves(trainable)
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} parameters")
        grads = [g.float() for g in grads]
        norm = self.global_norm(grads, per_identity)
        if self.accumulate > 1:
            acc = tree_leaves(opt_state["acc_grads"])
            for a, g in zip(acc, grads):  # MultiSteps' running mean (Welford)
                a.add_((g - a) / (n + 1))
            if not apply:
                return norm
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            clip_norm = self.global_norm(grads, per_identity)
        else:
            grads = [g.clone() for g in grads]
            clip_norm = norm
        # optax: t if ‖g‖ < max else (t / ‖g‖)·max, decided on the device
        below = clip_norm < self.max_grad_norm
        denom = torch.where(below, torch.ones_like(clip_norm), clip_norm)
        scale = torch.where(below, torch.ones_like(clip_norm), torch.full_like(clip_norm, self.max_grad_norm))
        if per_identity:
            for g in grads:
                shape = (-1,) + (1,) * (g.dim() - 1)
                g.div_(denom.view(shape)).mul_(scale.view(shape))
        else:
            torch._foreach_div_(grads, denom)
            torch._foreach_mul_(grads, scale)

        count = opt_state["count"]
        lr = self.schedule(count)
        count.add_(1)
        t = count.float()
        (b1, b2), eps, wd = self.betas, self.eps, self.weight_decay
        exp_avg, exp_avg_sq = tree_leaves(opt_state["exp_avg"]), tree_leaves(opt_state["exp_avg_sq"])
        torch._foreach_mul_(params, 1 - lr * wd)
        torch._foreach_lerp_(exp_avg, grads, 1 - b1)
        torch._foreach_mul_(exp_avg_sq, b2)
        torch._foreach_addcmul_(exp_avg_sq, grads, grads, 1 - b2)
        denom = torch._foreach_sqrt(exp_avg_sq)
        torch._foreach_div_(denom, torch.sqrt(1 - torch.pow(b2, t)))
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(exp_avg, denom)
        torch._foreach_mul_(step, -lr / (1 - torch.pow(b1, t)))
        torch._foreach_add_(params, step)
        return norm


def count_on_device(opt_state: dict, device) -> None:
    """A state restored with an int count (a checkpoint written while the
    count lived on the host) takes it as a 0-d int64 tensor on `device`."""
    if not isinstance(opt_state["count"], torch.Tensor):
        opt_state["count"] = torch.tensor(int(opt_state["count"]), dtype=torch.int64, device=device)


def _cosine_schedule(lr: float, warmup_steps: int, decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule (init 0 under warmup, else lr): of
    the optimizer's 0-d tensor count a 0-d fp32 tensor on its device,
    computed in fp32 as optax computes it."""
    init = 0.0 if warmup_steps else lr
    alpha = 0.0 if lr == 0.0 else end_value / lr

    if decay_steps <= warmup_steps:
        raise ValueError(f"the cosine schedule needs decay_steps > warmup_steps, got {decay_steps}")

    def schedule(count):
        c = count.float()
        warm = (init - lr) * (1 - c / max(warmup_steps, 1)) + lr
        k = torch.clamp(c - warmup_steps, min=0, max=decay_steps - warmup_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * k / (decay_steps - warmup_steps)))
        decayed = lr * ((1 - alpha) * cosine + alpha)
        return torch.where(c < warmup_steps, warm, decayed)

    return schedule


def make_optimizer(cfg: IDBoothConfig, total_steps: int, num_replicas: int = 1) -> LoRAOptimizer:
    """AdamW over the LoRA with cosine decay and global-norm clipping, every
    `gradient_accumulation_steps` micro-steps (idbooth.py:128-164; LR scaled
    like Accelerate's scale_lr; the schedule counts updates)."""
    lr = cfg.learning_rate
    if cfg.scale_lr:
        lr = lr * cfg.gradient_accumulation_steps * cfg.train_batch_size * num_replicas
    if cfg.lr_scheduler == "cosine":
        schedule = _cosine_schedule(lr, cfg.lr_warmup_steps, max(total_steps, 1))
    elif cfg.lr_scheduler == "constant":
        def schedule(count):
            return torch.full((), lr, device=torch.as_tensor(count).device)
    else:
        raise ValueError(cfg.lr_scheduler)
    return LoRAOptimizer(schedule, cfg.max_grad_norm, (cfg.adam_beta1, cfg.adam_beta2),
                         cfg.adam_epsilon, cfg.adam_weight_decay, accumulate=cfg.gradient_accumulation_steps)


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
                 policy: Policy = DEFAULT_POLICY, detect_fn: Callable = full_image_boxes,
                 identities: Optional[int] = None, mesh=None):
    """loss_fn(trainable, frozen, batch, generator=None, draws=None) →
    (loss, metrics), a scalar tensor with its graph and detached scalars.

    batch: {"pixel_values": (n, H, W, 3) in [-1, 1], the [instance; class]
    concat under prior preservation; "input_ids": (n, 77) (or
    "encoder_hidden_states"); "gt_embeds": (n, F)}. `draws` ({"latent_noise",
    "noise", "timesteps"}) overrides the draws from `generator`.

    `identities=K`: K independent fine-tunes in one pass. Every leaf of
    `trainable` and of `batch` carries a leading identity axis K, and
    `generator` / `draws` are lists of K, one per identity. The K batches
    run as one batch of K·n rows, [every instance half; every class half],
    each row with its identity's LoRA (per-row adapters: the stacked leaves
    gathered by row, so autograd sums each identity's gradient into its own
    slice). Each identity's loss is computed on its own rows as above, the
    loss returned is their sum, and the metrics have shape (K,).

    `mesh` (`core.mesh.Mesh`): the data-parallel loss. `batch` holds this
    rank's rows of the global batch, sharded contiguously over "data"
    (`core.mesh.shard_batch`), and the global batch is laid out
    [instance × B; class × B] as one process's, so a rank may hold only
    instance rows or only class rows: each rank knows which global rows it
    holds. The MSE terms are this rank's sums over the global counts; the
    identity term's numerator is this rank's, its denominator (the faces
    found) is summed over the ranks before the division; a triplet's
    negative, global row B + i, may live on another rank, so the embeddings
    are gathered. A rank with no instance rows runs no decode and no
    ArcFace. Summed over the ranks, the losses and their gradients are one
    process's on the global batch; the metrics returned are already summed.
    `generator` draws the global batch's draws (every rank the same) and
    `draws` are the global batch's; each rank keeps its rows."""
    T = schedule.num_train_timesteps
    stacked = identities is not None
    K = identities if stacked else 1
    if stacked and mesh is not None:
        raise ValueError("stacked identities shard over a mesh by identity (training.multi_identity), "
                         "not by row")
    if mesh is not None:
        from ..core.mesh import DATA_AXIS, all_gather_rows, all_reduce_, rows_of

    def loss_fn(trainable, frozen, batch, generator=None, draws=None):
        for net in frozen.values():
            net.requires_grad_(False)
        lora = trainable
        n = batch["pixel_values"].shape[1 if stacked else 0]
        if mesh is not None:  # the global batch's size, and this rank's rows of it
            n = n * mesh.data
            mine = rows_of(mesh, n)
        else:
            mine = slice(0, n * K)
        b = n // 2 if cfg.with_prior_preservation else n
        if stacked:
            def rows(x):  # (K, n, ...) → (K·n, ...): [instance rows of 0..K-1; class rows of 0..K-1]
                if not cfg.with_prior_preservation:
                    return x.flatten(0, 1)
                return torch.cat([x[:, :b].flatten(0, 1), x[:, b:].flatten(0, 1)])

            batch = {k: rows(v) for k, v in batch.items()}
            owner = rows(torch.arange(K, device=batch["pixel_values"].device)[:, None].expand(K, n))
            lora = tree_map(lambda leaf: leaf.index_select(0, owner), trainable)
        pix = batch["pixel_values"]
        b_inst = K * b  # the instance rows, identity by identity
        ni = max(0, min(mine.stop, b_inst) - mine.start)  # this call's instance rows
        with torch.no_grad():  # the latent encode (train_ID-Booth.py:1001)
            moments = frozen["vae"].encode_moments(pix, policy)
        shape = (n,) + tuple(moments[0].shape[1:])
        if draws is None:
            draws = ([draw(shape, n, T, g, pix.device) for g in generator] if stacked
                     else draw(shape, n, T, generator, pix.device))
        if stacked:
            draws = {k: rows(torch.stack([d[k].to(pix.device) for d in draws])) for k in draws[0]}
        elif mesh is not None:
            draws = {k: v[mine] for k, v in draws.items()}
        with torch.no_grad():
            latents = frozen["vae"].sample_latents(moments, draws["latent_noise"].to(pix.device))
            noise = draws["noise"].to(pix.device, torch.float32)
            timesteps = draws["timesteps"].to(pix.device)
            noisy = schedule.add_noise(latents, noise, timesteps)
            if "encoder_hidden_states" in batch:
                ctx = batch["encoder_hidden_states"].to(policy.compute_dtype)
            elif not cfg.train_text_encoder:
                ctx = frozen["text_encoder"](batch["input_ids"], policy)
        if "encoder_hidden_states" not in batch and cfg.train_text_encoder:
            # with grad: the text LoRA trains (train_ID-Booth.py:1024)
            ctx = frozen["text_encoder"](batch["input_ids"], policy, lora=lora.get("text_lora"))

        pred = frozen["unet"](noisy, timesteps, ctx, policy, lora=lora["unet_lora"],
                              attn_impl=models.attn_impl, remat=cfg.gradient_checkpointing)
        if pred.shape[-1] == 2 * latents.shape[-1]:  # variance-predicting UNets: the mean half
            pred = pred[..., : latents.shape[-1]]
        target = noise  # epsilon prediction (SD2.1-base)

        sq = torch.square(pred - target)
        per_row = sq[0].numel()

        def mean(x, rows_total):  # per identity; under a mesh this rank's share of the global mean
            if mesh is None:
                return x.reshape(K, -1).mean(1)
            return x.sum().reshape(1) / (rows_total * per_row)

        metrics = {}
        if cfg.with_prior_preservation:
            instance_loss, prior_loss = mean(sq[:ni], b_inst), mean(sq[ni:], n - b_inst)
            loss = instance_loss + cfg.prior_loss_weight * prior_loss
            metrics["prior_loss"] = prior_loss
        else:
            instance_loss = loss = mean(sq, n)
        metrics["instance_loss"] = instance_loss

        if cfg.which_loss in ("identity", "triplet_prior"):
            t_inst = timesteps[:ni]
            x0 = schedule.pred_original(pred[:ni], t_inst, noisy[:ni])
            gt = batch["gt_embeds"]
            if mesh is not None:  # a negative may live on another rank
                gt = all_gather_rows(mesh, gt.to(pix.device), DATA_AXIS)
            g0 = mine.start
            gt_inst = gt[g0:g0 + ni]
            gt_neg = gt[b_inst + g0:b_inst + g0 + ni] if cfg.with_prior_preservation else gt_inst

            def identity_terms(x0, gt_inst, gt_neg, t_inst):
                """(mask·w·term, mask) of each of these samples."""
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
                return mask * w * term, mask

            def branch(*args):
                if cfg.remat_identity:
                    # no random op inside: nothing to save, and a captured step cannot read the RNG
                    return checkpoint(identity_terms, *args, use_reentrant=False, preserve_rng_state=False)
                return identity_terms(*args)

            ck = cfg.identity_chunk
            if ck is not None and (ck <= 0 or ck > b or b % ck != 0):
                raise ValueError(
                    f"identity_chunk={ck} does not evenly divide the instance batch {b}; "
                    "choose a divisor of the (instance) batch size or unset it"
                )
            ck = ck or max(ni, 1)
            parts = [branch(x0[i:i + ck], gt_inst[i:i + ck], gt_neg[i:i + ck], t_inst[i:i + ck])
                     for i in range(0, ni, ck)]
            if mesh is None:
                num = torch.cat([p[0] for p in parts]).reshape(K, b).sum(1)
                den = torch.cat([p[1] for p in parts]).reshape(K, b).sum(1)
            else:  # the faces found anywhere divide this rank's numerator
                zero = torch.zeros(1, device=pix.device)
                num = torch.cat([p[0] for p in parts]).sum().reshape(1) if parts else zero
                den = torch.cat([p[1] for p in parts]).sum().reshape(1) if parts else zero
                den = all_reduce_(mesh, den.detach().clone(), DATA_AXIS)
            id_loss = num / torch.clamp(den, min=1.0)
            loss = loss + id_loss
            metrics["id_loss"] = id_loss

        metrics["loss"] = loss
        if mesh is not None:
            names = list(metrics)
            summed = all_reduce_(mesh, torch.cat([metrics[k].detach() for k in names]), DATA_AXIS)
            metrics = dict(zip(names, summed[:, None]))
        metrics = {k: v.detach() if stacked else v.detach()[0] for k, v in metrics.items()}
        return (loss.sum() if stacked else loss[0]), metrics

    return loss_fn


def make_train_step(cfg: IDBoothConfig, models: ModelBundle, optimizer: LoRAOptimizer,
                    schedule: Optional[DDPMSchedule] = None, policy: Policy = DEFAULT_POLICY,
                    detect_fn: Callable = full_image_boxes, identities: Optional[int] = None, mesh=None):
    """Returns `train_step(trainable, opt_state, frozen, batch, generator=None,
    draws=None) -> (trainable, opt_state, metrics)`; metrics carry the loss
    terms and `grad_norm`, the global norm of the gradients before the clip.
    With `identities=K`, the step of K stacked fine-tunes: the loss of
    `make_loss_fn(identities=K)` and the optimizer's per-identity update.

    The forward pass, `torch.autograd.grad`, the clip and the update run as
    one `core.compile.jit` function: on the card one captured CUDA graph per
    key, the "apply the update on this micro-step" choice of an
    accumulation part of the key (two graphs at most, where optax
    `MultiSteps` uses `lax.cond`). `draws` (or the draws of `generator`,
    made before the graph runs) and the batch are its inputs; the LoRA and
    the optimizer state are updated in place. Two cases run eagerly, by
    the argument rule of `core.compile`: a `detect_fn` other than
    `full_image_boxes` (MTCNN's NMS runs on the host and cannot be
    captured), and a mesh of more than one rank (its collectives).

    With `mesh`, the data-parallel step (`make_loss_fn(mesh=)`): equal to
    one process's step on the global batch. The gradients are summed over
    the ranks before the clip and the update, so the replicated LoRA and
    the optimizer state stay equal on every rank. Under a "model" axis
    (the UNet placed by `parallel.tp.shard_unet_params_tp`), a sharded
    attention's LoRA gradients are summed over its model ranks too, and the
    others, which every model rank holds whole, count once."""
    if schedule is None:
        schedule = make_ddpm()
    loss_fn = make_loss_fn(cfg, models, schedule, policy, detect_fn, identities=identities, mesh=mesh)
    stacked = identities is not None
    eager = detect_fn is not full_image_boxes or over_mesh(mesh)

    def step(trainable, opt_tensors, frozen, batch, draws, n, *, apply):
        loss, metrics = loss_fn(trainable, frozen, batch, None, draws)
        params = tree_leaves(trainable)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if mesh is not None and mesh.size > 1:
            grads = _sum_over_mesh(mesh, grads, trainable, frozen["unet"])
        metrics["grad_norm"] = optimizer.device_update(grads, opt_tensors, trainable, stacked, apply, n)
        return trainable, opt_tensors, metrics

    graphed = jit(step, static_argnames=("apply",), eager_if=lambda *a, **kw: eager)

    def train_step(trainable, opt_state, frozen, batch, generator=None, draws=None):
        if draws is None:
            draws = _draws_of(batch, frozen, schedule, generator, stacked, mesh)
        n = opt_state.get("mini_step", 0)
        apply = optimizer.accumulate == 1 or n == optimizer.accumulate - 1
        count_on_device(opt_state, tree_leaves(trainable)[0].device)
        opt_tensors = {k: v for k, v in opt_state.items() if k != "mini_step"}
        micro = torch.full((), float(n), device=opt_state["count"].device) if optimizer.accumulate > 1 else 0
        new_trainable, new_opt, metrics = graphed(trainable, opt_tensors, frozen, batch, draws, micro, apply=apply)
        with torch.no_grad():  # a replay returns copies of the graph's buffers
            for dst, src in zip(tree_leaves((trainable, opt_tensors)), tree_leaves((new_trainable, new_opt))):
                if dst is not src:
                    dst.copy_(src)
        if optimizer.accumulate > 1:
            opt_state["mini_step"] = 0 if apply else n + 1
        return trainable, opt_state, metrics

    train_step.graphed = graphed
    return train_step


def _draws_of(batch, frozen, schedule, generator, stacked: bool, mesh):
    """The step's draws from `generator` (a list of K under `stacked`), made
    before the step runs, in the order and shapes `make_loss_fn` draws them:
    the global batch's under a mesh."""
    pix = batch["pixel_values"]
    n = pix.shape[1 if stacked else 0] * (mesh.data if mesh is not None else 1)
    vae = frozen["vae"]
    f = 2 ** (len(vae.cfg.block_out_channels) - 1)
    shape = (n, pix.shape[-3] // f, pix.shape[-2] // f, vae.cfg.latent_channels)
    T = schedule.num_train_timesteps
    if stacked:
        return [draw(shape, n, T, g, pix.device) for g in generator]
    return draw(shape, n, T, generator, pix.device)


def _sum_over_mesh(mesh, grads: list, trainable: dict, unet) -> list:
    """The gradients summed over every rank of the mesh, in one all-reduce."""
    from ..core.mesh import all_reduce_

    if mesh.model > 1:
        from ..parallel.tp import lora_grad_scale

        scale = {"unet_lora": lora_grad_scale(unet, trainable["unet_lora"], mesh.model)}
        if "text_lora" in trainable:
            scale["text_lora"] = tree_map(lambda _: 1.0 / mesh.model, trainable["text_lora"])
        grads = [g * f for g, f in zip(grads, tree_leaves(scale))]
    flat = all_reduce_(mesh, torch.cat([g.float().reshape(-1) for g in grads]), None)
    return [f.view_as(g).to(g.dtype) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def init_trainable(generator, cfg: IDBoothConfig, models: ModelBundle,
                   unet: unet2d.UNet2DCondition, text_params: Optional[clip_text.CLIPTextModel] = None) -> dict:
    """Fresh fp32 LoRA tensors that require grad: Gaussian A / rank, zero B
    (`train_ID-Booth.py:676`), in the layout of JAX `init_trainable`: the
    UNet's in `unet2d.init_lora`'s, and with `train_text_encoder` and a text
    encoder, {"layer_i": {"q"|"k"|"v"|"out": {"a": (r, in), "b": (out, r)}}}
    for every CLIP layer (idbooth.py:342-356), drawn after the UNet's from
    the same generator. `generator` is a torch.Generator on the UNet's
    device, or a seed."""
    if isinstance(generator, int):
        generator = torch.Generator(device=unet.conv_in.weight.device).manual_seed(generator)
    trainable = {"unet_lora": unet2d.init_lora(unet, rank=cfg.lora_rank, generator=generator, dtype=torch.float32)}
    if cfg.train_text_encoder and text_params is not None:
        r = cfg.lora_rank
        text_lora = {}
        for i, layer in enumerate(text_params.layers):
            text_lora[f"layer_{i}"] = {}
            for name in ("q", "k", "v", "out"):
                w = getattr(layer, name).weight
                a = torch.randn(r, w.shape[1], generator=generator, device=w.device, dtype=torch.float32) / r
                text_lora[f"layer_{i}"][name] = {"a": a, "b": torch.zeros(w.shape[0], r, device=w.device)}
        trainable["text_lora"] = text_lora
    for leaf in tree_leaves(trainable):
        leaf.requires_grad_(True)
    return trainable
