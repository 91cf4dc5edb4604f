"""Face-recognition (FR) trainer: IResNet backbone + margin head (port of
`faceposegenerator_tpu/training/fr.py:36-217`).

Trains iresnet18/50 (+dropout) with an ArcFace, CosFace, ElasticCosFace or
AdaFace head: SGD with lr 0.1/512·batch, momentum 0.9, weight decay 5e-4,
global-norm clip 5, a step or plateau LR schedule. The entry points mirror
the JAX package's:

    params, state = init_train_state(cfg, seed)
    optimizer = make_optimizer(cfg, steps_per_epoch)
    opt_state = optimizer.init(params)
    step = make_train_step(cfg, optimizer, policy)
    params, state, opt_state, metrics = step(params, state, opt_state, batch,
                                             train_step_generator(seed, i, device))

`params` is {"backbone": the IResNet module, "kernel": the head's (D, C)
tensor}; `state` is {"bn": the backbone's running statistics (its
`state_tree()`: the module's own tensors), "adaface": the AdaFace EMA}
(AdaFace only). Where the JAX step is functional, this one updates the
tensors in place and returns the same objects. `fr_checkpoint_tree` gives
{"params", "state"} in the JAX trees' layout, so a checkpoint written by
`core.checkpointing.save_pytree` has JAX's keys and arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..bridge.jax_params import export_jax_params, load_jax_params
from ..core.checkpointing import load_pytree
from ..core.config import ConfigBase
from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..core.tree import tree_map
from ..models import iresnet
from . import losses as L


@dataclasses.dataclass
class FRConfig(ConfigBase):
    """Parameter surface of `FR_training/config/FR_config.py` (fr.py:36-70)."""

    network: str = "iresnet50"
    embedding_size: int = 512
    dropout: float = 0.4
    batch_size: int = 128
    num_classes: int = 100
    loss: str = "AdaFace"  # ArcFace | CosFace | ElasticCosFace | AdaFace
    s: float = 64.0
    m: float = 0.35
    # the reference instantiates AdaFace with its defaults (m=0.4, h=0.333,
    # s=64) whatever cfg.s and cfg.m say (train_FR.py:176)
    momentum: float = 0.9
    weight_decay: float = 5e-4
    base_lr: float = 0.1  # lr = base_lr / 512 * batch_size (train_FR.py:199)
    max_grad_norm: float = 5.0
    num_epochs: int = 200
    lr_steps: Tuple[int, ...] = (22, 30, 35)  # epoch milestones, ×plateau_factor
    lr_schedule: str = "plateau"  # "step" | "plateau" (ReduceLROnPlateau(max))
    plateau_patience: int = 2
    plateau_factor: float = 0.1
    early_stop_patience: int = 6
    val_targets: Tuple[str, ...] = ("lfw",)
    seed: int = 0
    models: Tuple[str, ...] = ("DreamBooth", "PortraitBooth", "ID-Booth")

    @property
    def lr(self) -> float:
        return self.base_lr / 512.0 * self.batch_size


NETWORKS = {"iresnet18": "r18", "iresnet34": "r34", "iresnet50": "r50", "iresnet100": "r100"}


def backbone_config(cfg: FRConfig, **kw) -> iresnet.IResNetConfig:
    """The backbone of `cfg.network`; `kw` overrides IResNetConfig fields
    (the tests' and the card's small depths, `use_se`, `remat`)."""
    base = iresnet.config_for(NETWORKS[cfg.network], num_features=cfg.embedding_size, dropout=cfg.dropout)
    return dataclasses.replace(base, **kw)


def init_train_state(cfg: FRConfig, seed: int = 0, device=None, backbone_cfg: Optional[iresnet.IResNetConfig] = None):
    """(params, state) for `cfg` on `device` (the card unless "cpu"): a fresh
    fp32 backbone from `seed` (`backbone_cfg`, default `backbone_config(cfg)`),
    and the head kernel (AdaFace: uniform with unit columns; else N(0, 0.01²))."""
    device = resolve_device(device)
    backbone = iresnet.IResNet(backbone_cfg or backbone_config(cfg), device=device, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    kernel = L.init_kernel(g, cfg.embedding_size, cfg.num_classes,
                           kind="uniform" if cfg.loss == "AdaFace" else "normal").requires_grad_(True)
    params = {"backbone": backbone, "kernel": kernel}
    state = {"bn": backbone.state_tree()}
    if cfg.loss == "AdaFace":
        state["adaface"] = L.adaface_init_state(device)
    return params, state


def param_leaves(params: dict) -> list:
    """The tensors the optimizer updates: every parameter of the JAX params
    tree (the backbone's `trainable_parameters`, then the kernel)."""
    return params["backbone"].trainable_parameters() + [params["kernel"]]


class SGDOptimizer:
    """`optax.chain(clip_by_global_norm(max_norm), add_decayed_weights(wd),
    sgd(lr, momentum))` (fr.py:96-118): the clip is t / ‖g‖ · max_norm where
    ‖g‖ ≥ max_norm (no eps, unlike `clip_grad_norm_`); the decay adds wd·p to
    every leaf's gradient, the convolution biases and the features BN's unused
    weight included; the momentum is optax's `trace` (t ← g + μ·t) and the
    update p ← p − lr·t. `lr_of(count)` is the step schedule; without one the
    learning rate is `opt_state["learning_rate"]` (what `inject_hyperparams`
    exposes and the plateau scheduler sets). `leaves_of(params)` lists the
    updated tensors (the FR params tree's by default)."""

    def __init__(self, lr: float, max_grad_norm: float, weight_decay: float, momentum: float,
                 lr_of: Optional[Callable[[int], float]] = None, leaves_of: Callable = param_leaves):
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.weight_decay, self.momentum, self.lr_of = weight_decay, momentum, lr_of
        self.leaves_of = leaves_of

    def init(self, params: dict) -> dict:
        state = {"count": 0, "trace": [torch.zeros_like(p, dtype=torch.float32) for p in self.leaves_of(params)]}
        if self.lr_of is None:
            state["learning_rate"] = self.lr
        return state

    @torch.no_grad()
    def update(self, grads: list, opt_state: dict, params: dict) -> torch.Tensor:
        """Apply one update in place; returns the global norm of `grads`."""
        leaves = self.leaves_of(params)
        grads = [g.float().clone() for g in grads]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        below = norm < self.max_grad_norm
        torch._foreach_div_(grads, torch.where(below, torch.ones_like(norm), norm))
        torch._foreach_mul_(grads, torch.where(below, torch.ones_like(norm), torch.full_like(norm, self.max_grad_norm)))
        torch._foreach_add_(grads, [p.float() for p in leaves], alpha=self.weight_decay)
        trace = opt_state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        lr = self.lr_of(opt_state["count"]) if self.lr_of is not None else opt_state["learning_rate"]
        opt_state["count"] += 1
        torch._foreach_add_(leaves, trace, alpha=-float(np.float32(lr)))
        return norm


def make_optimizer(cfg: FRConfig, steps_per_epoch: int = 1) -> SGDOptimizer:
    """Step schedule: piecewise constant, ×plateau_factor at each epoch of
    `lr_steps` (at update count epoch·steps_per_epoch); plateau: a constant
    rate the scheduler sets between epochs."""
    lr_of = None
    if cfg.lr_schedule == "step":
        boundaries = [e * steps_per_epoch for e in cfg.lr_steps]

        def lr_of(count: int) -> float:
            return cfg.lr * cfg.plateau_factor ** sum(count >= b for b in boundaries)

    return SGDOptimizer(cfg.lr, cfg.max_grad_norm, cfg.weight_decay, cfg.momentum, lr_of)


class PlateauScheduler:
    """ReduceLROnPlateau(mode="max") (`train_FR.py:208-214`)."""

    def __init__(self, cfg: FRConfig):
        self.best = -float("inf")
        self.bad_epochs = 0
        self.cfg = cfg
        self.scale = 1.0

    def update(self, metric: float) -> float:
        if metric > self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.cfg.plateau_patience:
                self.scale *= self.cfg.plateau_factor
                self.bad_epochs = 0
        return self.scale

    def set_lr(self, opt_state: dict, base_lr: float) -> dict:
        opt_state["learning_rate"] = float(np.float32(base_lr * self.scale))
        return opt_state


def _to_device(x, device, dtype=None):
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def make_train_step(cfg: FRConfig, optimizer: SGDOptimizer, policy: Policy = DEFAULT_POLICY,
                    group=None, mesh=None):
    """Returns `train_step(params, state, opt_state, batch, generator=None,
    draws=None) -> (params, state, opt_state, metrics)`. `batch` holds
    "images" (B, 112, 112, 3) in [-1, 1] and "labels" (B,), numpy or
    tensors. The generator draws the dropout mask, then ElasticCosFace's
    margins; `draws` may give them instead: {"dropout": bool (B, 512·49),
    "margin": (B,) standard normals}. Metrics: "loss", "train_acc" and
    "grad_norm", tensors on the device.

    `group` (a process group; JAX's `axis_name`, fr.py:139-151): every
    BatchNorm averages its local moments over the group's ranks, nothing
    else is reduced, as in JAX.

    `mesh` (`core.mesh.Mesh`): the data-parallel step of the driver, equal
    to one process's step on the global batch, whose rows are sharded over
    the mesh's "data" axis (`batch` holds this rank's). Under a mesh JAX
    computes BatchNorm over the global batch (jit semantics), so here every
    BatchNorm sums Σx, Σx² and the count over the data ranks; AdaFace's
    EMA takes the global batch's norms, the loss and accuracy are global
    means, the generator draws the global batch's dropout mask and margins
    (every rank the same, keeping its rows; `draws` are global too), and
    the gradients are summed over the data ranks before the update, so the
    replicas stay equal."""
    if group is not None and mesh is not None:
        raise ValueError("make_train_step takes a BatchNorm group or a data-parallel mesh, not both")
    policy.configure_backends()
    bn_group, bn_global = group, False
    if mesh is not None and mesh.data > 1:
        from ..core.mesh import DATA_AXIS

        bn_group, bn_global = mesh.group(DATA_AXIS), True

    def loss_fn(params, state, images, labels, generator, draws):
        emb_raw, new_bn = params["backbone"](images, policy, train=True, generator=generator,
                                             dropout_mask=draws.get("dropout"), bn_group=bn_group,
                                             bn_global=bn_global)
        kernel = params["kernel"]
        new_state = {"bn": new_bn}
        if cfg.loss == "AdaFace":
            norms = torch.linalg.norm(emb_raw, dim=1)
            emb = emb_raw / torch.clamp(norms[:, None], min=1e-12)
            batch_norms = None
            if mesh is not None:
                from ..core.mesh import all_gather_rows

                batch_norms = all_gather_rows(mesh, norms.detach())
            logits, new_state["adaface"] = L.adaface_logits(kernel, emb, norms, labels, state["adaface"],
                                                            batch_norms=batch_norms)
        elif cfg.loss == "ArcFace":
            logits = L.arcface_logits(kernel, emb_raw, labels, cfg.s, cfg.m)
        elif cfg.loss == "CosFace":
            logits = L.cosface_logits(kernel, emb_raw, labels, cfg.s, cfg.m)
        elif cfg.loss == "ElasticCosFace":
            logits = L.elastic_cosface_logits(kernel, emb_raw, labels, generator, cfg.s, cfg.m,
                                              normals=draws.get("margin"))
        else:
            raise ValueError(cfg.loss)
        loss = L.cross_entropy(logits, labels)
        acc = (logits.argmax(dim=1) == labels).float().mean()
        if mesh is not None:  # this rank's share of the global means
            share = labels.shape[0] / (labels.shape[0] * mesh.data)
            loss, acc = loss * share, acc * share
        return loss, new_state, acc

    def global_draws(generator, draws, n_local, device, bcfg):
        """This rank's rows of the global batch's draws, made as one process
        makes them: the dropout mask inside the backbone, then the margins."""
        from ..core.mesh import rows_of

        n = n_local * mesh.data
        rows = rows_of(mesh, n)
        if not draws and generator is not None:
            draws = {}
            if bcfg.dropout > 0:
                feat = 512 * bcfg.fc_scale
                draws["dropout"] = torch.rand((n, feat), generator=generator, device=device) < 1.0 - cfg.dropout
            if cfg.loss == "ElasticCosFace":
                draws["margin"] = torch.randn((n,), generator=generator, device=generator.device)
        return {k: v[rows] for k, v in (draws or {}).items()}

    def train_step(params, state, opt_state, batch, generator=None, draws=None):
        device = params["kernel"].device
        images = _to_device(batch["images"], device)
        labels = _to_device(batch["labels"], device, torch.long)
        draws = draws or {}
        if mesh is not None:
            draws = global_draws(generator, draws, labels.shape[0], device, params["backbone"].cfg)
        loss, new_state, acc = loss_fn(params, state, images, labels, generator, draws)
        leaves = param_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        loss, acc = loss.detach(), acc.detach()
        if mesh is not None and mesh.data > 1:
            from ..core.mesh import DATA_AXIS, all_reduce_

            flat = all_reduce_(mesh, torch.cat([g.reshape(-1) for g in grads] + [loss[None], acc[None]]), DATA_AXIS)
            loss, acc = flat[-2], flat[-1]
            grads = [f.view_as(g) for f, g in zip(flat[:-2].split([g.numel() for g in grads]), grads)]
        grad_norm = optimizer.update(grads, opt_state, params)
        params["backbone"].load_state_tree(tree_map(torch.Tensor.detach, new_state["bn"]))
        if "adaface" in new_state:
            state["adaface"] = {k: v.detach() for k, v in new_state["adaface"].items()}
        return params, state, opt_state, {"loss": loss, "train_acc": acc, "grad_norm": grad_norm}

    return train_step


def make_embed_fn(cfg: FRConfig, params: dict, state: dict, policy: Policy = DEFAULT_POLICY):
    """The verification callback's embed function (`CallBackVerification`):
    (B, 112, 112, 3) [-1, 1] numpy or tensor → (B, D) fp32 embeddings on the
    backbone's device, inference-mode BatchNorm over `state["bn"]` (the
    module's own running statistics)."""
    backbone = params["backbone"]
    device = params["kernel"].device
    policy.configure_backends()

    @torch.no_grad()
    def embed(images):
        return backbone(_to_device(images, device, torch.float32), policy)

    return embed


def fr_checkpoint_tree(params: dict, state: dict) -> dict:
    """{"params": {"backbone", "kernel"}, "state": {"bn"[, "adaface"]}} as
    numpy arrays in the JAX trees' layout (convolutions HWIO): what JAX's
    `save_pytree({"params": params, "state": state})` writes."""
    backbone, _ = export_jax_params(params["backbone"])
    to_np = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    out_state = {"bn": tree_map(to_np, state["bn"])}
    if "adaface" in state:
        out_state["adaface"] = tree_map(to_np, state["adaface"])
    return {"params": {"backbone": backbone, "kernel": to_np(params["kernel"])}, "state": out_state}


@torch.no_grad()
def load_fr_checkpoint(path: str, params: dict, state: dict) -> Tuple[dict, dict]:
    """Fill `params` and `state` in place from a `best_backbone.npz` written
    by either package; returns them."""
    data = load_pytree(fr_checkpoint_tree(params, state), path)
    load_jax_params(params["backbone"], data["params"]["backbone"], data["state"]["bn"])
    params["kernel"].copy_(torch.from_numpy(data["params"]["kernel"]))
    if "adaface" in state:
        state["adaface"] = {k: torch.as_tensor(v, device=params["kernel"].device)
                            for k, v in data["state"]["adaface"].items()}
    return params, state
