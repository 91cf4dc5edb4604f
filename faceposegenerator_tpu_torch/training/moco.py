"""MoCo momentum contrast (port of `faceposegenerator_tpu/training/moco.py`).

A behavioural rebuild of `FR_training/moco/builder.py` (legacy in the
reference): query and key encoders with the key encoder's momentum update,
a FIFO queue of negatives, InfoNCE logits with a temperature, and the
batch shuffle for BatchNorm across the ranks of the "data" axis
(`builder.py:212-256`). Over a mesh the keys are all-gathered into the
queue and the gradients averaged over "data" (`core.mesh` collectives),
where JAX runs `all_gather` and `pmean` under an axis name.

    state = init_moco(generator, encoder_init, cfg)
    loss, state, opt_state, metrics = moco_step(state, encoder_apply, optimizer, opt_state, q_imgs, k_imgs, cfg)

The encoder is any `encoder_apply(params, images)` over a tree of tensors,
such as `torch.func.functional_call` of the port's IResNet in training
mode. The optimizer is either a `torch.optim.Optimizer` built over
`tree_leaves(state["params_q"])`, or an optax-like one with
`update(grads, opt_state, params)` applied in place, as `training/fr.py`'s
`SGDOptimizer` (`sgd` below: `optax.sgd`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mesh import DATA_AXIS, Mesh, all_gather_rows, all_reduce_
from ..core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class MoCoConfig:
    dim: int = 128
    queue_size: int = 65536
    momentum: float = 0.999
    temperature: float = 0.07


def sgd(lr: float, momentum: float = 0.0):
    """`optax.sgd(lr, momentum)` over any tree of tensors: `training/fr.py`'s
    SGD with no clip and no weight decay."""
    from .fr import SGDOptimizer

    return SGDOptimizer(lr, math.inf, 0.0, momentum, leaves_of=tree_leaves)


def init_moco(generator: torch.Generator, encoder_init: Callable, cfg: MoCoConfig = MoCoConfig(),
              queue=None) -> dict:
    """`encoder_init(generator)` -> the query encoder's params; the key
    encoder starts as a copy (`builder.py`'s copy, requires_grad False). The
    (dim, queue_size) queue of unit columns is drawn from `generator`, or
    taken from `queue` (an array, e.g. JAX's carried across)."""
    params_q = encoder_init(generator)
    params_k = tree_map(lambda t: t.detach().clone(), params_q)
    device = tree_leaves(params_q)[0].device
    if queue is None:
        queue = torch.randn((cfg.dim, cfg.queue_size), generator=generator, device=generator.device)
        queue = queue / torch.linalg.vector_norm(queue, dim=0, keepdim=True)
    else:
        queue = torch.tensor(np.asarray(queue, np.float32))
    return {"params_q": params_q, "params_k": params_k, "queue": queue.to(device), "queue_ptr": 0}


@torch.no_grad()
def momentum_update(params_q, params_k, momentum: float):
    return tree_map(lambda k, q: momentum * k + (1 - momentum) * q, params_k, params_q)


def shuffle_bn(x: torch.Tensor, generator: torch.Generator, mesh: Optional[Mesh] = None):
    """The batch shuffle for BatchNorm (`builder.py:212-239`): within the
    local batch, or with `mesh` across its "data" ranks: the global batch
    gathered, permuted by a permutation drawn from `generator` (seeded the
    same on every rank) and this rank's rows taken back. Returns (shuffled,
    (perm, unshuffle indices)); the indices are global under a mesh."""
    n = x.shape[0]
    if mesh is None:
        perm = torch.randperm(n, generator=generator, device=generator.device).to(x.device)
        return x[perm], (perm, torch.argsort(perm))
    gathered = all_gather_rows(mesh, x)
    gperm = torch.randperm(gathered.shape[0], generator=generator, device=generator.device).to(x.device)
    i = mesh.axis_index(DATA_AXIS)
    return gathered[gperm][i * n:(i + 1) * n], (gperm, torch.argsort(gperm))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12)


def moco_loss(state: dict, encoder_apply: Callable, q_images: torch.Tensor, k_images: torch.Tensor,
              cfg: MoCoConfig = MoCoConfig()) -> Tuple[torch.Tensor, dict]:
    """InfoNCE with the queue's negatives: (loss, aux), aux carrying the key
    embeddings for the queue and the accuracy of the positive."""
    q = _normalize(encoder_apply(state["params_q"], q_images))
    with torch.no_grad():
        k = _normalize(encoder_apply(state["params_k"], k_images))
    l_pos = torch.sum(q * k, dim=1, keepdim=True)  # (B, 1)
    l_neg = q @ state["queue"]  # (B, K)
    logits = torch.cat([l_pos, l_neg], dim=1) / cfg.temperature
    loss = -torch.mean(F.log_softmax(logits, dim=1)[:, 0])
    acc = torch.mean((torch.argmax(logits, dim=1) == 0).float())
    return loss, {"keys": k, "acc": acc}


@torch.no_grad()
def dequeue_and_enqueue(state: dict, keys: torch.Tensor, cfg: MoCoConfig = MoCoConfig(),
                        mesh: Optional[Mesh] = None) -> dict:
    """The FIFO queue update (`builder.py:160-176`); with `mesh` the keys of
    every "data" rank, gathered in rank order (`concat_all_gather`)."""
    if mesh is not None:
        keys = all_gather_rows(mesh, keys)
    b = keys.shape[0]
    ptr = state["queue_ptr"]
    idx = (ptr + torch.arange(b, device=keys.device)) % cfg.queue_size
    queue = state["queue"].clone()
    queue[:, idx] = keys.T.to(queue.dtype)
    return {**state, "queue": queue, "queue_ptr": (ptr + b) % cfg.queue_size}


def moco_step(state: dict, encoder_apply: Callable, optimizer, opt_state, q_images: torch.Tensor,
              k_images: torch.Tensor, cfg: MoCoConfig = MoCoConfig(), mesh: Optional[Mesh] = None):
    """One step: the loss's gradient in the query encoder (averaged over
    "data" with `mesh`), the optimizer's update, the key encoder's momentum
    update and the queue's. Returns (loss, state, opt_state, {"acc"}); with
    `mesh` the loss and the accuracy are their means over "data" (JAX's
    are the rank's own)."""
    leaves = tree_leaves(state["params_q"])
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss, aux = moco_loss(state, encoder_apply, q_images, k_images, cfg)
        # a leaf the encoder does not read takes a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    loss, acc = loss.detach(), aux["acc"]
    if mesh is not None and mesh.data > 1:
        flat = all_reduce_(mesh, torch.cat([g.float().reshape(-1) for g in grads] + [loss[None], acc[None]]))
        flat /= mesh.data
        sizes = [p.numel() for p in leaves]
        grads = [g.reshape(p.shape).to(p.dtype) for g, p in zip(flat[:-2].split(sizes), leaves)]
        loss, acc = flat[-2], flat[-1]
    with torch.no_grad():
        if isinstance(optimizer, torch.optim.Optimizer):
            for p, g in zip(leaves, grads):
                p.grad = g
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        else:
            optimizer.update(grads, opt_state, state["params_q"])
    for p in leaves:
        p.requires_grad_(False)
    params_k = momentum_update(state["params_q"], state["params_k"], cfg.momentum)
    state = dequeue_and_enqueue({**state, "params_k": params_k}, aux["keys"], cfg, mesh)
    return loss, state, opt_state, {"acc": acc}
