"""K ID-Booth fine-tunes in one train step (port of
`faceposegenerator_tpu/training/multi_identity.py`).

The reference trains one identity per fine-tune at a small batch (1-2 +
prior, `configs/config_train_SD21.py:49`) and loops over identities
(`train_ID-Booth.py:1324-1334`). Here K identities train at once: their
batches run as one batch of K times the rows, so every conv, GEMM and
attention sees K·(instance + prior) rows, while the semantics stay those of
K independent fine-tunes:

  - each identity has its own LoRA, its own AdamW state and its own
    global-norm clip, and the K share one learning-rate schedule;
  - each identity's loss is computed on its own rows, and no gradient
    crosses identities: the stacked LoRA leaves (K, ...) are gathered into
    per-row adapters, so the backward sums each identity's gradient into
    its own slice (`idbooth.make_loss_fn(identities=K)`);
  - every identity starts from the same init and draws the same noise
    stream as a serial run, and keeps the directory and file contract of
    `idbooth_driver.run_identity` (checkpoints, final LoRA).

Where JAX maps the single step over the identity axis with `vmap`, the
port concatenates: a stacked step launches the attention kernels as often
as one step at the same number of rows. Over a mesh the identity axis
shards over "data" (`shard_identity_axis`, multi_identity.py:54-70): rank r
trains its K/n identities with no gradient collective, and the metrics and
the trees to save are gathered to the mesh's rank 0, which writes them.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.checkpointing import CheckpointManager
from ..core.logging_utils import ThroughputLogger, setup_logging
from ..core.precision import DEFAULT_POLICY, Policy
from ..core.rng import train_step_generator
from ..core.tree import tree_map
from ..data.dreambooth import DreamBoothDataset
from ..diffusion.lora_io import save_lora_safetensors
from ..diffusion.schedulers import DDPMSchedule
from . import idbooth
from .idbooth_driver import DATA_RNG, lora_export, net_device, restore_data_rng, to_device


def stack_pytrees(trees: Sequence):
    """Stack K trees of one structure leafwise on a new leading identity
    axis. Tensors stack (a stacked leaf requires grad where the first
    does); numbers, such as the optimizer's update count (a 0-d tensor),
    must agree and stay one number: the K identities share the schedule."""
    def stack(first, *others):
        if isinstance(first, torch.Tensor) and first.dim() > 0:
            return torch.stack([t.detach() for t in (first,) + others]).requires_grad_(first.requires_grad)
        if any(bool(t != first) for t in others):
            raise ValueError(f"the identities disagree on a shared number: {[first, *others]}")
        return first.clone() if isinstance(first, torch.Tensor) else first

    return tree_map(stack, trees[0], *trees[1:])


def shard_identity_axis(mesh, tree):
    """This rank's slice of a stacked tree's identity axis (K, ...), the
    K identities sharded contiguously over the mesh's "data" axis; numbers
    (a 0-d tensor too: the shared update count) pass through."""
    from ..core.mesh import rows_of

    def take(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return leaf
        return leaf[rows_of(mesh, leaf.shape[0])].detach().clone().requires_grad_(leaf.requires_grad)

    return tree_map(take, tree)


def gather_identity_axis(mesh, tree):
    """The inverse of `shard_identity_axis`: every rank's slices, in rank
    order, on every rank (detached)."""
    from ..core.mesh import DATA_AXIS, all_gather_rows

    return tree_map(lambda leaf: all_gather_rows(mesh, leaf.detach(), DATA_AXIS)
                    if isinstance(leaf, torch.Tensor) and leaf.dim() > 0 else leaf, tree)


def _data_rng_states(mesh, datasets) -> List[dict]:
    """Every identity's dataset random state (the data order to come, known
    where the identity trained), on every rank: the JSON of each state,
    padded to a fixed length, gathered as bytes."""
    states = [ds.rng.bit_generator.state for ds in datasets]
    if mesh is None:
        return states
    from ..core.mesh import DATA_AXIS, all_gather_rows

    n = 1024
    raw = [json.dumps(st).encode().ljust(n) for st in states]
    if any(len(r) > n for r in raw):
        raise ValueError("a dataset random state longer than its gather buffer")
    codes = torch.tensor([list(r) for r in raw], dtype=torch.uint8, device=mesh.device)
    return [json.loads(bytes(row.tolist()).decode()) for row in all_gather_rows(mesh, codes, DATA_AXIS).cpu()]


def unstack_pytree(tree, k: int) -> List:
    """Inverse of `stack_pytrees`: K trees with their own copies of slice i."""
    def take(i):
        def leaf_i(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if leaf.dim() == 0:  # a shared number: each tree its own copy
                return leaf.clone()
            return leaf[i].detach().clone().requires_grad_(leaf.requires_grad)

        return leaf_i

    return [tree_map(take(i), tree) for i in range(k)]


def make_multi_train_step(cfg: idbooth.IDBoothConfig, models: idbooth.ModelBundle, optimizer: idbooth.LoRAOptimizer,
                          identities: int, schedule: Optional[DDPMSchedule] = None,
                          policy: Policy = DEFAULT_POLICY, detect_fn: Callable = idbooth.full_image_boxes):
    """`multi_step(trainables, opt_states, frozen, batches, generators=None,
    draws=None) -> (trainables, opt_states, metrics)` over K = `identities`:
    `idbooth.make_train_step(identities=K)`. trainables / opt_states:
    stacked per-identity trees (leading axis K, `stack_pytrees`); frozen:
    one set of nets; batches: per-identity batches stacked to (K, n, ...);
    generators / draws: K of each, one per identity. The metrics have shape
    (K,), `grad_norm` each identity's."""
    return idbooth.make_train_step(cfg, models, optimizer, schedule, policy, detect_fn, identities=identities)


def run_identities_vmapped(
    cfg: idbooth.IDBoothConfig,
    bundle: idbooth.ModelBundle,
    frozen: Dict,
    instance_dirs: Sequence[str],
    output_dirs: Sequence[str],
    tokenizer=None,
    embeds_dirs: Optional[Sequence[Optional[str]]] = None,
    class_dir: Optional[str] = None,
    policy: Policy = DEFAULT_POLICY,
    detect_fn: Callable = idbooth.full_image_boxes,
    resume: bool = True,
    instance_ids: Optional[np.ndarray] = None,
    class_ids: Optional[np.ndarray] = None,
    logger=None,
    mesh=None,
) -> Tuple[List[Dict], List[List[Dict]]]:
    """Fine-tune K identities at once; returns (trainables, histories), one
    of each per identity. The same artifacts per identity as K serial
    `run_identity` calls (checkpoint-{epoch}-{step} directories, the final
    `pytorch_lora_weights.safetensors`); no validation images, as in JAX.
    The identities must have the same steps per epoch (one schedule), and
    when resumed, the same latest (epoch, step).

    `mesh` (`core.mesh.Mesh`): the K identities shard over its "data" axis
    (multi_identity.py:213-253), K a multiple of its size; each rank trains
    its own with no gradient collective, and only the mesh's rank 0 writes
    the checkpoints and the LoRAs, the trees and each identity's dataset
    random state gathered to it; every rank returns all K."""
    K = len(instance_dirs)
    if mesh is not None and K % mesh.data != 0:
        raise ValueError(
            f"vmapped identity group K={K} must divide the mesh data "
            f"axis ({mesh.data}) — pad the group or change vmap_identities"
        )
    coordinator = mesh is None or mesh.rank == 0
    if len(output_dirs) != K:
        raise ValueError(f"{len(output_dirs)} output directories for {K} identities")
    if embeds_dirs is None:
        embeds_dirs = [None] * K
    if logger is None:
        logger = setup_logging(output_dirs[0] if coordinator else None)
    if instance_ids is None:
        instance_ids = tokenizer([cfg.instance_prompt])[0]
    if class_ids is None and cfg.with_prior_preservation:
        class_ids = tokenizer([cfg.class_prompt])[0]
    device = net_device(frozen)

    datasets = [
        DreamBoothDataset(instance_dirs[i], instance_ids,
                          class_dir=class_dir if cfg.with_prior_preservation else None,
                          class_ids=class_ids, embeds_dir=embeds_dirs[i], resolution=cfg.resolution,
                          seed=cfg.seed, embed_dim=bundle.arcface_cfg.num_features)
        for i in range(K)
    ]
    spe = {len(ds) // cfg.train_batch_size for ds in datasets}
    if len(spe) != 1:
        raise ValueError(
            f"identities must share steps_per_epoch to share one LR schedule; got sizes "
            f"{[len(d) for d in datasets]} at batch {cfg.train_batch_size}: group identities by size")
    steps_per_epoch = max(spe.pop(), 1)
    total_steps = steps_per_epoch * cfg.num_train_epochs

    # the same init for every identity, as serial runs all start from cfg.seed
    one_trainable = idbooth.init_trainable(cfg.seed, cfg, bundle, frozen["unet"], frozen.get("text_encoder"))
    optimizer = idbooth.make_optimizer(cfg, total_steps)
    one_opt = optimizer.init(one_trainable)

    ckpts = [CheckpointManager(d, cfg.checkpoints_total_limit) for d in output_dirs]
    first_epoch, global_step = 0, 0
    per_id_trainables, per_id_opts, resumed = [], [], set()
    for i in range(K):
        t_i, o_i = one_trainable, one_opt
        if resume and ckpts[i].latest():
            t_i, o_i, ep, gs = ckpts[i].restore(ckpts[i].latest(), t_i, o_i)
            restore_data_rng(ckpts[i].latest(), datasets[i])
            resumed.add((ep + 1, gs))
            first_epoch, global_step = ep + 1, gs
        per_id_trainables.append(t_i)
        per_id_opts.append(o_i)
    if resume and resumed and (len(resumed) != 1 or any(not c.latest() for c in ckpts)):
        raise ValueError(
            "identities in one stacked group must resume from the same (epoch, step): re-group, or finish "
            f"the stragglers serially (found {sorted(resumed)}, with "
            f"{sum(1 for c in ckpts if not c.latest())} unstarted)")
    trainables = stack_pytrees(per_id_trainables)
    opt_states = stack_pytrees(per_id_opts)
    mine = range(K)
    if mesh is not None:
        from ..core.mesh import rows_of

        trainables, opt_states = shard_identity_axis(mesh, trainables), shard_identity_axis(mesh, opt_states)
        mine = range(K)[rows_of(mesh, K)]
    multi_step = make_multi_train_step(cfg, bundle, optimizer, len(mine), policy=policy, detect_fn=detect_fn)

    def whole(tree):
        return tree if mesh is None else gather_identity_axis(mesh, tree)

    def written():
        if mesh is not None and mesh.size > 1:
            from ..core.dist import barrier

            barrier("multi_identity_written")

    throughput = ThroughputLogger(frequency=50, total_steps=total_steps, logger=logger)
    histories: List[List[Dict]] = [[] for _ in range(K)]
    for epoch in range(first_epoch, cfg.num_train_epochs):
        sums, count = None, 0
        for batch_tuple in zip(*[datasets[i].batches(cfg.train_batch_size) for i in mine]):
            batches = {k: np.stack([b[k] for b in batch_tuple]) for k in batch_tuple[0]}
            # each identity's noise stream is a serial run's: cfg.seed at this step
            gens = [train_step_generator(cfg.seed, global_step, device) for _ in mine]
            trainables, opt_states, metrics = multi_step(trainables, opt_states, frozen,
                                                         to_device(batches, device), gens)
            global_step += 1
            count += 1
            vals = {k: v.double().cpu().numpy() for k, v in whole(metrics).items()}
            sums = vals if sums is None else {k: sums[k] + vals[k] for k in sums}
            throughput(global_step, cfg.train_batch_size * K)
        if count:
            for i in range(K):
                stats = {k: float(v[i]) / count for k, v in sums.items()}
                stats["epoch"] = epoch
                histories[i].append(stats)
            logger.info(f"epoch {epoch}: loss=" + "/".join(f"{h[-1]['loss']:.4f}" for h in histories))

        last = epoch == cfg.num_train_epochs - 1
        if (epoch + 1) % cfg.checkpointing_epochs == 0 or last:
            t_list, o_list = unstack_pytree(whole(trainables), K), unstack_pytree(whole(opt_states), K)
            rng_states = _data_rng_states(mesh, [datasets[i] for i in mine])
            if coordinator:
                for i in range(K):
                    path = ckpts[i].save(epoch, global_step, t_list[i], o_list[i], lora_export(t_list[i]))
                    with open(os.path.join(path, DATA_RNG), "w") as f:
                        json.dump(rng_states[i], f)
            written()

    t_list = unstack_pytree(whole(trainables), K)
    if coordinator:
        for i in range(K):
            save_lora_safetensors(lora_export(t_list[i]),
                                  os.path.join(output_dirs[i], "pytorch_lora_weights.safetensors"))
    written()
    return t_list, histories
