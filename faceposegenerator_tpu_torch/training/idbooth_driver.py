"""ID-Booth experiment driver: the epoch loop, checkpoints, validation and
the sweep (port of `faceposegenerator_tpu/training/idbooth_driver.py`).

The reference's `main(args)` and its `__main__` sweep
(`train_ID-Booth.py:505-1334`):
  - one LoRA fine-tune per (loss variant, identity);
  - sweep folders DreamBooth / PortraitBooth / ID-Booth after
    `losses_to_test` (`:1299-1307`), a `training_config.json` each (`:1316-1322`);
  - `checkpoint-{epoch}-{global_step}` every `checkpointing_epochs`,
    resumed from the latest (`:928-956,1181-1206`);
  - DPM-Solver++ validation images every `validation_epochs`
    (`log_validation`, `:132-191,1208-1234`);
  - the diffusers-format LoRA at the run's root (`:1240-1258`).

One deliberate difference: JAX's driver catches and logs any exception of
validation sampling (idbooth_driver.py:232-239). Here a failure in
validation, a kernel that does not build or launch included, stops the run.
A checkpoint also holds the dataset's random state (`data_rng.json`: the
shuffles and crops to come), as the reference's `save_state` keeps its RNG
states, so a resumed run repeats an uninterrupted one; a checkpoint without
it (one the JAX package wrote) restarts the data order.
Data-parallel runs (`mesh`, and `num_hosts`/`host_id` for a job whose
hosts each load only their rows) train one process's run on the global
batch over the mesh's ranks; only the mesh's rank 0 writes logs,
checkpoints, validation images and the export, and every rank waits at a
barrier after each write.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.checkpointing import CheckpointManager
from ..core.config import snapshot_config
from ..core.logging_utils import AverageMeter, ThroughputLogger, setup_logging
from ..core.precision import DEFAULT_POLICY, Policy
from ..core.rng import train_step_generator
from ..core.trackers import Tracker
from ..data.dreambooth import DreamBoothDataset, _natural_key, list_images
from ..diffusion.lora_io import save_lora_safetensors
from ..diffusion.sampler import sample
from ..diffusion.schedulers import make_ddpm, make_dpm_solver
from ..pipelines.sweep import save_image_grid
from . import idbooth

DATA_RNG = "data_rng.json"


def net_device(frozen: Dict) -> torch.device:
    """The device the frozen UNet lives on, where the driver puts its batches."""
    return frozen["unet"].conv_in.weight.device


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch of `DreamBoothDataset` as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def lora_export(trainable: Dict) -> Dict:
    """The {"unet", "text_encoder"} LoRA that `save_lora_safetensors` writes."""
    return {"unet": trainable["unet_lora"], "text_encoder": trainable.get("text_lora")}


def save_data_rng(ckpt_path: str, dataset: DreamBoothDataset):
    """Write the dataset's numpy bit-generator state into the checkpoint."""
    with open(os.path.join(ckpt_path, DATA_RNG), "w") as f:
        json.dump(dataset.rng.bit_generator.state, f)


def restore_data_rng(ckpt_path: str, dataset: DreamBoothDataset):
    """Set the dataset's bit-generator state from the checkpoint, where it has one."""
    path = os.path.join(ckpt_path, DATA_RNG)
    if os.path.exists(path):
        with open(path) as f:
            dataset.rng.bit_generator.state = json.load(f)


def generate_class_images(pipe, class_dir: str, class_prompt: str, num_class_images: int = 200,
                          batch_size: int = 4, num_inference_steps: int = 30) -> int:
    """Generate the prior-preservation images the folder lacks with `pipe`
    (a `StableDiffusionPipeline` with a tokenizer), `batch_size` at a time,
    the i-th image from seed i, saved as `<i>-<sha1>.jpg`
    (`train_ID-Booth.py:547-592`). Returns the index after the last image."""
    import hashlib

    from PIL import Image

    os.makedirs(class_dir, exist_ok=True)
    existing = len([f for f in os.listdir(class_dir) if f.lower().endswith((".jpg", ".png"))])
    needed = num_class_images - existing
    idx = existing
    while needed > 0:
        n = min(batch_size, needed)
        imgs = pipe(prompt=[class_prompt] * n, num_inference_steps=num_inference_steps, seed=idx)
        for img in imgs:
            arr = (np.asarray(img) * 255).astype(np.uint8)
            digest = hashlib.sha1(arr.tobytes()).hexdigest()
            Image.fromarray(arr).save(os.path.join(class_dir, f"{idx}-{digest}.jpg"))
            idx += 1
        needed -= n
    return idx


def validation_images(frozen: Dict, trainable: Dict, cfg: idbooth.IDBoothConfig, bundle: idbooth.ModelBundle,
                      tokenizer, policy: Policy, num_steps: int = 25) -> np.ndarray:
    """`num_validation_images` images of `validation_prompt` against the
    empty prompt, DPM-Solver++ `num_steps` steps, CFG 5.0, the UNet and text
    LoRA of `trainable`, noise from `cfg.seed` (`log_validation`): (N, H, W,
    3) in [0, 1]."""
    n = cfg.num_validation_images
    nets = {k: frozen[k] for k in ("text_encoder", "unet", "vae")}
    ids = torch.from_numpy(np.asarray(tokenizer([cfg.validation_prompt] * n))).long()
    neg = torch.from_numpy(np.asarray(tokenizer([""] * n))).long()
    device = net_device(frozen)
    images = sample(nets, make_dpm_solver(num_inference_steps=num_steps), ids.to(device), neg.to(device),
                    generator=torch.Generator(device=device).manual_seed(cfg.seed), guidance_scale=5.0,
                    height=cfg.resolution, width=cfg.resolution, policy=policy, scheduler="dpm",
                    attn_impl=bundle.attn_impl, lora=lora_export(trainable))
    return images.cpu().numpy()


def run_identity(
    cfg: idbooth.IDBoothConfig,
    bundle: idbooth.ModelBundle,
    frozen: Dict,
    instance_dir: str,
    output_dir: str,
    tokenizer=None,
    embeds_dir: Optional[str] = None,
    class_dir: Optional[str] = None,
    policy: Policy = DEFAULT_POLICY,
    detect_fn: Callable = idbooth.full_image_boxes,
    resume: bool = True,
    instance_ids: Optional[np.ndarray] = None,
    class_ids: Optional[np.ndarray] = None,
    logger=None,
    mesh=None,
    num_hosts: int = 1,
    host_id: int = 0,
):
    """The whole fine-tune of one identity on the frozen nets' device.
    Returns (trainable, history: one dict of epoch means per epoch run).

    Writes into `output_dir`: `training.log`, `logs/scalars.jsonl`,
    `checkpoint-{epoch}-{step}/` every `checkpointing_epochs` and after the
    last epoch, `validation/epoch_{e}.png` every `validation_epochs` and
    after the last (with a tokenizer), and `pytorch_lora_weights.safetensors`.
    With `resume`, training continues after the latest checkpoint's epoch.
    Step i's noise comes from `train_step_generator(cfg.seed, i)`, so a
    resumed run repeats an uninterrupted one.

    `mesh` (`core.mesh.Mesh`): the epoch loop runs data-parallel
    (idbooth_driver.py:123-204): the LoRA made equal on every rank, each
    global batch from `DreamBoothDataset.sharded_batches` (its order from
    (seed, epoch)), each rank training on its rows of it
    (`core.mesh.form_global_batch`) with `idbooth.make_train_step(mesh=)`.
    On a job of several hosts pass `num_hosts`/`host_id`: each host loads
    only its rows of every global batch. `cfg.train_batch_size` is the
    batch of a host; the global batch is that × `num_hosts`. Only the
    mesh's rank 0 writes into `output_dir`; all ranks pass a barrier after
    each write."""
    coordinator = mesh is None or mesh.rank == 0
    if mesh is not None:  # every rank takes an equal share of each global batch
        from ..core.mesh import local_batch_size

        local_batch_size(mesh, cfg.train_batch_size * max(num_hosts, 1) * (1 + cfg.with_prior_preservation))
    if logger is None:
        logger = setup_logging(output_dir if coordinator else None)
    if instance_ids is None:
        instance_ids = tokenizer([cfg.instance_prompt])[0]
    if class_ids is None and cfg.with_prior_preservation:
        class_ids = tokenizer([cfg.class_prompt])[0]
    device = net_device(frozen)

    dataset = DreamBoothDataset(
        instance_dir, instance_ids,
        class_dir=class_dir if cfg.with_prior_preservation else None,
        class_ids=class_ids, embeds_dir=embeds_dir, resolution=cfg.resolution, seed=cfg.seed,
        embed_dim=bundle.arcface_cfg.num_features,
    )
    global_batch = cfg.train_batch_size * max(num_hosts, 1)
    steps_per_epoch = max(len(dataset) // global_batch, 1)
    total_steps = steps_per_epoch * cfg.num_train_epochs

    trainable = idbooth.init_trainable(cfg.seed, cfg, bundle, frozen["unet"], frozen.get("text_encoder"))
    optimizer = idbooth.make_optimizer(cfg, total_steps)
    opt_state = optimizer.init(trainable)
    train_step = idbooth.make_train_step(cfg, bundle, optimizer, make_ddpm(), policy=policy, detect_fn=detect_fn,
                                         mesh=mesh)

    ckpt = CheckpointManager(output_dir, cfg.checkpoints_total_limit)
    first_epoch, global_step = 0, 0
    if resume and ckpt.latest():
        trainable, opt_state, first_epoch, global_step = ckpt.restore(ckpt.latest(), trainable, opt_state)
        restore_data_rng(ckpt.latest(), dataset)
        first_epoch += 1
        logger.info(f"resumed from {ckpt.latest()} (epoch {first_epoch})")
    if mesh is not None:
        from ..core.mesh import replicate

        replicate(mesh, trainable)

    def written():
        """Every rank waits until rank 0's files are there."""
        if mesh is not None and mesh.size > 1:
            from ..core.dist import barrier

            barrier("idbooth_written")

    def epoch_batches(epoch):
        if mesh is None and num_hosts == 1:
            yield from (to_device(b, device) for b in dataset.batches(cfg.train_batch_size))
            return
        for b in dataset.sharded_batches(cfg.train_batch_size, num_shards=max(num_hosts, 1), shard_index=host_id,
                                         epoch=epoch, order_seed=cfg.seed):
            if mesh is None:
                yield to_device(b, device)
            else:
                from ..core.mesh import form_global_batch

                yield form_global_batch(mesh, b, max(num_hosts, 1), host_id)

    throughput = ThroughputLogger(frequency=50, total_steps=total_steps, logger=logger)
    tracker = Tracker(os.path.join(output_dir, "logs")) if coordinator else None
    history: List[Dict] = []
    try:
        for epoch in range(first_epoch, cfg.num_train_epochs):
            meters = {k: AverageMeter() for k in ("loss", "instance_loss", "prior_loss", "id_loss")}
            for batch in epoch_batches(epoch):
                trainable, opt_state, metrics = train_step(
                    trainable, opt_state, frozen, batch, train_step_generator(cfg.seed, global_step, device))
                global_step += 1
                for k, m in meters.items():
                    if k in metrics:
                        m.update(float(metrics[k]))
                throughput(global_step, global_batch)
            epoch_stats = {k: m.avg for k, m in meters.items() if m.count}
            epoch_stats["epoch"] = epoch
            history.append(epoch_stats)
            if tracker is not None:
                tracker.log_scalars(global_step, {k: v for k, v in epoch_stats.items() if k != "epoch"})
            logger.info(f"epoch {epoch}: " + ", ".join(f"{k}={v:.4f}" for k, v in epoch_stats.items()
                                                       if k != "epoch"))

            last = epoch == cfg.num_train_epochs - 1
            if (epoch + 1) % cfg.checkpointing_epochs == 0 or last:
                if coordinator:
                    save_data_rng(ckpt.save(epoch, global_step, trainable, opt_state, lora_export(trainable)),
                                  dataset)
                written()
            if tokenizer is not None and ((epoch + 1) % cfg.validation_epochs == 0 or last):
                if coordinator:
                    imgs = validation_images(frozen, trainable, cfg, bundle, tokenizer, policy)
                    save_image_grid(imgs, os.path.join(output_dir, "validation", f"epoch_{epoch}.png"))
                    tracker.log_images(global_step, "validation", imgs)
                written()

        if coordinator:
            save_lora_safetensors(lora_export(trainable),
                                  os.path.join(output_dir, "pytorch_lora_weights.safetensors"))
        written()
    finally:
        if tracker is not None:
            tracker.close()
    return trainable, history


def vmap_groups(cfg: idbooth.IDBoothConfig, source_folder: str, identities: List[str], class_dir: Optional[str],
                k: int):
    """(groups of k identities that share steps per epoch, the identities
    left for serial runs), as `run_experiment_sweep(vmap_identities=k)`
    forms them: identities keyed by their dataset length (max of instance
    and class images) // batch, in order, each key's run cut into groups of k."""
    n_class = len(list_images(class_dir)) if class_dir and cfg.with_prior_preservation else 0
    by_spe: Dict[int, List[str]] = {}
    for ident in identities:
        n_img = len(list_images(os.path.join(source_folder, ident)))
        by_spe.setdefault(max(n_img, n_class or 1) // cfg.train_batch_size, []).append(ident)
    groups, serial = [], []
    for ids in by_spe.values():
        while len(ids) >= k:
            groups.append(ids[:k])
            ids = ids[k:]
        serial.extend(ids)
    return groups, serial


def run_experiment_sweep(
    cfg: idbooth.IDBoothConfig,
    bundle: idbooth.ModelBundle,
    frozen: Dict,
    source_folder: str,
    output_folder: str,
    tokenizer=None,
    embeds_root: Optional[str] = None,
    class_dir: Optional[str] = None,
    identities: Optional[List[str]] = None,
    vmap_identities: int = 1,
    **kw,
):
    """losses_to_test × identities (`train_ID-Booth.py:1287-1334`): each
    loss variant under `output_folder/<LOSS_TO_FOLDER[loss]>/` with its
    `training_config.json`, each identity in its own folder. With
    `vmap_identities=K > 1`, identities of equal steps per epoch train K at
    a time in one stacked run (`multi_identity.run_identities_vmapped`, the
    same artifacts as serial runs); the rest run one by one. A `mesh` in
    `kw` goes to both: the stacked groups shard by identity, the serial
    runs by row. Returns {(loss, identity): history}."""
    if identities is None:
        identities = sorted((d for d in os.listdir(source_folder) if os.path.isdir(os.path.join(source_folder, d))),
                            key=_natural_key)
    results = {}
    for which_loss in cfg.losses_to_test:
        run_cfg = cfg.replace(which_loss=which_loss)
        run_root = os.path.join(output_folder, idbooth.LOSS_TO_FOLDER[which_loss])
        os.makedirs(run_root, exist_ok=True)
        if kw.get("mesh") is None or kw["mesh"].rank == 0:
            snapshot_config(run_cfg, run_root)
        serial = list(identities)
        if vmap_identities > 1:
            from .multi_identity import run_identities_vmapped

            groups, serial = vmap_groups(run_cfg, source_folder, identities, class_dir, vmap_identities)
            for grp in groups:
                _, hists = run_identities_vmapped(
                    run_cfg, bundle, frozen,
                    instance_dirs=[os.path.join(source_folder, g) for g in grp],
                    output_dirs=[os.path.join(run_root, g) for g in grp],
                    tokenizer=tokenizer,
                    embeds_dirs=[os.path.join(embeds_root, g) if embeds_root else None for g in grp],
                    class_dir=class_dir,
                    **{k: v for k, v in kw.items()
                       if k in ("policy", "detect_fn", "resume", "instance_ids", "class_ids", "logger", "mesh")},
                )
                for g, h in zip(grp, hists):
                    results[(which_loss, g)] = h
        for ident in serial:
            _, history = run_identity(
                run_cfg, bundle, frozen,
                instance_dir=os.path.join(source_folder, ident),
                output_dir=os.path.join(run_root, ident),
                tokenizer=tokenizer,
                embeds_dir=os.path.join(embeds_root, ident) if embeds_root else None,
                class_dir=class_dir,
                **kw,
            )
            results[(which_loss, ident)] = history
    return results
