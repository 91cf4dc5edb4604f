"""FR training and testing drivers (port of
`faceposegenerator_tpu/training/fr_driver.py:35-197`).

  - `train_fr_run`: one run: a run whose `best_backbone.npz` exists is
    skipped (the reference's skip-if-done); `fr_config.json`; per epoch the
    verification callback on the benchmark bins with best-accuracy
    tracking, the plateau or step LR schedule and an early stop after
    `early_stop_patience` stagnant epochs; `history.json`;
  - `train_fr_sweep`: one run per generator variant of `cfg.models`, seeded
    with its index;
  - `test_fr_run`: load the best backbone, evaluate every benchmark, dump
    per-benchmark and average accuracy JSON.

`best_backbone.npz` (and `epoch_{e}_backbone.npz`) hold {"params",
"state"} keyed by JAX's tree paths in JAX's layout (`fr.fr_checkpoint_tree`),
so a file either package writes loads into the other.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.checkpointing import save_pytree
from ..core.config import snapshot_config
from ..core.device import resolve_device
from ..core.logging_utils import ThroughputLogger, setup_logging
from ..core.precision import DEFAULT_POLICY, Policy
from ..core.rng import train_step_generator
from ..data.fr_dataset import FlatDirDataset, prefetch
from ..evaluation import verification
from . import fr

def train_fr_run(
    cfg: fr.FRConfig,
    dataset: FlatDirDataset,
    output_dir: str,
    val_bins: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
    policy: Policy = DEFAULT_POLICY,
    seed: int = 0,
    logger=None,
    max_steps_per_epoch: Optional[int] = None,
    checkpoint_every_epoch: bool = False,
    mesh=None,
    num_hosts: int = 1,
    host_id: int = 0,
    device=None,
) -> Dict:
    """One FR training run on `device` (the card unless "cpu"). val_bins:
    {benchmark: (images, issame)}. `checkpoint_every_epoch` saves backbone
    and header each epoch beside the best-model file
    (`CallBackModelCheckpointOld`).

    `mesh` (`core.mesh.Mesh`): data-parallel training (fr_driver.py:45-100),
    equal to one process's run on the global batch: the weights made equal
    on every rank, each global batch from `dataset.batches(num_shards=,
    shard_index=)` and each rank training on its rows of it
    (`core.mesh.form_global_batch`) with `fr.make_train_step(mesh=)`, whose
    BatchNorm takes the statistics of the global batch as JAX's jit does
    under a mesh. On a job of several hosts pass `num_hosts`/`host_id`: each
    host loads only its rows. `cfg.batch_size` is the batch of a host. Every
    rank validates (the same weights, the same verdicts); only the mesh's
    rank 0 writes."""
    device = resolve_device(device)
    coordinator = mesh is None or mesh.rank == 0
    if mesh is not None:  # every rank takes an equal share of each global batch
        from ..core.mesh import local_batch_size

        local_batch_size(mesh, cfg.batch_size * max(num_hosts, 1))
    if logger is None:
        logger = setup_logging(output_dir if coordinator else None)
    best_path = os.path.join(output_dir, "best_backbone.npz")
    if os.path.exists(best_path):
        logger.info(f"skip: {best_path} exists (reference skip-if-done)")
        return {"skipped": True}

    os.makedirs(output_dir, exist_ok=True)
    cfg = cfg.replace(num_classes=dataset.num_classes)
    if coordinator:
        snapshot_config(cfg, output_dir, "fr_config.json")

    params, state = fr.init_train_state(cfg, seed, device)
    global_batch = cfg.batch_size * max(num_hosts, 1)
    steps_per_epoch = max(len(dataset) // global_batch, 1)
    optimizer = fr.make_optimizer(cfg, steps_per_epoch)
    opt_state = optimizer.init(params)
    step_fn = fr.make_train_step(cfg, optimizer, policy=policy, mesh=mesh)
    if mesh is not None:
        from ..core.mesh import form_global_batch, replicate

        replicate(mesh, params)
        replicate(mesh, state)
    plateau = fr.PlateauScheduler(cfg) if cfg.lr_schedule == "plateau" else None

    throughput = ThroughputLogger(frequency=100, logger=logger)
    best_acc, stagnant, global_step = -1.0, 0, 0
    history: List[Dict] = []

    def save(path):
        if coordinator:
            save_pytree(fr.fr_checkpoint_tree(params, state), path)
        if mesh is not None and mesh.size > 1:
            from ..core.dist import barrier

            barrier("fr_written")

    for epoch in range(cfg.num_epochs):
        if mesh is None and num_hosts == 1:
            batches = dataset.batches(cfg.batch_size)
        else:
            batches = dataset.batches(cfg.batch_size, num_shards=max(num_hosts, 1), shard_index=host_id,
                                      epoch=epoch, order_seed=seed)
        for i, batch in enumerate(prefetch(batches)):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            if mesh is not None:
                batch = form_global_batch(mesh, batch, max(num_hosts, 1), host_id)
            params, state, opt_state, metrics = step_fn(
                params, state, opt_state, batch, train_step_generator(seed, global_step, device))
            global_step += 1
            throughput(global_step, global_batch)
            if global_step % 100 == 0:
                logger.info(f"step {global_step} loss={float(metrics['loss']):.4f}")

        if checkpoint_every_epoch:
            save(os.path.join(output_dir, f"epoch_{epoch}_backbone.npz"))

        epoch_acc = None
        if val_bins:
            embed = fr.make_embed_fn(cfg, params, state, policy)
            accs = {}
            for name, data in val_bins.items():
                acc, acc_std, xnorm, *_ = verification.test(data, embed)
                accs[name] = acc
                logger.info(f"epoch {epoch} [{name}] acc={acc:.4f}±{acc_std:.4f} xnorm={xnorm:.2f}")
            epoch_acc = float(np.mean(list(accs.values())))
            history.append({"epoch": epoch, "acc": epoch_acc, **accs})
            if plateau is not None:
                plateau.update(epoch_acc)
                opt_state = plateau.set_lr(opt_state, cfg.lr)
            if epoch_acc > best_acc:
                best_acc = epoch_acc
                stagnant = 0
                save(best_path)
            else:
                stagnant += 1
                if stagnant >= cfg.early_stop_patience:
                    logger.info(f"early stop at epoch {epoch} (best {best_acc:.4f})")
                    break
        else:
            save(best_path)

    if coordinator:
        with open(os.path.join(output_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=2)
    return {"best_acc": best_acc, "history": history, "skipped": False}


def train_fr_sweep(
    cfg: fr.FRConfig,
    dataset_roots: Dict[str, str],
    output_root: str,
    val_bins=None,
    augment=None,
    output_prefix: str = "REC_",
    **kw,
):
    """One run per generator variant of `cfg.models`, seed = run index
    (`train_FR.py:68-71`); the augmented (real + synthetic) variant uses
    `output_prefix="REC_TFD+Synth_"`."""
    results = {}
    for run_idx, model_name in enumerate(cfg.models):
        root = dataset_roots.get(model_name)
        if root is None or not os.path.isdir(root):
            continue
        dataset = FlatDirDataset(root, augment=augment, seed=run_idx)
        out = os.path.join(output_root, f"{output_prefix}{model_name}")
        results[model_name] = train_fr_run(cfg, dataset, out, val_bins=val_bins, seed=run_idx, **kw)
    return results


def test_fr_run(
    cfg: fr.FRConfig,
    backbone_path: str,
    benchmarks: Dict[str, Tuple[np.ndarray, np.ndarray]],
    output_json: Optional[str] = None,
    policy: Policy = DEFAULT_POLICY,
    device=None,
) -> Dict:
    """Load `best_backbone.npz` (written by either package), run every
    benchmark, dump per-benchmark and average accuracy JSON
    (`test_FR.py:52-201`)."""
    params, state = fr.load_fr_checkpoint(backbone_path, *fr.init_train_state(cfg, 0, device))
    embed = fr.make_embed_fn(cfg, params, state, policy)

    results: Dict = {}
    for name, data in benchmarks.items():
        acc, acc_std, xnorm, val, val_std, far = verification.test(data, embed)
        results[name] = {
            "accuracy": acc, "accuracy_std": acc_std, "xnorm": xnorm,
            "val": val, "val_std": val_std, "far": far,
        }
    results["average_accuracy"] = float(
        np.mean([v["accuracy"] for v in results.values() if isinstance(v, dict)])
    )
    if output_json:
        os.makedirs(os.path.dirname(output_json) or ".", exist_ok=True)
        with open(output_json, "w") as f:
            json.dump(results, f, indent=2)
    return results
