"""Checkpoint and resume (port of `faceposegenerator_tpu/core/checkpointing.py`).

The reference's behaviour (`train_ID-Booth.py:696-766,928-956,1181-1206`):
`checkpoint-{epoch}-{global_step}` directories every `checkpointing_epochs`,
pruned to `checkpoints_total_limit` oldest first, the LoRA saved as
diffusers' `pytorch_lora_weights.safetensors`, and resume from the
directory with the highest step. Each directory holds

  - `state.npz`: {"trainable", "opt_state"} flattened to keys that are the
    tree paths ("trainable/unet_lora/down_blocks/0/attentions/0/blocks/0/
    attn1/q/a"), the keys the JAX package writes, so the `trainable` of a
    JAX checkpoint loads into the port and the other way round;
  - `META`: "<epoch> <global_step>";
  - `pytorch_lora_weights.safetensors`, what `load_lora_weights` reads.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from .tree import tree_map_with_path, tree_paths

_CKPT_RE = re.compile(r"^checkpoint-(\d+)-(\d+)$")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_pytree(tree, path: str):
    """Save a tree of tensors, arrays and numbers as one .npz keyed by tree path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{p: _to_numpy(leaf) for p, leaf in tree_paths(tree)})


def _like(arr: np.ndarray, template):
    """`arr` as the template leaf: a tensor on its device in its dtype
    (requiring grad where it does), a Python number, or an array."""
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.array(arr)).to(device=template.device, dtype=template.dtype)
        return t.requires_grad_(template.requires_grad)
    if isinstance(template, bool):
        return bool(arr)
    if isinstance(template, int):
        return int(arr)
    if isinstance(template, float):
        return float(arr)
    return np.array(arr)


def load_pytree(template, path: str):
    """The tree saved at `path`, in the structure and leaf types of `template`."""
    with np.load(path) as data:
        return tree_map_with_path(lambda p, leaf: _like(data[p], leaf), template)


class CheckpointManager:
    def __init__(self, output_dir: str, total_limit: Optional[int] = None):
        self.output_dir = output_dir
        self.total_limit = total_limit
        os.makedirs(output_dir, exist_ok=True)

    def list_checkpoints(self) -> List[Tuple[int, int, str]]:
        """[(epoch, step, path)] sorted by step ascending."""
        out = []
        for name in os.listdir(self.output_dir):
            m = _CKPT_RE.match(name)
            if m:
                out.append((int(m.group(1)), int(m.group(2)), os.path.join(self.output_dir, name)))
        return sorted(out, key=lambda x: x[1])

    def save(self, epoch: int, global_step: int, trainable, opt_state, lora_for_export=None) -> str:
        path = os.path.join(self.output_dir, f"checkpoint-{epoch}-{global_step}")
        os.makedirs(path, exist_ok=True)
        save_pytree({"trainable": trainable, "opt_state": opt_state}, os.path.join(path, "state.npz"))
        with open(os.path.join(path, "META"), "w") as f:
            f.write(f"{epoch} {global_step}\n")
        if lora_for_export is not None:
            from ..diffusion.lora_io import save_lora_safetensors

            save_lora_safetensors(lora_for_export, os.path.join(path, "pytorch_lora_weights.safetensors"))
        self._prune()
        return path

    def _prune(self):
        if self.total_limit is None:
            return
        ckpts = self.list_checkpoints()
        while len(ckpts) > self.total_limit:
            _, _, path = ckpts.pop(0)
            shutil.rmtree(path, ignore_errors=True)

    def latest(self) -> Optional[str]:
        ckpts = self.list_checkpoints()
        return ckpts[-1][2] if ckpts else None

    def restore(self, path: str, trainable_template, opt_state_template):
        """(trainable, opt_state, epoch, global_step) of the checkpoint at
        `path`, in the templates' structure, devices and dtypes."""
        state = load_pytree({"trainable": trainable_template, "opt_state": opt_state_template},
                            os.path.join(path, "state.npz"))
        m = _CKPT_RE.match(os.path.basename(path))
        epoch, step = int(m.group(1)), int(m.group(2))
        return state["trainable"], state["opt_state"], epoch, step
