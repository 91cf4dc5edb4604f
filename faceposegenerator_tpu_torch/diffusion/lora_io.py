"""LoRA checkpoint IO: diffusers/peft safetensors ↔ the port's LoRA trees
(port of `faceposegenerator_tpu/diffusion/lora_io.py`).

The reference saves LoRA-only checkpoints via
`LoraLoaderMixin.save_lora_weights` → `pytorch_lora_weights.safetensors`
(`train_ID-Booth.py:744-766,1240-1258`) and loads them with
`pipe.load_lora_weights(<model>/<id>/checkpoint-31-6400)`
(`inference_ID-Booth.py:107`). This module speaks that wire format:

  peft-style keys      `unet.<module>.lora_A.weight` / `.lora_B.weight`
                       (also `.lora_A.default.weight`)
  legacy processor     `<module>.processor.to_q_lora.down.weight` / `.up.…`
  network alpha        `<module>.alpha`, folded into B as alpha / rank
  text encoder         `text_encoder.text_model.encoder.layers.{i}.self_attn.
                        {q,k,v,out}_proj.lora_A.weight`

and converts to and from the trees of `models.unet2d.init_lora` and the
text encoder's {"layer_i": {"q"|"k"|"v"|"out": {"a", "b"}}}. Modules a
checkpoint lacks become zero pairs, so the tree keeps one structure across
checkpoint swaps. Files go through `bridge.safetensors_io`.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..bridge.safetensors_io import load_file, save_file
from ..core.tree import tree_map
from ..models.unet2d import init_lora

_PROJ = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "out"}
_PROJ_TEXT = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "out"}


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def _zeros_like_lora(unet, text_encoder, rank: int, dtype=torch.float32):
    device = unet.conv_in.weight.device
    # zero A and B: a loaded checkpoint overwrites what it has
    unet_lora = tree_map(torch.zeros_like,
                         init_lora(unet, rank=rank, generator=torch.Generator(device=device), dtype=dtype))
    text_lora = None
    if text_encoder is not None:
        text_lora = {}
        for i, layer in enumerate(text_encoder.layers):
            text_lora[f"layer_{i}"] = {
                name: {
                    "a": torch.zeros(rank, getattr(layer, name).weight.shape[1], dtype=dtype, device=device),
                    "b": torch.zeros(getattr(layer, name).weight.shape[0], rank, dtype=dtype, device=device),
                }
                for name in ("q", "k", "v", "out")
            }
    return unet_lora, text_lora


def zero_lora(unet, text_encoder=None, rank: int = 4, dtype=torch.float32) -> dict:
    """The all-zero {"unet", "text_encoder"} LoRA of the standard fixed-rank
    structure, on the UNet's device: the identity adapter."""
    unet_lora, text_lora = _zeros_like_lora(unet, text_encoder, rank, dtype)
    return {"unet": unet_lora, "text_encoder": text_lora}


def _normalize_keys(sd: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Raw checkpoint keys → {"<module path>.A" | ".B" | ".alpha": tensor}."""
    out = {}
    for k, v in sd.items():
        m = re.match(r"(.+)\.lora_A(?:\.default)?\.weight$", k)
        if m:
            out[f"{m.group(1)}.A"] = _tensor(v)
            continue
        m = re.match(r"(.+)\.lora_B(?:\.default)?\.weight$", k)
        if m:
            out[f"{m.group(1)}.B"] = _tensor(v)
            continue
        m = re.match(r"(.+)\.processor\.(to_[qkv]|to_out)_lora\.(down|up)\.weight$", k)
        if m:
            proj = m.group(2) if m.group(2) != "to_out" else "to_out.0"
            ab = "A" if m.group(3) == "down" else "B"
            out[f"{m.group(1)}.{proj}.{ab}"] = _tensor(v)
            continue
        m = re.match(r"(.+)\.alpha$", k)
        if m:
            # kohya/diffusers network_alpha: the effective scale is
            # alpha / rank (peft `scaling`), folded into B below
            out[f"{m.group(1)}.alpha"] = _tensor(v)
    return out


def lora_from_state_dict(sd: Dict[str, object], unet, text_encoder=None, rank: Optional[int] = None,
                         dtype=torch.float32) -> dict:
    """{"unet": tree, "text_encoder": tree or None} from a diffusers-format
    LoRA state dict (numpy arrays or tensors), on the UNet's device in
    `dtype`."""
    norm = _normalize_keys(sd)
    alphas = {k[: -len(".alpha")]: float(v) for k, v in norm.items() if k.endswith(".alpha")}
    if rank is None:
        ranks = {v.shape[0] for k, v in norm.items() if k.endswith(".A")}
        if not ranks:
            raise ValueError("no LoRA tensors found in state dict")
        if len(ranks) > 1:
            raise ValueError(
                f"mixed LoRA ranks {sorted(ranks)} in checkpoint — the fixed-rank tree needs a "
                "single rank; pass rank= explicitly to pad to a common rank"
            )
        rank = ranks.pop()
    unet_lora, text_lora = _zeros_like_lora(unet, text_encoder, rank, dtype)

    def put(node, leaf, tensor):
        node[leaf] = tensor.to(device=node[leaf].device, dtype=dtype)

    unmatched = []
    for key, tensor in norm.items():
        path, ab = key.rsplit(".", 1)
        if ab == "alpha":
            continue
        leaf = "a" if ab == "A" else "b"
        if leaf == "b":
            # fold alpha / rank into B, so the runtime scale 1 means alpha == rank
            alpha = alphas.get(path)
            if alpha is not None and alpha != tensor.shape[-1]:
                tensor = tensor * (alpha / tensor.shape[-1])
        if path.startswith("unet."):
            path = path[len("unet."):]
        if path.startswith("text_encoder."):
            m = re.match(r"(?:text_model\.)?encoder\.layers\.(\d+)\.self_attn\.(\w+_proj)$",
                         path[len("text_encoder."):])
            if m and text_lora is not None:
                put(text_lora[f"layer_{int(m.group(1))}"][_PROJ_TEXT[m.group(2)]], leaf, tensor)
                continue
            unmatched.append(key)
            continue
        m = re.match(
            r"(down_blocks\.(\d+)|mid_block|up_blocks\.(\d+))\.attentions\.(\d+)\."
            r"transformer_blocks\.(\d+)\.(attn[12])\.(to_q|to_k|to_v|to_out\.0)$",
            path,
        )
        if not m:
            unmatched.append(key)
            continue
        where, down_i, up_i, attn_j, blk_k, attn_name, proj = m.groups()
        if where == "mid_block":
            tr = unet_lora["mid_block"]["attentions"][int(attn_j)]
        elif where.startswith("down_blocks"):
            tr = unet_lora["down_blocks"][int(down_i)]["attentions"][int(attn_j)]
        else:
            tr = unet_lora["up_blocks"][int(up_i)]["attentions"][int(attn_j)]
        put(tr["blocks"][int(blk_k)][attn_name][_PROJ[proj]], leaf, tensor)

    if unmatched:
        raise ValueError(f"unrecognized LoRA keys: {unmatched[:5]} "
                         f"(+{len(unmatched) - 5 if len(unmatched) > 5 else 0})")
    return {"unet": unet_lora, "text_encoder": text_lora}


def lora_to_state_dict(lora: dict) -> Dict[str, torch.Tensor]:
    """The LoRA trees under diffusers/peft keys, as CPU tensors."""
    sd = {}

    def emit_attn(prefix, attn):
        inv = {v: k for k, v in _PROJ.items()}
        for name, pair in attn.items():
            sd[f"{prefix}.{inv[name]}.lora_A.weight"] = pair["a"].detach().cpu()
            sd[f"{prefix}.{inv[name]}.lora_B.weight"] = pair["b"].detach().cpu()

    def emit_transformer(prefix, tr):
        for k, blk in enumerate(tr["blocks"]):
            emit_attn(f"{prefix}.transformer_blocks.{k}.attn1", blk["attn1"])
            emit_attn(f"{prefix}.transformer_blocks.{k}.attn2", blk["attn2"])

    unet_lora = lora.get("unet")
    if unet_lora is not None:
        for i, block in enumerate(unet_lora["down_blocks"]):
            for j, tr in enumerate(block["attentions"] or []):
                emit_transformer(f"unet.down_blocks.{i}.attentions.{j}", tr)
        for j, tr in enumerate(unet_lora["mid_block"]["attentions"]):
            emit_transformer(f"unet.mid_block.attentions.{j}", tr)
        for i, block in enumerate(unet_lora["up_blocks"]):
            for j, tr in enumerate(block["attentions"] or []):
                emit_transformer(f"unet.up_blocks.{i}.attentions.{j}", tr)

    text_lora = lora.get("text_encoder")
    if text_lora is not None:
        inv = {v: k for k, v in _PROJ_TEXT.items()}
        for lname, attn in text_lora.items():
            i = int(lname.split("_")[1])
            for name, pair in attn.items():
                p = f"text_encoder.text_model.encoder.layers.{i}.self_attn.{inv[name]}"
                sd[f"{p}.lora_A.weight"] = pair["a"].detach().cpu()
                sd[f"{p}.lora_B.weight"] = pair["b"].detach().cpu()
    return sd


def save_lora_safetensors(lora: dict, path: str):
    save_file(lora_to_state_dict(lora), path)


def load_lora_safetensors(path_or_dir: str, unet, text_encoder=None, dtype=torch.float32) -> dict:
    """Load `pytorch_lora_weights.safetensors` (the file or its checkpoint directory)."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "pytorch_lora_weights.safetensors")
    return lora_from_state_dict(load_file(path), unet, text_encoder, dtype=dtype)
