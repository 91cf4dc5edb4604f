"""Backbone registry: name → embedder module (port of
`faceposegenerator_tpu/models/registry.py`).

`get_model` of the reference (`ArcFace_files/backbones/__init__.py:5-85`):
r18/r34/r50/r100/r200/r2060 (IResNet; r2060 recomputes each block in the
backward), mbf (MobileFaceNet), vit_t/s/b/l (the face ViT). Where the JAX
registry returns (init, apply, cfg), the port returns the module, built on
`device` (the card unless "cpu") with seeded random weights; its `cfg` is the
config and `model(images, policy)` gives the (B, num_features) fp32
embeddings. `bridge.jax_params.load_jax_params` fills it from a JAX tree.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from . import iresnet, mobilefacenet, vit_face


def model_config(name: str, num_features: int = 512, **kw):
    """The config `get_model(name)` builds with (the JAX registry's)."""
    name = name.lower()
    if name in iresnet.DEPTHS:
        remat = (name == "r2060") or kw.pop("remat", False)
        return iresnet.IResNetConfig(depths=iresnet.DEPTHS[name], num_features=num_features, remat=remat, **kw)
    if name == "mbf":
        return mobilefacenet.MBFConfig(num_features=num_features, **kw)
    if name in vit_face.VIT_CONFIGS:
        return dataclasses.replace(vit_face.VIT_CONFIGS[name], num_features=num_features, **kw)
    raise ValueError(f"unknown backbone {name!r}")


def get_model(name: str, num_features: int = 512, *, device=None, dtype: torch.dtype = torch.float32,
              seed: int = 0, **kw) -> nn.Module:
    cfg = model_config(name, num_features, **kw)
    build = {iresnet.IResNetConfig: iresnet.IResNet, mobilefacenet.MBFConfig: mobilefacenet.MobileFaceNet,
             vit_face.FaceViTConfig: vit_face.FaceViT}[type(cfg)]
    return build(cfg, device=device, dtype=dtype, seed=seed)
