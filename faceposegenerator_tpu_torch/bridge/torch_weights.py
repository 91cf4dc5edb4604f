"""Diffusers SD2.1 checkpoints → param trees in the JAX layout (port of the
SD2.1 part of `faceposegenerator_tpu/bridge/torch_weights.py:58-578`).

The converters return nested dicts/lists of numpy arrays keyed as the JAX
package's trees are, which `bridge.jax_params.load_jax_params` then writes
into the port's modules: one path into the modules, and a tree the tests
can hold leaf for leaf against the JAX converter's. Conventions:

  - conv weights: torch OIHW → HWIO (transpose 2, 3, 1, 0)
  - linear weights: kept in torch (out, in) orientation
  - GroupNorm/LayerNorm weight/bias → g/b

Safetensors files are read by `bridge.safetensors_io` (no `safetensors`
package), `.bin` files by `torch.load(..., weights_only=True)`.
`convert_iresnet_state_dict` takes the insightface/ArcFace `.pth` layout
(`backbone.pth`, `ArcFace_r100_ms1mv3_backbone.pth`) to IResNet's (params,
state). The seven dgm-eval encoders' converters (`convert_{dinov2,
inception,clip_vision,resnet50,convnext,data2vec,simclr}_state_dict`, JAX
`bridge/torch_weights.py:403-830`) take the reference checkpoints' layouts
to the trees of `models/{dinov2,inception_v3,clip_vision,resnet50,convnext,
data2vec_vision,simclr_resnet}.py`; DINOv2's takes both the hub and the
transformers layout, MAE's is DINOv2's without LayerScale.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import numpy as np
import torch

from ..models import clip_text, convnext, iresnet, unet2d, vae
from .safetensors_io import load_numpy


def load_torch_pth(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # unwrap common checkpoint containers (MAE nests under "model", FR
    # trainers under "state_dict")
    for container in ("state_dict", "model"):
        if container in sd and isinstance(sd[container], dict):
            sd = sd[container]
            break
    return {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def _arr(x, dtype):
    return np.asarray(x, dtype)


def _conv(sd, prefix, dtype):
    w = np.asarray(sd[f"{prefix}.weight"])
    if w.ndim == 2:  # some checkpoints store 1x1 convs as linear
        w = w[:, :, None, None]
    return {"w": _arr(w.transpose(2, 3, 1, 0), dtype), "b": _arr(sd[f"{prefix}.bias"], dtype)}


def _dense(sd, prefix, dtype, bias=True):
    w = np.asarray(sd[f"{prefix}.weight"])
    if w.ndim == 4:  # conv1x1 stored where we want a linear
        w = w[:, :, 0, 0]
    p = {"w": _arr(w, dtype)}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _arr(sd[f"{prefix}.bias"], dtype)
    return p


def _norm(sd, prefix, dtype):
    return {"g": _arr(sd[f"{prefix}.weight"], dtype), "b": _arr(sd[f"{prefix}.bias"], dtype)}


def _bn(sd, prefix, dtype):
    return _norm(sd, prefix, dtype), {"mean": _arr(sd[f"{prefix}.running_mean"], dtype),
                                      "var": _arr(sd[f"{prefix}.running_var"], dtype)}


# ---------------------------------------------------------------------------
# IResNet (ArcFace backbone .pth)
# ---------------------------------------------------------------------------


def _bias_free_conv(sd, key, dtype):
    w = np.asarray(sd[key])
    return {"w": _arr(w.transpose(2, 3, 1, 0), dtype), "b": np.zeros((w.shape[0],), dtype)}


def convert_iresnet_state_dict(sd: Dict[str, np.ndarray], cfg: iresnet.IResNetConfig = iresnet.IResNetConfig(),
                               dtype=np.float32):
    """insightface IResNet state dict → (params, state) in the JAX layout
    (torch_weights.py:346-395): the reference's convs are bias-free (zero
    "b"), BatchNorms give params {g, b} and state {mean, var}, and the fc
    weight is permuted from torch's (c, h, w) flatten to the NHWC (h, w, c)
    one. `load_jax_params(IResNet(cfg), params, state)` loads the result."""
    params, state = {}, {}
    params["conv1"] = _bias_free_conv(sd, "conv1.weight", dtype)
    params["bn1"], state["bn1"] = _bn(sd, "bn1", dtype)
    params["prelu1"] = _arr(sd["prelu.weight"], dtype)
    for li, depth in enumerate(cfg.depths, start=1):
        bp_list, bs_list = [], []
        for bi in range(depth):
            p = f"layer{li}.{bi}"
            bp, bs = {}, {}
            bp["bn1"], bs["bn1"] = _bn(sd, f"{p}.bn1", dtype)
            bp["conv1"] = _bias_free_conv(sd, f"{p}.conv1.weight", dtype)
            bp["bn2"], bs["bn2"] = _bn(sd, f"{p}.bn2", dtype)
            bp["prelu"] = _arr(sd[f"{p}.prelu.weight"], dtype)
            bp["conv2"] = _bias_free_conv(sd, f"{p}.conv2.weight", dtype)
            bp["bn3"], bs["bn3"] = _bn(sd, f"{p}.bn3", dtype)
            if f"{p}.downsample.0.weight" in sd:
                bp["down_conv"] = _bias_free_conv(sd, f"{p}.downsample.0.weight", dtype)
                bp["down_bn"], bs["down_bn"] = _bn(sd, f"{p}.downsample.1", dtype)
            bp_list.append(bp)
            bs_list.append(bs)
        params[f"layer{li}"] = bp_list
        state[f"layer{li}"] = bs_list
    params["bn2"], state["bn2"] = _bn(sd, "bn2", dtype)
    w = np.asarray(sd["fc.weight"])
    nf = w.shape[0]
    side = int(round((w.shape[1] // 512) ** 0.5))
    w = w.reshape(nf, 512, side, side).transpose(0, 2, 3, 1).reshape(nf, -1)
    params["fc"] = {"w": _arr(w, dtype), "b": _arr(sd["fc.bias"], dtype)}
    params["features_bn"], state["features_bn"] = _bn(sd, "features", dtype)
    return params, state


def export_iresnet_state_dict(model) -> Dict[str, np.ndarray]:
    """The port's IResNet → an insightface state dict (the port's addition:
    the inverse of `convert_iresnet_state_dict`, for writing an `arcface.pth`
    from a port model). The convs must be bias-free (all zero), as the
    reference's are; the fc weight goes back to torch's (c, h, w) flatten."""
    from .jax_params import export_jax_params

    params, state = export_jax_params(model)
    sd: Dict[str, np.ndarray] = {}

    def conv(key, p):
        if np.any(p["b"]):
            raise ValueError(f"{key}: the insightface layout has bias-free convs, this one has a bias")
        sd[f"{key}.weight"] = p["w"].transpose(3, 2, 0, 1)

    def bn(key, p, s):
        sd.update({f"{key}.weight": p["g"], f"{key}.bias": p["b"], f"{key}.running_mean": s["mean"],
                   f"{key}.running_var": s["var"]})

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], state["bn1"])
    sd["prelu.weight"] = params["prelu1"]
    for li in range(1, 5):
        for bi, (bp, bs) in enumerate(zip(params[f"layer{li}"], state[f"layer{li}"])):
            p = f"layer{li}.{bi}"
            bn(f"{p}.bn1", bp["bn1"], bs["bn1"])
            conv(f"{p}.conv1", bp["conv1"])
            bn(f"{p}.bn2", bp["bn2"], bs["bn2"])
            sd[f"{p}.prelu.weight"] = bp["prelu"]
            conv(f"{p}.conv2", bp["conv2"])
            bn(f"{p}.bn3", bp["bn3"], bs["bn3"])
            if "down_conv" in bp:
                conv(f"{p}.downsample.0", bp["down_conv"])
                bn(f"{p}.downsample.1", bp["down_bn"], bs["down_bn"])
    bn("bn2", params["bn2"], state["bn2"])
    w = params["fc"]["w"]
    nf = w.shape[0]
    side = int(round((w.shape[1] // 512) ** 0.5))
    sd["fc.weight"] = w.reshape(nf, side, side, 512).transpose(0, 3, 1, 2).reshape(nf, -1)
    sd["fc.bias"] = params["fc"]["b"]
    bn("features", params["features_bn"], state["features_bn"])
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _resblock(sd, p, dtype, temb=True):
    out = {
        "norm1": _norm(sd, f"{p}.norm1", dtype),
        "conv1": _conv(sd, f"{p}.conv1", dtype),
        "norm2": _norm(sd, f"{p}.norm2", dtype),
        "conv2": _conv(sd, f"{p}.conv2", dtype),
    }
    if temb:
        out["time_emb_proj"] = _dense(sd, f"{p}.time_emb_proj", dtype)
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut", dtype)
    return out


def _attn(sd, p, dtype):
    return {
        "q": _dense(sd, f"{p}.to_q", dtype, bias=False),
        "k": _dense(sd, f"{p}.to_k", dtype, bias=False),
        "v": _dense(sd, f"{p}.to_v", dtype, bias=False),
        "out": _dense(sd, f"{p}.to_out.0", dtype),
    }


def _transformer(sd, p, dtype, n_blocks=1):
    blocks = []
    for i in range(n_blocks):
        b = f"{p}.transformer_blocks.{i}"
        blocks.append({
            "ln1": _norm(sd, f"{b}.norm1", dtype),
            "attn1": _attn(sd, f"{b}.attn1", dtype),
            "ln2": _norm(sd, f"{b}.norm2", dtype),
            "attn2": _attn(sd, f"{b}.attn2", dtype),
            "ln3": _norm(sd, f"{b}.norm3", dtype),
            "ff_in": _dense(sd, f"{b}.ff.net.0.proj", dtype),
            "ff_out": _dense(sd, f"{b}.ff.net.2", dtype),
        })
    return {
        "norm": _norm(sd, f"{p}.norm", dtype),
        "proj_in": _dense(sd, f"{p}.proj_in", dtype),
        "proj_out": _dense(sd, f"{p}.proj_out", dtype),
        "blocks": blocks,
    }


def convert_unet_state_dict(sd: Dict[str, np.ndarray], cfg: unet2d.UNetConfig = unet2d.SD21_UNET_CONFIG,
                            dtype=np.float32):
    params = {
        "conv_in": _conv(sd, "conv_in", dtype),
        "time_embedding": {
            "linear_1": _dense(sd, "time_embedding.linear_1", dtype),
            "linear_2": _dense(sd, "time_embedding.linear_2", dtype),
        },
        "down_blocks": [],
        "up_blocks": [],
        "conv_norm_out": _norm(sd, "conv_norm_out", dtype),
        "conv_out": _conv(sd, "conv_out", dtype),
    }
    n_levels = len(cfg.block_out_channels)
    for i in range(n_levels):
        p = f"down_blocks.{i}"
        params["down_blocks"].append({
            "resnets": [_resblock(sd, f"{p}.resnets.{j}", dtype) for j in range(cfg.layers_per_block)],
            "attentions": (
                [_transformer(sd, f"{p}.attentions.{j}", dtype, cfg.transformer_layers)
                 for j in range(cfg.layers_per_block)]
                if cfg.down_block_has_attn[i] else None
            ),
            "downsample": (_conv(sd, f"{p}.downsamplers.0.conv", dtype)
                           if f"{p}.downsamplers.0.conv.weight" in sd else None),
        })
    params["mid_block"] = {
        "resnets": [_resblock(sd, "mid_block.resnets.0", dtype), _resblock(sd, "mid_block.resnets.1", dtype)],
        "attentions": [_transformer(sd, "mid_block.attentions.0", dtype, cfg.transformer_layers)],
    }
    has_attn_rev = list(reversed(cfg.down_block_has_attn))
    for i in range(n_levels):
        p = f"up_blocks.{i}"
        params["up_blocks"].append({
            "resnets": [_resblock(sd, f"{p}.resnets.{j}", dtype) for j in range(cfg.layers_per_block + 1)],
            "attentions": (
                [_transformer(sd, f"{p}.attentions.{j}", dtype, cfg.transformer_layers)
                 for j in range(cfg.layers_per_block + 1)]
                if has_attn_rev[i] else None
            ),
            "upsample": (_conv(sd, f"{p}.upsamplers.0.conv", dtype)
                         if f"{p}.upsamplers.0.conv.weight" in sd else None),
        })
    return params


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _vae_attn(sd, p, dtype):
    """Both diffusers VAE attention key layouts: to_q/to_out.0 and the
    legacy query/key/value/proj_attn."""
    if f"{p}.to_q.weight" in sd:
        names = {"q": "to_q", "k": "to_k", "v": "to_v", "out": "to_out.0"}
    else:
        names = {"q": "query", "k": "key", "v": "value", "out": "proj_attn"}
    return {
        "norm": _norm(sd, f"{p}.group_norm", dtype),
        **{k: _dense(sd, f"{p}.{names[k]}", dtype) for k in ("q", "k", "v", "out")},
    }


def _vae_mid(sd, p, dtype):
    return {
        "res1": _resblock(sd, f"{p}.resnets.0", dtype, temb=False),
        "attn": _vae_attn(sd, f"{p}.attentions.0", dtype),
        "res2": _resblock(sd, f"{p}.resnets.1", dtype, temb=False),
    }


def convert_vae_state_dict(sd: Dict[str, np.ndarray], cfg: vae.VAEConfig = vae.SD_VAE_CONFIG, dtype=np.float32):
    n = len(cfg.block_out_channels)
    enc = {
        "conv_in": _conv(sd, "encoder.conv_in", dtype),
        "down_blocks": [],
        "mid": _vae_mid(sd, "encoder.mid_block", dtype),
        "norm_out": _norm(sd, "encoder.conv_norm_out", dtype),
        "conv_out": _conv(sd, "encoder.conv_out", dtype),
    }
    for i in range(n):
        p = f"encoder.down_blocks.{i}"
        enc["down_blocks"].append({
            "resnets": [_resblock(sd, f"{p}.resnets.{j}", dtype, temb=False) for j in range(cfg.layers_per_block)],
            "downsample": (_conv(sd, f"{p}.downsamplers.0.conv", dtype)
                           if f"{p}.downsamplers.0.conv.weight" in sd else None),
        })
    dec = {
        "conv_in": _conv(sd, "decoder.conv_in", dtype),
        "mid": _vae_mid(sd, "decoder.mid_block", dtype),
        "up_blocks": [],
        "norm_out": _norm(sd, "decoder.conv_norm_out", dtype),
        "conv_out": _conv(sd, "decoder.conv_out", dtype),
    }
    for i in range(n):
        p = f"decoder.up_blocks.{i}"
        dec["up_blocks"].append({
            "resnets": [_resblock(sd, f"{p}.resnets.{j}", dtype, temb=False)
                        for j in range(cfg.layers_per_block + 1)],
            "upsample": (_conv(sd, f"{p}.upsamplers.0.conv", dtype)
                         if f"{p}.upsamplers.0.conv.weight" in sd else None),
        })
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv(sd, "quant_conv", dtype),
        "post_quant_conv": _conv(sd, "post_quant_conv", dtype),
    }


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------


def convert_clip_text_state_dict(sd: Dict[str, np.ndarray],
                                 cfg: clip_text.CLIPTextConfig = clip_text.SD21_TEXT_CONFIG, dtype=np.float32):
    """Keys with the `text_model.` prefix (transformers' CLIPTextModel) or without it."""
    pre = "text_model." if "text_model.embeddings.token_embedding.weight" in sd else ""
    params = {
        "token_embedding": _arr(sd[f"{pre}embeddings.token_embedding.weight"], dtype),
        "position_embedding": _arr(sd[f"{pre}embeddings.position_embedding.weight"], dtype),
        "final_ln": _norm(sd, f"{pre}final_layer_norm", dtype),
        "layers": [],
    }
    for i in range(cfg.num_layers):
        p = f"{pre}encoder.layers.{i}"
        params["layers"].append({
            "ln1": _norm(sd, f"{p}.layer_norm1", dtype),
            "q": _dense(sd, f"{p}.self_attn.q_proj", dtype),
            "k": _dense(sd, f"{p}.self_attn.k_proj", dtype),
            "v": _dense(sd, f"{p}.self_attn.v_proj", dtype),
            "out": _dense(sd, f"{p}.self_attn.out_proj", dtype),
            "ln2": _norm(sd, f"{p}.layer_norm2", dtype),
            "fc1": _dense(sd, f"{p}.mlp.fc1", dtype),
            "fc2": _dense(sd, f"{p}.mlp.fc2", dtype),
        })
    return params


# ---------------------------------------------------------------------------
# Top-level SD2.1 loader
# ---------------------------------------------------------------------------


def configs_from_model_dir(model_dir: str):
    """The port's (text, unet, vae) configs from the diffusers config.json
    files of a local SD model directory, falling back to the SD2.1 defaults
    for missing files or keys. diffusers' `attention_head_dim` for SD2.x is
    the per-level head COUNT list ([5, 10, 20, 20]): the head dim is
    channels / heads = 64."""

    def read(sub):
        p = os.path.join(model_dir, sub, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    u = read("unet")
    C = tuple(u.get("block_out_channels", unet2d.SD21_UNET_CONFIG.block_out_channels))
    ahd = u.get("attention_head_dim", None)
    if ahd is None:
        head_dim = unet2d.SD21_UNET_CONFIG.head_dim
    else:
        heads0 = ahd[0] if isinstance(ahd, (list, tuple)) else ahd
        head_dim = C[0] // heads0
    down_types = u.get("down_block_types")
    has_attn = (tuple("CrossAttn" in t for t in down_types) if down_types
                else unet2d.SD21_UNET_CONFIG.down_block_has_attn)
    unet_cfg = unet2d.UNetConfig(
        in_channels=u.get("in_channels", 4),
        out_channels=u.get("out_channels", 4),
        block_out_channels=C,
        layers_per_block=u.get("layers_per_block", 2),
        cross_attention_dim=u.get("cross_attention_dim", 1024),
        head_dim=head_dim,
        norm_groups=u.get("norm_num_groups", 32),
        down_block_has_attn=has_attn,
        freq_shift=u.get("freq_shift", 0),
        flip_sin_to_cos=u.get("flip_sin_to_cos", True),
    )

    v = read("vae")
    vae_cfg = vae.VAEConfig(
        in_channels=v.get("in_channels", 3),
        latent_channels=v.get("latent_channels", 4),
        block_out_channels=tuple(v.get("block_out_channels", vae.SD_VAE_CONFIG.block_out_channels)),
        layers_per_block=v.get("layers_per_block", 2),
        scaling_factor=v.get("scaling_factor", 0.18215),
    )

    t = read("text_encoder")
    d = clip_text.SD21_TEXT_CONFIG
    text_cfg = clip_text.CLIPTextConfig(
        vocab_size=t.get("vocab_size", d.vocab_size),
        hidden_size=t.get("hidden_size", d.hidden_size),
        num_layers=t.get("num_hidden_layers", d.num_layers),
        num_heads=t.get("num_attention_heads", d.num_heads),
        intermediate_size=t.get("intermediate_size", d.intermediate_size),
        max_positions=t.get("max_position_embeddings", 77),
        hidden_act=t.get("hidden_act", d.hidden_act),
    )
    return text_cfg, unet_cfg, vae_cfg


WEIGHT_NAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                "diffusion_pytorch_model.bin", "pytorch_model.bin")


def find_weights(model_dir: str, sub: str) -> str:
    """The first of `WEIGHT_NAMES` under `model_dir/sub`."""
    d = os.path.join(model_dir, sub)
    for name in WEIGHT_NAMES:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weights found under {d}")


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    return load_numpy(path) if path.endswith(".safetensors") else load_torch_pth(path)


def load_sd21_params(model_dir: str, dtype=np.float32) -> dict:
    """A local diffusers-format SD2.1 directory → {"text_encoder", "unet",
    "vae"} trees in the JAX layout (`StableDiffusionPipeline.from_pretrained`,
    `inference_ID-Booth.py:103`)."""
    text_cfg, unet_cfg, vae_cfg = configs_from_model_dir(model_dir)
    return {
        "text_encoder": convert_clip_text_state_dict(load_state_dict(find_weights(model_dir, "text_encoder")),
                                                     text_cfg, dtype=dtype),
        "unet": convert_unet_state_dict(load_state_dict(find_weights(model_dir, "unet")), unet_cfg, dtype=dtype),
        "vae": convert_vae_state_dict(load_state_dict(find_weights(model_dir, "vae")), vae_cfg, dtype=dtype),
    }


# ---------------------------------------------------------------------------
# dgm-eval encoders
# ---------------------------------------------------------------------------


def convert_dinov2_state_dict(sd: Dict[str, np.ndarray], cfg=None, dtype=np.float32):
    """DINOv2 ViT weights → `models/dinov2.py` pytree.

    Accepts both the `transformers.Dinov2Model` layout
    (embeddings.patch_embeddings.projection / encoder.layer.{i}.attention.
    attention.{query,key,value} / layer_scale{1,2}.lambda1 / layernorm) and
    the facebookresearch/dinov2 hub layout (patch_embed.proj /
    blocks.{i}.attn.qkv fused / ls{1,2}.gamma / norm) — the reference loads
    the hub checkpoint (`dgm_eval/models/dinov2.py:43`)."""
    hub = "cls_token" in sd  # hub layout has top-level cls_token/pos_embed

    def arr(k):
        return np.asarray(sd[k])

    if hub:
        patch_w, patch_b = arr("patch_embed.proj.weight"), arr("patch_embed.proj.bias")
        cls_token, pos = arr("cls_token"), arr("pos_embed")
        fin_g, fin_b = arr("norm.weight"), arr("norm.bias")
        n_layers = max(int(m.group(1)) for m in
                       (re.match(r"blocks\.(\d+)\.", k) for k in sd) if m) + 1
    else:
        patch_w = arr("embeddings.patch_embeddings.projection.weight")
        patch_b = arr("embeddings.patch_embeddings.projection.bias")
        cls_token, pos = arr("embeddings.cls_token"), arr("embeddings.position_embeddings")
        fin_g, fin_b = arr("layernorm.weight"), arr("layernorm.bias")
        n_layers = max(int(m.group(1)) for m in
                       (re.match(r"encoder\.layer\.(\d+)\.", k) for k in sd) if m) + 1

    layers = []
    for i in range(n_layers):
        if hub:
            p = f"blocks.{i}"
            qkv_w, qkv_b = arr(f"{p}.attn.qkv.weight"), arr(f"{p}.attn.qkv.bias")
            d = qkv_w.shape[0] // 3
            qw, kw, vw = qkv_w[:d], qkv_w[d : 2 * d], qkv_w[2 * d :]
            qb, kb, vb = qkv_b[:d], qkv_b[d : 2 * d], qkv_b[2 * d :]
            ow, ob = arr(f"{p}.attn.proj.weight"), arr(f"{p}.attn.proj.bias")
            # LayerScale absent in plain timm ViTs (MAE) — hub layout only
            has_ls = f"{p}.ls1.gamma" in sd
            ls1 = arr(f"{p}.ls1.gamma") if has_ls else None
            ls2 = arr(f"{p}.ls2.gamma") if has_ls else None
            n1, n2 = f"{p}.norm1", f"{p}.norm2"
            f1, f2 = f"{p}.mlp.fc1", f"{p}.mlp.fc2"
        else:
            p = f"encoder.layer.{i}"
            a = f"{p}.attention.attention"
            qw, qb = arr(f"{a}.query.weight"), arr(f"{a}.query.bias")
            kw, kb = arr(f"{a}.key.weight"), arr(f"{a}.key.bias")
            vw, vb = arr(f"{a}.value.weight"), arr(f"{a}.value.bias")
            ow, ob = arr(f"{p}.attention.output.dense.weight"), arr(f"{p}.attention.output.dense.bias")
            ls1, ls2 = arr(f"{p}.layer_scale1.lambda1"), arr(f"{p}.layer_scale2.lambda1")
            n1, n2 = f"{p}.norm1", f"{p}.norm2"
            f1, f2 = f"{p}.mlp.fc1", f"{p}.mlp.fc2"
        layer = {
            "norm1": _norm(sd, n1, dtype),
            "q": {"w": _arr(qw, dtype), "b": _arr(qb, dtype)},
            "k": {"w": _arr(kw, dtype), "b": _arr(kb, dtype)},
            "v": {"w": _arr(vw, dtype), "b": _arr(vb, dtype)},
            "out": {"w": _arr(ow, dtype), "b": _arr(ob, dtype)},
            "norm2": _norm(sd, n2, dtype),
            "fc1": _dense(sd, f1, dtype),
            "fc2": _dense(sd, f2, dtype),
        }
        if ls1 is not None:
            layer["ls1"] = _arr(ls1, dtype)
            layer["ls2"] = _arr(ls2, dtype)
        layers.append(layer)
    return {
        "patch_embed": {
            "w": _arr(patch_w.transpose(2, 3, 1, 0), dtype),  # OIHW→HWIO
            "b": _arr(patch_b, dtype),
        },
        "cls_token": _arr(cls_token.reshape(1, 1, -1), dtype),
        "pos_embed": _arr(pos, dtype),
        "layers": layers,
        "final_norm": {"g": _arr(fin_g, dtype), "b": _arr(fin_b, dtype)},
    }



def convert_inception_state_dict(sd: Dict[str, np.ndarray], dtype=np.float32):
    """pytorch-fid / torchvision InceptionV3 state dict →
    `models/inception_v3.py` pytree. Each BasicConv2d unit becomes
    {w (HWIO), g, b, mean, var}; the classifier fc (absent from the feature
    path) is ignored."""
    units: Dict[str, dict] = {}
    for k, v in sd.items():
        if not (k.endswith(".conv.weight") or ".bn." in k):
            continue
        prefix = k.rsplit(".conv.weight", 1)[0] if k.endswith(".conv.weight") else k.split(".bn.")[0]
        u = units.setdefault(prefix, {})
        arr = np.asarray(v)
        if k.endswith(".conv.weight"):
            u["w"] = _arr(arr.transpose(2, 3, 1, 0), dtype)
        elif k.endswith(".bn.weight"):
            u["g"] = _arr(arr, dtype)
        elif k.endswith(".bn.bias"):
            u["b"] = _arr(arr, dtype)
        elif k.endswith(".bn.running_mean"):
            u["mean"] = _arr(arr, dtype)
        elif k.endswith(".bn.running_var"):
            u["var"] = _arr(arr, dtype)

    params: Dict = {}
    for prefix, u in units.items():
        parts = prefix.split(".")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = u
    return params


def convert_clip_vision_state_dict(sd: Dict[str, np.ndarray], cfg=None, dtype=np.float32):
    """`transformers.CLIPVisionModel` state dict → `models/clip_vision.py`
    pytree (accepts keys with or without the `vision_model.` prefix; the HF
    pre-layernorm key is spelled `pre_layrnorm`)."""
    pre = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""

    def arr(k):
        return np.asarray(sd[pre + k])

    n_layers = 1 + max(
        int(m.group(1))
        for m in (re.match(re.escape(pre) + r"encoder\.layers\.(\d+)\.", k) for k in sd)
        if m
    )
    layers = []
    for i in range(n_layers):
        p = f"encoder.layers.{i}"
        layers.append(
            {
                "ln1": {"g": _arr(arr(f"{p}.layer_norm1.weight"), dtype),
                        "b": _arr(arr(f"{p}.layer_norm1.bias"), dtype)},
                "q": {"w": _arr(arr(f"{p}.self_attn.q_proj.weight"), dtype),
                      "b": _arr(arr(f"{p}.self_attn.q_proj.bias"), dtype)},
                "k": {"w": _arr(arr(f"{p}.self_attn.k_proj.weight"), dtype),
                      "b": _arr(arr(f"{p}.self_attn.k_proj.bias"), dtype)},
                "v": {"w": _arr(arr(f"{p}.self_attn.v_proj.weight"), dtype),
                      "b": _arr(arr(f"{p}.self_attn.v_proj.bias"), dtype)},
                "out": {"w": _arr(arr(f"{p}.self_attn.out_proj.weight"), dtype),
                        "b": _arr(arr(f"{p}.self_attn.out_proj.bias"), dtype)},
                "ln2": {"g": _arr(arr(f"{p}.layer_norm2.weight"), dtype),
                        "b": _arr(arr(f"{p}.layer_norm2.bias"), dtype)},
                "fc1": {"w": _arr(arr(f"{p}.mlp.fc1.weight"), dtype),
                        "b": _arr(arr(f"{p}.mlp.fc1.bias"), dtype)},
                "fc2": {"w": _arr(arr(f"{p}.mlp.fc2.weight"), dtype),
                        "b": _arr(arr(f"{p}.mlp.fc2.bias"), dtype)},
            }
        )
    return {
        "patch_embed": _arr(
            arr("embeddings.patch_embedding.weight").transpose(2, 3, 1, 0), dtype
        ),
        "class_embedding": _arr(arr("embeddings.class_embedding"), dtype),
        "pos_embed": _arr(arr("embeddings.position_embedding.weight"), dtype),
        "pre_ln": {"g": _arr(arr("pre_layrnorm.weight"), dtype),
                   "b": _arr(arr("pre_layrnorm.bias"), dtype)},
        "layers": layers,
        "post_ln": {"g": _arr(arr("post_layernorm.weight"), dtype),
                    "b": _arr(arr("post_layernorm.bias"), dtype)},
    }


def convert_resnet50_state_dict(sd: Dict[str, np.ndarray], dtype=np.float32):
    """torchvision ResNet-50 state dict → `models/resnet50.py` pytree.
    SwAV checkpoints prefix keys with `module.` and carry projection-head
    keys (ignored); the classifier fc is ignored too."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}

    def unit(conv_prefix, bn_prefix):
        return {
            "w": _arr(np.asarray(sd[f"{conv_prefix}.weight"]).transpose(2, 3, 1, 0), dtype),
            "g": _arr(sd[f"{bn_prefix}.weight"], dtype),
            "b": _arr(sd[f"{bn_prefix}.bias"], dtype),
            "mean": _arr(sd[f"{bn_prefix}.running_mean"], dtype),
            "var": _arr(sd[f"{bn_prefix}.running_var"], dtype),
        }

    params = {"stem": unit("conv1", "bn1")}
    for li, n in enumerate((3, 4, 6, 3)):
        blocks = []
        for bi in range(n):
            p = f"layer{li + 1}.{bi}"
            block = {
                "conv1": unit(f"{p}.conv1", f"{p}.bn1"),
                "conv2": unit(f"{p}.conv2", f"{p}.bn2"),
                "conv3": unit(f"{p}.conv3", f"{p}.bn3"),
            }
            if f"{p}.downsample.0.weight" in sd:
                block["downsample"] = unit(f"{p}.downsample.0", f"{p}.downsample.1")
            blocks.append(block)
        params[f"layer{li + 1}"] = blocks
    return params


def convert_convnext_state_dict(sd: Dict[str, np.ndarray], cfg=None, dtype=np.float32):
    """timm ConvNeXt state dict → `models/convnext.py` pytree (accepts the
    modern timm naming conv_dw/mlp.fc{1,2} and the original facebook naming
    dwconv/pwconv{1,2}/downsample_layers)."""
    cfg = cfg or convnext.CONVNEXT_LARGE

    def has(k):
        return k in sd

    def conv(prefix):
        return {
            "w": _arr(np.asarray(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0), dtype),
            "b": _arr(sd[f"{prefix}.bias"], dtype),
        }

    def dense(prefix):
        return {
            "w": _arr(sd[f"{prefix}.weight"], dtype),
            "b": _arr(sd[f"{prefix}.bias"], dtype),
        }

    def ln(prefix):
        return {
            "g": _arr(sd[f"{prefix}.weight"], dtype),
            "b": _arr(sd[f"{prefix}.bias"], dtype),
        }

    timm_layout = any(k.startswith("stem.0") for k in sd)
    if timm_layout:
        params = {"stem_conv": conv("stem.0"), "stem_norm": ln("stem.1")}
        for s, depth in enumerate(cfg.depths):
            if s > 0:
                params[f"stage{s}_downsample"] = {
                    "norm": ln(f"stages.{s}.downsample.0"),
                    "conv": conv(f"stages.{s}.downsample.1"),
                }
            blocks = []
            for b in range(depth):
                p = f"stages.{s}.blocks.{b}"
                dw = f"{p}.conv_dw" if has(f"{p}.conv_dw.weight") else f"{p}.dwconv"
                fc1 = f"{p}.mlp.fc1" if has(f"{p}.mlp.fc1.weight") else f"{p}.pwconv1"
                fc2 = f"{p}.mlp.fc2" if has(f"{p}.mlp.fc2.weight") else f"{p}.pwconv2"
                block = {
                    "conv_dw": conv(dw),
                    "norm": ln(f"{p}.norm"),
                    "fc1": dense(fc1),
                    "fc2": dense(fc2),
                }
                if has(f"{p}.gamma"):
                    block["gamma"] = _arr(sd[f"{p}.gamma"], dtype)
                blocks.append(block)
            params[f"stage{s}_blocks"] = blocks
        head = "head.norm" if has("head.norm.weight") else "norm"
        params["head_norm"] = ln(head)
        return params

    # facebook research layout
    params = {"stem_conv": conv("downsample_layers.0.0"), "stem_norm": ln("downsample_layers.0.1")}
    for s, depth in enumerate(cfg.depths):
        if s > 0:
            params[f"stage{s}_downsample"] = {
                "norm": ln(f"downsample_layers.{s}.0"),
                "conv": conv(f"downsample_layers.{s}.1"),
            }
        blocks = []
        for b in range(depth):
            p = f"stages.{s}.{b}"
            block = {
                "conv_dw": conv(f"{p}.dwconv"),
                "norm": ln(f"{p}.norm"),
                "fc1": dense(f"{p}.pwconv1"),
                "fc2": dense(f"{p}.pwconv2"),
            }
            if has(f"{p}.gamma"):
                block["gamma"] = _arr(sd[f"{p}.gamma"], dtype)
            blocks.append(block)
        params[f"stage{s}_blocks"] = blocks
    params["head_norm"] = ln("norm")
    return params


def convert_data2vec_state_dict(sd: Dict[str, np.ndarray], cfg=None, dtype=np.float32):
    """`transformers.Data2VecVisionModel` state dict →
    `models/data2vec_vision.py` pytree (BEiT layout: encoder.layer.{i}.
    attention.attention.{query,key,value} + relative_position_bias table,
    lambda_1/lambda_2 LayerScale, pooler.layernorm)."""

    def arr(k):
        return np.asarray(sd[k])

    n_layers = 1 + max(
        int(m.group(1))
        for m in (re.match(r"encoder\.layer\.(\d+)\.", k) for k in sd)
        if m
    )
    layers = []
    for i in range(n_layers):
        p = f"encoder.layer.{i}"
        a = f"{p}.attention.attention"
        layers.append(
            {
                "norm1": _norm(sd, f"{p}.layernorm_before", dtype),
                "q": {"w": _arr(arr(f"{a}.query.weight"), dtype),
                      "b": _arr(arr(f"{a}.query.bias"), dtype)},
                "k": {"w": _arr(arr(f"{a}.key.weight"), dtype)},
                "v": {"w": _arr(arr(f"{a}.value.weight"), dtype),
                      "b": _arr(arr(f"{a}.value.bias"), dtype)},
                "out": {"w": _arr(arr(f"{p}.attention.output.dense.weight"), dtype),
                        "b": _arr(arr(f"{p}.attention.output.dense.bias"), dtype)},
                "rel_bias": _arr(
                    arr(f"{a}.relative_position_bias.relative_position_bias_table"), dtype
                ),
                "ls1": _arr(arr(f"{p}.lambda_1"), dtype),
                "norm2": _norm(sd, f"{p}.layernorm_after", dtype),
                "fc1": _dense(sd, f"{p}.intermediate.dense", dtype),
                "fc2": _dense(sd, f"{p}.output.dense", dtype),
                "ls2": _arr(arr(f"{p}.lambda_2"), dtype),
            }
        )
    return {
        "patch_embed": {
            "w": _arr(
                arr("embeddings.patch_embeddings.projection.weight").transpose(2, 3, 1, 0), dtype
            ),
            "b": _arr(arr("embeddings.patch_embeddings.projection.bias"), dtype),
        },
        "cls_token": _arr(arr("embeddings.cls_token"), dtype),
        "layers": layers,
        "pooler_norm": _norm(sd, "pooler.layernorm", dtype),
    }


def convert_simclr_state_dict(sd: Dict[str, np.ndarray], dtype=np.float32):
    """SimCLRv2-Pytorch checkpoint (the 'resnet' entry) →
    `models/simclr_resnet.py` pytree. Key layout: net.0.{0,2,4} stem convs
    with BatchNormRelu at odd indices; net.{1..4}.blocks.{i} with
    projection.shortcut.2 / net.{0..4} (conv1, bn1, SK, conv3, bn3)."""
    if "resnet" in sd and isinstance(sd["resnet"], dict):
        sd = sd["resnet"]

    def cw(prefix):  # conv weight OIHW→HWIO
        return _arr(np.asarray(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0), dtype)

    def bn(prefix):
        return {
            "g": _arr(sd[f"{prefix}.weight"], dtype),
            "b": _arr(sd[f"{prefix}.bias"], dtype),
            "mean": _arr(sd[f"{prefix}.running_mean"], dtype),
            "var": _arr(sd[f"{prefix}.running_var"], dtype),
        }

    params = {
        "stem": {
            "conv1_w": cw("net.0.0"), "bn1": bn("net.0.1.0"),
            "conv2_w": cw("net.0.2"), "bn2": bn("net.0.3.0"),
            "conv3_w": cw("net.0.4"), "bn3": bn("net.0.5.0"),
        },
        "stages": [],
    }
    for s, n in enumerate((3, 4, 6, 3)):
        blocks = []
        for b in range(n):
            p = f"net.{s + 1}.blocks.{b}"
            block = {
                "conv1_w": cw(f"{p}.net.0"),
                "bn1": bn(f"{p}.net.1.0"),
                "sk": {
                    "main_w": cw(f"{p}.net.2.main_conv.0"),
                    "main_bn": bn(f"{p}.net.2.main_conv.1.0"),
                    "mix1_w": cw(f"{p}.net.2.mixing_conv.0"),
                    "mix1_bn": bn(f"{p}.net.2.mixing_conv.1.0"),
                    "mix2_w": cw(f"{p}.net.2.mixing_conv.2"),
                },
                "conv3_w": cw(f"{p}.net.3"),
                "bn3": bn(f"{p}.net.4.0"),
            }
            if f"{p}.projection.shortcut.2.weight" in sd:
                block["proj"] = {
                    "conv_w": cw(f"{p}.projection.shortcut.2"),
                    "bn": bn(f"{p}.projection.bn.0"),
                }
            blocks.append(block)
        params["stages"].append(blocks)
    return params
