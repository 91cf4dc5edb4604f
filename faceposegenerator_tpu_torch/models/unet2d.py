"""SD2.1 UNet2DCondition (port of `faceposegenerator_tpu/models/unet2d.py`).

NHWC at the boundary, as in the JAX package; each conv sees the
channels_last NCHW view of its NHWC input. The module tree follows the JAX
param tree key for key (`init`, unet2d.py:178), so `bridge.jax_params`
loads a JAX tree by walking it, and `init_lora` returns the layout of JAX
`init_lora` (unet2d.py:244-272). Every attention goes through
`ops.attention.dot_product_attention`: kernel K1 on the card (K8 under
`attn_impl="flash_int8"`), and K5 for its backward when a gradient is taken
through the LoRA. After `ops.quant.quantize_unet` every dense layer but the
time path runs kernel K7 and every conv but conv_in/conv_out runs
`qconv2d`. `forward_cached` is the DeepCache forward; `tome_ratio` turns on ToMe
(`ops/tome.py`) in both. Under
GN_CONV_IMPL=pallas each resblock's `conv(silu(gn(x)))` that K4 takes runs
kernel K4, and under GN_IMPL=pallas every GroupNorm that K3 takes runs
kernel K3 (`ops.norms`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY, Policy
from ..ops import fused_gn_conv, tome
from ..ops.attention import dot_product_attention
from ..ops.lora import add_delta, lora_delta, lora_dense
from ..ops.norms import group_norm, layer_norm
from ..ops.quant import is_quantized, qdense_fused
from .layers import Affine, conv2d, materialize


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    head_dim: int = 64
    norm_groups: int = 32
    down_block_has_attn: Sequence[bool] = (True, True, True, False)
    transformer_layers: int = 1
    freq_shift: int = 0
    flip_sin_to_cos: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD21_UNET_CONFIG = UNetConfig()


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, freq_shift: float,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features, diffusers `Timesteps` semantics (unet2d.py:88-95)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour ×2 (`jnp.repeat` on H then W)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def _gn_silu_conv(x: torch.Tensor, norm: Affine, conv: nn.Conv2d, num_groups: int) -> torch.Tensor:
    """conv3x3(silu(gn(x))) with the resblocks' GN eps 1e-5 (unet2d.py:280-298):
    with GN_CONV_IMPL=pallas, an unquantized 3×3 conv on a shape that
    `fused_gn_conv.supported` accepts goes to K4 (the kernel on the card,
    its plain version on the CPU); everything else to `group_norm` (which
    may route to K3) and the conv."""
    if fused_gn_conv.gn_conv_impl() == "pallas" and not is_quantized(conv.weight) and conv.kernel_size == (3, 3):
        n, h, w, cin = x.shape
        if fused_gn_conv.supported(n, h, w, cin, conv.out_channels, num_groups):
            return fused_gn_conv.gn_silu_conv3x3(x, norm.weight, norm.bias, conv, num_groups, 1e-5)
    return conv2d(group_norm(x, norm.weight, norm.bias, num_groups, 1e-5, "silu"), conv)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int):
        super().__init__()
        self.norm1 = Affine(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = Affine(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb, num_groups: int):
        h = _gn_silu_conv(x, self.norm1, self.conv1, num_groups)
        t = lora_dense(F.silu(temb), self.time_emb_proj.weight, self.time_emb_proj.bias)
        h = h + t[:, None, None, :].to(h.dtype)
        h = _gn_silu_conv(h, self.norm2, self.conv2, num_groups)
        if self.conv_shortcut is not None:
            x = conv2d(x, self.conv_shortcut, padding=0)
        return x + h


class Attention(nn.Module):
    # `parallel.tp.TPSlice` when this rank holds a slice of the heads
    # (`parallel.tp.shard_unet_params_tp`): q/k/v hold its out-rows, `out` its
    # in-columns, and `out`'s partial sums are reduced over "model"
    tp = None

    def __init__(self, dim: int, ctx_dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim, bias=False)
        self.k = nn.Linear(ctx_dim, dim, bias=False)
        self.v = nn.Linear(ctx_dim, dim, bias=False)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, ctx, head_dim: int, lora=None, lora_scale: float = 1.0,
                attn_impl: str = "auto", kv_len: Optional[int] = None):
        """x: (B, S, C) queries; ctx: (B, Skv, Cctx). Self-attention (ctx is
        x) runs the q/k/v projections as one GEMM (unet2d.py:331-355), one
        `qdense_fused` when the layers are quantized; the q/k/v views of its
        output go to the kernel without a copy."""
        b, s, c = x.shape
        tp, self_attn = self.tp, ctx is x
        inner = c if tp is None else tp.width
        nh = inner // head_dim
        if tp is not None:
            x = tp.enter(x)
            ctx = x if self_attn else tp.enter(ctx)

        def pair(name):
            la = None if lora is None else lora.get(name)
            if la is None:
                return None, None
            return (la["a"], la["b"]) if tp is None else tp.lora(name, la["a"], la["b"])

        def proj(name, inp):
            layer = getattr(self, name)
            a, bb = pair(name)
            if tp is not None and name == "out":  # partial sums: the bias after the reduce
                return tp.leave(lora_dense(inp, layer.weight, None, lora_a=a, lora_b=bb, scale=lora_scale),
                                layer.bias)
            return lora_dense(inp, layer.weight, layer.bias, lora_a=a, lora_b=bb, scale=lora_scale)

        if self_attn:
            ws = [self.q.weight, self.k.weight, self.v.weight]
            if is_quantized(ws[0]):
                qkv = qdense_fused(x, ws)
            else:
                qkv = F.linear(x, torch.cat(ws, dim=0).to(x.dtype))
            qkv = list(qkv.split(inner, dim=-1))
            for i, name in enumerate(("q", "k", "v")):
                a, bb = pair(name)
                if a is None:
                    continue
                # autograd refuses in-place ops on split views; without grad
                # the add is in place and the views stay views of one buffer
                qkv[i] = add_delta(qkv[i], lora_delta(x, a, bb), lora_scale,
                                   inplace=not torch.is_grad_enabled())
            q, k, v = qkv
            skv = s
        else:
            q, k, v = proj("q", x), proj("k", ctx), proj("v", ctx)
            skv = ctx.shape[1]
        q = q.reshape(b, s, nh, head_dim)
        k = k.reshape(b, skv, nh, head_dim)
        v = v.reshape(b, skv, nh, head_dim)
        o = dot_product_attention(q, k, v, impl=attn_impl, kv_len=kv_len).reshape(b, s, inner)
        return proj("out", o)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int):
        super().__init__()
        self.ln1 = Affine(dim)
        self.attn1 = Attention(dim, dim)
        self.ln2 = Affine(dim)
        self.attn2 = Attention(dim, ctx_dim)
        self.ln3 = Affine(dim)
        self.ff_in = nn.Linear(dim, dim * 8)  # GEGLU: 2 × 4·dim
        self.ff_out = nn.Linear(dim * 4, dim)

    # `parallel.tp.TPSlice` when this rank holds a slice of the MLP:
    # ff_in's value and gate rows of its range, ff_out's in-columns
    tp = None

    def feed_forward(self, x):
        """GEGLU MLP: ff_out(value · gelu(gate))."""
        tp = self.tp
        if tp is not None:
            x = tp.enter(x)
        val, gate = lora_dense(x, self.ff_in.weight, self.ff_in.bias).chunk(2, dim=-1)
        if tp is None:
            return lora_dense(val * F.gelu(gate), self.ff_out.weight, self.ff_out.bias)
        return tp.leave(lora_dense(val * F.gelu(gate), self.ff_out.weight), self.ff_out.bias)


class Transformer2D(nn.Module):
    def __init__(self, cfg: UNetConfig, dim: int):
        super().__init__()
        self.norm = Affine(dim)
        self.proj_in = nn.Linear(dim, dim)
        self.proj_out = nn.Linear(dim, dim)
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(dim, cfg.cross_attention_dim) for _ in range(cfg.transformer_layers)
        )

    def forward(self, x, ctx, cfg: UNetConfig, lora=None, lora_scale=1.0, attn_impl="auto", ctx_len=None,
                tome_ratio: float = 0.0, tome_min_tokens: int = 4096, tome_ops: str = "attn"):
        """With `tome_ratio > 0` and at least `tome_min_tokens` tokens, ToMe
        (ops/tome.py) merges tokens before the self-attention and, as
        `tome_ops` names them, the cross-attention ("xattn") and the MLP
        ("mlp"), one match a block from its input (unet2d.py:364-435)."""
        b, hh, ww, c = x.shape
        res = x
        tome_r = tome.merge_count(hh * ww, tome_ratio) if tome_ratio > 0.0 and hh * ww >= tome_min_tokens else 0
        # GN eps 1e-6 in transformers (unet2d.py:381)
        h = group_norm(x, self.norm.weight, self.norm.bias, cfg.norm_groups, 1e-6).reshape(b, hh * ww, c)
        h = lora_dense(h, self.proj_in.weight, self.proj_in.bias)
        for i, blk in enumerate(self.blocks):
            blora = None if lora is None else lora["blocks"][i]
            m = tome.build_match(h, hh, ww, tome_r) if tome_r > 0 else None
            hn = layer_norm(h, blk.ln1.weight, blk.ln1.bias)
            if m is not None:
                hm = tome.merge(hn, m)  # one object: the fused-qkv path
                h = h + tome.unmerge(blk.attn1(hm, hm, cfg.head_dim, None if blora is None else blora["attn1"],
                                               lora_scale, attn_impl), m)
            else:
                h = h + blk.attn1(hn, hn, cfg.head_dim, None if blora is None else blora["attn1"],
                                  lora_scale, attn_impl)
            hn = layer_norm(h, blk.ln2.weight, blk.ln2.bias)
            xm = m is not None and "xattn" in tome_ops
            a2 = blk.attn2(tome.merge(hn, m) if xm else hn, ctx, cfg.head_dim,
                           None if blora is None else blora["attn2"], lora_scale, attn_impl, kv_len=ctx_len)
            h = h + (tome.unmerge(a2, m) if xm else a2)
            hn = layer_norm(h, blk.ln3.weight, blk.ln3.bias)
            mm = m is not None and "mlp" in tome_ops
            ff = blk.feed_forward(tome.merge(hn, m) if mm else hn)
            h = h + (tome.unmerge(ff, m) if mm else ff)
        h = lora_dense(h, self.proj_out.weight, self.proj_out.bias)
        return res + h.reshape(b, hh, ww, c)


class UNetBlock(nn.Module):
    """A down block (`downsample`) or an up block (`upsample`)."""

    def __init__(self, resnets, attentions, resample: Optional[nn.Conv2d], resample_name: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = None if attentions is None else nn.ModuleList(attentions)
        setattr(self, resample_name, resample)


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, c: int, temb: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResBlock(c, c, temb), ResBlock(c, c, temb)])
        self.attentions = nn.ModuleList([Transformer2D(cfg, c)])


class TimeEmbedding(nn.Module):
    def __init__(self, cin: int, temb: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, temb)
        self.linear_2 = nn.Linear(temb, temb)


class UNet2DCondition(nn.Module):
    """ε-prediction UNet; `forward` ports `unet2d.apply` (unet2d.py:448)."""

    def __init__(self, cfg: UNetConfig = SD21_UNET_CONFIG, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        device = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        C = list(cfg.block_out_channels)
        temb = cfg.time_embed_dim
        with torch.device("meta"):
            self.conv_in = nn.Conv2d(cfg.in_channels, C[0], 3)
            self.time_embedding = TimeEmbedding(C[0], temb)
            down, cin = [], C[0]
            for lvl, cout in enumerate(C):
                has_attn = cfg.down_block_has_attn[lvl]
                resnets = [ResBlock(cin if j == 0 else cout, cout, temb) for j in range(cfg.layers_per_block)]
                attns = [Transformer2D(cfg, cout) for _ in resnets] if has_attn else None
                ds = None if lvl == len(C) - 1 else nn.Conv2d(cout, cout, 3)
                down.append(UNetBlock(resnets, attns, ds, "downsample"))
                cin = cout
            self.down_blocks = nn.ModuleList(down)
            self.mid_block = MidBlock(cfg, C[-1], temb)
            rev = list(reversed(C))
            has_attn_rev = list(reversed(cfg.down_block_has_attn))
            up, prev_out = [], C[-1]
            for lvl, cout in enumerate(rev):
                resnets = []
                for j in range(cfg.layers_per_block + 1):
                    res_skip = rev[min(lvl + 1, len(rev) - 1)] if j == cfg.layers_per_block else cout
                    rin = prev_out if j == 0 else cout
                    resnets.append(ResBlock(rin + res_skip, cout, temb))
                attns = [Transformer2D(cfg, cout) for _ in resnets] if has_attn_rev[lvl] else None
                us = None if lvl == len(rev) - 1 else nn.Conv2d(cout, cout, 3)
                up.append(UNetBlock(resnets, attns, us, "upsample"))
                prev_out = cout
            self.up_blocks = nn.ModuleList(up)
            self.conv_norm_out = Affine(C[0])
            self.conv_out = nn.Conv2d(C[0], cfg.out_channels, 3)
        materialize(self, device, dtype, torch.Generator(device=device).manual_seed(seed))

    def forward(self, latents, timesteps, encoder_hidden_states, policy: Policy = DEFAULT_POLICY,
                lora: Optional[dict] = None, lora_scale: float = 1.0, attn_impl: str = "auto",
                ctx_len: Optional[int] = None, remat: bool = False, tome_ratio: float = 0.0,
                tome_min_tokens: int = 4096, tome_ops: str = "attn") -> torch.Tensor:
        """latents (B, H, W, 4) NHWC, timesteps (B,) or a scalar,
        encoder_hidden_states (B, 77, Cctx) → ε̂ (B, H, W, 4) in fp32.
        `remat` (gradient checkpointing) recomputes each down, mid and up
        unit in the backward instead of keeping its activations, the units
        `jax.checkpoint` wraps in the JAX twin (unet2d.py:482-533).
        `tome_ratio > 0` merges tokens in every transformer of at least
        `tome_min_tokens` tokens (`Transformer2D.forward`); 0.0 is exact."""
        return self._run(latents, timesteps, encoder_hidden_states, policy, lora, lora_scale, attn_impl,
                         ctx_len, remat, tome=(tome_ratio, tome_min_tokens, tome_ops))[0]

    def forward_cached(self, latents, timesteps, encoder_hidden_states, policy: Policy = DEFAULT_POLICY,
                       lora: Optional[dict] = None, lora_scale: float = 1.0, attn_impl: str = "auto",
                       ctx_len: Optional[int] = None, depth: int = 1,
                       cached: Optional[torch.Tensor] = None, tome_ratio: float = 0.0,
                       tome_min_tokens: int = 4096, tome_ops: str = "attn"):
        """ε̂ with a DeepCache deep-feature cache (`apply_cached`,
        unet2d.py:559-681); returns (eps, cache). With `cached=None` the full
        network runs and the cache is the feature entering
        `up_blocks[L - depth]`. With `cached` given, only the first `depth`
        down blocks (the last of them without its downsample) and the last
        `depth` up blocks run, and `cached` is spliced in at
        `up_blocks[L - depth]`: on the latent that made the cache this equals
        the full pass bit for bit."""
        L = len(self.down_blocks)
        if not 1 <= depth < L:
            raise ValueError(f"depth must be in [1, {L - 1}], got {depth}")
        return self._run(latents, timesteps, encoder_hidden_states, policy, lora, lora_scale, attn_impl,
                         ctx_len, False, L - depth, cached, tome=(tome_ratio, tome_min_tokens, tome_ops))

    def _run(self, latents, timesteps, encoder_hidden_states, policy, lora, lora_scale, attn_impl, ctx_len,
             remat, splice=None, cached=None, tome=(0.0, 4096, "attn")):
        """The one down/mid/up loop: (ε̂, the feature entering
        up_blocks[splice]). With `cached`, the down blocks below the splice
        and the mid block are skipped and `cached` enters there instead."""
        cfg = self.cfg
        x = latents.to(policy.compute_dtype)
        ctx = encoder_hidden_states.to(policy.compute_dtype)
        t = torch.as_tensor(timesteps, device=x.device)
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        temb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = temb.to(policy.compute_dtype)
        te = self.time_embedding
        temb = lora_dense(temb, te.linear_1.weight, te.linear_1.bias)
        temb = lora_dense(F.silu(temb), te.linear_2.weight, te.linear_2.bias)
        G = cfg.norm_groups
        L = len(self.down_blocks)
        depth = L if cached is None else L - splice

        def unit(fn, *args):
            if remat and torch.is_grad_enabled():
                # no random op inside: nothing to save, and a captured step cannot read the RNG
                return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
            return fn(*args)

        def level_unit(x, rb, tr, tlora):
            h = rb(x, temb, G)
            if tr is not None:
                h = tr(h, ctx, cfg, tlora, lora_scale, attn_impl, ctx_len, *tome)
            return h

        x = conv2d(x, self.conv_in)
        skips = [x]
        for bi, block in enumerate(self.down_blocks[:depth]):
            blora = None if lora is None else lora["down_blocks"][bi]
            for j, rb in enumerate(block.resnets):
                tr = None if block.attentions is None else block.attentions[j]
                tlora = None if blora is None or tr is None else blora["attentions"][j]
                x = unit(level_unit, x, rb, tr, tlora)
                skips.append(x)
            # the last recomputed block's downsample feeds only skipped blocks
            if block.downsample is not None and not (cached is not None and bi == depth - 1):
                x = conv2d(x, block.downsample, stride=2, padding=1)
                skips.append(x)

        if cached is None:
            mid = self.mid_block
            mlora = None if lora is None else lora["mid_block"]["attentions"][0]

            def mid_unit(x):
                h = level_unit(x, mid.resnets[0], mid.attentions[0], mlora)
                return mid.resnets[1](h, temb, G)

            x = unit(mid_unit, x)
        else:
            x = cached.to(x.dtype)

        cache = cached
        for bi, block in enumerate(self.up_blocks):
            if cached is not None and bi < splice:
                continue
            if bi == splice and cached is None:
                cache = x
            blora = None if lora is None else lora["up_blocks"][bi]
            for j, rb in enumerate(block.resnets):
                tr = None if block.attentions is None else block.attentions[j]
                tlora = None if blora is None or tr is None else blora["attentions"][j]

                def up_unit(x, skip, rb=rb, tr=tr, tlora=tlora):
                    # skip concat order [x, skip] (unet2d.py:535)
                    return level_unit(torch.cat([x, skip.to(x.dtype)], dim=-1), rb, tr, tlora)

                x = unit(up_unit, x, skips.pop())
            if block.upsample is not None:
                x = conv2d(upsample_nearest2x(x), block.upsample)

        x = group_norm(x, self.conv_norm_out.weight, self.conv_norm_out.bias, G, 1e-5, "silu")
        return conv2d(x, self.conv_out).float(), cache


def init_lora(unet: UNet2DCondition, rank: int = 4, *, generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32, targets=("q", "k", "v", "out")) -> dict:
    """Gaussian-A / zero-B LoRA pairs for every attention projection, in the
    tree layout of JAX `init_lora` (unet2d.py:244-272): A (r, in) ~ N(0,1)/r,
    B (out, r) = 0. Tensors on the UNet's device."""
    device = unet.conv_in.weight.device

    def attn_lora(attn: Attention):
        out = {}
        for name in targets:
            w = getattr(attn, name).weight
            a = torch.randn(rank, w.shape[1], generator=generator, device=device, dtype=torch.float32) / rank
            out[name] = {"a": a.to(dtype), "b": torch.zeros(w.shape[0], rank, device=device, dtype=dtype)}
        return out

    def block_lora(block):
        if block.attentions is None:
            return {"attentions": None}
        return {"attentions": [
            {"blocks": [{"attn1": attn_lora(b.attn1), "attn2": attn_lora(b.attn2)} for b in tr.blocks]}
            for tr in block.attentions
        ]}

    return {
        "down_blocks": [block_lora(b) for b in unet.down_blocks],
        "mid_block": block_lora(unet.mid_block),
        "up_blocks": [block_lora(b) for b in unet.up_blocks],
    }
