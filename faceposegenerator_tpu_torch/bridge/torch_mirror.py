"""Plain torch mirrors of the reference's layouts (port of
`faceposegenerator_tpu/bridge/torch_mirror.py`): the diffusers
UNet2DConditionModel / AutoencoderKL wiring (`TUNet`, `TVAE`), the eval CNNs
(`TInceptionV3`, `TResNet50`, `TConvNeXt`, `TSimCLRResNet`), the
facenet-pytorch MTCNN nets (`TPNet`, `TRNet`, `TONet`) and, new here, the
CLIP text encoder in Hugging Face's `text_model.*` key layout (`TCLIPText`;
the JAX runbook uses `transformers.CLIPTextModel`, which the card's machine
does not have). Module names are chosen so that `state_dict()` gives the
checkpoints' exact keys: each mirror loads a real checkpoint with
`load_state_dict`, and serves as an oracle that shares no code with the
port's models. That is what `cli parity` holds the port against, step by
step (`bridge/full_chain.py`).

The mirrors are plain torch with an explicit softmax (no fused attention
call), and run on whatever device their parameters are moved to. Their
configs are the port's `models.unet2d.UNetConfig`, `models.vae.VAEConfig`
and `models.clip_text.CLIPTextConfig`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import clip_text, unet2d, vae


class TResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb_dim=None, eps=1e-5, groups=32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class TAttention(nn.Module):
    def __init__(self, dim, ctx_dim, head_dim):
        super().__init__()
        self.heads = dim // head_dim
        self.head_dim = head_dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, s, c = x.shape
        q = self.to_q(x).view(b, s, self.heads, self.head_dim).transpose(1, 2)
        k = self.to_k(ctx).view(b, ctx.shape[1], self.heads, self.head_dim).transpose(1, 2)
        v = self.to_v(ctx).view(b, ctx.shape[1], self.heads, self.head_dim).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(self.head_dim), dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(b, s, c)
        return self.to_out[0](o)


class TGEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class TFeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([TGEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class TBasicTransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, head_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = TAttention(dim, dim, head_dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = TAttention(dim, ctx_dim, head_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = TFeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class TTransformer2D(nn.Module):
    """use_linear_projection=True variant (SD2.1)."""

    def __init__(self, dim, ctx_dim, head_dim, n_blocks=1, groups=32):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [TBasicTransformerBlock(dim, ctx_dim, head_dim) for _ in range(n_blocks)]
        )
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        res = x
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.proj_in(h)
        for blk in self.transformer_blocks:
            h = blk(h, ctx)
        h = self.proj_out(h)
        return res + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class TDownsample(nn.Module):
    def __init__(self, c, asymmetric=False):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0 if asymmetric else 1)
        self.asymmetric = asymmetric

    def forward(self, x):
        if self.asymmetric:  # diffusers VAE Downsample2D pads (0,1,0,1)
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class TUpsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Holder(nn.Module):
    """Bare module used to get dotted names like `downsamplers.0.conv`."""


def _timesteps_embed(t, dim, flip_sin_to_cos=True, freq_shift=0):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TUNet(nn.Module):
    """Mirror of diffusers UNet2DConditionModel for our UNetConfig subset."""

    def __init__(self, cfg: unet2d.UNetConfig):
        super().__init__()
        self.cfg = cfg
        C = list(cfg.block_out_channels)
        temb = cfg.time_embed_dim
        g = cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, C[0], 3, padding=1)
        self.time_embedding = _Holder()
        self.time_embedding.linear_1 = nn.Linear(C[0], temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)

        self.down_blocks = nn.ModuleList()
        cin = C[0]
        for lvl, cout in enumerate(C):
            blk = _Holder()
            blk.resnets = nn.ModuleList(
                [TResnetBlock(cin if j == 0 else cout, cout, temb, groups=g) for j in range(cfg.layers_per_block)]
            )
            if cfg.down_block_has_attn[lvl]:
                blk.attentions = nn.ModuleList(
                    [TTransformer2D(cout, cfg.cross_attention_dim, cfg.head_dim, cfg.transformer_layers, g)
                     for _ in range(cfg.layers_per_block)]
                )
            if lvl < len(C) - 1:
                blk.downsamplers = nn.ModuleList([TDownsample(cout)])
            self.down_blocks.append(blk)
            cin = cout

        self.mid_block = _Holder()
        self.mid_block.resnets = nn.ModuleList(
            [TResnetBlock(C[-1], C[-1], temb, groups=g), TResnetBlock(C[-1], C[-1], temb, groups=g)]
        )
        self.mid_block.attentions = nn.ModuleList(
            [TTransformer2D(C[-1], cfg.cross_attention_dim, cfg.head_dim, cfg.transformer_layers, g)]
        )

        rev = list(reversed(C))
        has_attn_rev = list(reversed(cfg.down_block_has_attn))
        self.up_blocks = nn.ModuleList()
        prev_out = C[-1]
        for lvl, cout in enumerate(rev):
            blk = _Holder()
            blk.resnets = nn.ModuleList()
            for j in range(cfg.layers_per_block + 1):
                res_skip = rev[min(lvl + 1, len(rev) - 1)] if j == cfg.layers_per_block else cout
                rin = prev_out if j == 0 else cout
                blk.resnets.append(TResnetBlock(rin + res_skip, cout, temb, groups=g))
            if has_attn_rev[lvl]:
                blk.attentions = nn.ModuleList(
                    [TTransformer2D(cout, cfg.cross_attention_dim, cfg.head_dim, cfg.transformer_layers, g)
                     for _ in range(cfg.layers_per_block + 1)]
                )
            if lvl < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([TUpsample(cout)])
            self.up_blocks.append(blk)
            prev_out = cout

        self.conv_norm_out = nn.GroupNorm(g, C[0], eps=1e-5)
        self.conv_out = nn.Conv2d(C[0], cfg.out_channels, 3, padding=1)

    def forward(self, latents, t, ctx):
        cfg = self.cfg
        temb = _timesteps_embed(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))
        x = self.conv_in(latents)
        skips = [x]
        for blk in self.down_blocks:
            for j, rp in enumerate(blk.resnets):
                x = rp(x, temb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, ctx)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, ctx)
        x = self.mid_block.resnets[1](x, temb)
        for blk in self.up_blocks:
            for j, rp in enumerate(blk.resnets):
                x = rp(torch.cat([x, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class TVAEAttn(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c), dim=-1)
        o = self.to_out[0](attn @ v)
        return x + o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class TVAE(nn.Module):
    def __init__(self, cfg: vae.VAEConfig):
        super().__init__()
        C = list(cfg.block_out_channels)
        enc = _Holder()
        enc.conv_in = nn.Conv2d(cfg.in_channels, C[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        cin = C[0]
        for lvl, cout in enumerate(C):
            blk = _Holder()
            blk.resnets = nn.ModuleList(
                [TResnetBlock(cin if j == 0 else cout, cout, None, eps=1e-6) for j in range(cfg.layers_per_block)]
            )
            if lvl < len(C) - 1:
                blk.downsamplers = nn.ModuleList([TDownsample(cout, asymmetric=True)])
            enc.down_blocks.append(blk)
            cin = cout
        enc.mid_block = _Holder()
        enc.mid_block.resnets = nn.ModuleList(
            [TResnetBlock(C[-1], C[-1], None, eps=1e-6), TResnetBlock(C[-1], C[-1], None, eps=1e-6)]
        )
        enc.mid_block.attentions = nn.ModuleList([TVAEAttn(C[-1])])
        enc.conv_norm_out = nn.GroupNorm(32, C[-1], eps=1e-6)
        enc.conv_out = nn.Conv2d(C[-1], 2 * cfg.latent_channels, 3, padding=1)
        self.encoder = enc

        rev = list(reversed(C))
        dec = _Holder()
        dec.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        dec.mid_block = _Holder()
        dec.mid_block.resnets = nn.ModuleList(
            [TResnetBlock(rev[0], rev[0], None, eps=1e-6), TResnetBlock(rev[0], rev[0], None, eps=1e-6)]
        )
        dec.mid_block.attentions = nn.ModuleList([TVAEAttn(rev[0])])
        dec.up_blocks = nn.ModuleList()
        cin = rev[0]
        for lvl, cout in enumerate(rev):
            blk = _Holder()
            blk.resnets = nn.ModuleList(
                [TResnetBlock(cin if j == 0 else cout, cout, None, eps=1e-6) for j in range(cfg.layers_per_block + 1)]
            )
            if lvl < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([TUpsample(cout)])
            dec.up_blocks.append(blk)
            cin = cout
        dec.conv_norm_out = nn.GroupNorm(32, C[0], eps=1e-6)
        dec.conv_out = nn.Conv2d(C[0], cfg.in_channels, 3, padding=1)
        self.decoder = dec

        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.cfg = cfg

    def encode_moments(self, images):
        e = self.encoder
        x = e.conv_in(images)
        for blk in e.down_blocks:
            for rp in blk.resnets:
                x = rp(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = e.mid_block.resnets[0](x)
        x = e.mid_block.attentions[0](x)
        x = e.mid_block.resnets[1](x)
        x = e.conv_out(F.silu(e.conv_norm_out(x)))
        x = self.quant_conv(x)
        mean, logvar = x.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, latents):
        d = self.decoder
        x = self.post_quant_conv(latents / self.cfg.scaling_factor)
        x = d.conv_in(x)
        x = d.mid_block.resnets[0](x)
        x = d.mid_block.attentions[0](x)
        x = d.mid_block.resnets[1](x)
        for blk in d.up_blocks:
            for rp in blk.resnets:
                x = rp(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return d.conv_out(F.silu(d.conv_norm_out(x)))




# ---------------------------------------------------------------------------
# FID InceptionV3 mirror (pytorch-fid/torchvision key layout) — oracle for
# models/inception_v3.py and loader for real pt_inception checkpoints
# ---------------------------------------------------------------------------


class TBasicConv2d(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)), inplace=True)


def _avg_excl(x):
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=False)


class TInceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = TBasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = TBasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = TBasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = TBasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = TBasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = TBasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = TBasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x):
        return torch.cat(
            [
                self.branch1x1(x),
                self.branch5x5_2(self.branch5x5_1(x)),
                self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
                self.branch_pool(_avg_excl(x)),
            ],
            1,
        )


class TInceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = TBasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = TBasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = TBasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = TBasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat(
            [
                self.branch3x3(x),
                self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
                F.max_pool2d(x, kernel_size=3, stride=2),
            ],
            1,
        )


class TInceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = TBasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = TBasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = TBasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = TBasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = TBasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = TBasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = TBasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = TBasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = TBasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = TBasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(
            self.branch7x7dbl_4(self.branch7x7dbl_3(self.branch7x7dbl_2(self.branch7x7dbl_1(x))))
        )
        return torch.cat(
            [self.branch1x1(x), b7, bd, self.branch_pool(_avg_excl(x))], 1
        )


class TInceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = TBasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = TBasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = TBasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = TBasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = TBasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = TBasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, kernel_size=3, stride=2)], 1)


class TInceptionE(nn.Module):
    def __init__(self, cin, pool="avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = TBasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = TBasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = TBasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = TBasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = TBasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = TBasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = TBasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = TBasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = TBasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":  # FIDInceptionE_2 patch
            bp = F.max_pool2d(x, kernel_size=3, stride=1, padding=1)
        else:
            bp = _avg_excl(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class TInceptionV3(nn.Module):
    """FID InceptionV3 feature extractor (2048-d final-avgpool features)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = TBasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = TBasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = TBasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = TBasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = TBasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = TInceptionA(192, 32)
        self.Mixed_5c = TInceptionA(256, 64)
        self.Mixed_5d = TInceptionA(288, 64)
        self.Mixed_6a = TInceptionB(288)
        self.Mixed_6b = TInceptionC(768, 128)
        self.Mixed_6c = TInceptionC(768, 160)
        self.Mixed_6d = TInceptionC(768, 160)
        self.Mixed_6e = TInceptionC(768, 192)
        self.Mixed_7a = TInceptionD(768)
        self.Mixed_7b = TInceptionE(1280, pool="avg")
        self.Mixed_7c = TInceptionE(2048, pool="max")

    def forward(self, x, normalize_input=True):
        if normalize_input:
            x = 2 * x - 1
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = F.max_pool2d(x, kernel_size=3, stride=2)
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                  self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                  self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = m(x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# torchvision ResNet-50 mirror (swav/simclr-family encoders)
# ---------------------------------------------------------------------------


class TBottleneck(nn.Module):
    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False), nn.BatchNorm2d(cout)
            )

    def forward(self, x):
        idt = self.downsample(x) if hasattr(self, "downsample") else x
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + idt)


class TResNet50(nn.Module):
    """torchvision key layout (conv1/bn1/layer{1..4}.{i}.*) — loads real
    SwAV/imagenet ResNet-50 checkpoints; 2048-d avgpool features."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for li, (n, width, stride) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512), (1, 2, 2, 2))):
            blocks = []
            for bi in range(n):
                blocks.append(TBottleneck(cin if bi == 0 else width * 4, width, stride if bi == 0 else 1))
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            cin = width * 4

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# timm-layout ConvNeXt mirror (dgm-eval "convnext" encoder oracle/loader)
# ---------------------------------------------------------------------------


class TConvNeXtBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Holder()
        self.mlp.fc1 = nn.Linear(dim, dim * 4)
        self.mlp.fc2 = nn.Linear(dim * 4, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        h = self.conv_dw(x).permute(0, 2, 3, 1)
        h = self.norm(h)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(h)))
        h = (self.gamma * h).permute(0, 3, 1, 2)
        return x + h


class TConvNeXt(nn.Module):
    """timm state-dict layout: stem.{0,1}, stages.{s}.downsample.{0,1},
    stages.{s}.blocks.{i}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}, head.norm."""

    def __init__(self, depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)):
        super().__init__()
        self.depths, self.dims = depths, dims
        self.stem = nn.Sequential(
            nn.Conv2d(3, dims[0], 4, stride=4), nn.LayerNorm(dims[0], eps=1e-6)
        )
        self.stages = nn.ModuleList()
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            stage = _Holder()
            if s > 0:
                stage.downsample = nn.Sequential(
                    nn.LayerNorm(dims[s - 1], eps=1e-6),
                    nn.Conv2d(dims[s - 1], dim, 2, stride=2),
                )
            stage.blocks = nn.ModuleList([TConvNeXtBlock(dim) for _ in range(depth)])
            self.stages.append(stage)
        self.head = _Holder()
        self.head.norm = nn.LayerNorm(dims[-1], eps=1e-6)

    def forward(self, x):
        x = self.stem[0](x)
        x = self.stem[1](x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        for s, stage in enumerate(self.stages):
            if s > 0:
                x = stage.downsample[0](x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                x = stage.downsample[1](x)
            for blk in stage.blocks:
                x = blk(x)
        x = x.mean(dim=(2, 3))
        return self.head.norm(x)


# ---------------------------------------------------------------------------
# SimCLRv2 selective-kernel ResNet mirror (SimCLRv2-Pytorch key layout:
# net.0 stem / net.{1..4}.blocks.{i} stages) — oracle + real-ckpt loader
# ---------------------------------------------------------------------------


def _bnrelu(c, relu=True):
    return nn.Sequential(nn.BatchNorm2d(c, eps=1e-5), nn.ReLU() if relu else nn.Identity())


class TSelectiveKernel(nn.Module):
    def __init__(self, cin, cout, stride, sk_ratio=0.0625):
        super().__init__()
        self.main_conv = nn.Sequential(
            nn.Conv2d(cin, 2 * cout, 3, stride=stride, padding=1, bias=False),
            _bnrelu(2 * cout),
        )
        mid = max(int(cout * sk_ratio), 32)
        self.mixing_conv = nn.Sequential(
            nn.Conv2d(cout, mid, 1, bias=False), _bnrelu(mid),
            nn.Conv2d(mid, 2 * cout, 1, bias=False),
        )

    def forward(self, x):
        x = self.main_conv(x)
        x = torch.stack(torch.chunk(x, 2, dim=1), dim=0)
        g = x.sum(dim=0).mean(dim=[2, 3], keepdim=True)
        m = self.mixing_conv(g)
        m = torch.stack(torch.chunk(m, 2, dim=1), dim=0)
        return (x * F.softmax(m, dim=0)).sum(dim=0)


class TSKProjection(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.shortcut = nn.Sequential(
            nn.ZeroPad2d((0, 1, 0, 1)),
            nn.AvgPool2d(2, stride=stride, padding=0),
            nn.Conv2d(cin, cout, 1, bias=False),
        )
        self.bn = _bnrelu(cout, relu=False)

    def forward(self, x):
        return self.bn(self.shortcut(x))


class TSKBottleneck(nn.Module):
    def __init__(self, cin, width, stride, use_projection):
        super().__init__()
        cout = width * 4
        self.projection = TSKProjection(cin, cout, stride) if use_projection else nn.Identity()
        self.net = nn.Sequential(
            nn.Conv2d(cin, width, 1, bias=False), _bnrelu(width),
            TSelectiveKernel(width, width, stride),
            nn.Conv2d(width, cout, 1, bias=False), _bnrelu(cout, relu=False),
        )

    def forward(self, x):
        return F.relu(self.projection(x) + self.net(x))


class _TSKBlocks(nn.Module):
    def __init__(self, n, cin, width, stride):
        super().__init__()
        self.blocks = nn.ModuleList([TSKBottleneck(cin, width, stride, True)])
        for _ in range(n - 1):
            self.blocks.append(TSKBottleneck(width * 4, width, 1, False))

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


class TSimCLRResNet(nn.Module):
    """r50_{w}x_sk1; features = 2048·w global-average-pool."""

    def __init__(self, width_multiplier=1):
        super().__init__()
        c0 = 64 * width_multiplier // 2
        stem = nn.Sequential(
            nn.Conv2d(3, c0, 3, stride=2, padding=1, bias=False), _bnrelu(c0),
            nn.Conv2d(c0, c0, 3, padding=1, bias=False), _bnrelu(c0),
            nn.Conv2d(c0, 2 * c0, 3, padding=1, bias=False), _bnrelu(2 * c0),
            nn.MaxPool2d(3, stride=2, padding=1),
        )
        mods = [stem]
        cin = 64 * width_multiplier
        for n, width, stride in zip((3, 4, 6, 3), (64, 128, 256, 512), (1, 2, 2, 2)):
            mods.append(_TSKBlocks(n, cin, width * width_multiplier, stride))
            cin = width * width_multiplier * 4
        self.net = nn.Sequential(*mods)

    def forward(self, x):
        return self.net(x).mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# MTCNN P/R/O-net mirrors (facenet-pytorch layer structure, for the identity
# -stack parity runbook — `extract_ArcFace_embeds.py:28`, cascade used at
# `train_ID-Booth.py:982,1085`)
# ---------------------------------------------------------------------------


class TPNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.pool1 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = self.prelu1(self.conv1(x))
        x = self.pool1(x)
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        a = torch.softmax(self.conv4_1(x), dim=1)
        return a[:, 1], self.conv4_2(x)


class TRNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.pool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.pool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.prelu3(self.conv3(x))
        # facenet-pytorch flatten quirk: permute(0, 3, 2, 1) before view
        x = x.permute(0, 3, 2, 1).contiguous().view(x.shape[0], -1)
        x = self.prelu4(self.dense4(x))
        return torch.softmax(self.dense5_1(x), dim=1)[:, 1], self.dense5_2(x)


class TONet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.pool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.pool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.pool3 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.pool3(self.prelu3(self.conv3(x)))
        x = self.prelu4(self.conv4(x))
        x = x.permute(0, 3, 2, 1).contiguous().view(x.shape[0], -1)
        x = self.prelu5(self.dense5(x))
        return (
            torch.softmax(self.dense6_1(x), dim=1)[:, 1],
            self.dense6_2(x),
            self.dense6_3(x),
        )


# ---------------------------------------------------------------------------
# CLIP text encoder mirror (Hugging Face CLIPTextModel key layout:
# text_model.embeddings / encoder.layers.{i}.{self_attn,layer_norm1,mlp,
# layer_norm2} / final_layer_norm), causal attention, fp32 softmax
# ---------------------------------------------------------------------------


class TCLIPAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, c = x.shape
        q, k, v = (p(x).view(b, s, self.heads, self.head_dim).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = (q @ k.transpose(-1, -2)) * self.head_dim**-0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        attn = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, s, c))


class TCLIPMLP(nn.Module):
    def __init__(self, dim, inner, act):
        super().__init__()
        self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)
        self.act = act

    def forward(self, x):
        h = self.fc1(x)
        h = F.gelu(h) if self.act == "gelu" else h * torch.sigmoid(1.702 * h)
        return self.fc2(h)


class TCLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: clip_text.CLIPTextConfig):
        super().__init__()
        self.self_attn = TCLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = TCLIPMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class TCLIPText(nn.Module):
    """CLIPTextModel's forward to `last_hidden_state` (pre-LN layers, causal
    mask, final LayerNorm; "gelu" or "quick_gelu"), `state_dict()` in its
    `text_model.*` keys. A checkpoint's `text_model.embeddings.position_ids`
    buffer, where it has one, is not a weight: load with strict=False."""

    def __init__(self, cfg: clip_text.CLIPTextConfig = clip_text.SD21_TEXT_CONFIG):
        super().__init__()
        if cfg.hidden_act not in ("gelu", "quick_gelu"):
            raise ValueError(cfg.hidden_act)
        self.cfg = cfg
        tm = _Holder()
        tm.embeddings = _Holder()
        tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)
        tm.encoder = _Holder()
        tm.encoder.layers = nn.ModuleList([TCLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])
        tm.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.text_model = tm

    def forward(self, input_ids):
        """Token ids (B, S) int64 → last_hidden_state (B, S, hidden)."""
        tm = self.text_model
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)[None]
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)
