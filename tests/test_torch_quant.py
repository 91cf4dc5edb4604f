"""The port's w8a8 quantization (ops/quant.py, ops/qdense.py) against the JAX
package's (ops/quant.py, ops/quant_pallas.py), fp32 on the CPU, inputs from
numpy seeds.

K7's plain version is held to `qdense_pallas(interpret=True)` and to the
static branch of JAX `qdense` exactly at fp32: the codes come from the same
fp32 division and round half to even, the integer sums are exact on both
sides, and the rescale multiplies in the same order. At bf16 the one output
rounding differs in order only (1e-2). `qconv2d` is within 1e-6 relative.
The quantized site sets of the tiny UNet and VAE equal JAX's.

JAX ops that derive a scale from an amax run under `jax.jit` here, as they do
in the sampling program: XLA then divides by 127 through the reciprocal,
which the port reproduces (`ops.qdense.INV127`); eager JAX divides truly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from faceposegenerator_tpu.ops import quant as jquant
from faceposegenerator_tpu.ops import quant_pallas
from faceposegenerator_tpu.ops.lora import lora_dense as jlora_dense
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.models import unet2d, vae
from faceposegenerator_tpu_torch.models.layers import Affine, conv2d
from faceposegenerator_tpu_torch.ops import qdense as qd
from faceposegenerator_tpu_torch.ops import quant
from faceposegenerator_tpu_torch.ops.lora import lora_dense

from test_torch_models import TINY_UNET, TINY_VAE


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_tree(mod):
    """The JAX param tree of a port module (nested dicts and lists of numpy
    arrays, the inverse of `bridge.jax_params.load_jax_params`): JAX trees
    built from the port's seeded weights, without JAX `init`'s compile time."""
    if isinstance(mod, nn.ModuleList):
        return [jax_tree(m) for m in mod]
    if isinstance(mod, Affine):
        return {"g": mod.weight.detach().numpy(), "b": mod.bias.detach().numpy()}
    if isinstance(mod, (nn.Linear, nn.Conv2d)):
        w = mod.weight.detach()
        out = {"w": (w.permute(2, 3, 1, 0) if w.dim() == 4 else w).contiguous().numpy()}
        if mod.bias is not None:
            out["b"] = mod.bias.detach().numpy()
        return out
    out = {k: p.detach().numpy() for k, p in mod.named_parameters(recurse=False)}
    out.update({k: jax_tree(m) for k, m in mod.named_children()})
    out.update({k: None for k in ("attentions", "downsample", "upsample") if k in vars(mod) and vars(mod)[k] is None})
    return out


def _np_quantize_weight(w, channel_axis, act_scale=None):
    """JAX `quantize_weight`'s arithmetic in numpy (fp32 true division, round
    half to even), for tests about which sites are quantized."""
    wf = np.asarray(w, np.float32)
    axes = tuple(a for a in range(wf.ndim) if a != channel_axis % wf.ndim)
    s = np.maximum(np.abs(wf).max(axis=axes, keepdims=True), np.float32(1e-8)) / np.float32(127.0)
    out = {"q": np.clip(np.round(wf / s), -127, 127).astype(np.int8), "s": s.reshape(-1)}
    if act_scale is not None:
        out["a"] = np.float32(act_scale)
    return out


def _weight(seed, n=24, k=40):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32) * 0.3


def _jax_sites(tree, prefix=()):
    """Paths of the quantized leaves of a JAX tree, as save_act_scales writes them."""
    if isinstance(tree, dict):
        if jquant.is_quantized(tree):
            return {"/".join(prefix)}
        return set().union(*[_jax_sites(v, prefix + (k,)) for k, v in tree.items()]) if tree else set()
    if isinstance(tree, (list, tuple)):
        return set().union(*[_jax_sites(v, prefix + (str(i),)) for i, v in enumerate(tree)]) if tree else set()
    return set()


@pytest.mark.parametrize("shape", [(6, 40), (37, 40), (2, 3, 40)])
def test_qdense_plain_matches_pallas_kernel(shape):
    w = _weight(7)
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w), channel_axis=0)
    want = quant_pallas.qdense_pallas(jnp.asarray(x), jw["q"], jw["s"], block_m=16, block_n=128, interpret=True)
    tw = quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw["q"]))
    np.testing.assert_array_equal(tw.s.numpy(), np.asarray(jw["s"]))
    qd.reset_launch_counts()
    got = qd.qdense_kernel(torch.from_numpy(x), tw.q, tw.s)
    assert got.shape == want.shape and qd.LAUNCHES["qdense"] == 0  # a CPU tensor never launches
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qdense_plain_bf16_within_one_rounding_of_pallas():
    w = _weight(9)
    x = np.random.default_rng(10).standard_normal((6, 40)).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w), channel_axis=0)
    want = quant_pallas.qdense_pallas(jnp.asarray(x, jnp.bfloat16), jw["q"], jw["s"], interpret=True)
    got = qd.qdense_plain(torch.from_numpy(x).to(torch.bfloat16), quant.quantize_weight(torch.from_numpy(w)).q,
                          quant.quantize_weight(torch.from_numpy(w)).s)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


def test_qdense_static_and_fused_match_jax():
    """Static scales: acc·(a·s) exactly as JAX's XLA branch; the fused q/k/v
    GEMM quantizes x against the max of its members' scales."""
    x = np.random.default_rng(11).standard_normal((5, 3, 40)).astype(np.float32)
    ws = [_weight(12 + i) for i in range(3)]
    scales = [0.021, 0.034, 0.027]
    jws = [jquant.quantize_weight(jnp.asarray(w), channel_axis=0, act_scale=a) for w, a in zip(ws, scales)]
    tws = [quant.quantize_weight(torch.from_numpy(w), act_scale=a) for w, a in zip(ws, scales)]
    np.testing.assert_array_equal(quant.qdense(torch.from_numpy(x), tws[0]).numpy(),
                                  np.asarray(jquant.qdense(jnp.asarray(x), jws[0])))
    np.testing.assert_array_equal(quant.qdense_fused(torch.from_numpy(x), tws).numpy(),
                                  np.asarray(jquant.qdense_fused(jnp.asarray(x), jws)))


def test_lora_dense_over_a_quantized_weight_matches_jax():
    """base product, + scale·delta on the unquantized x, cast, + bias."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((4, 40)).astype(np.float32)
    w, b = _weight(14), rng.standard_normal(24).astype(np.float32)
    la, lb = rng.standard_normal((4, 40)).astype(np.float32), rng.standard_normal((24, 4)).astype(np.float32)
    for a in (None, 0.03):
        jw = jquant.quantize_weight(jnp.asarray(w), channel_axis=0, act_scale=a)
        want = jax.jit(jlora_dense, static_argnames="scale")(jnp.asarray(x), jw, jnp.asarray(b), jnp.asarray(la),
                                                             jnp.asarray(lb), scale=0.5)
        got = lora_dense(torch.from_numpy(x), quant.quantize_weight(torch.from_numpy(w), act_scale=a),
                         torch.from_numpy(b), torch.from_numpy(la), torch.from_numpy(lb), scale=0.5)
        # the delta joins in another order than XLA's fused multiply-add: 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ksize,stride,static", [(3, 1, False), (3, 2, False), (1, 1, False), (3, 1, True), (1, 2, True)])
def test_qconv2d_matches_jax(ksize, stride, static):
    rng = np.random.default_rng(ksize * 10 + stride)
    x = rng.standard_normal((2, 9, 9, 8)).astype(np.float32)
    w = rng.standard_normal((ksize, ksize, 8, 12)).astype(np.float32) * 0.2
    b = rng.standard_normal(12).astype(np.float32)
    pad = ksize // 2
    a = 0.031 if static else None
    jconv = jax.jit(lambda x, p: jquant.qconv2d(x, p, stride=stride, padding=pad))
    want = jconv(jnp.asarray(x), {"w": jquant.quantize_weight(jnp.asarray(w), -1, act_scale=a), "b": jnp.asarray(b)})
    conv = nn.Conv2d(8, 12, ksize)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
    qw = quant.quantize_weight(conv.weight, act_scale=a)
    del conv.weight
    conv.weight = qw
    with torch.no_grad():
        got = conv2d(torch.from_numpy(x), conv, stride=stride, padding=pad)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_quantized_sites_match_jax(monkeypatch):
    """quantize_unet / quantize_vae pick JAX quantize_tree's sites on the tiny
    UNet and VAE (the codes themselves are checked above, per layer)."""
    monkeypatch.setattr(jquant, "quantize_weight", _np_quantize_weight)
    tunet = unet2d.UNet2DCondition(unet2d.UNetConfig(**TINY_UNET), device="cpu")
    jq = jquant.quantize_unet(jax_tree(tunet))
    sites = quant.quantize_unet(tunet)
    assert set(sites) == _jax_sites(jq) and len(sites) == len(set(sites))
    assert not any(k in p for p in sites for k in ("conv_in", "conv_out", "time_emb"))
    tvae = vae.AutoencoderKL(vae.VAEConfig(**TINY_VAE), device="cpu")
    jvq = jquant.quantize_vae(jax_tree(tvae))
    vsites = quant.quantize_vae(tvae)
    assert set(vsites) == _jax_sites(jvq)
    assert vsites and all(p.startswith("decoder/") and "/attn/" not in p for p in vsites)


class _Two(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(8, 12, 3)
        self.lin = nn.Linear(40, 24)


def test_bridge_calibration_and_scale_files(tmp_path):
    """A JAX-quantized tree with static scales carries over with its codes and
    scales; the port's calibration freezes the same scale as JAX's on the
    same observation; the scale file is JAX's format; loading onto a drifted
    layout raises."""
    rng = np.random.default_rng(3)
    tree = {"conv": {"w": rng.standard_normal((3, 3, 8, 12)).astype(np.float32), "b": np.zeros(12, np.float32)},
            "lin": {"w": _weight(4), "b": np.zeros(24, np.float32)}}
    jq = {k: dict(v, w=jquant.quantize_weight(jnp.asarray(v["w"]), -1 if k == "conv" else 0, act_scale=0.05))
          for k, v in tree.items()}
    two = load_jax_params(_Two(), _np(jq))
    sites = quant.quantized_sites(two)
    assert set(sites) == {"conv/w", "lin/w"} and all(w.a == np.float32(0.05) for w in sites.values())
    np.testing.assert_array_equal(two.conv.weight.q.permute(2, 3, 1, 0).numpy(), np.asarray(jq["conv"]["w"]["q"]))
    np.testing.assert_array_equal(two.lin.weight.s.numpy(), np.asarray(jq["lin"]["w"]["s"]))

    # calibration: the same observation freezes the same scale
    x = rng.standard_normal((3, 40)).astype(np.float32) * 2.5
    with jquant.observe_act_scales() as jcal:
        jquant.qdense(jnp.asarray(x), jq["lin"]["w"])
    jfrozen = jquant.freeze_act_scales(jq, jcal, margin=1.1)
    with quant.observe_act_scales() as tcal:
        quant.qdense(torch.from_numpy(x), two.lin.weight)
    assert quant.freeze_act_scales(two, tcal, margin=1.1) == ["conv/w"]  # never observed: stays as it was
    assert two.lin.weight.a == float(jfrozen["lin"]["w"]["a"]) and two.conv.weight.a == np.float32(0.05)

    # scale files: the port writes JAX's keys and values; drift raises
    path, jpath = tmp_path / "scales.json", tmp_path / "jax_scales.json"
    assert quant.save_act_scales({"m": two}, str(path)) == 2
    jquant.save_act_scales({"m": jfrozen}, str(jpath))
    assert json.loads(path.read_text()) == json.loads(jpath.read_text())
    fresh = _Two()
    quant.quantize_module(fresh)
    quant.load_act_scales({"m": fresh}, str(jpath))
    assert {p: w.a for p, w in quant.quantized_sites(fresh).items()} == {p: w.a for p, w in sites.items()}
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **{"m/conv2/w": 0.1})))
    with pytest.raises(ValueError, match="matched no quantized site"):
        quant.load_act_scales({"m": fresh}, str(path))
