"""K4's plain version and its route against the JAX package, on the CPU.

`fused_gn_conv.gn_silu_conv3x3_plain` (what K4 computes, and what a CPU
tensor gets) against JAX `gn_silu_conv3x3(..., interpret=True)`, the Pallas
kernel in interpret mode, at the shapes of tests/test_ops.py:326-329 (fp32
within 5e-4; bf16 within 1e-1 with mean abs err <= 1e-2); a border case that
a pad-before-SiLU variant fails; gradients of the autograd Function against
`jax.grad` within 1e-3; `supported` against JAX's; a quantized conv that
does not route to K4; and the tiny UNet with GN_IMPL and GN_CONV_IMPL at
`pallas` against the JAX XLA path (2e-4), with its route counts held to the
predicates. The JAX outputs are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.ops import fused_gn as jfg
from faceposegenerator_tpu.ops import fused_gn_conv as jfgc
from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch, load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.models import unet2d
from faceposegenerator_tpu_torch.ops import fused_gn as fg
from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc
from faceposegenerator_tpu_torch.ops import norms
from faceposegenerator_tpu_torch.ops.quant import quantize_unet

from test_torch_models import TINY_UNET, nonzero_lora

CASES = [((2, 16, 16, 320), 320, 32), ((1, 8, 8, 64), 96, 8), ((1, 24, 16, 96), 64, 16)]
DTYPES = {"fp32": (jnp.float32, torch.float32, 5e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-1)}


def _inputs(shape, cout, seed=7, beta_shift=0.0):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    gamma = rng.standard_normal(cin).astype(np.float32)
    beta = rng.standard_normal(cin).astype(np.float32) + beta_shift
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    return x, gamma, beta, w, b


def _conv(w_hwio, b):
    """An nn.Conv2d holding the HWIO weight as (Cout, Cin, 3, 3) channels_last."""
    cin, cout = w_hwio.shape[2:]
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1)
    conv.weight.data = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))).contiguous(
        memory_format=torch.channels_last)
    conv.bias.data = torch.from_numpy(b)
    return conv


def _jax_k4(x, gamma, beta, w, b, groups, dtype=jnp.float32):
    y = jfgc.gn_silu_conv3x3(jnp.asarray(x).astype(dtype), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w),
                             jnp.asarray(b), groups, 1e-5, True)
    return np.asarray(y.astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_outputs():
    """{(case index, dtype name): JAX interpret-mode K4 output as fp32 numpy}."""
    return {(i, name): _jax_k4(*_inputs(shape, cout), groups, jdt)
            for i, (shape, cout, groups) in enumerate(CASES) for name, (jdt, _, _) in DTYPES.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_jax_interpret_kernel(jax_outputs, case, dtype):
    shape, cout, groups = CASES[case]
    _, tdt, tol = DTYPES[dtype]
    x, gamma, beta, w, b = _inputs(shape, cout)
    with torch.no_grad():
        got = fgc.gn_silu_conv3x3(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma), torch.from_numpy(beta),
                                  _conv(w, b), groups, 1e-5)
    assert got.dtype == tdt and got.shape == (*shape[:3], cout)
    want = jax_outputs[case, dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    if dtype == "bf16":
        assert np.abs(got.float().numpy() - want).mean() <= 1e-2


def test_padding_comes_after_the_activation():
    """With beta far from 0, SiLU(shift) at the border is far from 0. The
    plain version matches JAX's kernel; a variant that pads x with zeros
    before the normalisation and SiLU does not."""
    shape, cout, groups = (1, 8, 8, 64), 32, 8
    x, gamma, beta, w, b = _inputs(shape, cout, seed=11, beta_shift=3.0)
    want = _jax_k4(x, gamma, beta, w, b, groups)
    tx, conv = torch.from_numpy(x), _conv(w, b)
    got = fgc.gn_silu_conv3x3(tx, torch.from_numpy(gamma), torch.from_numpy(beta), conv, groups)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-4, rtol=5e-4)
    scale, shift = fgc.group_scale_shift(tx, torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-5)
    xp = torch.nn.functional.pad(tx, (0, 0, 1, 1, 1, 1))
    a = torch.nn.functional.silu(xp * scale[:, None, None] + shift[:, None, None])
    pad_first = torch.nn.functional.conv2d(a.permute(0, 3, 1, 2), conv.weight, conv.bias).permute(0, 2, 3, 1)
    assert np.abs(pad_first.detach().numpy() - want).max() > 1e-1


def test_autograd_function_grads_match_jax():
    shape, cout, groups = (1, 8, 8, 64), 64, 8
    x, gamma, beta, w, b = _inputs(shape, cout, seed=9)

    def loss(*args):
        return jnp.sum(jfgc.gn_silu_conv3x3(*args, groups, 1e-5, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (x, gamma, beta, w, b)))
    conv = _conv(w, b)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    y = fgc.gn_silu_conv3x3(*args, conv, groups)
    assert type(y.grad_fn).__name__ == "GNSiLUConv3x3Backward"
    y.square().sum().backward()
    got = [a.grad for a in args] + [conv.weight.grad.permute(2, 3, 1, 0), conv.bias.grad]
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-3, rtol=1e-3)


def test_supported_matches_jax():
    grid = [(n, h, w, cin, cout, g) for n in (1, 16) for h, w in ((4, 4), (12, 12), (16, 16), (32, 32), (64, 64),
                                                                  (96, 96), (128, 128))
            for cin in (64, 320, 640, 960) for cout in (320, 640, 1280) for g in (32, 48)]
    for args in grid:
        assert fgc.supported(*args) == jfgc.supported(*args), args
    assert sum(fgc.supported(*args) for args in grid) > 20


def _fused_routes(monkeypatch):
    """Both switches at pallas; records the calls to K3, K4 and the plain GroupNorm."""
    monkeypatch.setattr(fg, "_GN_IMPL", "pallas")
    monkeypatch.setattr(fgc, "_IMPL", "pallas")
    routes = {}
    for module, name in ((fg, "fused_group_norm"), (fgc, "gn_silu_conv3x3"), (norms, "group_norm_plain")):
        routes[name] = []
        fn = getattr(module, name)

        def wrapped(x, *args, fn=fn, calls=routes[name], name=name):
            out_c = args[2].out_channels if name == "gn_silu_conv3x3" else None
            calls.append((tuple(x.shape), out_c))
            return fn(x, *args)

        monkeypatch.setattr(module, name, wrapped)
    return routes


def test_quantized_conv_does_not_route_to_k4(monkeypatch):
    """Quantized convs keep `group_norm` + `qconv2d` (unet2d.py:289), even
    at shapes K4 takes; their GroupNorms may still go to K3."""
    unet = unet2d.UNet2DCondition(unet2d.UNetConfig(**TINY_UNET), device="cpu")
    quantize_unet(unet)
    routes = _fused_routes(monkeypatch)
    rng = np.random.default_rng(2)
    lat = torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 77, 64)).astype(np.float32))
    with torch.no_grad():
        unet(lat, torch.tensor([10]), ctx, PARITY_POLICY)
    assert routes["gn_silu_conv3x3"] == []
    assert len(routes["fused_group_norm"]) > 0


# The tiny UNet at 16² latents, 32 groups: every resblock's (cin, cout) is at
# most 256 and its rows divide by min(h, 8), so all 22 resblocks take K4
# twice; K3 takes the 2 + 2 + 2 down and 3 + 3 + 3 up transformer norms at
# 16², 8² and 4² and conv_norm_out, but not the mid block's norm at 2²
# (S = 4 is not a multiple of 8).
TINY_ROUTES = {"gn_silu_conv3x3": 44, "fused_group_norm": 16, "group_norm_plain": 1}


def test_tiny_unet_fused_routes_match_jax(monkeypatch):
    """The JAX XLA path (the switches route only on a TPU) against the port
    with both switches at pallas: K3 and K4's plain versions on the CPU."""
    PARITY_POLICY.configure_backends()
    jcfg = junet.UNetConfig(**TINY_UNET)
    params = junet.init(jax.random.key(0), jcfg)
    lora = nonzero_lora(params)
    np_tree = jax.tree.map(np.asarray, params)
    model = load_jax_params(unet2d.UNet2DCondition(unet2d.UNetConfig(**TINY_UNET), device="cpu"), np_tree)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([7, 531])
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    apply = jax.jit(lambda p, *a, lora: junet.apply(p, *a, jcfg, policy=JPOLICY, lora=lora, attn_impl="reference"))
    ref = apply(params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx), lora=lora)
    routes = _fused_routes(monkeypatch)
    with torch.no_grad():
        out = model(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx), PARITY_POLICY,
                    lora=jax_tree_to_torch(jax.tree.map(np.asarray, lora), "cpu", torch.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
    assert {name: len(calls) for name, calls in routes.items()} == TINY_ROUTES
    groups = jcfg.norm_groups
    for (n, h, w, cin), cout in routes["gn_silu_conv3x3"]:
        assert jfgc.supported(n, h, w, cin, cout, groups)
    for shape, _ in routes["fused_group_norm"] + routes["group_norm_plain"]:
        n, c = shape[0], shape[-1]
        on_k3 = (shape, None) in routes["fused_group_norm"]
        assert jfg.slab_supported(n, int(np.prod(shape[1:-1])), c, groups) == on_k3
