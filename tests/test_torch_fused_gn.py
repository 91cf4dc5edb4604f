"""K3's plain version and its route against the JAX package, on the CPU.

`fused_gn.fused_group_norm_plain` (what K3 computes, and what a CPU tensor
gets) against JAX `fused_group_norm(..., interpret=True)`, the Pallas kernel
in interpret mode, at the shapes of tests/test_ops.py:250-254 (fp32 within
1e-5, bf16 within 2e-2, the JAX test's own tolerances); gradients of the
autograd Function against `jax.grad` of the same loss within 1e-4;
`slab_supported` against JAX's; the GN_IMPL route in `norms.group_norm`; a
backward under GN_IMPL=pallas that recomputes through the plain formula
without routing to K3 again. The JAX outputs are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.ops import fused_gn as jfg
from faceposegenerator_tpu.ops.norms import group_norm as jgroup_norm
from faceposegenerator_tpu_torch.ops import fused_gn as fg
from faceposegenerator_tpu_torch.ops import norms

CASES = [((2, 16, 16, 320), 32, "silu"), ((2, 8, 8, 64), 8, None), ((1, 24, 8, 96), 16, "silu")]
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    return x, gamma, beta


@pytest.fixture(scope="module")
def jax_outputs():
    """{(case index, dtype name): JAX interpret-mode K3 output as fp32 numpy}."""
    out = {}
    for i, (shape, groups, act) in enumerate(CASES):
        x, gamma, beta = _inputs(shape)
        for name, (jdt, _, _) in DTYPES.items():
            y = jfg.fused_group_norm(jnp.asarray(x).astype(jdt), jnp.asarray(gamma), jnp.asarray(beta), groups,
                                     1e-6, act, True)
            out[i, name] = np.asarray(y.astype(jnp.float32))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_jax_interpret_kernel(jax_outputs, case, dtype):
    shape, groups, act = CASES[case]
    _, tdt, tol = DTYPES[dtype]
    x, gamma, beta = _inputs(shape)
    got = fg.fused_group_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma), torch.from_numpy(beta),
                              groups, 1e-6, act)
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), jax_outputs[case, dtype], atol=tol, rtol=tol)


def test_autograd_function_grads_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    gamma = rng.standard_normal(64).astype(np.float32)
    beta = rng.standard_normal(64).astype(np.float32)

    def loss(x, g, b):
        return jnp.sum(jfg.fused_group_norm(x, g, b, 8, 1e-6, "silu", True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    y = fg.fused_group_norm(*args, 8, 1e-6, "silu")
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "FusedGroupNormBackward"
    y.square().sum().backward()
    for a, w in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_slab_supported_matches_jax():
    grid = [(n, s, c, g) for n in (1, 16) for s in (4, 64, 100, 256, 1024, 1536, 4096, 16384)
            for c in (32, 64, 96, 320, 330, 512, 640, 960, 1280) for g in (8, 32)]
    for args in grid:
        assert fg.slab_supported(*args) == jfg.slab_supported(*args), args
    assert sum(fg.slab_supported(*args) for args in grid) > 20


def _record(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(x, *args):
        calls.append(tuple(x.shape))
        return fn(x, *args)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_group_norm_routes_by_gn_impl(monkeypatch, impl):
    """Under GN_IMPL=pallas the shapes slab_supported accepts go to K3 (its
    plain version on the CPU); the others, and all under xla, stay plain.
    Both routes match JAX's XLA GroupNorm."""
    monkeypatch.setattr(fg, "_GN_IMPL", impl)
    fused = _record(monkeypatch, fg, "fused_group_norm")
    plain = _record(monkeypatch, norms, "group_norm_plain")
    for shape, groups in (((2, 16, 16, 64), 32), ((2, 4, 4, 960), 32), ((1, 10, 10, 64), 8)):
        x, gamma, beta = _inputs(shape, seed=sum(shape))
        got = norms.group_norm(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-5,
                               "silu")
        want = jgroup_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), num_groups=groups, eps=1e-5,
                           act="silu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    routed = [(2, 16, 16, 64)] if impl == "pallas" else []
    assert fused == routed
    assert len(plain) == 3 - len(routed)


def test_backward_under_pallas_does_not_route_again(monkeypatch):
    """The JAX backward recomputes through the dispatching group_norm; the
    port's recomputes through the plain formula: one K3 call, in the forward."""
    monkeypatch.setattr(fg, "_GN_IMPL", "pallas")
    fused = _record(monkeypatch, fg, "fused_group_norm")
    x, gamma, beta = _inputs((2, 8, 8, 64), seed=9)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    norms.group_norm(*args, 8, 1e-6, "silu").square().sum().backward()
    assert fused == [(2, 8, 8, 64)]
    ref = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    norms.group_norm_plain(*ref, 8, 1e-6, "silu").square().sum().backward()
    for a, r in zip(args, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=1e-4, rtol=1e-4)
