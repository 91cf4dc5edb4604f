"""FLOP counts (`faceposegenerator_tpu_torch/core/flops.py`) against the JAX
package's `core.flops` (XLA's cost analysis) on the same matmuls, and the
kernel routes against the plain routes: each attention wrapper's launch
path run here with its C calls stubbed (`_call`, `_check` and the stream;
the outputs are left unwritten) must count what the plain version's aten
ops count, forward (K1, K2 and their fp32 instance, K8) and backward (K5,
K6, fp32: the pair, and each pass alone), and a tiny UNet call must count
the same on both routes. `summarize` gives the rate and the share of a peak.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core import flops as jflops
from faceposegenerator_tpu_torch.core import flops
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.models import unet2d
from faceposegenerator_tpu_torch.ops import attention
from faceposegenerator_tpu_torch.ops import flash_attention as fa

from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("shapes", [((64, 96), (96, 40)), ((3, 16, 32), (3, 32, 8)), ((5, 7, 24), (24, 10))])
def test_matmul_flops_equal_jax(shapes):
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    want = jflops.flops(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = flops.flops(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got == want == 2.0 * np.prod(a.shape[:-1]) * a.shape[-1] * b.shape[-1]


@pytest.fixture
def kernel_route(monkeypatch):
    """The wrappers' CUDA paths on CPU tensors, their C calls stubbed."""
    monkeypatch.setattr(fa, "_call", lambda name, *args: None)
    monkeypatch.setattr(fa, "_check", lambda name, *tensors: None)
    monkeypatch.setattr(fa, "f32_split", lambda specs: [torch.empty(0)] * len(specs))
    monkeypatch.setattr(fa, "_launch_bwd_f32", lambda *args: None)
    monkeypatch.setattr(fa, "_int8_args", lambda q, k, v, kv_len=None: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[1], None, 0, 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa, "_fwd", lambda name, q, k, v, scale, kv_len, with_lse: fa._launch_fwd(
        name, q, k, v, scale, kv_len, with_lse))
    monkeypatch.setattr(fa, "flash_attention_int8", fa._launch_int8)
    monkeypatch.setattr(attention, "flash_attention_int8", fa._launch_int8)


def _qkv(b, sq, skv, h, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to(dtype) for s in (sq, skv, skv)]


FWD = [("K1 self", 2, 64, 64, 2, 64, torch.bfloat16, None), ("K1 cross, 77 keys", 2, 64, 77, 2, 64, torch.bfloat16, 70),
       ("K2", 1, 64, 64, 1, 512, torch.bfloat16, None), ("fp32 d64", 2, 32, 48, 3, 64, torch.float32, None),
       ("fp32 d512", 1, 16, 16, 1, 512, torch.float32, None)]


@pytest.mark.parametrize("case", FWD, ids=[c[0] for c in FWD])
def test_attention_forward_counts_the_same_on_both_routes(case, request):
    _, b, sq, skv, h, d, dtype, kv_len = case
    q, k, v = _qkv(b, sq, skv, h, d, dtype)
    unit = b * h * sq * skv * d
    plain = flops.cost_analysis(attention.dot_product_attention, q, k, v, kv_len=kv_len)
    assert plain["flops"] == 4.0 * unit and not plain["kernel_flops"]
    request.getfixturevalue("kernel_route")
    kernel = flops.cost_analysis(attention.dot_product_attention, q, k, v, kv_len=kv_len)
    assert kernel["flops"] == plain["flops"]
    assert kernel["kernel_flops"] == {fa.kernel_for(dtype, d): 4.0 * unit} and kernel["bytes_accessed"] is None


@pytest.mark.parametrize("kind,d,dtype", [("d64", 64, torch.bfloat16), ("wide", 512, torch.bfloat16),
                                          ("f32", 64, torch.float32)])
def test_attention_backward_counts_the_same_on_both_routes(kind, d, dtype, kernel_route):
    b, sq, skv, h = 2, 32, 40, 1
    q, k, v = _qkv(b, sq, skv, h, d, dtype)
    o, lse = fa.attention_plain_lse(q, k, v, d**-0.5)
    do = torch.randn(q.shape).to(dtype)
    unit = b * h * sq * skv * d
    plain = flops.flops(fa.attention_bwd_plain, q, k, v, o, lse, do, d**-0.5)
    assert plain == 10.0 * unit
    for passes, n in ((("dkv", "dq"), 10), (("dkv",), 8), (("dq",), 6)):
        got = flops.cost_analysis(fa._launch_bwd, kind, q, k, v, o, lse, do, d**-0.5, None, passes)
        assert got["kernel_flops"] == {f"flash_bwd_{kind}": n * unit}, passes
    assert flops.flops(fa._launch_bwd, kind, q, k, v, o, lse, do, d**-0.5, None, ("dkv", "dq")) == plain


def test_int8_attention_counts_the_same_on_both_routes(kernel_route):
    q, k, v = _qkv(2, 64, 77, 2, 64, torch.bfloat16)
    plain = flops.flops(fa.attention_int8_plain, q, k, v, 0.125)
    got = flops.cost_analysis(attention.dot_product_attention, q, k, v, impl="flash_int8")
    assert got["flops"] == plain == 4.0 * 2 * 2 * 64 * 77 * 64 and set(got["kernel_flops"]) == {"flash_int8"}


def test_unet_call_counts_the_same_on_both_routes(request):
    """A two-level UNet with one attention level (self- and cross-attention),
    batch 2 at 16²: the whole call's FLOPs on the plain route equal the
    kernel route's (aten ops + the wrappers' counts), and the counter stack
    is empty after each call."""
    cfg = unet2d.UNetConfig(block_out_channels=(64, 64), layers_per_block=1, down_block_has_attn=(True, False),
                            cross_attention_dim=64, head_dim=64)
    net = unet2d.UNet2DCondition(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    lat, ctx = torch.randn(2, 16, 16, 4, generator=g), torch.randn(2, 77, 64, generator=g)
    args = (lat, torch.tensor([10, 10]), ctx)
    with torch.no_grad():
        plain = flops.cost_analysis(net, *args, policy=PARITY_POLICY)
        request.getfixturevalue("kernel_route")
        kernel = flops.cost_analysis(net, *args, policy=PARITY_POLICY)
    assert kernel["flops"] == plain["flops"] > 0
    # self-attention and cross-attention over 77 keys, one 64-dim head, in the three transformers at
    # 16² (256 tokens: one down, layers_per_block + 1 up) and the mid one at 8² (64 tokens)
    attn = 4.0 * 2 * 64 * (3 * 256 * (256 + 77) + 64 * (64 + 77))
    assert kernel["kernel_flops"] == {"flash_fwd_f32": attn}
    assert plain["flops"] - sum(plain["aten_flops"].values()) == 0
    assert not flops._TALLIES


def test_summarize_rate_and_share_of_peak():
    a, b = torch.ones(128, 64), torch.ones(64, 32)
    out = flops.summarize(lambda x, y: x @ y, a, b, peak_flops_per_sec=1e9, runtime_s=1e-3)
    assert out == {"flops": 2.0 * 128 * 64 * 32, "bytes_accessed": None,
                   "achieved_flops_per_sec": 2.0 * 128 * 64 * 32 / 1e-3,
                   "tensor_core_utilization": 2.0 * 128 * 64 * 32 / 1e-3 / 1e9}
    assert set(flops.summarize(lambda x, y: x @ y, a, b)) == {"flops", "bytes_accessed"}
