"""The port's CNN encoders (pytorch-fid InceptionV3, SwAV's ResNet-50,
SimCLRv2's SK-ResNet, a tiny ConvNeXt) and their converters against the JAX
package's, fp32. Each state dict comes from the JAX package's torch mirror
of the reference layout (`bridge/torch_mirror.py`) with random weights and
non-trivial BatchNorm statistics (ConvNeXt: LayerScale); the port's
converter must give JAX's tree leaf for leaf, the module must load it, and
its features must agree with JAX's on the same inputs: Inception within
JAX's own 2e-3 (tests/test_inception.py:35; here on 2 × 96×80 inputs, so the
299² bilinear resize runs too), the others within 2e-4 of the max abs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.bridge import torch_mirror as mirror
from faceposegenerator_tpu.bridge import torch_weights as jtw
from faceposegenerator_tpu.models import convnext as jcn
from faceposegenerator_tpu.models import inception_v3 as jinc
from faceposegenerator_tpu.models import resnet50 as jres
from faceposegenerator_tpu.models import simclr_resnet as jsim
from faceposegenerator_tpu_torch.bridge import torch_weights as tw
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.models import convnext, inception_v3, resnet50, simclr_resnet


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TINY_CNX = dict(depths=(2, 2, 2, 2), dims=(16, 32, 48, 64))
CASES = {  # mirror, converter name, port module, JAX apply, input shape, tolerance
    "inception": (mirror.TInceptionV3, "convert_inception_state_dict", lambda: inception_v3.InceptionV3(device="cpu"),
                  jinc.apply, (2, 96, 80, 3), 2e-3),
    "resnet50": (mirror.TResNet50, "convert_resnet50_state_dict", lambda: resnet50.ResNet50(device="cpu"),
                 jres.apply, (2, 64, 64, 3), 2e-4),
    "simclr": (mirror.TSimCLRResNet, "convert_simclr_state_dict", lambda: simclr_resnet.SimCLRResNet(device="cpu"),
               jsim.apply, (2, 64, 64, 3), 2e-4),
    "convnext": (lambda: mirror.TConvNeXt(**TINY_CNX), "convert_convnext_state_dict",
                 lambda: convnext.ConvNeXt(convnext.ConvNeXtConfig(**TINY_CNX), device="cpu"),
                 lambda p, x: jcn.apply(p, x, jcn.ConvNeXtConfig(**TINY_CNX)), (2, 64, 64, 3), 2e-4),
}


def _mirror_state_dict(make) -> dict:
    torch.manual_seed(0)
    tm = make().eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
        for name, p in tm.named_parameters():
            if name.endswith(".gamma"):
                p.uniform_(0.5, 1.5)
    return {k: v.detach().numpy() for k, v in tm.state_dict().items()}


def _convert(fn, sd):
    kw = {"cfg": jcn.ConvNeXtConfig(**TINY_CNX)} if fn == "convert_convnext_state_dict" else {}
    port_kw = {"cfg": convnext.ConvNeXtConfig(**TINY_CNX)} if kw else {}
    return getattr(tw, fn)(sd, **port_kw), getattr(jtw, fn)(sd, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_cnn_encoders_and_converters_match_jax(name):
    make, fn, module, japply, shape, tol = CASES[name]
    got_tree, want_tree = _convert(fn, _mirror_state_dict(make))
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree)
    for g, w in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)):
        assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w))
    rng = np.random.default_rng(1)
    x = (rng.uniform(0, 1, shape) if name == "inception" else rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(jax.jit(japply)(want_tree, jnp.asarray(x)))
    model = load_jax_params(module(), got_tree)
    assert not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err
