"""The port's FD-sensitivity heatmaps against the JAX package's on the CPU:
GradCAM maps and `make_heatmap_fn` on a tiny DINOv2 (fp32, PARITY_POLICY on
both sides) and a tiny ConvNeXt within 1e-4 of the map's max abs (1), the
scores within 1e-4 relative, the FD change within 1e-6 of the covariances'
traces (a difference of two fp32 W2 values). These use 400 real and
generated feature rows over 128 dimensions, so the covariances are full
rank: with fewer rows than dimensions the eigen-term's gradient at
eigenvalues ~0 is rounding noise in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.evaluation import heatmaps as jheat
from faceposegenerator_tpu.models import convnext as jcn
from faceposegenerator_tpu.models import dinov2 as jdino
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.evaluation import heatmaps
from faceposegenerator_tpu_torch.models import convnext, dinov2
from test_torch_dgm import TINY_VIT
from test_torch_eval_vits import numpy_init


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_dino():
    """JAX's tiny DINOv2 tree and the port module holding it (fp32)."""
    cfg = jdino.DINOv2Config(**TINY_VIT)
    params = numpy_init(jdino.init, cfg, 0)
    model = load_jax_params(dinov2.DINOv2(dinov2.DINOv2Config(**TINY_VIT), device="cpu"),
                            jax.tree.map(np.asarray, params))
    return params, cfg, model


def _feature_rows(d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((400, d)), 0.2 + 1.1 * rng.standard_normal((400, d))


TINY_CNX = dict(depths=(1, 1), dims=(16, 128))  # 128 features, as the tiny ViT: JAX compiles its W2 ops once


def _jitted(encode_with_tap):
    """A JAX encoder with a tap as two jitted programs: JAX's GradCAM calls
    its encoder op by op (seconds of small compiles). The activation comes
    from the first; JAX's own tap gives a + ε, and (a + ε) − a = ε goes into
    the second, the whole encoder with ε added at the tap, whose gradient in
    ε is the hook gradient."""

    @jax.jit
    def act_of(x):
        out = {}
        encode_with_tap(x, lambda a: out.setdefault("a", a))
        return out["a"]

    full = jax.jit(lambda x, e: encode_with_tap(x, lambda a: a + e.astype(a.dtype)))

    def encode(x, tap):
        act = act_of(x)
        return full(x, tap(act) - act)

    return encode


def _gradcam_cases(tiny_dino):
    params, cfg, model = tiny_dino
    cparams = numpy_init(jcn.init, jcn.ConvNeXtConfig(**TINY_CNX), 1)
    cmodel = load_jax_params(convnext.ConvNeXt(convnext.ConvNeXtConfig(**TINY_CNX), device="cpu"),
                             jax.tree.map(np.asarray, cparams))

    return {
        "dinov2": (_jitted(lambda x, tap: jdino.cls_feature(params, x, cfg, JPOLICY, tap=tap)),
                   lambda x, tap: model.cls_feature(x, PARITY_POLICY, tap=tap), (1, 28, 28, 3), 128),
        "convnext": (_jitted(lambda x, tap: jcn.apply(cparams, x, jcn.ConvNeXtConfig(**TINY_CNX), tap=tap)),
                     heatmaps.make_convnext_gradcam_encoder(cmodel), (1, 32, 32, 3), 128),
    }


@pytest.mark.parametrize("name", ["dinov2", "convnext"])
def test_gradcam_matches_jax(name, tiny_dino):
    jenc, enc, shape, d = _gradcam_cases(tiny_dino)[name]
    real, gen = _feature_rows(d, 6)
    image = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want_heat, want_delta = jheat.GradCAM(jenc, real, gen).get_map(image, 3)
    heat, delta = heatmaps.GradCAM(enc, real, gen, device="cpu").get_map(image, 3)
    assert heat.shape == want_heat.shape and np.abs(heat - want_heat).max() <= 1e-4
    # the FD change is a difference of two fp32 W2 values of the order of the
    # covariances' traces: within 1e-6 of those
    scale = np.trace(np.cov(real, rowvar=False)) + np.trace(np.cov(gen, rowvar=False))
    assert abs(delta - want_delta) <= 1e-6 * scale


def test_make_heatmap_fn_matches_jax(tiny_dino):
    params, cfg, model = tiny_dino
    real, _ = _feature_rows(128, 8)
    images = np.random.default_rng(9).standard_normal((2, 28, 28, 3)).astype(np.float32)
    jmu, jprec = jheat.fit_real_gaussian(real)
    want_scores, want_maps = jheat.make_heatmap_fn(
        lambda x: jdino.cls_feature(params, x, cfg, JPOLICY), jmu, jprec)(jnp.asarray(images))
    mu, prec = heatmaps.fit_real_gaussian(real, device="cpu")
    fn = heatmaps.make_heatmap_fn(lambda x: model.cls_feature(x, PARITY_POLICY), mu, prec, device="cpu")
    scores, maps = fn(images)
    assert maps.shape == (2, 28, 28) and float(maps.max()) == 1.0
    assert np.abs(scores.numpy() - np.asarray(want_scores)).max() <= 1e-4 * np.abs(np.asarray(want_scores)).max()
    assert np.abs(maps.numpy() - np.asarray(want_maps)).max() <= 1e-4
