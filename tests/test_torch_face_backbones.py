"""The port's MobileFaceNet, face ViT and backbone registry against the JAX
package, fp32 (JAX PARITY_POLICY, the port's PARITY_POLICY), weights from
JAX `init` carried over by `bridge.jax_params.load_jax_params`, inputs from
a seed; within 2e-4 of the output's max abs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.models import mobilefacenet as jmbf
from faceposegenerator_tpu.models import registry as jregistry
from faceposegenerator_tpu.models import vit_face as jvit
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.models import iresnet, mobilefacenet, registry, vit_face


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=2e-4):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _images(n=2, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 112, 112, 3)).astype(np.float32)


def test_mobilefacenet_matches_jax():
    cfg = jmbf.MBFConfig(blocks=(1, 1, 2, 1))
    params, state = jmbf.init(jax.random.key(0), cfg)
    rng = np.random.default_rng(1)
    state = jax.tree.map(lambda s: s + 0.1 * rng.uniform(0, 1, np.shape(s)).astype(np.float32), state)
    x = _images()
    want = jax.jit(lambda x: jmbf.apply(params, state, x, cfg, policy=JPOLICY))(jnp.asarray(x))
    model = load_jax_params(mobilefacenet.MobileFaceNet(mobilefacenet.MBFConfig(blocks=(1, 1, 2, 1)), device="cpu"),
                            _np(params), _np(state))
    with torch.no_grad():
        _close(model(torch.from_numpy(x), PARITY_POLICY).numpy(), want)


@pytest.mark.parametrize("train", [False, True])
def test_face_vit_matches_jax(train):
    """vit_t's layout at depth 2 and width 64; in training mode, JAX's
    per-sample token mask (from its key) given to the port as `mask`."""
    cfg = dataclasses.replace(jvit.VIT_CONFIGS["vit_t"], depth=2, embed_dim=64, num_heads=4, mask_ratio=0.25)
    params, state = jax.jit(jvit.init, static_argnums=1)(jax.random.key(2), cfg)
    x = _images(seed=3)
    key = jax.random.key(4)
    want = jax.jit(lambda x: jvit.apply(params, state, x, cfg, policy=JPOLICY, train=train, mask_key=key))(
        jnp.asarray(x))
    n = cfg.num_patches
    ranks = jnp.argsort(jnp.argsort(jax.random.uniform(key, (2, n)), axis=1), axis=1)
    mask = torch.from_numpy(np.asarray(ranks < int(n * cfg.mask_ratio)))
    model = load_jax_params(vit_face.FaceViT(vit_face.FaceViTConfig(**dataclasses.asdict(cfg)), device="cpu"),
                            _np(params), _np(state))
    with torch.no_grad():
        got = model(torch.from_numpy(x), PARITY_POLICY, train=train, mask=mask)
        _close(got.numpy(), want)
        if train:  # a generator draws its own mask of the same size
            g = torch.Generator().manual_seed(0)
            assert torch.isfinite(model(torch.from_numpy(x), PARITY_POLICY, train=True, generator=g)).all()


@pytest.mark.parametrize("name", ["r18", "r2060", "mbf", "vit_t", "vit_l"])
def test_registry_configs_match_jax(name):
    """get_model's config is the JAX registry's for each family (r2060
    recomputes its blocks, as in JAX)."""
    _, _, jcfg = jregistry.get_model(name, num_features=256)
    assert dataclasses.asdict(registry.model_config(name, num_features=256)) == dataclasses.asdict(jcfg)


def test_registry_builds_each_family():
    x = torch.from_numpy(_images(1))
    for name, kind in (("r18", iresnet.IResNet), ("mbf", mobilefacenet.MobileFaceNet), ("vit_t", vit_face.FaceViT)):
        model = registry.get_model(name, num_features=128, device="cpu")
        assert isinstance(model, kind)
        with torch.no_grad():
            assert model(x, PARITY_POLICY).shape == (1, 128)
    with pytest.raises(ValueError, match="unknown backbone"):
        registry.get_model("r1000", device="cpu")
