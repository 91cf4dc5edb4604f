"""The train step's two options against the JAX package, on the CPU:
gradient accumulation and the text-encoder LoRA.

Accumulation: the port's optimizer against `optax.MultiSteps(k=2)` (JAX
`make_optimizer`) on given gradients over 4 micro-steps, no model: the
parameters bit-unchanged after micro-steps 1 and 3 and within 1e-6 of
optax's after 2 and 4, the schedule counting updates, `scale_lr`
multiplying by k.

Text-encoder LoRA: its init from the seed (JAX's layout, zero B, A of
scale 1/rank), and the loss and every UNet and text LoRA gradient against
JAX at `which_loss=""` (one compile) on the tiny bundle of
tests/test_torch_training.py at 64², fp32, with the tolerances there: the
loss 2e-4 relative, each gradient leaf within 1e-3 of its max abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.diffusion import make_ddpm as jmake_ddpm
from faceposegenerator_tpu.models import clip_text as jclip
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.models import vae as jvae
from faceposegenerator_tpu.training import idbooth as jidbooth
from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch, load_jax_params
from faceposegenerator_tpu_torch.core.tree import tree_paths
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae
from faceposegenerator_tpu_torch.training import idbooth
from test_torch_checkpoints import numpy_init

JTEXT = jclip.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
JUNET = junet.UNetConfig(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32, head_dim=8, norm_groups=8)
JVAE = jvae.VAEConfig(block_out_channels=(32, 32, 32, 32))
JTINY = jidbooth.ModelBundle(text_cfg=JTEXT, unet_cfg=JUNET, vae_cfg=JVAE)
TINY = idbooth.ModelBundle(
    text_cfg=clip_text.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
    unet_cfg=unet2d.UNetConfig(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32, head_dim=8,
                               norm_groups=8),
    vae_cfg=vae.VAEConfig(block_out_channels=(32, 32, 32, 32)),
)
N, RES = 4, 64


def test_accumulation_matches_optax_multisteps():
    cfg = jidbooth.IDBoothConfig(learning_rate=1e-2, gradient_accumulation_steps=2, max_grad_norm=1.0)
    rng = np.random.default_rng(8)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32), "b": rng.standard_normal((8, 4)).astype(np.float32)}
    grads = [{k: (s * rng.standard_normal(v.shape) / np.sqrt(v.size * 2)).astype(np.float32) for k, v in params.items()}
             for s in (3.0, 0.5, 2.0, 0.2)]
    jopt = jidbooth.make_optimizer(cfg, total_steps=3)
    assert isinstance(jopt, optax.MultiSteps)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    topt = idbooth.make_optimizer(idbooth.IDBoothConfig(**cfg.to_dict()), total_steps=3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for i, g in enumerate(grads):
        before = {k: v.clone() for k, v in tp.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.update([torch.from_numpy(g[k]) for k in tp], tstate, tp)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for k in tp:
            if i % 2 == 0:  # micro-steps 1 and 3: nothing moves
                assert torch.equal(tp[k], before[k])
            else:
                assert not torch.equal(tp[k], before[k])
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
        assert tstate["count"] == int(jstate.gradient_step) == (i + 1) // 2
        assert tstate["mini_step"] == int(jstate.mini_step) == (i + 1) % 2
    np.testing.assert_allclose(tstate["exp_avg"]["a"].numpy(), np.asarray(jstate.inner_opt_state[1][0].mu["a"]),
                               atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_stacked_optimizer_is_k_serial_optimizers(accumulate):
    """Stacked mode on given gradients, one identity's norm above the clip
    and one below: each slice within 1e-6 of a serial optimizer on that
    identity alone (the clip per identity), the norms per identity."""
    from faceposegenerator_tpu_torch.training import multi_identity

    cfg = idbooth.IDBoothConfig(learning_rate=1e-2, max_grad_norm=1.0, gradient_accumulation_steps=accumulate)
    rng = np.random.default_rng(3)
    params = [{"a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))} for _ in range(2)]
    grads = [[[torch.from_numpy((s * rng.standard_normal(p.shape) / np.sqrt(p.numel() * 2)).astype(np.float32))
               for p in params[k].values()] for k, s in enumerate((3.0, 0.3))] for _ in range(2 * accumulate)]
    serial = [idbooth.make_optimizer(cfg, total_steps=4) for _ in range(2)]
    states = [opt.init(p) for opt, p in zip(serial, params)]
    stacked_opt = idbooth.make_optimizer(cfg, total_steps=4)
    stacked = multi_identity.stack_pytrees([{k: v.clone() for k, v in p.items()} for p in params])
    stacked_state = stacked_opt.init(stacked)
    for g in grads:
        norms = [opt.update(g[k], st, p) for k, (opt, st, p) in enumerate(zip(serial, states, params))]
        norm = stacked_opt.update([torch.stack([g[0][i], g[1][i]]) for i in range(2)], stacked_state, stacked,
                                  per_identity=True)
        assert norm.shape == (2,) and float(norms[0]) > 1.0 > float(norms[1])
        np.testing.assert_allclose(norm.numpy(), [float(n) for n in norms], rtol=1e-6)
        for k in range(2):
            for name in ("a", "b"):
                np.testing.assert_allclose(stacked[name][k].numpy(), params[k][name].numpy(), atol=1e-6, rtol=1e-6)
    assert stacked_state["count"] == states[0]["count"] == 2


@pytest.mark.parametrize("k", [1, 3])
def test_scale_lr_multiplies_by_the_accumulation(k):
    cfg = idbooth.IDBoothConfig(learning_rate=1e-4, scale_lr=True, gradient_accumulation_steps=k,
                                train_batch_size=2, lr_scheduler="constant")
    assert idbooth.make_optimizer(cfg, 10, num_replicas=2).schedule(5) == pytest.approx(1e-4 * k * 2 * 2)


@pytest.fixture(scope="module")
def setup():
    """JAX `init`'s trees filled from numpy (nothing compiled; see
    tests/test_torch_checkpoints.numpy_init) and the port's nets from them."""
    PARITY_POLICY.configure_backends()
    jfrozen = {
        "text_encoder": numpy_init(jclip.init, JTEXT, 0),
        "unet": numpy_init(junet.init, JUNET, 1),
        "vae": numpy_init(jvae.init, JVAE, 2),
    }
    p = jfrozen
    frozen = {
        "text_encoder": load_jax_params(clip_text.CLIPTextModel(TINY.text_cfg, device="cpu"), p["text_encoder"]),
        "unet": load_jax_params(unet2d.UNet2DCondition(TINY.unet_cfg, device="cpu"), p["unet"]),
        "vae": load_jax_params(vae.AutoencoderKL(TINY.vae_cfg, device="cpu"), p["vae"]),
    }
    return jfrozen, frozen


def test_text_lora_init_from_the_seed(setup):
    jfrozen, frozen = setup
    cfg = idbooth.IDBoothConfig(train_text_encoder=True)
    ref = jidbooth.init_trainable(jax.random.key(0), jidbooth.IDBoothConfig(train_text_encoder=True), JTINY,
                                  jfrozen["unet"], jfrozen["text_encoder"])
    a = idbooth.init_trainable(5, cfg, TINY, frozen["unet"], frozen["text_encoder"])
    b = idbooth.init_trainable(5, cfg, TINY, frozen["unet"], frozen["text_encoder"])
    c = idbooth.init_trainable(6, cfg, TINY, frozen["unet"], frozen["text_encoder"])
    unet_only = idbooth.init_trainable(5, idbooth.IDBoothConfig(), TINY, frozen["unet"], frozen["text_encoder"])
    assert set(unet_only) == {"unet_lora"}
    shapes = {p: tuple(np.shape(x)) for p, x in tree_paths(jax.tree.map(np.asarray, ref))}
    assert {p: tuple(x.shape) for p, x in tree_paths(a)} == shapes and len(shapes) == 256 + 2 * 4 * 2
    for (p, x), y, z in zip(tree_paths(a), idbooth.tree_leaves(b), idbooth.tree_leaves(c)):
        assert x.dtype == torch.float32 and x.requires_grad and torch.equal(x, y)
        if p.endswith("/b"):
            assert float(x.detach().abs().max()) == 0.0
        elif p.startswith("text_lora"):
            assert not torch.equal(x, z)
    for x, y in zip(idbooth.tree_leaves(a["unet_lora"]), idbooth.tree_leaves(unet_only)):
        assert torch.equal(x, y)
    text_a = torch.cat([x.detach().flatten() for p, x in tree_paths(a["text_lora"]) if p.endswith("/a")])
    assert abs(float(text_a.std()) - 1 / cfg.lora_rank) < 0.1 / cfg.lora_rank


@pytest.fixture
def one_thread():
    """Torch on one thread within the test: the test workers share the
    machine's cores, and a thread pool per worker oversubscribes them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_text_encoder_lora_loss_and_grads_match_jax(setup, one_thread):
    """CLIP with grad and its LoRA, the UNet LoRA, both with nonzero B."""
    jfrozen, frozen = setup
    jcfg = jidbooth.IDBoothConfig(which_loss="", resolution=RES, train_batch_size=N // 2, train_text_encoder=True)
    jtrain = jidbooth.init_trainable(jax.random.key(4), jcfg, JTINY, jfrozen["unet"], jfrozen["text_encoder"])
    jtrain = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 * jax.random.normal(jax.random.key(len(str(p))), x.shape) if p[-1].key == "b" else x,
        jtrain)
    rng = np.random.default_rng(0)
    batch = {
        "pixel_values": rng.uniform(-1, 1, (N, RES, RES, 3)).astype(np.float32),
        "input_ids": rng.integers(0, 64, (N, 77)),
        "gt_embeds": rng.standard_normal((N, 64)).astype(np.float32),
    }
    key = jax.random.key(0)
    loss_fn = jidbooth.make_loss_fn(jcfg, JTINY, jmake_ddpm(), policy=JPOLICY)
    # XLA's optimisation passes are most of the compile time, and change no rounding the tolerances see
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jtrain, jfrozen, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    finally:
        jax.config.update("jax_disable_most_optimizations", was)
    k_lat, k_noise, k_t = jax.random.split(key, 3)
    shape = (N, RES // 8, RES // 8, 4)
    draws = {"latent_noise": torch.from_numpy(np.array(jax.random.normal(k_lat, shape, jnp.float32))),
             "noise": torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
             "timesteps": torch.from_numpy(np.array(jax.random.randint(k_t, (N,), 0, 1000)))}

    cfg = idbooth.IDBoothConfig(**jcfg.to_dict())
    trainable = {k: jax_tree_to_torch(jax.tree.map(np.asarray, v), "cpu", torch.float32) for k, v in jtrain.items()}
    for leaf in idbooth.tree_leaves(trainable):
        leaf.requires_grad_(True)
    checksum = sum(float(p.detach().sum()) for p in frozen["text_encoder"].parameters())
    tloss, tmetrics = idbooth.make_loss_fn(cfg, TINY, make_ddpm(), policy=PARITY_POLICY)(
        trainable, frozen, {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=2e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=2e-4, atol=1e-7)
    tgrads = torch.autograd.grad(tloss, idbooth.tree_leaves(trainable))
    ref = dict(tree_paths(jax.tree.map(np.asarray, grads)))
    mine = {p: g.numpy() for (p, _), g in zip(tree_paths(trainable), tgrads)}
    assert set(mine) == set(ref) and any(p.startswith("text_lora") for p in ref)
    for p, r in ref.items():  # (the mid block's 1-token self-attention gives k no gradient)
        scale = max(float(np.abs(r).max()), 1e-12)
        assert float(np.abs(mine[p] - r).max()) / scale <= 1e-3, p
    assert all(float(np.abs(r).max()) > 0 for p, r in ref.items() if p.startswith("text_lora"))
    assert all(p.grad is None for p in frozen["text_encoder"].parameters())
    assert sum(float(p.detach().sum()) for p in frozen["text_encoder"].parameters()) == checksum
