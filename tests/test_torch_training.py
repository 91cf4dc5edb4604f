"""The port's ID-Booth train step and its new modules against the JAX
package, on the TINY bundle of tests/test_idbooth_trainer.py at 64², fp32
(JAX PARITY_POLICY; the port's PARITY_POLICY, TF32 off), on the CPU.

One change to TINY: the UNet's GroupNorm has 8 groups, not 32. At 64² the
TINY UNet's last level is 1×1, where 32 groups over 64 channels normalise 2
values each; the loss is then so ill-conditioned in the LoRA that fp32
reassociation alone moves its gradients by tens of percent (both packages
disagree with a finite difference). With 8 groups the two agree to ~1e-5.

Weights are JAX `init` trees carried into the port by
`bridge.jax_params.load_jax_params`; inputs are numpy arrays from a seed.
The loss takes JAX's own draws (latent noise, noise, timesteps), replayed
from the same key, so the two random streams never need to match. JAX's
`value_and_grad` is jitted once per loss mode and module, and its result
cached per batch.

The stacked step (K = 2 identities in one batch, `identities=2`) is held
per identity to JAX's single step on that identity's batch and draws (JAX's
multi-identity step is that step under `vmap`) with the tolerances below,
and its update to two serial port updates within 1e-6 (where the gradient
is at least 1e-6; see the test).

Tolerances: IResNet and the VAE encoder 2e-4 (the repo's parity tolerance
for full tiny networks); crop_and_resize 1e-5; the scheduler ops 1e-6; the
optimizer 1e-6 over 3 steps; loss and metrics 2e-4 relative; every LoRA
gradient leaf within 1e-3 of JAX's, relative to that leaf's max abs.
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
from faceposegenerator_tpu.models import iresnet as jiresnet
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.models import vae as jvae
from faceposegenerator_tpu.ops import image as jimage
from faceposegenerator_tpu.training import idbooth as jidbooth
from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch, load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.core.rng import train_step_generator
from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
from faceposegenerator_tpu_torch.models import clip_text, iresnet, unet2d, vae
from faceposegenerator_tpu_torch.ops import image
from faceposegenerator_tpu_torch.training import idbooth, multi_identity

JTINY = jidbooth.ModelBundle(
    text_cfg=jclip.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
    unet_cfg=junet.UNetConfig(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32, head_dim=8,
                              norm_groups=8),
    vae_cfg=jvae.VAEConfig(block_out_channels=(32, 32, 32, 32)),
    arcface_cfg=jiresnet.config_for("r18", num_features=64),
)
TINY = idbooth.ModelBundle(
    text_cfg=clip_text.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
    unet_cfg=unet2d.UNetConfig(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32, head_dim=8,
                               norm_groups=8),
    vae_cfg=vae.VAEConfig(block_out_channels=(32, 32, 32, 32)),
    arcface_cfg=iresnet.config_for("r18", num_features=64),
)
N, RES = 4, 64  # 2 instance + 2 class images


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    """{path: array} over a nested dict/list tree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items() for p, a in _paths(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: a for i, v in enumerate(tree) for p, a in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


@pytest.fixture(scope="module")
def setup():
    PARITY_POLICY.configure_backends()
    ap, ast = jiresnet.init(jax.random.key(3), JTINY.arcface_cfg)
    jfrozen = {
        "text_encoder": jclip.init(jax.random.key(0), JTINY.text_cfg),
        "unet": junet.init(jax.random.key(1), JTINY.unet_cfg),
        "vae": jvae.init(jax.random.key(2), JTINY.vae_cfg),
        "arcface": {"params": ap, "state": ast},
    }
    p = _np(jfrozen)
    frozen = {
        "text_encoder": load_jax_params(clip_text.CLIPTextModel(TINY.text_cfg, device="cpu"), p["text_encoder"]),
        "unet": load_jax_params(unet2d.UNet2DCondition(TINY.unet_cfg, device="cpu"), p["unet"]),
        "vae": load_jax_params(vae.AutoencoderKL(TINY.vae_cfg, device="cpu"), p["vae"]),
        "arcface": load_jax_params(iresnet.IResNet(TINY.arcface_cfg, device="cpu"),
                                   p["arcface"]["params"], p["arcface"]["state"]),
    }
    rng = np.random.default_rng(0)
    batch = {
        "pixel_values": rng.uniform(-1, 1, (N, RES, RES, 3)).astype(np.float32),
        "input_ids": rng.integers(0, 64, (N, 77)),
        "gt_embeds": rng.standard_normal((N, 64)).astype(np.float32),
    }
    # JAX's draws for key 0, replayed as its loss_fn makes them (idbooth.py:194-201)
    key = jax.random.key(0)
    draws = _jax_draws(key)
    jtrainable = jidbooth.init_trainable(jax.random.key(4), jidbooth.IDBoothConfig(), JTINY, jfrozen["unet"])
    # a second identity: its own batch, draws (key 1) and a LoRA with nonzero B
    rng = np.random.default_rng(1)
    batch2 = {
        "pixel_values": rng.uniform(-1, 1, (N, RES, RES, 3)).astype(np.float32),
        "input_ids": rng.integers(0, 64, (N, 77)),
        "gt_embeds": rng.standard_normal((N, 64)).astype(np.float32),
    }
    jtrainable2 = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.01 * jax.random.normal(jax.random.key(len(str(p))), x.shape) if p[-1].key == "b" else x,
        jtrainable)
    return dict(jfrozen=jfrozen, frozen=frozen, batch=batch, key=key, draws=draws, jtrainable=jtrainable,
                batch2=batch2, key2=jax.random.key(1), draws2=_jax_draws(jax.random.key(1)), jtrainable2=jtrainable2)


def _jax_draws(key):
    """JAX's draws for `key`, replayed as its loss_fn makes them (idbooth.py:194-201)."""
    k_lat, k_noise, k_t = jax.random.split(key, 3)
    shape = (N, RES // 8, RES // 8, 4)
    return {
        "latent_noise": np.array(jax.random.normal(k_lat, shape, jnp.float32)),
        "noise": np.array(jax.random.normal(k_noise, shape, jnp.float32)),
        "timesteps": np.array(jax.random.randint(k_t, (N,), 0, 1000)),
    }


_JAX_FNS: dict = {}
_JAX_REFS: dict = {}


def _jax_ref(setup, which_loss, second=False):
    """JAX (loss, metrics, grads) for this loss mode on the first identity's
    batch and LoRA (or the second's), each computed once, one compile a mode."""
    if which_loss not in _JAX_FNS:
        cfg = jidbooth.IDBoothConfig(which_loss=which_loss, resolution=RES, train_batch_size=N // 2)
        loss_fn = jidbooth.make_loss_fn(cfg, JTINY, jmake_ddpm(), policy=JPOLICY)
        _JAX_FNS[which_loss] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    if (which_loss, second) not in _JAX_REFS:
        suffix = "2" if second else ""
        batch = {k: jnp.asarray(v) for k, v in setup["batch" + suffix].items()}
        (loss, metrics), grads = _JAX_FNS[which_loss](setup["jtrainable" + suffix], setup["jfrozen"], batch,
                                                      setup["key" + suffix])
        _JAX_REFS[which_loss, second] = (float(loss), {k: float(v) for k, v in metrics.items()}, _np(grads))
    return _JAX_REFS[which_loss, second]


def _port_trainable(setup, suffix=""):
    lora = jax_tree_to_torch(_np(setup["jtrainable" + suffix]["unet_lora"]), "cpu", torch.float32)
    for leaf in idbooth.tree_leaves(lora):
        leaf.requires_grad_(True)
    return {"unet_lora": lora}


def _port_batch(setup, suffix=""):
    b = setup["batch" + suffix]
    return {"pixel_values": torch.from_numpy(b["pixel_values"]), "input_ids": torch.from_numpy(b["input_ids"]),
            "gt_embeds": torch.from_numpy(b["gt_embeds"])}


def _port_draws(setup, suffix=""):
    return {k: torch.from_numpy(v) for k, v in setup["draws" + suffix].items()}


def test_iresnet_r18_eval_matches_jax():
    """IResNet r18 inference forward with non-trivial BatchNorm statistics,
    PReLU slopes and head, params and state both carried by the bridge."""
    cfg = jiresnet.config_for("r18", num_features=64)
    params, state = jiresnet.init(jax.random.key(5), cfg)
    rng = np.random.default_rng(5)

    def jitter(tree, lo, hi):
        return jax.tree.map(lambda a: a * rng.uniform(lo, hi, a.shape).astype(np.float32), _np(tree))

    params = jitter(params, 0.5, 1.5)
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: (a * rng.uniform(0.5, 1.5, a.shape) + 0.1 * rng.standard_normal(a.shape))
                         .astype(np.float32), _np(state))
    state = jax.tree.map(np.abs, state)  # variances stay positive; means may be any sign
    face = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    ref, _ = jiresnet.apply(params, state, jnp.asarray(face), cfg, policy=JPOLICY, train=False)
    model = load_jax_params(iresnet.IResNet(iresnet.config_for("r18", num_features=64), device="cpu"), params, state)
    with torch.no_grad():
        out = model(torch.from_numpy(face), PARITY_POLICY)
    assert out.dtype == torch.float32 and out.shape == (2, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_vae_encode_matches_jax(setup):
    p = setup["jfrozen"]["vae"]
    pix = setup["batch"]["pixel_values"]
    mean, logvar = jvae.encode_moments(p, jnp.asarray(pix), JTINY.vae_cfg, JPOLICY)
    model = setup["frozen"]["vae"]
    with torch.no_grad():
        tm, tl = model.encode_moments(torch.from_numpy(pix), PARITY_POLICY)
    assert tm.shape == (N, RES // 8, RES // 8, 4) and tm.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(mean), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logvar), atol=2e-4, rtol=2e-4)
    k = jax.random.key(9)
    ref = jvae.sample_latents((mean, logvar), k, JTINY.vae_cfg)
    noise = np.array(jax.random.normal(k, mean.shape, mean.dtype))
    out = model.sample_latents((tm, tl), torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_crop_and_resize_values_and_grads_match_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (3, 20, 24, 3)).astype(np.float32)
    boxes = np.array([[0.0, 0.0, 24.0, 20.0], [2.3, 1.7, 15.2, 18.9], [-4.0, 3.5, 30.0, 12.25]], np.float32)
    cot = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: jimage.crop_and_resize(x, jnp.asarray(boxes), 16), jnp.asarray(img))
    (ref_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(img).requires_grad_()
    out = image.crop_and_resize(x, torch.from_numpy(boxes), 16)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), atol=1e-5, rtol=1e-5)
    face = rng.uniform(0, 255, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(image.normalize_to_arcface(torch.from_numpy(face)).numpy(),
                               np.asarray(jimage.normalize_to_arcface(jnp.asarray(face))), atol=1e-6)


def test_scheduler_train_ops_match_jax():
    """add_noise and pred_original at per-sample timesteps; the integer form
    of pred_original (the sampler's) agrees with the tensor form."""
    rng = np.random.default_rng(7)
    x0, noise, eps = (rng.standard_normal((4, 8, 8, 4)).astype(np.float32) for _ in range(3))
    t = np.array([0, 17, 500, 999])
    js, ts = jmake_ddpm(), make_ddpm()
    assert ts.num_train_timesteps == 1000
    ref = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    out = ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    ref = js.pred_original(jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x0))
    out = ts.pred_original(torch.from_numpy(eps), torch.from_numpy(t), torch.from_numpy(x0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)
    one = ts.pred_original(torch.from_numpy(eps[1:2]), 17, torch.from_numpy(x0[1:2]))
    np.testing.assert_allclose(one.numpy(), out[1:2].numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 2])
def test_optimizer_matches_optax(warmup):
    """Three updates on given gradients (global norms above and below the
    clip) against optax: warmup-cosine LR, clip_by_global_norm, AdamW."""
    cfg = jidbooth.IDBoothConfig(learning_rate=1e-2, lr_warmup_steps=warmup, max_grad_norm=1.0)
    rng = np.random.default_rng(8)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32), "b": rng.standard_normal((8, 4)).astype(np.float32)}
    grads = [{k: (s * rng.standard_normal(v.shape) / np.sqrt(v.size * 2)).astype(np.float32) for k, v in params.items()}
             for s in (3.0, 0.5, 2.0)]
    jopt = jidbooth.make_optimizer(cfg, total_steps=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    topt = idbooth.make_optimizer(cfg, total_steps=5)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for g in grads:
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.update([torch.from_numpy(g[k]) for k in tp], tstate, tp)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
    assert tstate["count"] == 3


@pytest.mark.parametrize("which_loss", ["", "identity", "triplet_prior"])
def test_loss_and_grads_match_jax(setup, which_loss):
    loss, metrics, grads = _jax_ref(setup, which_loss)
    cfg = idbooth.IDBoothConfig(which_loss=which_loss, resolution=RES, train_batch_size=N // 2)
    loss_fn = idbooth.make_loss_fn(cfg, TINY, make_ddpm(), policy=PARITY_POLICY)
    trainable = _port_trainable(setup)
    tloss, tmetrics = loss_fn(trainable, setup["frozen"], _port_batch(setup), draws=_port_draws(setup))
    assert set(tmetrics) == set(metrics)
    np.testing.assert_allclose(float(tloss.detach()), loss, rtol=2e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), v, rtol=2e-4, atol=1e-7)
    params = idbooth.tree_leaves(trainable)
    tgrads = torch.autograd.grad(tloss, params)
    ref = _paths(grads["unet_lora"])
    mine = {path: g.numpy() for path, g in zip(_paths(trainable["unet_lora"]), tgrads)}
    assert set(mine) == set(ref)
    for path, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-12)
        err = float(np.abs(mine[path] - r).max()) / scale
        assert err <= 1e-3, (path, err)


def test_loss_and_grads_fused_gn_match_jax(setup, monkeypatch):
    """triplet_prior (the UNet, the VAE encode and the decode with its
    gradient) with GN_IMPL and GN_CONV_IMPL at pallas, against the JAX XLA
    path with the tolerances above. On the CPU K3 and K4 run their plain
    versions, and the decode's gradient goes through their autograd
    Functions; every routed call satisfies the JAX predicates."""
    from faceposegenerator_tpu.ops import fused_gn as jfg
    from faceposegenerator_tpu.ops import fused_gn_conv as jfgc
    from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv

    monkeypatch.setattr(fused_gn, "_GN_IMPL", "pallas")
    monkeypatch.setattr(fused_gn_conv, "_IMPL", "pallas")
    routed = {"fused_group_norm": [], "gn_silu_conv3x3": []}
    for module, name in ((fused_gn, "fused_group_norm"), (fused_gn_conv, "gn_silu_conv3x3")):
        def recorded(x, *args, fn=getattr(module, name), name=name):
            # (shape, groups) of K3's calls; (shape, Cout, groups) of K4's
            routed[name].append((tuple(x.shape), args[2]) if name == "fused_group_norm" else
                                (tuple(x.shape), args[2].out_channels, args[3]))
            return fn(x, *args)

        monkeypatch.setattr(module, name, recorded)
    loss, metrics, grads = _jax_ref(setup, "triplet_prior")
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=RES, train_batch_size=N // 2)
    loss_fn = idbooth.make_loss_fn(cfg, TINY, make_ddpm(), policy=PARITY_POLICY)
    trainable = _port_trainable(setup)
    tloss, tmetrics = loss_fn(trainable, setup["frozen"], _port_batch(setup), draws=_port_draws(setup))
    np.testing.assert_allclose(float(tloss.detach()), loss, rtol=2e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), v, rtol=2e-4, atol=1e-7)
    tgrads = torch.autograd.grad(tloss, idbooth.tree_leaves(trainable))
    ref = _paths(grads["unet_lora"])
    for path, g in zip(_paths(trainable["unet_lora"]), tgrads):
        scale = max(float(np.abs(ref[path]).max()), 1e-12)
        assert float(np.abs(g.numpy() - ref[path]).max()) / scale <= 1e-3, path
    assert routed["fused_group_norm"] and routed["gn_silu_conv3x3"]
    for (n, h, w, cin), cout, groups in routed["gn_silu_conv3x3"]:
        assert jfgc.supported(n, h, w, cin, cout, groups)
    for shape, groups in routed["fused_group_norm"]:
        assert jfg.slab_supported(shape[0], int(np.prod(shape[1:-1])), shape[-1], groups)


def test_train_step_matches_jax(setup):
    """One make_train_step update (triplet_prior) against JAX's: the JAX side
    applies its optimizer to its own gradients, which is the body of its
    make_train_step (idbooth.py:327-333). Adam's first step is sign-like
    where |g| is near zero, so elements with |g| < 1e-6·max|g| are left out."""
    loss, metrics, grads = _jax_ref(setup, "triplet_prior")
    jcfg = jidbooth.IDBoothConfig(which_loss="triplet_prior", resolution=RES, train_batch_size=N // 2)
    jopt = jidbooth.make_optimizer(jcfg, total_steps=10)
    upd, _ = jopt.update(grads, jopt.init(setup["jtrainable"]), setup["jtrainable"])
    jnew = optax.apply_updates(setup["jtrainable"], upd)

    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=RES, train_batch_size=N // 2)
    opt = idbooth.make_optimizer(cfg, total_steps=10)
    trainable = _port_trainable(setup)
    opt_state = opt.init(trainable)
    step = idbooth.make_train_step(cfg, TINY, opt, policy=PARITY_POLICY)
    trainable, opt_state, tmetrics = step(trainable, opt_state, setup["frozen"], _port_batch(setup),
                                          draws=_port_draws(setup))
    np.testing.assert_allclose(float(tmetrics["loss"]), loss, rtol=2e-4)
    np.testing.assert_allclose(float(tmetrics["grad_norm"]), float(optax.global_norm(grads)), rtol=1e-3)
    ref, g, mine = _paths(jnew["unet_lora"]), _paths(grads["unet_lora"]), _paths(trainable["unet_lora"])
    moved = 0
    for path, r in ref.items():
        keep = np.abs(g[path]) >= 1e-6 * np.abs(g[path]).max()
        np.testing.assert_allclose(mine[path][keep], np.asarray(r)[keep], atol=1e-6, rtol=1e-5)
        moved += int(keep.sum())
    assert moved > 0


def test_identity_chunk_must_divide_the_instance_batch(setup):
    rng = np.random.default_rng(10)
    batch = {"pixel_values": torch.from_numpy(rng.uniform(-1, 1, (6, RES, RES, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(rng.integers(0, 64, (6, 77))),
             "gt_embeds": torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))}
    trainable = _port_trainable(setup)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    for bad in (2, 4, 0, -1):
        cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", train_batch_size=3, identity_chunk=bad)
        loss_fn = idbooth.make_loss_fn(cfg, TINY, make_ddpm(), policy=PARITY_POLICY)
        with pytest.raises(ValueError, match="identity_chunk"):
            loss_fn(trainable, setup["frozen"], batch, gen())
    for ok in (1, 3):
        cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", train_batch_size=3, identity_chunk=ok)
        loss, _ = idbooth.make_loss_fn(cfg, TINY, make_ddpm(), policy=PARITY_POLICY)(
            trainable, setup["frozen"], batch, gen())
        assert np.isfinite(float(loss.detach()))


def test_memory_knobs_change_nothing_but_memory(setup):
    """gradient_checkpointing, remat_identity and identity_chunk give the
    same loss and gradients as the plain step (fp32 reassociation only)."""
    outs = []
    for kw in ({}, {"gradient_checkpointing": True}, {"remat_identity": True}, {"remat_identity": True, "identity_chunk": 1}):
        cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", train_batch_size=N // 2, **kw)
        trainable = _port_trainable(setup)
        loss, m = idbooth.make_loss_fn(cfg, TINY, make_ddpm(), policy=PARITY_POLICY)(
            trainable, setup["frozen"], _port_batch(setup), draws=_port_draws(setup))
        grads = torch.autograd.grad(loss, idbooth.tree_leaves(trainable))
        outs.append((float(loss.detach()), float(m["id_loss"]), grads))
    for loss, id_loss, grads in outs[1:]:
        np.testing.assert_allclose(loss, outs[0][0], rtol=1e-6)
        np.testing.assert_allclose(id_loss, outs[0][1], rtol=1e-6)
        for a, b in zip(grads, outs[0][2]):
            assert float((a - b).norm()) <= 1e-4 * max(float(b.norm()), 1e-12)


def test_init_trainable_and_generator(setup):
    """init_trainable has JAX init_trainable's layout (fp32, zero B, A
    requiring grad); train_step_generator is a function of (seed, step)."""
    cfg = idbooth.IDBoothConfig()
    t = idbooth.init_trainable(4, cfg, TINY, setup["frozen"]["unet"])
    mine = {p: a.shape for p, a in _paths(t).items()}
    ref = {p: a.shape for p, a in _paths(_np(setup["jtrainable"])).items()}
    assert mine == ref
    for path, leaf in zip(_paths(t), idbooth.tree_leaves(t)):
        assert leaf.dtype == torch.float32 and leaf.requires_grad
        if path.endswith("/b"):
            assert float(leaf.abs().max()) == 0.0
    draws = [idbooth.draw((2, 4, 4, 4), 2, 1000, train_step_generator(0, s, "cpu"), "cpu") for s in (3, 3, 4)]
    torch.testing.assert_close(draws[0]["noise"], draws[1]["noise"])
    assert not torch.equal(draws[0]["noise"], draws[2]["noise"])
    boxes, found = idbooth.full_image_boxes(torch.zeros(2, 30, 40, 3))
    assert boxes.tolist() == [[0.0, 0.0, 40.0, 30.0]] * 2 and bool(found.all())


@pytest.fixture
def one_thread():
    """Torch on one thread within the test: the test workers share the
    machine's cores, and a thread pool per worker oversubscribes them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_stacked_step_matches_jax_per_identity(setup, one_thread):
    """Two identities in one stacked loss (triplet_prior): each one's loss,
    metrics and LoRA gradients against JAX's single step on its own batch,
    draws and LoRA, with the tolerances above."""
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=RES, train_batch_size=N // 2)
    loss_fn = idbooth.make_loss_fn(cfg, TINY, make_ddpm(), policy=PARITY_POLICY, identities=2)
    trainables = multi_identity.stack_pytrees([_port_trainable(setup), _port_trainable(setup, "2")])
    batches = {k: torch.stack([a, b]) for (k, a), b in zip(_port_batch(setup).items(), _port_batch(setup, "2").values())}
    loss, metrics = loss_fn(trainables, setup["frozen"], batches, draws=[_port_draws(setup), _port_draws(setup, "2")])
    grads = torch.autograd.grad(loss, idbooth.tree_leaves(trainables))
    paths = list(_paths(trainables["unet_lora"]))
    for i, second in enumerate((False, True)):
        ref_loss, ref_metrics, ref_grads = _jax_ref(setup, "triplet_prior", second)
        assert set(metrics) == set(ref_metrics) and metrics["loss"].shape == (2,)
        for k, v in ref_metrics.items():
            np.testing.assert_allclose(float(metrics[k][i]), v, rtol=2e-4, atol=1e-7)
        ref = _paths(ref_grads["unet_lora"])
        for path, g in zip(paths, grads):
            r = ref[path]
            scale = max(float(np.abs(r).max()), 1e-12)
            assert float(np.abs(g[i].numpy() - r).max()) / scale <= 1e-3, (i, path)
    np.testing.assert_allclose(float(loss.detach()), sum(_jax_ref(setup, "triplet_prior", s)[0] for s in (False, True)),
                               rtol=2e-4)


def test_stacked_update_matches_serial_updates(setup, one_thread):
    """One stacked step of two identities (per-identity clip, AdamW over the
    stacked leaves) against one port step of each identity alone: the
    parameters within 1e-6 wherever the gradient is at least 100·eps (1e-6;
    Adam's first step is g / (|g| + eps), so below that the two batch
    shapes' fp32 rounding noise becomes up to a whole step: there within
    2·lr), the moments within 1e-6 + 1e-4 relative; the metrics come back
    per identity. The diffusion loss alone: the identity branch's stacking
    is held to JAX above."""
    cfg = idbooth.IDBoothConfig(which_loss="", resolution=RES, train_batch_size=N // 2)
    serial = []
    for suffix in ("", "2"):
        opt = idbooth.make_optimizer(cfg, total_steps=10)
        trainable = _port_trainable(setup, suffix)
        state = opt.init(trainable)
        step = idbooth.make_train_step(cfg, TINY, opt, policy=PARITY_POLICY)
        serial.append(step(trainable, state, setup["frozen"], _port_batch(setup, suffix),
                           draws=_port_draws(setup, suffix)))
    opt = idbooth.make_optimizer(cfg, total_steps=10)
    trainables = multi_identity.stack_pytrees([_port_trainable(setup), _port_trainable(setup, "2")])
    states = opt.init(trainables)
    batches = {k: torch.stack([a, b]) for (k, a), b in zip(_port_batch(setup).items(), _port_batch(setup, "2").values())}
    step = multi_identity.make_multi_train_step(cfg, TINY, opt, 2, policy=PARITY_POLICY)
    trainables, states, metrics = step(trainables, states, setup["frozen"], batches,
                                       draws=[_port_draws(setup), _port_draws(setup, "2")])
    assert states["count"] == 1 and metrics["grad_norm"].shape == (2,)
    per_id = multi_identity.unstack_pytree(trainables, 2)
    per_state = multi_identity.unstack_pytree(states, 2)
    for i, (t, s, m) in enumerate(serial):
        np.testing.assert_allclose(float(metrics["grad_norm"][i]), float(m["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(metrics["loss"][i]), float(m["loss"]), rtol=1e-5)
        kept = total = 0
        for a, b, m1 in zip(idbooth.tree_leaves(per_id[i]), idbooth.tree_leaves(t), idbooth.tree_leaves(s["exp_avg"])):
            keep = (m1.abs() / (1 - cfg.adam_beta1) >= 1e-6).numpy()  # exp_avg = (1 - β1)·g after one step
            diff = np.abs(a.detach().numpy() - b.detach().numpy())
            assert diff[keep].max(initial=0.0) <= 1e-6 and diff.max() <= 2 * cfg.learning_rate
            kept, total = kept + int(keep.sum()), total + keep.size
        assert kept >= 0.5 * total, (kept, total)
        for key in ("exp_avg", "exp_avg_sq"):
            for a, b in zip(idbooth.tree_leaves(per_state[i][key]), idbooth.tree_leaves(s[key])):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-4)
    moved = [float((a - b).abs().max()) for a, b in zip(idbooth.tree_leaves(per_id[0]), idbooth.tree_leaves(per_id[1]))]
    assert max(moved) > 1e-4  # the two identities' LoRAs differ
