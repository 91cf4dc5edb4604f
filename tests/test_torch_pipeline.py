"""The port's DDPM scheduler and its txt2img slice against the JAX package.

The slice as a whole: tiny CLIP/UNet/VAE from JAX `init` trees, 128², batch
2, 3 DDPM steps, CFG 5.0, a rank-4 LoRA with nonzero B, fp32, the same numpy
`noise_override` on both sides. The latent after each step and the images
must match JAX `sample(..., attn_impl="flash", return_trajectory=True)`
(Pallas in interpret mode) to 1e-3, which lets the per-model 2e-4 compound
over the steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.diffusion import schedulers as jsched
from faceposegenerator_tpu.diffusion import sampler as jsampler
from faceposegenerator_tpu.models import clip_text as jclip
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.models import vae as jvae
from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch, load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.diffusion import sampler, schedulers
from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae
from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

from test_torch_models import TINY_CLIP, TINY_UNET, TINY_VAE, nonzero_lora


@pytest.mark.parametrize("steps", [None, 3, 30])
def test_ddpm_tables_match_jax(steps):
    j = jsched.make_ddpm(num_inference_steps=steps)
    t = schedulers.make_ddpm(num_inference_steps=steps)
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    np.testing.assert_array_equal(t.prev_timesteps, np.asarray(j.prev_timesteps))
    np.testing.assert_array_equal(t.alphas_cumprod, np.asarray(j.alphas_cumprod))
    np.testing.assert_array_equal(t.betas, np.asarray(j.betas))
    assert t.num_inference_steps == j.num_inference_steps


@pytest.mark.parametrize("steps,index", [(30, 0), (30, 17), (30, 29), (None, 999)])
def test_ddpm_step_matches_jax(steps, index):
    """One step on the same (eps, x, noise); index 999 of the full schedule is t = 0 (no noise)."""
    rng = np.random.default_rng(index)
    eps, x, noise = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(3))
    j = jsched.make_ddpm(num_inference_steps=steps)
    t = schedulers.make_ddpm(num_inference_steps=steps)
    jx, jx0 = j.step(jnp.asarray(eps), index, jnp.asarray(x), jnp.asarray(noise))
    tx, tx0 = t.step(torch.from_numpy(eps), index, torch.from_numpy(x), torch.from_numpy(noise))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-5, rtol=1e-5)


S, B, H = 3, 2, 128


@pytest.fixture(scope="module")
def jax_slice():
    """The JAX sample of the slice (and what both sides are given), once per module."""
    jmodels = jsampler.SamplerModels(
        text_cfg=jclip.CLIPTextConfig(**TINY_CLIP), unet_cfg=junet.UNetConfig(**TINY_UNET),
        vae_cfg=jvae.VAEConfig(**TINY_VAE), attn_impl="flash",
    )
    params = {
        "text_encoder": jclip.init(jax.random.key(0), jmodels.text_cfg),
        "unet": junet.init(jax.random.key(1), jmodels.unet_cfg),
        "vae": jvae.init(jax.random.key(2), jmodels.vae_cfg),
    }
    lora = nonzero_lora(params["unet"], seed=3)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1000, (B, 77))
    neg = np.zeros_like(ids)
    noise = rng.standard_normal((S + 1, B, H // 8, H // 8, 4)).astype(np.float32)

    jimg, jtraj = jsampler.sample(
        params, jsched.make_ddpm(num_inference_steps=S), jnp.asarray(ids), jnp.asarray(neg),
        jax.random.key(0), models=jmodels, guidance_scale=5.0, height=H, width=H, policy=JPOLICY,
        lora={"unet": lora, "text_encoder": None}, noise_override=jnp.asarray(noise),
        return_trajectory=True,
    )
    return dict(params=params, lora=lora, ids=ids, neg=neg, noise=noise, jimg=jimg, jtraj=jtraj)


def _port_slice(j):
    """The port's pipeline with the JAX weights and LoRA, and its sample."""
    pmodels = sampler.SamplerModels(
        text_cfg=clip_text.CLIPTextConfig(**TINY_CLIP), unet_cfg=unet2d.UNetConfig(**TINY_UNET),
        vae_cfg=vae.VAEConfig(**TINY_VAE),
    )
    pipe = StableDiffusionPipeline.from_random(models=pmodels, device="cpu", policy=PARITY_POLICY)
    for name, net in pipe.nets.items():
        load_jax_params(net, jax.tree.map(np.asarray, j["params"][name]))
    tlora = {"unet": jax_tree_to_torch(jax.tree.map(np.asarray, j["lora"]), "cpu", torch.float32),
             "text_encoder": None}
    timg, ttraj = sampler.sample(
        pipe.nets, schedulers.make_ddpm(num_inference_steps=S), torch.from_numpy(j["ids"]),
        torch.from_numpy(j["neg"]), guidance_scale=5.0, height=H, width=H, policy=PARITY_POLICY,
        lora=tlora, noise_override=j["noise"], return_trajectory=True,
    )
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(j["jtraj"]), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(timg.numpy(), np.asarray(j["jimg"]), atol=1e-3, rtol=1e-3)
    return pipe, tlora, timg


def test_txt2img_slice_matches_jax_sample(jax_slice):
    ids, noise = jax_slice["ids"], jax_slice["noise"]
    pipe, tlora, timg = _port_slice(jax_slice)

    # the user-facing call takes the same path (missing negative ids mean zeros)
    pipe.set_lora(tlora)
    out = pipe(input_ids=ids, num_inference_steps=S, height=H, width=H, noise_override=noise)
    assert out.shape == (B, H, H, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, timg.numpy(), atol=1e-6, rtol=0)


def test_pipeline_surface():
    pmodels = sampler.SamplerModels(
        text_cfg=clip_text.CLIPTextConfig(**TINY_CLIP), unet_cfg=unet2d.UNetConfig(**TINY_UNET),
        vae_cfg=vae.VAEConfig(**TINY_VAE),
    )
    pipe = StableDiffusionPipeline.from_random(models=pmodels, device="cpu")
    pipe.set_scheduler("dpm")
    assert pipe.scheduler_kind == "dpm"
    with pytest.raises(ValueError, match="unknown scheduler"):
        pipe.set_scheduler("euler")
    pipe.set_scheduler("ddpm")
    pipe.set_lora({"unet": unet2d.init_lora(pipe.nets["unet"]), "text_encoder": None}, 0.5)
    assert pipe.lora is not None and pipe.lora_scale == 0.5
    pipe.unload_lora_weights()
    assert pipe.lora is None
    ids = np.ones((1, 77), np.int64)
    a = pipe(input_ids=ids, num_inference_steps=2, height=64, width=64, seed=3)
    b = pipe(input_ids=ids, num_inference_steps=2, height=64, width=64, seed=3)
    c = pipe(input_ids=ids, num_inference_steps=2, height=64, width=64, seed=4)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
    assert a.shape == (1, 64, 64, 3) and np.isfinite(a).all() and a.min() >= 0 and a.max() <= 1


def test_txt2img_slice_fused_gn_matches_jax_sample(jax_slice, monkeypatch):
    """The same slice with GN_IMPL and GN_CONV_IMPL at pallas (K3 and K4's
    plain versions on the CPU) against the JAX XLA path, within the same 1e-3.
    Per UNet call K4 takes all 44 resblock convs and K3 16 GroupNorms (see
    tests/test_torch_fused_gn_conv.py); K3 takes all 30 of the VAE decoder's
    (at most 128²·32 elements an image): 3·44 and 3·16 + 30 calls."""
    from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv

    monkeypatch.setattr(fused_gn, "_GN_IMPL", "pallas")
    monkeypatch.setattr(fused_gn_conv, "_IMPL", "pallas")
    calls = {"fused_group_norm": 0, "gn_silu_conv3x3": 0}
    for module, name in ((fused_gn, "fused_group_norm"), (fused_gn_conv, "gn_silu_conv3x3")):
        def counted(*args, fn=getattr(module, name), name=name):
            calls[name] += 1
            return fn(*args)

        monkeypatch.setattr(module, name, counted)
    _port_slice(jax_slice)
    assert calls == {"fused_group_norm": 3 * 16 + 30, "gn_silu_conv3x3": 3 * 44}
