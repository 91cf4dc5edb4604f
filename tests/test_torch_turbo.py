"""The turbo slice against the JAX package: DeepCache's cached UNet forward,
the presets, and the sampler under the turbo preset's settings scaled to a
few steps, fp32 on the CPU.

The models are small (a two-level UNet with one transformer level at head
dim 64, a two-level VAE, a one-layer CLIP) so that JAX's compile of the
segmented sampler stays short; their weights are the port's seeded ones,
carried into a JAX tree by `test_torch_quant.jax_tree`. Both sides run the
same w8a8+vae codes: JAX quantizes, the bridge carries its quantized tree
into the port, the port calibrates its static scales on its own pass and
the scale file carries them back to JAX. Then DPM-Solver++, DeepCache-2, a
guidance interval inside S and a rank-4 LoRA run on the same
`noise_override[0]`; the int8 case runs K8's plain version against JAX's
Pallas kernel in interpret mode. The images are 16² (2² latents): every
quantized site then holds the same codes on both sides, and the images agree
within 1e-3 max abs (measured ≤ 1.2e-7). At 64² some sites flip a code where
the fp32 inputs differ in the last bit (XLA fuses and orders fp32 sums
otherwise), and the first DPM steps amplify that to ~1e-2 on the images;
each site alone matches JAX exactly on the same input (test_torch_quant.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.diffusion import sampler as jsampler
from faceposegenerator_tpu.diffusion import schedulers as jsched
from faceposegenerator_tpu.models import clip_text as jclip
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.models import vae as jvae
from faceposegenerator_tpu.ops import quant as jquant
from faceposegenerator_tpu.pipelines import presets as jpresets
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.diffusion import sampler, schedulers
from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae
from faceposegenerator_tpu_torch.pipelines import presets
from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

from test_torch_quant import jax_tree

UNET = dict(block_out_channels=(64, 64), layers_per_block=1, down_block_has_attn=(True, False),
            cross_attention_dim=64, head_dim=64)
VAE = dict(block_out_channels=(32, 32), layers_per_block=1)
CLIP = dict(vocab_size=1000, hidden_size=64, num_layers=1, num_heads=2, intermediate_size=128)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lora(unet, seed):
    """A rank-4 port LoRA with nonzero B, and its JAX tree."""
    tree = unet2d.init_lora(unet, rank=4, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict) and "a" in node:
            node["b"] = torch.from_numpy(rng.standard_normal(tuple(node["b"].shape)).astype(np.float32) * 0.1)
        elif isinstance(node, dict):
            for v in node.values():
                fill(v)
        elif isinstance(node, list):
            for v in node:
                fill(v)

    fill(tree)
    return tree, jax.tree.map(lambda t: t.numpy(), tree)


def test_presets_match_jax():
    for name in ("turbo", "latency"):
        t, j = presets.get_preset(name), jpresets.get_preset(name)
        assert t.mode_spec() == j.mode_spec() and t.sample_kwargs() == j.sample_kwargs()
        assert (t.scheduler, t.steps, t.quantize, t.quant_calibrate_steps) == (
            j.scheduler, j.steps, j.quantize, j.quant_calibrate_steps)
    with pytest.raises(ValueError, match="unknown preset"):
        presets.get_preset("warp")


@pytest.mark.parametrize("depth", [1])
def test_deepcache_forward_matches_jax(depth):
    """The partial pass over the cache of the same latent is the full pass
    bit for bit; both within 2e-4 of JAX apply_cached."""
    unet = unet2d.UNet2DCondition(unet2d.UNetConfig(**UNET), device="cpu", seed=3)
    tlora, jlora = _lora(unet, 4)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    t = np.asarray([7, 7])
    with torch.no_grad():
        args = (torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(ctx), PARITY_POLICY)
        full, cache = unet.forward_cached(*args, lora=tlora, depth=depth)
        part, cache2 = unet.forward_cached(*args, lora=tlora, depth=depth, cached=cache)
        with pytest.raises(ValueError, match="depth"):
            unet.forward_cached(*args, depth=2)
    torch.testing.assert_close(part, full, atol=0, rtol=0)
    assert cache2 is cache

    apply = jax.jit(lambda p, l, z, c, cached: junet.apply_cached(
        p, z, jnp.asarray(t), c, junet.UNetConfig(**UNET), policy=JPOLICY, lora=l, depth=depth, cached=cached))
    params = jax_tree(unet)
    jfull, jcache = apply(params, jlora, jnp.asarray(z), jnp.asarray(ctx), None)
    jpart, _ = apply(params, jlora, jnp.asarray(z) + 0.5, jnp.asarray(ctx), jcache)
    with torch.no_grad():
        tpart, _ = unet.forward_cached(args[0] + 0.5, *args[1:], lora=tlora, depth=depth, cached=cache)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tpart.numpy(), np.asarray(jpart), atol=2e-4, rtol=2e-4)


# attn impl: batch, steps, deepcache_interval, cfg_interval. "auto": every
# segment kind (cond-only, CFG with DeepCache partial passes, cond-only);
# "flash_int8": the int8 attention at two steps (its per-tensor scales span
# the batch, so one more row puts more codes near a rounding boundary)
TURBO_CASES = {"auto": (2, 5, 2, (1, 4)), "flash_int8": (1, 2, 1, None)}


@pytest.mark.parametrize("attn_impl", sorted(TURBO_CASES))
def test_turbo_slice_matches_jax(attn_impl, tmp_path):
    B, S, dc, civ = TURBO_CASES[attn_impl]
    H = 16
    pmodels = sampler.SamplerModels(text_cfg=clip_text.CLIPTextConfig(**CLIP), unet_cfg=unet2d.UNetConfig(**UNET),
                                    vae_cfg=vae.VAEConfig(**VAE), attn_impl=attn_impl)
    pipe = StableDiffusionPipeline.from_random(seed=6, models=pmodels, device="cpu", policy=PARITY_POLICY)
    tlora, jlora = _lora(pipe.nets["unet"], 7)
    params = {k: jax_tree(net) for k, net in pipe.nets.items()}
    jq = dict(params, unet=jax.jit(jquant.quantize_unet)(params["unet"]),
              vae=jax.jit(jquant.quantize_vae)(params["vae"]))
    for name in ("unet", "vae"):
        load_jax_params(pipe.nets[name], _np(jq[name]))
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 1000, (B, 77))
    pipe.calibrate_quant(input_ids=ids, steps=2, height=H, width=H)
    pipe.save_quant_scales(str(tmp_path / "scales.json"))
    jq = jquant.load_act_scales(jq, str(tmp_path / "scales.json"))
    assert all(w.a is not None for w in pipe.nets["unet"].modules() if hasattr(w, "a"))

    neg = np.zeros_like(ids)
    noise = rng.standard_normal((S + 1, B, H // 8, H // 8, 4)).astype(np.float32)
    kw = dict(deepcache_interval=dc, cfg_interval=civ)
    jmodels = jsampler.SamplerModels(text_cfg=jclip.CLIPTextConfig(**CLIP), unet_cfg=junet.UNetConfig(**UNET),
                                     vae_cfg=jvae.VAEConfig(**VAE), attn_impl=attn_impl)
    jimg = jsampler.sample(
        jq, jsched.make_dpm_solver(num_inference_steps=S), jnp.asarray(ids), jnp.asarray(neg), jax.random.key(0),
        models=jmodels, guidance_scale=5.0, height=H, width=H, policy=JPOLICY, scheduler="dpm",
        lora={"unet": jlora, "text_encoder": None}, noise_override=jnp.asarray(noise), **kw)
    pipe.set_scheduler("dpm")
    pipe.set_lora({"unet": tlora, "text_encoder": None})
    timg = pipe(input_ids=ids, num_inference_steps=S, height=H, width=H, noise_override=noise, **kw)
    assert timg.shape == np.asarray(jimg).shape and np.isfinite(timg).all()
    np.testing.assert_allclose(timg, np.asarray(jimg), atol=1e-3, rtol=0)


def test_sampler_keeps_jax_errors():
    pmodels = sampler.SamplerModels(text_cfg=clip_text.CLIPTextConfig(**CLIP), unet_cfg=unet2d.UNetConfig(**UNET),
                                    vae_cfg=vae.VAEConfig(**VAE))
    pipe = StableDiffusionPipeline.from_random(models=pmodels, device="cpu")
    ids = np.ones((1, 77), np.int64)
    sched = schedulers.make_dpm_solver(num_inference_steps=3)
    with pytest.raises(ValueError, match="cfg_interval"):
        sampler.sample(pipe.nets, sched, ids, ids, scheduler="dpm", height=64, width=64, cfg_interval=(1, 4))
    with pytest.raises(ValueError, match="return_trajectory"):
        sampler.sample(pipe.nets, sched, ids, ids, scheduler="dpm", height=64, width=64, deepcache_interval=2,
                       return_trajectory=True)
    with pytest.raises(TypeError, match="DPMSolverSchedule"):
        sampler.sample(pipe.nets, schedulers.make_ddpm(num_inference_steps=3), ids, ids, scheduler="dpm")
    with pytest.raises(ValueError, match="no quantized sites"):
        pipe.calibrate_quant(input_ids=ids, steps=1, height=64, width=64)
    with pytest.raises(ValueError, match="no tokenizer"):
        pipe.calibrate_quant("a prompt")
