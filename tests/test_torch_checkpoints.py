"""Checkpoints into the port against the JAX package: the diffusers SD2.1
converters and configs, LoRA checkpoint IO, and `from_pretrained` +
`load_lora_weights` + prompts end to end.

A tiny diffusers directory is written from JAX `init`'s trees, filled from
a numpy seed (the UNet through `tests/test_bridge_lora.py`'s emitter, the
VAE's and CLIP's beside it here) with the `safetensors` package,
SD2-style config.json files and a byte-level CLIP tokenizer directory.
Both packages load it: their trees must
be equal leaf for leaf (atol 0) and their configs field for field, also
with the config files missing, with the legacy VAE attention keys, CLIP
keys without the `text_model.` prefix and `.bin` files. LoRA checkpoints
written by either side load into the other's tree unchanged. The pipelines
then run the same prompts, negative prompts and `noise_override`, fp32, and
their images agree within the 1e-3 of tests/test_torch_pipeline.py.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from faceposegenerator_tpu.bridge import torch_weights as jtw
from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.diffusion import lora_io as jlio
from faceposegenerator_tpu.models import clip_text as jclip
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.models import vae as jvae
from faceposegenerator_tpu.pipelines.txt2img import StableDiffusionPipeline as JPipeline
from faceposegenerator_tpu_torch.bridge import torch_weights as tw
from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.diffusion import lora_io
from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

from test_bridge_lora import _conv_sd, _dense_sd, _emit_resblock, _flatten, _norm_sd, _unet_params_to_diffusers_sd
from test_torch_models import TINY_UNET, TINY_VAE
from test_torch_tokenizer import chip_smoke, grid_words, sd2_vocab, write_tokenizer_dir

# the tiny CLIP of test_torch_models with the full 49408-token vocab, so the
# SD2 tokenizer's bos/eos ids (49406/49407) have embeddings
TINY_CLIP = dict(vocab_size=49408, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=256)
PROMPTS = ["face portrait photo of woman sks person, forest background",
           "face side-portrait photo of old man sks person"]
NEGATIVE = "cartoon, cgi, render, illustration, painting, drawing, black and white"


def emit_vae(params, legacy=False):
    """diffusers AutoencoderKL keys; `legacy` spells the mid attention as
    query/key/value/proj_attn."""
    sd = {}
    enc, dec = params["encoder"], params["decoder"]
    names = ("query", "key", "value", "proj_attn") if legacy else ("to_q", "to_k", "to_v", "to_out.0")

    def emit_mid(prefix, mid):
        _emit_resblock(sd, f"{prefix}.resnets.0", mid["res1"], temb=False)
        _emit_resblock(sd, f"{prefix}.resnets.1", mid["res2"], temb=False)
        a = mid["attn"]
        _flatten(f"{prefix}.attentions.0.group_norm", _norm_sd(a["norm"]), sd)
        for key, name in zip(("q", "k", "v", "out"), names):
            _flatten(f"{prefix}.attentions.0.{name}", _dense_sd(a[key]), sd)

    _flatten("encoder.conv_in", _conv_sd(enc["conv_in"]), sd)
    for i, block in enumerate(enc["down_blocks"]):
        for j, rp in enumerate(block["resnets"]):
            _emit_resblock(sd, f"encoder.down_blocks.{i}.resnets.{j}", rp, temb=False)
        if block["downsample"] is not None:
            _flatten(f"encoder.down_blocks.{i}.downsamplers.0.conv", _conv_sd(block["downsample"]), sd)
    emit_mid("encoder.mid_block", enc["mid"])
    _flatten("encoder.conv_norm_out", _norm_sd(enc["norm_out"]), sd)
    _flatten("encoder.conv_out", _conv_sd(enc["conv_out"]), sd)
    _flatten("decoder.conv_in", _conv_sd(dec["conv_in"]), sd)
    emit_mid("decoder.mid_block", dec["mid"])
    for i, block in enumerate(dec["up_blocks"]):
        for j, rp in enumerate(block["resnets"]):
            _emit_resblock(sd, f"decoder.up_blocks.{i}.resnets.{j}", rp, temb=False)
        if block["upsample"] is not None:
            _flatten(f"decoder.up_blocks.{i}.upsamplers.0.conv", _conv_sd(block["upsample"]), sd)
    _flatten("decoder.conv_norm_out", _norm_sd(dec["norm_out"]), sd)
    _flatten("decoder.conv_out", _conv_sd(dec["conv_out"]), sd)
    _flatten("quant_conv", _conv_sd(params["quant_conv"]), sd)
    _flatten("post_quant_conv", _conv_sd(params["post_quant_conv"]), sd)
    return sd


def emit_clip(params, prefix="text_model."):
    sd = {f"{prefix}embeddings.token_embedding.weight": np.asarray(params["token_embedding"]),
          f"{prefix}embeddings.position_embedding.weight": np.asarray(params["position_embedding"])}
    _flatten(f"{prefix}final_layer_norm", _norm_sd(params["final_ln"]), sd)
    for i, layer in enumerate(params["layers"]):
        p = f"{prefix}encoder.layers.{i}"
        _flatten(f"{p}.layer_norm1", _norm_sd(layer["ln1"]), sd)
        for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            _flatten(f"{p}.self_attn.{name}", _dense_sd(layer[key]), sd)
        _flatten(f"{p}.layer_norm2", _norm_sd(layer["ln2"]), sd)
        _flatten(f"{p}.mlp.fc1", _dense_sd(layer["fc1"]), sd)
        _flatten(f"{p}.mlp.fc2", _dense_sd(layer["fc2"]), sd)
    return sd


def configs(unet_cfg, vae_cfg, text_cfg):
    """SD2-style config.json contents (attention_head_dim: heads per level)."""
    C = list(unet_cfg.block_out_channels)
    return {
        "unet": {"_class_name": "UNet2DConditionModel", "in_channels": 4, "out_channels": 4,
                 "block_out_channels": C, "layers_per_block": unet_cfg.layers_per_block,
                 "cross_attention_dim": unet_cfg.cross_attention_dim,
                 "attention_head_dim": [c // unet_cfg.head_dim for c in C], "norm_num_groups": 32,
                 "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D"
                                      for a in unet_cfg.down_block_has_attn],
                 "freq_shift": 0, "flip_sin_to_cos": True, "sample_size": 64},
        "vae": {"_class_name": "AutoencoderKL", "in_channels": 3, "latent_channels": 4,
                "block_out_channels": list(vae_cfg.block_out_channels),
                "layers_per_block": vae_cfg.layers_per_block,
                "scaling_factor": 0.18215},
        "text_encoder": {"architectures": ["CLIPTextModel"], "vocab_size": text_cfg.vocab_size,
                         "hidden_size": text_cfg.hidden_size, "num_hidden_layers": text_cfg.num_layers,
                         "num_attention_heads": text_cfg.num_heads,
                         "intermediate_size": text_cfg.intermediate_size, "max_position_embeddings": 77,
                         "hidden_act": "gelu"},
    }


# a smaller set for the pipeline tests (JAX compiles each option set's
# sampler anew): tests/test_torch_turbo.py's two-level UNet and one-layer
# CLIP, and a four-level VAE (JAX's decode_chunk needs 8× upsampling)
SMALL = (dict(block_out_channels=(64, 64), layers_per_block=1, down_block_has_attn=(True, False),
              cross_attention_dim=64, head_dim=64),
         dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1),
         dict(TINY_CLIP, num_layers=1, num_heads=2, intermediate_size=128))


def numpy_init(init, cfg, seed):
    """JAX `init`'s tree for `cfg` (its structure, from `jax.eval_shape`,
    so nothing is compiled) filled from a numpy seed at init's scales: norm
    scales about 1, small biases, dense (out, in) and conv HWIO weights
    uniform in ±1/sqrt(fan_in), embeddings at 0.02, and batch-norm running
    statistics and PReLU slopes near their initial 0, 1 and 0.25."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "g":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            x = rng.uniform(0.8, 1.2, shape)
        elif name.startswith("prelu"):
            x = 0.25 + 0.05 * rng.standard_normal(shape)
        elif name in ("b", "mean"):
            x = 0.02 * rng.standard_normal(shape)
        elif name == "w":
            fan_in = shape[-1] if len(shape) == 2 else int(np.prod(shape[:-1]))
            x = rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)
        else:
            x = 0.02 * rng.standard_normal(shape)
        return x.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def jax_params(seed=0, small=False):
    unet, vae_, clip = SMALL if small else (TINY_UNET, TINY_VAE, TINY_CLIP)
    cfgs = (junet.UNetConfig(**unet), jvae.VAEConfig(**vae_), jclip.CLIPTextConfig(**clip))
    params = {
        "unet": numpy_init(junet.init, cfgs[0], seed + 1),
        "vae": numpy_init(jvae.init, cfgs[1], seed + 2),
        "text_encoder": numpy_init(jclip.init, cfgs[2], seed),
    }
    return cfgs, params


def write_model_dir(root, params, cfgs, *, legacy_vae=False, clip_prefix="text_model.", bin_files=False,
                    config_files=True, tokenizer=True):
    """A diffusers-format directory of the tiny models; returns its path."""
    sds = {"unet": _unet_params_to_diffusers_sd(params["unet"]),
           "vae": emit_vae(params["vae"], legacy=legacy_vae),
           "text_encoder": emit_clip(params["text_encoder"], prefix=clip_prefix)}
    names = {"unet": "diffusion_pytorch_model", "vae": "diffusion_pytorch_model", "text_encoder": "model"}
    for sub, sd in sds.items():
        (root / sub).mkdir(parents=True, exist_ok=True)
        sd = {k: np.ascontiguousarray(v) for k, v in sd.items()}
        if bin_files:
            torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                       root / sub / ("pytorch_model.bin" if sub == "text_encoder" else "diffusion_pytorch_model.bin"))
        else:
            save_file(sd, str(root / sub / f"{names[sub]}.safetensors"))
    if config_files:
        for sub, cfg in configs(*cfgs).items():
            (root / sub / "config.json").write_text(json.dumps(cfg))
    if tokenizer:
        write_tokenizer_dir(root / "tokenizer", *sd2_vocab(grid_words()))
    return root


def assert_trees_equal(a, b, path="tree"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b) if isinstance(b, dict) else b)
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}.{i}")
    elif a is None:
        assert b is None, path
    else:
        x = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    cfgs, params = jax_params()
    return write_model_dir(tmp_path_factory.mktemp("sd21"), params, cfgs), params, cfgs


VARIANTS = {
    "safetensors": {},
    "legacy vae keys, .bin files": dict(legacy_vae=True, bin_files=True),
    "clip without text_model. prefix": dict(clip_prefix=""),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_load_sd21_params_matches_jax(tmp_path, variant):
    cfgs, params = jax_params()
    d = str(write_model_dir(tmp_path, params, cfgs, tokenizer=False, **VARIANTS[variant]))
    port = tw.load_sd21_params(d)
    ref = jax.tree.map(np.asarray, jtw.load_sd21_params(d))
    assert_trees_equal(port, ref)
    assert_trees_equal(port, params)  # and the converters invert the emitters
    for t, j in zip(tw.configs_from_model_dir(d), jtw.configs_from_model_dir(d)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_configs_default_to_sd21_without_config_files(tmp_path):
    cfgs, params = jax_params()
    d = str(write_model_dir(tmp_path, params, cfgs, config_files=False, tokenizer=False))
    port, ref = tw.configs_from_model_dir(d), jtw.configs_from_model_dir(d)
    for t, j in zip(port, ref):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert port[1].block_out_channels == (320, 640, 1280, 1280) and port[1].head_dim == 64
    # SD2.1-base's own values read back as the port's defaults
    cfg = configs(tw.unet2d.SD21_UNET_CONFIG, tw.vae.SD_VAE_CONFIG, tw.clip_text.SD21_TEXT_CONFIG)
    for sub, c in cfg.items():
        (tmp_path / sub / "config.json").write_text(json.dumps(c))
    assert tw.configs_from_model_dir(str(tmp_path)) == (
        tw.clip_text.SD21_TEXT_CONFIG, tw.unet2d.SD21_UNET_CONFIG, tw.vae.SD_VAE_CONFIG)
    assert cfg["unet"]["attention_head_dim"] == [5, 10, 20, 20]
    with pytest.raises(FileNotFoundError):
        tw.find_weights(str(tmp_path), "missing")


# --- LoRA IO ------------------------------------------------------------------


@pytest.fixture(scope="module")
def loaded(tiny_dir):
    d, params, _ = tiny_dir
    pipe = StableDiffusionPipeline.from_pretrained(str(d), dtype=torch.float32, policy=PARITY_POLICY, device="cpu")
    return pipe, params


def jax_lora(params, seed=3):
    """A nonzero JAX {"unet", "text_encoder"} LoRA (rank 4): JAX's
    zero-filled tree (its structure, from `jax.eval_shape`) filled from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jlio.zero_lora(params["unet"], params["text_encoder"], rank=4))
    return jax.tree.map(lambda x: jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype), shapes)


def _legacy(sd, every=3):
    """Every `every`-th UNet pair in the legacy processor spelling, with an
    `.alpha` of 8 (folded into B as 8 / rank) on another third."""
    out = {}
    modules = sorted({k[: -len(".lora_A.weight")] for k in sd if k.endswith(".lora_A.weight")})
    for i, m in enumerate(modules):
        a, b = sd[f"{m}.lora_A.weight"], sd[f"{m}.lora_B.weight"]
        if m.startswith("unet.") and i % every == 0:
            base, proj = m.rsplit(".", 1) if not m.endswith("to_out.0") else (m[: -len(".to_out.0")], "to_out")
            out[f"{base}.processor.{proj}_lora.down.weight"] = a
            out[f"{base}.processor.{proj}_lora.up.weight"] = b
        elif i % every == 1:
            out[f"{m}.lora_A.default.weight"] = a
            out[f"{m}.lora_B.default.weight"] = b
            out[f"{m}.alpha"] = np.asarray(8.0, np.float32)
        else:
            out[f"{m}.lora_A.weight"] = a
            out[f"{m}.lora_B.weight"] = b
    return out


@pytest.mark.parametrize("case", ["peft", "legacy processor and alpha", "partial"])
def test_lora_state_dicts_load_as_jax(loaded, case):
    pipe, params = loaded
    sd = {k: np.asarray(v) for k, v in jlio.lora_to_state_dict(jax_lora(params)).items()}
    if case == "legacy processor and alpha":
        sd = _legacy(sd)
    elif case == "partial":  # modules left out come back as zero pairs
        keys = sorted(sd)
        sd = {k: sd[k] for i, k in enumerate(keys) if (i // 2) % 3 != 0}
    port = lora_io.lora_from_state_dict(sd, pipe.nets["unet"], pipe.nets["text_encoder"])
    ref = jlio.lora_from_state_dict(sd, params["unet"], params["text_encoder"])
    assert_trees_equal(port, jax.tree.map(np.asarray, ref))
    if case == "partial":
        zero = jax.tree.map(lambda x: float(np.abs(x).max()) == 0.0, jax.tree.map(np.asarray, ref))
        assert any(jax.tree.leaves(zero)) and not all(jax.tree.leaves(zero))


def test_lora_files_cross_both_ways(loaded, tmp_path):
    pipe, params = loaded
    src = jax_lora(params, seed=5)
    # JAX writes, the port reads
    jlio.save_lora_safetensors(src, str(tmp_path / "jax" / "pytorch_lora_weights.safetensors"))
    port = lora_io.load_lora_safetensors(str(tmp_path / "jax"), pipe.nets["unet"], pipe.nets["text_encoder"])
    ref = jlio.load_lora_safetensors(str(tmp_path / "jax"), params["unet"], params["text_encoder"])
    assert_trees_equal(port, jax.tree.map(np.asarray, ref))
    # the port writes, JAX reads back the source
    tsrc = jax_tree_to_torch(jax.tree.map(np.asarray, src), "cpu", torch.float32)
    lora_io.save_lora_safetensors(tsrc, str(tmp_path / "port.safetensors"))
    back = jlio.load_lora_safetensors(str(tmp_path / "port.safetensors"), params["unet"], params["text_encoder"])
    assert_trees_equal(jax.tree.map(np.asarray, back), jax.tree.map(np.asarray, src))
    # the same keys on both sides
    assert set(lora_io.lora_to_state_dict(tsrc)) == set(jlio.lora_to_state_dict(src))
    zero = lora_io.zero_lora(pipe.nets["unet"], pipe.nets["text_encoder"])
    assert_trees_equal(zero, jax.tree.map(np.asarray, jlio.zero_lora(params["unet"], params["text_encoder"])))
    with pytest.raises(ValueError, match="unrecognized LoRA keys"):
        lora_io.lora_from_state_dict({"unet.nowhere.lora_A.weight": np.zeros((4, 8), np.float32)},
                                     pipe.nets["unet"])


# --- from_pretrained + load_lora_weights + prompts --------------------------

S, H = 2, 64


def pipelines(tiny_dir, tmp_path):
    """Both pipelines from the directory, with one JAX-written LoRA loaded."""
    d, params, _ = tiny_dir
    jlio.save_lora_safetensors(jax_lora(params, seed=9), str(tmp_path / "pytorch_lora_weights.safetensors"))
    jpipe = JPipeline.from_pretrained(str(d), dtype=jnp.float32, policy=JPOLICY)
    jpipe.load_lora_weights(str(tmp_path))
    pipe = StableDiffusionPipeline.from_pretrained(str(d), dtype=torch.float32, policy=PARITY_POLICY, device="cpu")
    pipe.load_lora_weights(str(tmp_path))
    return pipe, jpipe


def test_from_pretrained_prompts_match_jax(tmp_path):
    cfgs, params = jax_params(small=True)
    d = write_model_dir(tmp_path / "model", params, cfgs)
    (tmp_path / "lora").mkdir()
    pipe, jpipe = pipelines((d, params, cfgs), tmp_path / "lora")
    assert pipe.tokenizer is not None and pipe.models.unet_cfg == tw.configs_from_model_dir(str(d))[1]
    np.testing.assert_array_equal(pipe.tokenize(PROMPTS).numpy(), np.asarray(jpipe.tokenize(PROMPTS)))
    noise = np.random.default_rng(11).standard_normal((S + 1, 2, H // 8, H // 8, 4)).astype(np.float32)
    kw = dict(num_inference_steps=S, guidance_scale=5.0, height=H, width=H, noise_override=noise)
    img = pipe(PROMPTS, negative_prompt=NEGATIVE, **kw)
    jimg = np.asarray(jpipe(PROMPTS, negative_prompt=NEGATIVE, **dict(kw, noise_override=jnp.asarray(noise))))
    assert img.shape == (2, H, H, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, jimg, atol=1e-3, rtol=0)
    # the same call through ids gives the same images; u8 outputs quantize them
    ids = pipe.tokenize(PROMPTS)
    again = pipe(input_ids=ids, negative_input_ids=pipe.tokenize([NEGATIVE]), **kw)
    np.testing.assert_array_equal(again, img)
    u8 = pipe(PROMPTS, negative_prompt=NEGATIVE, output_type="u8", **kw)
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8, np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8))


def test_chip_smoke_directory_loads_back(tmp_path):
    """chip_smoke.py's phase-12 writer (port modules → diffusers keys, the
    port's safetensors writer, a synthetic tokenizer) round-trips through
    `from_pretrained`: every parameter equal, and the prompt grid's words
    whole tokens."""
    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae

    cfgs, _ = jax_params()
    models = SamplerModels(text_cfg=clip_text.CLIPTextConfig(**TINY_CLIP), unet_cfg=unet2d.UNetConfig(**TINY_UNET),
                           vae_cfg=vae.VAEConfig(**TINY_VAE))
    src = StableDiffusionPipeline.from_random(seed=4, models=models, device="cpu")
    chip_smoke.write_sd21_dir(str(tmp_path), src, torch, configs=configs(*cfgs))
    pipe = StableDiffusionPipeline.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu")
    assert (pipe.models.text_cfg, pipe.models.unet_cfg, pipe.models.vae_cfg) == (
        models.text_cfg, models.unet_cfg, models.vae_cfg)
    for name, net in pipe.nets.items():
        theirs = dict(src.nets[name].named_parameters())
        for key, p in net.named_parameters():
            assert torch.equal(p, theirs[key]), (name, key)
    assert pipe.tokenizer.pad_token_id == 0
    for prompt in chip_smoke.PROMPTS + [chip_smoke.NEGATIVE_PROMPT]:
        for w in prompt.replace(",", " ").replace("-", " ").split():
            assert len(pipe.tokenizer.encode(w)) == 1, w
    # the reference's negative prompt, written out in chip_smoke.py, is the JAX sweep's
    from faceposegenerator_tpu.pipelines.sweep import DEFAULT_NEGATIVE

    assert chip_smoke.NEGATIVE_PROMPT == DEFAULT_NEGATIVE and len(chip_smoke.PROMPTS) == 8
    assert all(p.startswith("face ") and "sks person" in p for p in chip_smoke.PROMPTS)
    # SD2.1-base's own config files read back as the port's SD2.1 configs
    for sub, c in chip_smoke.SD21_CONFIGS.items():
        (tmp_path / sub / "config.json").write_text(json.dumps(c))
    assert tw.configs_from_model_dir(str(tmp_path)) == (
        tw.clip_text.SD21_TEXT_CONFIG, tw.unet2d.SD21_UNET_CONFIG, tw.vae.SD_VAE_CONFIG)
