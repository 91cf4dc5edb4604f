"""The rest of the port's txt2img surface against the JAX package, on the
tiny diffusers directory of tests/test_torch_checkpoints.py loaded by both
`from_pretrained`s (fp32, 64², 2 DDPM steps, CFG 5.0, a JAX-written LoRA,
the same `noise_override`; tests/test_torch_turbo.py's two-level models):
`num_images_per_prompt`, the negative prompt tokenized from "" when a
tokenizer is loaded, `decode_chunk`, per-sample adapters with a (B,) scale
(with a guidance interval and without), and ToMe at ratio 0.5 under each
`tome_ops`. Images agree within the 1e-3 of tests/test_torch_pipeline.py;
ToMe's match indices are equal to JAX's on the same hidden states, also
where rows repeat.

JAX compiles its sampler once for each static option set, so the cases
share three option sets (`RUNS`), each run once on both sides: every
option is held against JAX in one of them, and most tests also hold their
option against a port call without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.diffusion import sampler as jsampler
from faceposegenerator_tpu.diffusion import schedulers as jsched
from faceposegenerator_tpu.ops import tome as jtome
from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch
from faceposegenerator_tpu_torch.ops import tome

from test_torch_checkpoints import NEGATIVE, PROMPTS, jax_lora, jax_params, pipelines, write_model_dir

S, H = 2, 64
# the three option sets: "repeat" (2 images a prompt, no negative prompt,
# ToMe on attn), "chunk" (per-sample adapters, decode_chunk=1, ToMe on
# attn+xattn) and "interval" (per-sample adapters, cfg_interval (1, 2), ToMe
# on attn+xattn+mlp); ToMe merges 64 level-0 tokens to 32
RUNS = {
    "repeat": dict(num_images_per_prompt=2, tome_ops="attn"),
    "chunk": dict(per_sample=True, decode_chunk=1, tome_ops="attn,xattn"),
    "interval": dict(per_sample=True, cfg_interval=(1, 2), tome_ops="attn,xattn,mlp"),
}
TOME = dict(tome_ratio=0.5, tome_min_tokens=64)
SCALE = np.array([1.0, 0.5], np.float32)


def _noise(b, seed=0):
    return np.random.default_rng(seed).standard_normal((S + 1, b, H // 8, H // 8, 4)).astype(np.float32)


def _torch_lora(tree):
    return jax_tree_to_torch(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


class Runs:
    """Each option set of `RUNS` run once on both pipelines: the port's
    images, JAX's, and the ToMe matches the port built on the way."""

    def __init__(self, pipe, jpipe, params):
        self.pipe, self.jpipe = pipe, jpipe
        self.loras = [jax_lora(params, seed=s) for s in (21, 22)]
        self.done = {}

    def port_kw(self, name, **over):
        """The port's keyword arguments for option set `name`; `over`
        replaces some."""
        opts = dict(RUNS[name])
        kw = dict(num_inference_steps=S, guidance_scale=5.0, height=H, width=H, **TOME, tome_ops=opts["tome_ops"])
        if opts.get("per_sample"):
            kw.update(lora=_torch_lora(jax.tree.map(lambda *x: jnp.stack(x), *self.loras)),
                      lora_scale=torch.from_numpy(SCALE), negative_prompt=NEGATIVE, noise_override=_noise(2, 3))
        else:
            kw.update(noise_override=_noise(4))
        for k in ("num_images_per_prompt", "decode_chunk", "cfg_interval"):
            if k in opts:
                kw[k] = opts[k]
        kw.update(over)
        return kw

    def __call__(self, name):
        if name not in self.done:
            self.done[name] = self._run(name)
        return self.done[name]

    def _run(self, name):
        kw = self.port_kw(name)
        seen = []
        build = tome.build_match

        def recording(metric, h, w, r, **k):
            m = build(metric, h, w, r, **k)
            seen.append((metric.clone(), h, w, r, m))
            return m

        tome.build_match = recording
        try:
            img = self.pipe(PROMPTS, **kw)
        finally:
            tome.build_match = build
        jkw = {k: v for k, v in kw.items() if k not in ("lora", "lora_scale", "noise_override", "decode_chunk")}
        jkw["noise_override"] = jnp.asarray(kw["noise_override"])
        if RUNS[name].get("per_sample"):
            jkw.update(lora=jax.tree.map(lambda *x: jnp.stack(x), *self.loras), lora_scale=jnp.asarray(SCALE))
        if "decode_chunk" in kw:  # the JAX pipeline's __call__ has no decode_chunk: its sampler does
            jp = self.jpipe
            ids = jnp.asarray(jp.tokenize(PROMPTS))
            neg = jnp.asarray(jp.tokenize([jkw.pop("negative_prompt")] * len(PROMPTS)))
            jimg = jsampler.sample(jp.params, jsched.make_ddpm(num_inference_steps=S), ids, neg, jax.random.key(0),
                                   models=jp.models, guidance_scale=5.0, height=H, width=H, policy=jp.policy,
                                   lora=jkw["lora"], lora_scale=jkw["lora_scale"],
                                   noise_override=jkw["noise_override"], decode_chunk=kw["decode_chunk"],
                                   **TOME, tome_ops=kw["tome_ops"])
        else:
            jimg = self.jpipe(PROMPTS, **jkw)
        jimg = np.asarray(jimg)
        assert img.shape == jimg.shape and np.isfinite(img).all()
        return img, jimg, seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfgs, params = jax_params(small=True)
    root = tmp_path_factory.mktemp("sd21")
    write_model_dir(root / "model", params, cfgs)
    (root / "lora").mkdir()
    pipe, jpipe = pipelines((root / "model", params, cfgs), root / "lora")
    return Runs(pipe, jpipe, params)


def _matches_jax(runs, name):
    img, jimg, _ = runs(name)
    np.testing.assert_allclose(img, jimg, atol=1e-3, rtol=0)
    return img


def test_num_images_per_prompt(runs):
    img = _matches_jax(runs, "repeat")
    assert img.shape[0] == 4
    # each prompt's row repeats (and its one negative is tiled first)
    pipe = runs.pipe
    kw = runs.port_kw("repeat", num_images_per_prompt=1)
    again = pipe(input_ids=pipe.tokenize(PROMPTS).repeat_interleave(2, 0), negative_input_ids=pipe.tokenize([""] * 4),
                 **kw)
    np.testing.assert_array_equal(again, img)


def test_negative_prompt_defaults_to_tokenized_empty_string(runs):
    pipe = runs.pipe
    _, neg = pipe._ids(PROMPTS, None, None, None)
    np.testing.assert_array_equal(neg.numpy(), pipe.tokenize(["", ""]).numpy())
    assert neg[0, 0] == 49406 and neg[0, 1] == 49407 and neg.abs().sum() > 0
    _matches_jax(runs, "repeat")  # the "repeat" set gives no negative prompt


def test_decode_chunk(runs):
    img = _matches_jax(runs, "chunk")
    whole = runs.pipe(PROMPTS, **runs.port_kw("chunk", decode_chunk=None))
    np.testing.assert_allclose(img, whole, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["chunk", "interval"], ids=["cfg", "cfg_interval"])
def test_per_sample_adapters(runs, name):
    img = _matches_jax(runs, name)
    # slot 1 is adapter 1 at scale 0.5, shared by the batch
    shared = runs.pipe(PROMPTS, **runs.port_kw(name, lora=_torch_lora(runs.loras[1]), lora_scale=0.5))
    np.testing.assert_allclose(img[1], shared[1], atol=1e-5, rtol=0)
    assert np.abs(img[0] - shared[0]).max() > 1e-4


def _jax_tome(metric, h, w, r, x=None, y=None):
    """JAX's match on `metric` as (merged, unmerged, match), with its merge
    of `x` and unmerge of `y`, compiled as one program."""
    def run(metric, x, y):
        j = jtome.build_match(metric, h, w, r)
        return (j.merged, j.unmerged, j.match) + ((jtome.merge(x, j), jtome.unmerge(y, j)) if x is not None else ())

    return [np.asarray(a) for a in jax.jit(run)(jnp.asarray(metric), x, y)]


def _assert_same_match(t, j, h, w):
    for name, want in zip(("merged", "unmerged", "match"), j):
        np.testing.assert_array_equal(getattr(t, name).numpy(), want, err_msg=name)
    dst, src = jtome._lattice(h, w, 2, 2)
    np.testing.assert_array_equal(t.dst_idx.numpy(), dst)
    np.testing.assert_array_equal(t.src_idx.numpy(), src)


@pytest.mark.parametrize("name", ["repeat", "chunk", "interval"], ids=["attn", "attn+xattn", "attn+xattn+mlp"])
def test_tome_matches_jax(runs, name):
    _matches_jax(runs, name)
    _, _, seen = runs(name)
    # 3 level-0 transformers (1 down, 2 up) a UNet pass, 2 steps; 64 tokens → 32 merged
    assert len(seen) == 6 and {(h, w, r) for _, h, w, r, _ in seen} == {(8, 8, 32)}
    for metric, h, w, r, m in seen:
        _assert_same_match(m, _jax_tome(metric.numpy(), h, w, r), h, w)


def test_tome_ties_break_as_jax():
    """One-hot rows: every score is 0 or the same value, so the order rests
    on the stable sort and the first argmax alone."""
    rng = np.random.default_rng(5)
    B, h, w, C = 3, 8, 8, 6
    metric = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, h * w))]
    x = rng.standard_normal((B, h * w, 16)).astype(np.float32)
    for r in (8, 24, 48):
        t = tome.build_match(torch.from_numpy(metric), h, w, r)
        merged = tome.merge(torch.from_numpy(x), t)
        *j, jmerged, junmerged = _jax_tome(metric, h, w, r, x=x, y=merged.numpy())
        _assert_same_match(t, j, h, w)
        np.testing.assert_allclose(merged.numpy(), jmerged, atol=1e-6)
        np.testing.assert_allclose(tome.unmerge(merged, t).numpy(), junmerged, atol=0)
    for n, ratio in ((4096, 0.5), (1024, 0.5), (64, 0.5), (63, 0.9), (10, 0.1)):
        assert tome.merge_count(n, ratio) == jtome.merge_count(n, ratio)
    assert tome.merge_count(4096, 0.5) == 2048
