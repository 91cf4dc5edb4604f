"""`core.compile`: one program per static key, on the CPU and on a card.

On the CPU a `jit` function runs eagerly but records its key, so
`_cache_size()` means here what it means on the card, where each key is one
captured CUDA graph. These tests hold the key (a), the sampler's static
names against JAX's (b), JAX's no-recompile invariants on the port (c, d),
the up-front noise table (e), the device-side optimizer (f) and the build
directories (g). The `cuda` cases (replay against eager) skip without a
card; on one: `python -m pytest --noconftest tests/test_torch_compile.py -m
cuda`. JAX is imported only inside the tests that compare with it, and no
test here builds a JAX program.
"""

import numpy as np
import pytest
import torch

from faceposegenerator_tpu_torch.core import compile as cc
from faceposegenerator_tpu_torch.core.checkpointing import load_pytree, save_pytree
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.core.tree import tree_leaves, tree_map
from faceposegenerator_tpu_torch.data.tokenizer import CLIPTokenizer, bytes_to_unicode
from faceposegenerator_tpu_torch.diffusion import sampler, schedulers
from faceposegenerator_tpu_torch.models import clip_text, iresnet, unet2d, vae
from faceposegenerator_tpu_torch.ops import fused_gn, fused_gn_conv
from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
from faceposegenerator_tpu_torch.training import idbooth

TEXT = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64)
UNET = dict(block_out_channels=(32, 32, 32, 32), cross_attention_dim=32, head_dim=8, norm_groups=8)
VAE = dict(block_out_channels=(32, 32, 32, 32))
# head dim 64: the card's attention kernels run inside the graph
UNET_D64 = dict(block_out_channels=(64, 64, 64, 64), cross_attention_dim=32, head_dim=64, norm_groups=8)
S, H = 2, 128  # 16² latents: the tiny UNet is ill-conditioned at 64²


def _byte_vocab():
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for u in bytes_to_unicode().values():
        vocab.setdefault(u, len(vocab))
        vocab.setdefault(u + "</w>", len(vocab))
    return vocab


def _pipe(device="cpu", seed=0, unet=UNET):
    models = sampler.SamplerModels(text_cfg=clip_text.CLIPTextConfig(**TEXT), unet_cfg=unet2d.UNetConfig(**unet),
                                   vae_cfg=vae.VAEConfig(**VAE))
    return StableDiffusionPipeline.from_random(seed=seed, models=models, device=device, policy=PARITY_POLICY,
                                               tokenizer=CLIPTokenizer(_byte_vocab(), [], 77))


def _lora(pipe, seed):
    """A rank-4 UNet adapter with nonzero B factors."""
    g = torch.Generator(device=pipe.device).manual_seed(seed)
    tree = unet2d.init_lora(pipe.nets["unet"], rank=4, generator=g, dtype=torch.float32)

    def fill(t):
        return t + 0.1 * torch.randn(t.shape, generator=g, device=t.device)

    return {"unet": tree_map(fill, tree), "text_encoder": None}


@pytest.fixture(scope="module")
def pipe():
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return _pipe()


# -- (a) the key ---------------------------------------------------------------


def test_key_values_keep_it_statics_shapes_dtypes_routes_and_rebinding_add_one(monkeypatch):
    lin = torch.nn.Linear(4, 3)

    @cc.jit(static_argnames=("k",))
    def f(net, x, scale, *, k):
        return net(x) * k * scale

    x = torch.randn(2, 4)
    f(lin, x, 1.0, k=2)
    assert f._cache_size() == 1
    f(lin, torch.randn(2, 4), 1.0, k=2)  # new values
    with torch.no_grad():
        lin.weight.copy_(torch.randn(3, 4))  # an in-place load keeps the pointers
    f(lin, torch.randn(2, 4), 1.0, k=2)
    assert f._cache_size() == 1
    changes = [
        lambda: f(lin, x, 1.0, k=3),  # a static
        lambda: f(lin, torch.randn(5, 4), 1.0, k=2),  # a shape
        lambda: f(lin, x, 0.5, k=2),  # a host number the graph bakes in
        lambda: f(lin.double(), x.double(), 1.0, k=2),  # a dtype (and a rebound parameter)
    ]
    for n, change in enumerate(changes, start=2):
        change()
        assert f._cache_size() == n
    lin.float()
    n = f._cache_size()
    monkeypatch.setattr(fused_gn, "_GN_IMPL", "pallas")  # a routing switch
    f(lin, x, 1.0, k=2)
    assert f._cache_size() == n + 1
    monkeypatch.setattr(fused_gn, "_GN_IMPL", "xla")
    lin.weight = torch.nn.Parameter(torch.randn(3, 4))  # a rebound parameter
    f(lin, x, 1.0, k=2)
    assert f._cache_size() == n + 2
    with cc.disable():  # eager, unrecorded
        f(lin, torch.randn(7, 4), 1.0, k=9)
    assert f._cache_size() == n + 2
    with pytest.raises(TypeError, match="Generator"):
        f(lin, x, torch.Generator(), k=2)


def test_a_registered_route_and_the_argument_rule(monkeypatch):
    monkeypatch.setattr(cc, "_ROUTES", list(cc._ROUTES))  # the registration ends with the test
    mode = {"v": 1}
    cc.register_route(lambda: mode["v"])  # a module's switch, read at every call
    g = cc.jit(lambda x: x * mode["v"])
    g(torch.ones(2))
    mode["v"] = 2
    g(torch.ones(2))
    assert g._cache_size() == 2
    monkeypatch.setattr(fused_gn_conv, "_IMPL", "pallas")  # the ops' own registered switches
    g(torch.ones(2))
    assert g._cache_size() == 3
    h = cc.jit(lambda x, eager: x + 1, eager_if=lambda x, eager: eager)
    h(torch.ones(2), True)  # the argument rule: eager, unrecorded
    assert h._cache_size() == 0
    h(torch.ones(2), False)
    assert h._cache_size() == 1
    assert not cc.over_mesh(None, torch.nn.Linear(2, 2))


def test_schedule_identity_is_in_the_key():
    a = schedulers.make_ddpm(num_inference_steps=S)
    b = schedulers.make_ddpm(schedulers.SchedulerConfig(beta_end=0.02), num_inference_steps=S)
    assert a.cache_key() == schedulers.make_ddpm(num_inference_steps=S).cache_key()
    assert a.cache_key() != b.cache_key() and a.num_inference_steps == b.num_inference_steps
    d = schedulers.make_dpm_solver(num_inference_steps=S)
    assert d.cache_key() != schedulers.make_dpm_solver(num_inference_steps=S + 1).cache_key()


# -- (b) the sampler's static names ------------------------------------------


def test_sample_static_names_are_jaxs():
    from faceposegenerator_tpu.diffusion import sampler as jsampler

    jax_static = set(jsampler.sample._kw["static_argnames"])
    # `models`: here the modules carry their configs; `unroll`: XLA's loop
    # unrolling, where a graph unrolls every step
    assert set(sampler._sample.static_argnames) == (jax_static - {"models", "unroll"}) | {"attn_impl"}


# -- (c, d) JAX's no-recompile invariants ----------------------------------------


def test_lora_swap_and_seed_do_not_add_a_key(pipe):
    """JAX tests/test_no_recompile.py on the port."""
    ids = pipe.tokenize(["photo of sks person"])
    run = lambda lora, seed: pipe(input_ids=ids, num_inference_steps=S, height=H, width=H, seed=seed,  # noqa: E731
                                  lora=lora)
    a = run(_lora(pipe, 1), 0)
    n = sampler._sample._cache_size()
    b = run(_lora(pipe, 2), 0)
    assert sampler._sample._cache_size() == n
    assert not np.allclose(a, b)
    c = run(_lora(pipe, 2), 7)
    assert sampler._sample._cache_size() == n
    assert not np.allclose(b, c)


def test_batch_engine_zero_and_loaded_adapter_share_a_key(pipe):
    """JAX tests/test_serving.py:94-102: the zero adapter and a loaded one
    ride one program."""
    from faceposegenerator_tpu_torch.serving import GenerationRequest, SamplerServer

    srv = SamplerServer(pipe, batch_size=2, num_inference_steps=S, height=H, width=H)
    try:
        g = torch.Generator().manual_seed(3)
        srv.register_lora("A", tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=g), srv._zero_lora()))
        srv.generate([GenerationRequest(prompt="a", seed=1)])
        n = sampler._sample._cache_size()
        out = srv.generate([GenerationRequest(prompt="a", seed=1, lora_id="A"),
                            GenerationRequest(prompt="b", seed=2, lora_id="A")])
        assert sampler._sample._cache_size() == n and len(out) == 2
    finally:
        srv.shutdown()


# -- (e) the noise table ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["ddpm", "dpm"])
def test_generator_equals_the_up_front_table(pipe, kind):
    sched = schedulers.make_ddpm(num_inference_steps=S) if kind == "ddpm" else \
        schedulers.make_dpm_solver(num_inference_steps=S)
    ids = pipe.tokenize(["a", "b"])
    neg = torch.zeros_like(ids)
    kw = dict(height=H, width=H, policy=PARITY_POLICY, scheduler=kind)
    got = sampler.sample(pipe.nets, sched, ids, neg, generator=torch.Generator().manual_seed(5), **kw)
    g = torch.Generator().manual_seed(5)  # the loop's order: index 0, then step i's noise at i + 1
    draws = [torch.randn((2, H // 8, H // 8, 4), generator=g) for _ in range(S + 1 if kind == "ddpm" else 1)]
    table = torch.stack(draws + [torch.zeros_like(draws[0])] * (S + 1 - len(draws)))
    want = sampler.sample(pipe.nets, sched, ids, neg, noise_override=table, **kw)
    assert torch.equal(got, want)


# -- (f) the device-side optimizer ---------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 3])
def test_learning_rate_on_the_device_is_optaxs(warmup):
    import optax

    lr, total = 1e-2, 12
    want = optax.warmup_cosine_decay_schedule(0.0 if warmup else lr, lr, warmup, total, 0.0)
    sched = idbooth._cosine_schedule(lr, warmup, total)
    for count in range(total + 2):
        got = sched(torch.tensor(count))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want(count)), rtol=1e-6, atol=1e-6 * lr)


def test_accumulated_updates_match_optax_multisteps():
    """Six micro-steps of 2-step accumulation (three AdamW updates), the
    count and the moments on the device, against JAX's optimizer."""
    import jax.numpy as jnp
    import optax

    from faceposegenerator_tpu.training import idbooth as jidbooth

    cfg = jidbooth.IDBoothConfig(learning_rate=1e-2, lr_warmup_steps=1, max_grad_norm=1.0,
                                 gradient_accumulation_steps=2)
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32), "b": rng.standard_normal((8, 4)).astype(np.float32)}
    grads = [{k: (s * rng.standard_normal(v.shape) / np.sqrt(v.size * 2)).astype(np.float32) for k, v in params.items()}
             for s in (3.0, 0.5, 2.0, 0.7, 1.5, 0.2)]
    jopt = jidbooth.make_optimizer(cfg, total_steps=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    topt = idbooth.make_optimizer(cfg, total_steps=5)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    assert isinstance(tstate["count"], torch.Tensor) and tstate["count"].dim() == 0
    for g in grads:
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update([torch.from_numpy(g[k]) for k in tp], tstate, tp)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
    assert tstate["count"] == int(jstate.gradient_step) == 3 and tstate["mini_step"] == 0


def test_a_checkpoint_with_an_int_count_restores(tmp_path):
    cfg = idbooth.IDBoothConfig(learning_rate=1e-2)
    opt = idbooth.make_optimizer(cfg, total_steps=10)
    tp = {"a": torch.ones(3, 2)}
    old = {"count": 4, "exp_avg": {"a": torch.full((3, 2), 0.1)}, "exp_avg_sq": {"a": torch.full((3, 2), 0.01)}}
    save_pytree(old, str(tmp_path / "opt.npz"))  # a state written while the count was a host int
    state = load_pytree(opt.init(tp), str(tmp_path / "opt.npz"))
    assert isinstance(state["count"], torch.Tensor) and state["count"] == 4
    assert torch.equal(state["exp_avg"]["a"], old["exp_avg"]["a"])
    opt.update([torch.full((3, 2), 0.5)], state, tp)
    opt.update([torch.full((3, 2), 0.5)], old, {"a": torch.ones(3, 2)})  # a state still holding the int
    assert state["count"] == old["count"] == 5 and isinstance(old["count"], torch.Tensor)
    assert not torch.equal(tp["a"], torch.ones(3, 2))


# -- (g) build directories ---------------------------------------------------------


def test_machine_scoped_cache_dir(monkeypatch, tmp_path):
    a = cc.machine_scoped_cache_dir(tmp_path, cc.kernel_toolchain_tag("nvcc"))
    assert a == cc.machine_scoped_cache_dir(tmp_path, cc.kernel_toolchain_tag("nvcc")) and a.parent == tmp_path
    assert not a.exists()
    monkeypatch.setattr(cc, "_command_version", lambda *cmd: "Cuda compilation tools, release 99.9")
    b = cc.machine_scoped_cache_dir(tmp_path, cc.kernel_toolchain_tag("nvcc"))
    assert b != a and b.parent == tmp_path
    n1 = cc.machine_scoped_cache_dir(tmp_path, cc.native_toolchain_tag("g++"))
    monkeypatch.setattr(cc, "_command_version", lambda *cmd: "g++ (GCC) 99.1")
    assert cc.machine_scoped_cache_dir(tmp_path, cc.native_toolchain_tag("g++")) != n1


# -- on a card: replay against eager -----------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_replayed_sample_equals_eager():
    _card()
    from faceposegenerator_tpu_torch.ops import flash_attention as fa

    p = _pipe("cuda", unet=UNET_D64)
    sampler._sample.clear()
    ids = p.tokenize(["a", "b"])
    with cc.disable():
        want = p(input_ids=ids, num_inference_steps=S, height=H, width=H, seed=3, lora=_lora(p, 1), output_type="pt")
    outs, launches = [], []
    for _ in range(3):  # warm-up, capture, replay
        before = dict(fa.LAUNCHES)
        outs.append(p(input_ids=ids, num_inference_steps=S, height=H, width=H, seed=3, lora=_lora(p, 1),
                      output_type="pt"))
        launches.append({k: v - before[k] for k, v in fa.LAUNCHES.items() if v != before[k]})
    assert sampler._sample._cache_size() == 1
    for out in outs:
        assert torch.equal(out, want), (out - want).abs().max().item()
    assert launches[0] == launches[1] == launches[2] and launches[0]


@pytest.mark.cuda
def test_replayed_train_step_equals_eager():
    _card()
    cfg = idbooth.IDBoothConfig(which_loss="identity", with_prior_preservation=True, learning_rate=1e-3,
                                gradient_checkpointing=True)
    models = idbooth.ModelBundle(text_cfg=clip_text.CLIPTextConfig(**TEXT), unet_cfg=unet2d.UNetConfig(**UNET_D64),
                                 vae_cfg=vae.VAEConfig(**VAE),
                                 arcface_cfg=iresnet.config_for("r18", num_features=32))

    frozen = {"text_encoder": clip_text.CLIPTextModel(models.text_cfg, device="cuda", seed=0),
              "unet": unet2d.UNet2DCondition(models.unet_cfg, device="cuda", seed=1),
              "vae": vae.AutoencoderKL(models.vae_cfg, device="cuda", seed=2),
              "arcface": iresnet.IResNet(models.arcface_cfg, device="cuda", seed=3).eval()}
    g = torch.Generator(device="cuda").manual_seed(4)
    batch = {"pixel_values": torch.rand((4, H, H, 3), generator=g, device="cuda") * 2 - 1,
             "input_ids": torch.randint(0, TEXT["vocab_size"], (4, 77), generator=g, device="cuda"),
             "gt_embeds": torch.randn((4, 32), generator=g, device="cuda")}
    runs = []
    for graphed in (False, True):
        trainable = idbooth.init_trainable(5, cfg, models, frozen["unet"])
        opt = idbooth.make_optimizer(cfg, total_steps=10)
        state = opt.init(trainable)
        step = idbooth.make_train_step(cfg, models, opt)
        losses = []
        for i in range(4):
            draws = idbooth.draw((4, H // 8, H // 8, 4), 4, 1000, torch.Generator(device="cuda").manual_seed(i),
                                 "cuda")
            if graphed:
                trainable, state, m = step(trainable, state, frozen, batch, draws=draws)
            else:
                with cc.disable():
                    trainable, state, m = step(trainable, state, frozen, batch, draws=draws)
            losses.append(m["loss"].item())
        runs.append((losses, [t.detach().clone() for t in tree_leaves(trainable)], state["count"].item()))
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2] == 4
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b), (a - b).abs().max().item()
