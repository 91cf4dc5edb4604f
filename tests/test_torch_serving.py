"""The port's serving layer against the JAX package: per-slot scheduler
steps, the rolling engine's ticks, per-request determinism, the rolling
engine against the batch engine, and the engines' contracts (queue cap,
deadlines, shutdown, seed range, adapter structure, arrival order, a
failing collector, HTTP codes, refusals). The servers over a mesh are in
tests/test_torch_mesh_serving.py.

The models are the tiny ones of the JAX serving tests
(tests/test_serving.py:25-33: 64², 3 steps), fp32 `PARITY_POLICY`, JAX
`init` trees filled from a numpy seed and carried into the port; every
comparison feeds both sides the same numpy noise. JAX compiles each tick
once, in a module-scoped fixture that starts both on worker threads when
the first test asks for it, so the port-only tests below run while JAX
compiles. The batch engine's images are held to JAX's sampler in
tests/test_torch_sweep.py, where JAX compiles that program for the packed
sweep anyway.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from faceposegenerator_tpu.diffusion import schedulers as jsched
from faceposegenerator_tpu.diffusion.sampler import SamplerModels as JModels
from faceposegenerator_tpu.models import clip_text as jclip
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.models import vae as jvae
from faceposegenerator_tpu.pipelines.txt2img import StableDiffusionPipeline as JPipeline
from faceposegenerator_tpu.serving import rolling as jrolling
from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch, load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.core.tree import tree_map
from faceposegenerator_tpu_torch.data.tokenizer import CLIPTokenizer, bytes_to_unicode
from faceposegenerator_tpu_torch.diffusion import schedulers
from faceposegenerator_tpu_torch.diffusion.lora_io import zero_lora
from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae
from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
from faceposegenerator_tpu_torch.serving import (GenerationRequest, GenerationResult, QueueFull, RollingServer,
                                                 SamplerServer)
from faceposegenerator_tpu_torch.serving.http_api import start_http_background

from test_torch_checkpoints import jax_lora, numpy_init

# tests/test_serving.py:25-33
TEXT = dict(vocab_size=512, hidden_size=48, num_layers=2, num_heads=4, intermediate_size=96)
UNET = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=48, head_dim=8)
VAE = dict(block_out_channels=(32, 32, 32, 32))
S, H = 3, 64
KW = dict(num_inference_steps=S, height=H, width=H)
# the tick's shared state: 4 slots at steps 0, 1, 2 and S (free, frozen),
# 128² (16² latents): at 64² the UNet's bottom level is 1×1, its GroupNorm
# groups hold 2 values, and fp32 rounding differences grow to ~1e-3 of the
# UNet's output on some random latents (2e-6 at 128²)
TICK_STEPS = np.array([0, 1, 2, S], np.int32)
TICK_H = 128


def byte_vocab():
    """A byte-level CLIP vocab without merges (tests/test_serving.py:36-42)."""
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for u in bytes_to_unicode().values():
        vocab.setdefault(u, len(vocab))
        vocab.setdefault(u + "</w>", len(vocab))
    return vocab


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU ops in one thread: with the suite's workers
    sharing the cores, spinning intra-op threads cost more than they give."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def build_pipes():
    """The JAX pipeline and the port's, on the same weights; two nonzero
    rank-4 adapters as JAX trees and as the port's."""
    jmodels = JModels(text_cfg=jclip.CLIPTextConfig(**TEXT), unet_cfg=junet.UNetConfig(**UNET),
                      vae_cfg=jvae.VAEConfig(**VAE))
    params = {"text_encoder": numpy_init(jclip.init, jmodels.text_cfg, 0),
              "unet": numpy_init(junet.init, jmodels.unet_cfg, 1),
              "vae": numpy_init(jvae.init, jmodels.vae_cfg, 2)}
    jpipe = JPipeline(params, jmodels, tokenizer=JTokenizer(byte_vocab(), [], 77), policy=JPOLICY)
    models = SamplerModels(text_cfg=clip_text.CLIPTextConfig(**TEXT), unet_cfg=unet2d.UNetConfig(**UNET),
                           vae_cfg=vae.VAEConfig(**VAE))
    pipe = StableDiffusionPipeline.from_random(models=models, device="cpu", policy=PARITY_POLICY,
                                               tokenizer=CLIPTokenizer(byte_vocab(), [], 77))
    for name, net in pipe.nets.items():
        load_jax_params(net, jax.tree.map(np.asarray, params[name]))
    jloras = {name: jax_lora(params, seed=s) for name, s in (("A", 30), ("B", 31))}
    loras = {name: jax_tree_to_torch(jax.tree.map(np.asarray, t), "cpu", torch.float32) for name, t in jloras.items()}
    return dict(jpipe=jpipe, pipe=pipe, jloras=jloras, loras=loras)


@pytest.fixture(scope="module")
def pipes():
    return build_pipes()


def stack(trees, fn):
    return jax.tree.map(lambda *xs: fn(xs), *trees)


def tick_state(pipes, dpm):
    """The shared rolling state of the tick comparisons, numpy, from a seed."""
    rng = np.random.default_rng(40 + dpm)
    B = len(TICK_STEPS)
    h = TICK_H // 8
    state = dict(latents=rng.standard_normal((B, h, h, 4)), ctx=rng.standard_normal((2 * B, 77, TEXT["hidden_size"])),
                 noise=rng.standard_normal((S + 1, B, h, h, 4)), m0=rng.standard_normal((B, h, h, 4)),
                 m1=rng.standard_normal((B, h, h, 4)), scale=np.array([1.0, 0.5, 1.0, 0.7]))
    state = {k: v.astype(np.float32) for k, v in state.items()}
    state["lora_ids"] = ["A", "B", None, "A"]
    return state


def _jax_tick(pipes, dpm):
    jp = pipes["jpipe"]
    st = tick_state(pipes, dpm)
    zero = jax.tree.map(jnp.zeros_like, pipes["jloras"]["A"])
    trees = [pipes["jloras"][i] if i else zero for i in st["lora_ids"]]
    lora = stack(trees, jnp.stack)
    common = dict(models=jp.models, guidance_scale=5.0, policy=JPOLICY, S=S)
    if dpm:
        out = jrolling._tick_dpm(jp.params, jsched.make_dpm_solver(num_inference_steps=S), st["latents"], st["m0"],
                                 st["m1"], jnp.asarray(TICK_STEPS), st["ctx"], lora, jnp.asarray(st["scale"]),
                                 **common)
    else:
        out = jrolling._tick(jp.params, jsched.make_ddpm(num_inference_steps=S), st["latents"],
                             jnp.asarray(TICK_STEPS), st["ctx"], st["noise"], lora, jnp.asarray(st["scale"]), **common)
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def jax_runs(pipes):
    """JAX's two compiled programs (the DDPM tick, the DPM tick), started
    together on worker threads."""
    pool = ThreadPoolExecutor(max_workers=2)
    runs = {"tick": pool.submit(_jax_tick, pipes, False), "tick_dpm": pool.submit(_jax_tick, pipes, True)}
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def server(pipes):
    srv = SamplerServer(pipes["pipe"], batch_size=2, max_wait_s=0.05, multi_lora=True, **KW)
    for name, tree in pipes["loras"].items():
        srv.register_lora(name, tree)
    yield srv
    srv.shutdown()


def test_tokenizers_agree(pipes, jax_runs):
    """Both pipelines tokenize the prompts alike (and JAX starts compiling)."""
    prompts = ["face portrait photo of woman sks person", "face side-portrait photo of man sks person, forest background",
               ""]
    np.testing.assert_array_equal(pipes["pipe"].tokenize(prompts).numpy(), np.asarray(pipes["jpipe"].tokenize(prompts)))


# --- per-slot scheduler steps ----------------------------------------------


@pytest.mark.parametrize("steps", [3, 30])
def test_ddpm_step_per_slot_matches_jax_and_scalar_step(steps):
    """Mixed step positions, 0 and S - 1 included (S - 1 is t = 1 at 30 steps;
    the last of 3 is t = 1 too, so one more row uses the full schedule's t = 0)."""
    idx = np.array([0, steps - 1, 1, steps // 2, steps - 1, 0])
    rng = np.random.default_rng(steps)
    eps, x, z = (rng.standard_normal((len(idx), 8, 8, 4)).astype(np.float32) for _ in range(3))
    j = jsched.make_ddpm(num_inference_steps=steps)
    jx, jx0 = jax.jit(jax.vmap(lambda e, i, xx, n: j.step(e, i, xx, n)))(eps, jnp.asarray(idx), x, z)
    t = schedulers.make_ddpm(num_inference_steps=steps)
    tx, tx0 = t.step_per_slot(torch.from_numpy(eps), torch.from_numpy(idx), torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-5, rtol=1e-5)
    for b, i in enumerate(idx):
        rows = [torch.from_numpy(a[b:b + 1]) for a in (eps, x, z)]
        rx, rx0 = t.step(rows[0], int(i), rows[1], rows[2])
        assert torch.equal(rx[0], tx[b]) and torch.equal(rx0[0], tx0[b]), b
    full = schedulers.make_ddpm()
    last = torch.tensor([999, 0])  # t = 0 (no noise) and t = 999
    fx, _ = full.step_per_slot(torch.from_numpy(eps[:2]), last, torch.from_numpy(x[:2]), torch.from_numpy(z[:2]))
    for b in range(2):
        assert torch.equal(full.step(torch.from_numpy(eps[b:b + 1]), int(last[b]), torch.from_numpy(x[b:b + 1]),
                                     torch.from_numpy(z[b:b + 1]))[0][0], fx[b])


@pytest.mark.parametrize("steps", [3, 12])
def test_dpm_step_per_slot_matches_jax_and_scalar_step(steps):
    """A slot's count is its step position: position 0 takes the first
    order, S - 1 the lower-order final step, the others the 2M update."""
    idx = np.array([0, 1, steps - 1, steps // 2, 2 % steps])
    rng = np.random.default_rng(steps + 1)
    eps, x, m0, m1 = (rng.standard_normal((len(idx), 8, 8, 4)).astype(np.float32) for _ in range(4))
    j = jsched.make_dpm_solver(num_inference_steps=steps)

    def one(e, i, xx, a, b):
        (xn, an, bn, _), _ = j.step(e, i, (xx, a, b, i))
        return xn, an, bn

    ref = jax.jit(jax.vmap(one))(eps, jnp.asarray(idx), x, m0, m1)
    t = schedulers.make_dpm_solver(num_inference_steps=steps)
    got = t.step_per_slot(*(torch.from_numpy(a) for a in (eps, idx, x, m0, m1)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
    for b, i in enumerate(idx):
        state = tuple(torch.from_numpy(a[b:b + 1]) for a in (x, m0, m1)) + (int(i),)
        (rx, rx0, rm0, _), _ = t.step(torch.from_numpy(eps[b:b + 1]), int(i), state)
        assert torch.equal(rx[0], got[0][b]) and torch.equal(rx0[0], got[1][b]) and torch.equal(rm0[0], got[2][b]), b


# --- the engines' contracts (port only) -------------------------------------


def _slow_server(pipe, **kw):
    """A server whose batches sample nothing, and whose "busy" request holds
    the worker until `srv.release` is set (`srv.started` says it holds it):
    the tests control how full the queue is, whatever the machine's load."""
    srv = SamplerServer(pipe, batch_size=1, max_wait_s=0.0, num_inference_steps=2, height=H, width=H, **kw)
    srv.started, srv.release = threading.Event(), threading.Event()

    def fake_execute(batch):
        if batch[0][0].prompt == "busy":
            srv.started.set()
            srv.release.wait(timeout=30)
        for req, fut, _ in batch:
            if not fut.done():
                fut.set_result(GenerationResult(np.zeros((H, H, 3), np.uint8), req.seed, req.lora_id, 0.0, 0.0))

    srv._execute = fake_execute
    return srv


def _hold_worker(srv):
    """Park the worker inside the "busy" batch."""
    srv.submit(GenerationRequest(prompt="busy", seed=0))
    assert srv.started.wait(timeout=30), "the worker did not take the request"


def test_bounded_queue_raises_queuefull(pipes):
    srv = _slow_server(pipes["pipe"], max_queue=2)
    try:
        _hold_worker(srv)
        srv.submit(GenerationRequest(prompt="q1", seed=1))
        srv.submit(GenerationRequest(prompt="q2", seed=2))
        with pytest.raises(QueueFull):
            srv.submit(GenerationRequest(prompt="q3", seed=3))
    finally:
        srv.release.set()
        srv.shutdown(wait=False)


def test_deadline_and_shutdown_fail_futures(pipes):
    """A request queued past request_timeout_s fails with TimeoutError; one
    stranded by shutdown fails with RuntimeError; submit after shutdown
    raises."""
    srv = _slow_server(pipes["pipe"], request_timeout_s=0.05)
    try:
        _hold_worker(srv)
        late = srv.submit(GenerationRequest(prompt="late", seed=1))
        time.sleep(0.1)  # past its deadline while the worker is held
        srv.release.set()
        with pytest.raises(TimeoutError):
            late.result(timeout=5)
    finally:
        srv.release.set()
        srv.shutdown(wait=False)
    srv = _slow_server(pipes["pipe"])
    _hold_worker(srv)
    stranded = srv.submit(GenerationRequest(prompt="stranded", seed=1))
    srv.shutdown(wait=False)
    with pytest.raises(RuntimeError, match="shut down"):
        stranded.result(timeout=5)
    with pytest.raises(RuntimeError, match="shut down"):
        srv.submit(GenerationRequest(prompt="x", seed=0))
    srv.release.set()
    srv._worker.join(timeout=5)
    assert not srv._worker.is_alive()


def test_seed_range_and_unknown_lora(server):
    for bad in (-1, 2**32):
        with pytest.raises(ValueError, match="seed"):
            server.submit(GenerationRequest(prompt="x", seed=bad))
    with pytest.raises(KeyError, match="unknown lora_id"):
        server.submit(GenerationRequest(prompt="x", lora_id="nope"))
    out = server.generate([GenerationRequest(prompt="x", seed=2**32 - 1)])[0]
    assert out.image.shape == (H, H, 3) and out.image.dtype == np.uint8


def test_register_lora_rejects_structure_mismatch(server):
    """Another rank, a missing text-encoder half, another dtype: refused."""
    pipe = server.pipe
    zero = server._loras[None][0]
    bad = {"rank8": zero_lora(pipe.nets["unet"], pipe.nets["text_encoder"], rank=8),
           "no_text": {"unet": zero["unet"], "text_encoder": None},
           "f64": tree_map(lambda t: t.double(), zero)}
    for name, tree in bad.items():
        with pytest.raises(ValueError, match="adapter structure"):
            server.register_lora(name, tree)
        assert name not in server._loras


def test_collect_batch_keeps_arrival_order(pipes):
    srv = SamplerServer(pipes["pipe"], batch_size=4, max_wait_s=0.0, **KW)
    srv.register_lora("A", pipes["loras"]["A"])
    srv.shutdown()  # the worker is gone: the queue is the test's
    items = [(GenerationRequest(prompt=f"p{i}", lora_id=lid), Future(), float(i))
             for i, lid in enumerate([None, "A", None, "A", "A"])]
    srv._pending.extend(items)
    taken = srv._take_matching("A", 2)
    assert [t[0].prompt for t in taken] == ["p1", "p3"]
    assert [t[0].prompt for t in srv._pending] == ["p0", "p2", "p4"]
    assert [t[0].prompt for t in srv._take_front(2)] == ["p0", "p2"]
    srv._pending.clear()


def test_collect_batch_failure_fails_pending_and_serving_goes_on(pipes):
    srv = _slow_server(pipes["pipe"])
    try:
        blocker = srv.submit(GenerationRequest(prompt="busy", seed=0))
        assert srv.started.wait(timeout=30)  # the worker waits inside the batch
        boom = {"n": 0}
        orig = srv._collect_batch

        def bad_collect():
            if boom["n"] == 0 and srv._pending:
                boom["n"] += 1
                raise RuntimeError("collector exploded")
            return orig()

        srv._collect_batch = bad_collect
        victim = srv.submit(GenerationRequest(prompt="x", seed=1))
        srv.release.set()
        assert blocker.result(timeout=5) is not None
        with pytest.raises(RuntimeError, match="exploded"):
            victim.result(timeout=5)
        assert srv.submit(GenerationRequest(prompt="y", seed=2)).result(timeout=5) is not None
    finally:
        srv.release.set()
        srv.shutdown(wait=False)


def test_http_codes(pipes):
    """200 (and /stats, /healthz), 400 for a bad seed, an unknown adapter
    and a missing prompt, 404, 429 with Retry-After when the queue is full."""
    srv = _slow_server(pipes["pipe"], max_queue=1)
    httpd, port = start_http_background(srv, port=0)
    url = f"http://127.0.0.1:{port}"

    def post(body, path="/generate"):
        return urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST")

    def code_of(req):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        return ei.value

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True}
        with urllib.request.urlopen(post({"prompt": "hi", "seed": 3, "output": "none"}), timeout=30) as r:
            assert r.status == 200 and json.load(r)["seed"] == 3
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            assert json.load(r)["requests"] >= 0
        for body, frag in (({"prompt": "x", "seed": -5}, "seed"),
                           ({"prompt": "x", "lora_id": "nope"}, "unknown lora_id"),
                           ({"seed": 1}, "missing field 'prompt'")):
            err = code_of(post(body))
            assert err.code == 400 and frag in json.loads(err.read())["error"]
        assert code_of(post({"prompt": "x"}, "/nowhere")).code == 404
        assert code_of(urllib.request.Request(url + "/nowhere")).code == 404
        _hold_worker(srv)
        srv.submit(GenerationRequest(prompt="fill", seed=1))  # the queue is full
        err = code_of(post({"prompt": "over", "seed": 2, "output": "none"}))
        assert err.code == 429 and err.headers.get("Retry-After") is not None
    finally:
        srv.release.set()
        httpd.shutdown()
        httpd.server_close()
        srv.shutdown(wait=False)


def test_refusals(pipes):
    from faceposegenerator_tpu_torch.core.mesh import make_mesh

    pipe = pipes["pipe"]
    # over a mesh: the batch must divide the data axis, whose model axis is 1
    with pytest.raises(ValueError, match="data axis"):
        SamplerServer(pipe, batch_size=3, mesh=make_mesh(data=2, world_size=2, rank=0, device="cpu"), **KW)
    with pytest.raises(ValueError, match="model axis of 1"):
        RollingServer(pipe, batch_size=2, mesh=make_mesh(data=1, model=2, world_size=2, rank=1, device="cpu"), **KW)
    with pytest.raises(ValueError, match="ddpm"):
        SamplerServer(pipe, scheduler="dpm", parallel_window=2, **KW)
    with pytest.raises(ValueError, match="cfg_interval"):
        SamplerServer(pipe, parallel_window=2, cfg_interval=(0, 1), **KW)
    with pytest.raises(ValueError, match="unknown scheduler"):
        SamplerServer(pipe, scheduler="euler", **KW)
    for bad in (dict(parallel_window=2), dict(deepcache_interval=2), dict(tome_ratio=0.5), dict(cfg_interval=(0, 1))):
        with pytest.raises(ValueError, match="not composable with RollingServer"):
            RollingServer(pipe, **bad, **KW)


def test_stats_count_this_tests_requests(pipes):
    """The statistics of a server that served exactly these requests."""
    srv = SamplerServer(pipes["pipe"], batch_size=2, max_wait_s=1.0, **KW)
    try:
        srv.generate([GenerationRequest(prompt=f"s{i}", seed=i) for i in range(3)])
        s = srv.stats()
    finally:
        srv.shutdown()
    assert s["requests"] == 3 and s["batches"] == 2 and s["padded_slots"] == 1
    assert s["p50_batch_s"] > 0 and s["images_per_s"] > 0 and s["p50_queue_s"] >= 0


# --- images -------------------------------------------------------------------


def test_requests_are_deterministic_across_batches(server):
    """A request's image is the same alone (padded), first or second in a
    mixed batch, and differs across seeds and adapters."""
    r = GenerationRequest(prompt="a face portrait", seed=5, lora_id="A")
    alone = server.generate([r])[0]
    second = server.generate([GenerationRequest(prompt="other", seed=1, lora_id="B"), r])[1]
    first = server.generate([r, GenerationRequest(prompt="other", seed=2)])[0]
    np.testing.assert_array_equal(alone.image, second.image)
    np.testing.assert_array_equal(alone.image, first.image)
    seed = server.generate([GenerationRequest(prompt="a face portrait", seed=6, lora_id="A")])[0]
    lora = server.generate([GenerationRequest(prompt="a face portrait", seed=5, lora_id="B")])[0]
    assert np.abs(seed.image.astype(int) - alone.image).max() >= 1
    assert np.abs(lora.image.astype(int) - alone.image).max() >= 1


@pytest.mark.parametrize("dpm", [False, True], ids=["ddpm", "dpm"])
def test_tick_matches_jax(pipes, jax_runs, dpm):
    """One tick of the rolling engine from a shared state (slots at steps
    0, 1, 2 and S, adapters A, B, none, A, scales 1, 0.5, 1, 0.7; 128²) against
    JAX `rolling._tick` / `_tick_dpm`: 2e-4, the tiny UNet's tolerance."""
    st = tick_state(pipes, dpm)
    srv = RollingServer(pipes["pipe"], batch_size=len(TICK_STEPS), scheduler="dpm" if dpm else "ddpm",
                        num_inference_steps=S, height=TICK_H, width=TICK_H)
    try:
        for name, tree in pipes["loras"].items():
            srv.register_lora(name, tree)
        lora, _ = srv._stacked_lora(tuple(st["lora_ids"]))
        scale = torch.from_numpy(st["scale"])
        t = {k: torch.from_numpy(st[k]) for k in ("latents", "ctx", "noise", "m0", "m1")}
        steps = torch.from_numpy(TICK_STEPS).long()
        if dpm:
            got = srv._tick_dpm(t["latents"], t["m0"], t["m1"], steps, t["ctx"], lora, scale)
        else:
            got = srv._tick(t["latents"], steps, t["ctx"], t["noise"], lora, scale)
    finally:
        srv.shutdown()
    want = jax_runs["tick_dpm" if dpm else "tick"].result()
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(got[-1].numpy(), want[-1])
    assert torch.equal(got[0][-1], t["latents"][-1])  # the free slot is frozen


@pytest.mark.parametrize("scheduler", ["ddpm", "dpm"])
def test_rolling_matches_batch_engine(pipes, scheduler):
    """Six requests through 3 rolling slots, two admitted mid-flight, each
    within 1 uint8 code of the batch engine's image of the same request."""
    pipe = pipes["pipe"]
    kw = dict(KW, scheduler=scheduler)
    reqs = [GenerationRequest(prompt=f"roll {i}", seed=20 + i, lora_id=(None, "A", "B")[i % 3]) for i in range(6)]
    roll = RollingServer(pipe, batch_size=3, max_wait_s=0.0, **kw)
    batch = SamplerServer(pipe, batch_size=3, max_wait_s=0.0, multi_lora=True, **kw)
    try:
        for srv in (roll, batch):
            for name, tree in pipes["loras"].items():
                srv.register_lora(name, tree)
        futs = [roll.submit(r) for r in reqs[:4]]
        deadline = time.time() + 60
        while roll.stats()["ticks"] < 1 and not futs[0].done():
            assert time.time() < deadline, "the rolling engine did not tick"
            time.sleep(0.01)
        futs += [roll.submit(r) for r in reqs[4:]]
        got = [f.result(timeout=120) for f in futs]
        want = batch.generate(reqs)
        stats = roll.stats()
    finally:
        roll.shutdown()
        batch.shutdown()
    for g, w in zip(got, want):
        assert np.abs(g.image.astype(int) - w.image.astype(int)).max() <= 1
    assert stats["requests"] == 6 and stats["ticks"] >= 2 * S
