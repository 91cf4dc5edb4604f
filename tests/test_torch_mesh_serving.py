"""The port's servers over a mesh (`SamplerServer(mesh=)`,
`RollingServer(mesh=)`, `sample_parallel(mesh=)` and `serve --data_parallel
N`) on gloo ranks on the CPU, held against the one-process port and the JAX
package's one-device results.

One module-scoped launch runs, all at once: this file as a script in a job
of two ranks (one torch thread a rank, no JAX), a second job of two ranks
whose rank 1 raises inside its first batch, and `serve` from one process
and with `--data_parallel 2` on the tiny directory of tests/test_torch_cli.py
(2 steps, 64², batch 2); the parent computes JAX's results on a worker
thread meanwhile. The ports come from binding port 0; every process group
times out after 120 s, and no process outlives the fixture.

The models are the tiny ones of tests/test_torch_serving.py (64², 3 steps,
fp32 `PARITY_POLICY`), JAX `init` trees filled from a numpy seed and carried
into the port. Legs and tolerances:
  - `SamplerServer(mesh=)` at batch 4 over 2 ranks (2 slots a rank): three
    requests under adapter A (a batch with one pad slot) and, under
    `multi_lora`, four under A, B, none and A; both adapters registered on
    rank 0 after the server started. Rank 0's uint8 images within 1 code of
    the one-process port server's and of JAX's one-device `sample` fed the
    same noise (each request's own seed stream); the same requests again
    give the same images; rank 1 holds the adapters bit-equal.
  - `RollingServer(mesh=)` at 4 slots (2 a rank), DDPM and DPM-Solver++, two
    requests admitted first and three more after the first tick (one waits
    for a free slot): within 1 code of the one-process rolling server.
  - `sample_parallel(mesh=)` at batch 2 (adapters A and B a request), 4
    DDPM steps, a window of 2 (1 position a rank), tolerance 0: within 1e-5
    of the one-process port and within 1e-3 of JAX's `sample_parallel`, JAX's
    own cross-placement bound (tests/test_parallel_sampler.py:166-170).
  - w8a8 on both ranks, calibrated on rank 0 alone: the server gives rank 1
    rank 0's static scales; the images within 1 code of one process's.
  - `serve --data_parallel 2 --device cpu` from one command: its PNG within
    1 code of the one-process `serve`'s.
  - A rank that raises inside a batch ends its job non-zero within the
    timeout.
  - The refusals: `batch_size % data`, `window % data`, a model axis above 1.
"""

import base64
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_cli import light_model_dir  # noqa: F401 (fixture)

TIMEOUT_S = 120.0
TEXT = dict(vocab_size=512, hidden_size=48, num_layers=2, num_heads=4, intermediate_size=96)
UNET = dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=48, head_dim=8)
VAE = dict(block_out_channels=(32, 32, 32, 32))
S, H, BATCH = 3, 128, 4
KW = dict(num_inference_steps=S, height=H, width=H)
UNIFORM = [("face portrait photo of sks person", "", 11, "A"), ("face side-portrait photo of man", "blurry", 12, "A"),
           ("old woman sks person", "", 13, "A")]
MIXED = [("face portrait photo of sks person", "", 21, "A"), ("young man sks person", "cartoon", 22, "B"),
         ("face photo", "", 23, None), ("old woman sks person", "", 24, "A")]
ROLL = [(f"rolling prompt {i}", "" if i % 2 else "blurry", 31 + i, (None, "A", "B")[i % 3]) for i in range(5)]
PAR_S, PAR_W = 4, 2
PAR_PROMPTS = ["face portrait photo of woman sks person", "face side-portrait photo of old man sks person"]
PAR_SCALE = [1.0, 0.5]
SERVE_ARGV = ["--size", "64", "--steps", "2", "--batch_size", "2", "--device", "cpu", "--max_wait_ms", "10"]
SERVE_REQUEST = {"prompt": "face portrait photo of sks person", "seed": 5}


# --------------------------------------------------------------------------
# the ranks (this file run as a script; no JAX)
# --------------------------------------------------------------------------

def _pipe(inp):
    from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.data.tokenizer import CLIPTokenizer
    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    models = SamplerModels(text_cfg=clip_text.CLIPTextConfig(**TEXT), unet_cfg=unet2d.UNetConfig(**UNET),
                           vae_cfg=vae.VAEConfig(**VAE))
    pipe = StableDiffusionPipeline.from_random(models=models, device="cpu", policy=PARITY_POLICY,
                                               tokenizer=CLIPTokenizer(inp["vocab"], [], 77))
    for name, net in pipe.nets.items():
        load_jax_params(net, inp["params"][name])
    return pipe


def _loras(inp):
    from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch

    return {name: jax_tree_to_torch(tree, "cpu", torch.float32) for name, tree in inp["loras"].items()}


def _requests(spec):
    from faceposegenerator_tpu_torch.serving import GenerationRequest

    return [GenerationRequest(prompt=p, negative_prompt=n, seed=s, lora_id=a) for p, n, s, a in spec]


def _images(results):
    return np.stack([r.image for r in results])


def _staggered(srv, reqs):
    """Two requests, then the rest once the first tick has run."""
    futs = [srv.submit(r) for r in reqs[:2]]
    deadline = time.monotonic() + 60
    while srv.stats()["ticks"] < 1:
        assert time.monotonic() < deadline, "the rolling server ran no tick"
        time.sleep(0.005)
    futs += [srv.submit(r) for r in reqs[2:]]
    return np.stack([f.result(timeout=TIMEOUT_S).image for f in futs])


def _par_inputs(pipe, loras):
    from faceposegenerator_tpu_torch.core.tree import tree_map

    lora = {"unet": tree_map(lambda a, b: torch.stack([a, b]), loras["A"]["unet"], loras["B"]["unet"]),
            "text_encoder": tree_map(lambda a, b: torch.stack([a, b]), loras["A"]["text_encoder"],
                                     loras["B"]["text_encoder"])}
    return dict(lora=lora, lora_scale=torch.tensor(PAR_SCALE), height=H, width=H, policy=pipe.policy)


def _references(inp, pipe, loras):
    """Rank 0, one process: the batch servers', the rolling servers' and
    `sample_parallel`'s results."""
    from faceposegenerator_tpu_torch.diffusion.parallel_sampler import sample_parallel
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.serving import RollingServer, SamplerServer

    out = {}
    for key, spec, multi in (("uniform", UNIFORM, False), ("mixed", MIXED, True)):
        srv = SamplerServer(pipe, batch_size=BATCH, max_wait_s=1.0, multi_lora=multi, **KW)
        try:
            for name, tree in loras.items():
                srv.register_lora(name, tree)
            out[key] = _images(srv.generate(_requests(spec)))
        finally:
            srv.shutdown()
    for sched in ("ddpm", "dpm"):
        srv = RollingServer(pipe, batch_size=BATCH, scheduler=sched, **KW)
        try:
            for name, tree in loras.items():
                srv.register_lora(name, tree)
            out[f"rolling_{sched}"] = _staggered(srv, _requests(ROLL))
        finally:
            srv.shutdown()
    out["parallel"] = sample_parallel(pipe.nets, make_ddpm(num_inference_steps=PAR_S), inp["par_ids"],
                                      inp["par_neg"], window=PAR_W, tolerance=0.0,
                                      noise_override=torch.from_numpy(inp["par_noise"]),
                                      **_par_inputs(pipe, loras)).numpy()
    return out


def _digest(tree):
    from faceposegenerator_tpu_torch.core.tree import tree_paths

    return {p: leaf.numpy().copy() for p, leaf in tree_paths(tree)}


def _legs(inp, out, rank, mesh):
    from faceposegenerator_tpu_torch.core import dist
    from faceposegenerator_tpu_torch.diffusion.parallel_sampler import sample_parallel
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.serving import RollingServer, SamplerServer

    pipe, loras = _pipe(inp), _loras(inp)
    if rank == 0:
        out["refs"] = _references(inp, pipe, loras)
    dist.coordination_barrier("refs", TIMEOUT_S)
    pipe.to_mesh(mesh)  # rank 0's weights, broadcast once; the servers then broadcast none
    servers = (("uniform", UNIFORM, SamplerServer, dict(multi_lora=False)),
               ("mixed", MIXED, SamplerServer, dict(multi_lora=True)),
               ("rolling_ddpm", ROLL, RollingServer, dict(scheduler="ddpm")),
               ("rolling_dpm", ROLL, RollingServer, dict(scheduler="dpm")))
    for key, spec, cls, extra in servers:
        srv = cls(pipe, batch_size=BATCH, max_wait_s=1.0, mesh=mesh, **extra, **KW)
        if rank != 0:
            srv.join()
            out[f"{key}_loras"] = {name: _digest(tree) for name, (tree, _) in srv._loras.items()}
            continue
        try:
            for name, tree in loras.items():  # after the start: through the worker thread
                srv.register_lora(name, tree)
            reqs = _requests(spec)
            if cls is RollingServer:
                out[key] = _staggered(srv, reqs)
            else:
                out[key] = _images(srv.generate(reqs))
                out[f"{key}_again"] = _images(srv.generate(reqs))
            out[f"{key}_stats"] = srv.stats()
        finally:
            srv.shutdown()
        srv.join()
        out[f"{key}_loras"] = {name: _digest(tree) for name, (tree, _) in srv._loras.items()}
    out["parallel"] = sample_parallel(pipe.nets, make_ddpm(num_inference_steps=PAR_S), inp["par_ids"],
                                      inp["par_neg"], window=PAR_W, tolerance=0.0,
                                      noise_override=torch.from_numpy(inp["par_noise"]), mesh=mesh,
                                      **_par_inputs(pipe, loras)).numpy()
    _quantized(pipe, out, rank, mesh)


def _quantized(pipe, out, rank, mesh):
    """Every rank quantizes, rank 0 alone calibrates (as `serve
    --quant_calibrate` does), and the server gives every rank rank 0's
    static scales; rank 0 then serves the same requests in one process."""
    from faceposegenerator_tpu_torch.ops.quant import quantized_sites
    from faceposegenerator_tpu_torch.serving import SamplerServer

    pipe.quantize("w8a8")
    if rank == 0:
        pipe.calibrate_quant(["face portrait photo of sks person"], steps=1, height=H, width=H)
    srv = SamplerServer(pipe, batch_size=BATCH, max_wait_s=1.0, mesh=mesh, **KW)
    sites = quantized_sites({"unet": pipe.nets["unet"], "vae": pipe.nets["vae"]})
    out["quant_scales"] = {path: w.a for path, w in sorted(sites.items())}
    if rank != 0:
        srv.join()
        return
    reqs = _requests([(p, n, seed, None) for p, n, seed, _ in UNIFORM])
    out["quant"] = _images(srv.generate(reqs))
    srv.shutdown()
    srv.join()
    one = SamplerServer(pipe, batch_size=BATCH, max_wait_s=1.0, **KW)
    try:
        out["quant_one"] = _images(one.generate(reqs))
    finally:
        one.shutdown()


def _failing(inp, out, rank, mesh):
    """Rank 1 raises inside its first batch: rank 0's request fails and the
    job ends non-zero."""
    from faceposegenerator_tpu_torch.serving import SamplerServer

    pipe = _pipe(inp)
    if rank == 1:
        def broken(h):
            raise RuntimeError("injected failure in rank 1's batch")

        SamplerServer._run_batch = lambda self, h: broken(h)
    srv = SamplerServer(pipe, batch_size=2, max_wait_s=0.0, mesh=mesh, **KW)
    if rank == 1:
        srv.join()
        return
    fut = srv.submit(_requests([("a request", "", 1, None)])[0])
    print(f"rank 0's request failed: {fut.exception(timeout=TIMEOUT_S)!r}", flush=True)
    srv.join()


def _rank_main(inputs_path, out_dir, rank, world, port, mode):
    torch.set_num_threads(1)
    from faceposegenerator_tpu_torch.core import dist
    from faceposegenerator_tpu_torch.core.mesh import make_mesh

    inp = torch.load(inputs_path, weights_only=False)
    dist.init_distributed(f"127.0.0.1:{port}", world, rank, platform="cpu", timeout_s=TIMEOUT_S)
    out = {}
    (_legs if mode == "legs" else _failing)(inp, out, rank, make_mesh(data=world, device="cpu"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier("saved")
    dist.shutdown()


# --------------------------------------------------------------------------
# the parent: inputs, JAX's results, the launch
# --------------------------------------------------------------------------

def _inputs():
    import jax

    from faceposegenerator_tpu.models import clip_text as jclip
    from faceposegenerator_tpu.models import unet2d as junet
    from faceposegenerator_tpu.models import vae as jvae
    from faceposegenerator_tpu_torch.data.tokenizer import CLIPTokenizer
    from faceposegenerator_tpu_torch.serving.engine import request_noise
    from test_torch_checkpoints import jax_lora, numpy_init
    from test_torch_serving import byte_vocab

    params = {"text_encoder": numpy_init(jclip.init, jclip.CLIPTextConfig(**TEXT), 0),
              "unet": numpy_init(junet.init, junet.UNetConfig(**UNET), 1),
              "vae": numpy_init(jvae.init, jvae.VAEConfig(**VAE), 2)}
    params = jax.tree.map(np.asarray, params)
    loras = {name: jax.tree.map(np.asarray, jax_lora(params, seed=s)) for name, s in (("A", 30), ("B", 31))}
    tok = CLIPTokenizer(byte_vocab(), [], 77)
    ids = torch.from_numpy(tok(PAR_PROMPTS)).long()
    noise = request_noise([41, 42], PAR_S, H // 8, H // 8, "cpu").numpy()
    return {"params": params, "loras": loras, "vocab": byte_vocab(), "par_ids": ids,
            "par_neg": torch.from_numpy(tok([""] * 2)).long(), "par_noise": noise}


def _padded(spec):
    return spec + [spec[0]] * (BATCH - len(spec))


def _jax_results(inp):
    """JAX's one-device `sample` on each batch as the server pads it, every
    slot under its own adapter (the zero adapter for none) and its seed's
    stream; JAX's `sample_parallel` on the parallel leg's inputs."""
    import jax
    import jax.numpy as jnp

    from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
    from faceposegenerator_tpu.diffusion import schedulers as jsched
    from faceposegenerator_tpu.diffusion.parallel_sampler import sample_parallel as jsample_parallel
    from faceposegenerator_tpu.diffusion.sampler import SamplerModels as JModels
    from faceposegenerator_tpu.diffusion.sampler import sample as jsample
    from faceposegenerator_tpu.models import clip_text as jclip
    from faceposegenerator_tpu.models import unet2d as junet
    from faceposegenerator_tpu.models import vae as jvae
    from faceposegenerator_tpu.serving.engine import _quantize_u8
    from faceposegenerator_tpu_torch.data.tokenizer import CLIPTokenizer
    from faceposegenerator_tpu_torch.serving.engine import request_noise

    models = JModels(text_cfg=jclip.CLIPTextConfig(**TEXT), unet_cfg=junet.UNetConfig(**UNET),
                     vae_cfg=jvae.VAEConfig(**VAE))
    tok = CLIPTokenizer(inp["vocab"], [], 77)
    zero = jax.tree.map(np.zeros_like, inp["loras"]["A"])
    res = {}
    for key, spec in (("uniform", UNIFORM), ("mixed", MIXED)):
        padded = _padded(spec)
        trees = [inp["loras"][a] if a else zero for _, _, _, a in padded]
        lora = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
        noise = request_noise([s for _, _, s, _ in padded], S, H // 8, H // 8, "cpu").numpy()
        img = jsample(inp["params"], jsched.make_ddpm(num_inference_steps=S), jnp.asarray(tok([p for p, *_ in padded])),
                      jnp.asarray(tok([n for _, n, *_ in padded])), jax.random.key(0), models=models, height=H,
                      width=H, policy=JPOLICY, lora=lora, lora_scale=jnp.ones(BATCH), noise_override=jnp.asarray(noise))
        res[key] = np.asarray(_quantize_u8(img))[:len(spec)]
    lora = jax.tree.map(lambda a, b: jnp.stack([a, b]), inp["loras"]["A"], inp["loras"]["B"])
    res["parallel"] = np.asarray(jsample_parallel(
        inp["params"], jsched.make_ddpm(num_inference_steps=PAR_S), jnp.asarray(inp["par_ids"].numpy()),
        jnp.asarray(inp["par_neg"].numpy()), jax.random.key(0), models=models, guidance_scale=5.0, height=H, width=H,
        policy=JPOLICY, lora=lora, lora_scale=jnp.asarray(PAR_SCALE, jnp.float32),
        noise_override=jnp.asarray(inp["par_noise"]), window=PAR_W, tolerance=0.0))
    return res


_LAUNCH_ENV = ("FPG_COORDINATOR", "FPG_NUM_PROCESSES", "FPG_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "LOCAL_RANK")


def _job(inputs_path, out, mode):
    from faceposegenerator_tpu_torch.core.dist import free_port, spawn

    os.makedirs(out)
    port = free_port()
    cmds = [[sys.executable, os.path.abspath(__file__), inputs_path, out, str(r), "2", str(port), mode]
            for r in range(2)]
    t0 = time.monotonic()
    try:
        spawn(cmds, lambda i: {"OMP_NUM_THREADS": "1"}, TIMEOUT_S, log_dir=out)
    except Exception as e:  # the failing job's end, kept for its test
        if mode == "legs":
            raise
        return {"error": e, "s": time.monotonic() - t0}
    if mode != "legs":
        return {"error": None, "s": time.monotonic() - t0}
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]


def _start_serve(model_dir, port, log, extra=()):
    """`serve` as a process group of its own (its ranks included)."""
    argv = [sys.executable, "-m", "faceposegenerator_tpu_torch.cli", "serve", "--model_dir", str(model_dir),
            "--port", str(port), *SERVE_ARGV, *extra]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(filter(None, (root, env.get("PYTHONPATH")))))
    return subprocess.Popen(argv, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)


def _serve_png(proc, port, log_path):
    """POST the request once /healthz answers; the PNG as uint8."""
    from PIL import Image

    deadline = time.monotonic() + TIMEOUT_S
    while True:
        assert proc.poll() is None, f"serve exited with {proc.returncode}: {open(log_path).read()[-3000:]}"
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                if r.status == 200:
                    break
        except OSError:
            assert time.monotonic() < deadline, f"serve did not start: {open(log_path).read()[-3000:]}"
            time.sleep(0.2)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(SERVE_REQUEST).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
        out = json.load(r)
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image"]))))


@pytest.fixture(scope="module")
def launch(tmp_path_factory, light_model_dir):  # noqa: F811 (fixture)
    from faceposegenerator_tpu_torch.core.dist import free_port

    tmp = str(tmp_path_factory.mktemp("mesh_serving"))
    inp = _inputs()
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inp, path)
    pool = ThreadPoolExecutor(max_workers=2)
    jax_future = pool.submit(_jax_results, inp)
    ports = {k: free_port() for k in ("one", "dp")}
    logs = {k: open(os.path.join(tmp, f"serve_{k}.log"), "w") for k in ports}
    procs = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            for k in _LAUNCH_ENV:
                mp.delenv(k, raising=False)
            for k, extra in (("one", ()), ("dp", ("--data_parallel", "2"))):
                procs[k] = _start_serve(light_model_dir, ports[k], logs[k], extra)
            failing = pool.submit(_job, path, os.path.join(tmp, "failing"), "fail")
            ranks = _job(path, os.path.join(tmp, "legs"), "legs")
        pngs = {k: _serve_png(procs[k], ports[k], logs[k].name) for k in procs}
        yield {"ranks": ranks, "jax": jax_future.result(), "failing": failing.result(), "pngs": pngs,
               "logs": os.path.join(tmp, "failing")}
    finally:
        for p in procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        for f in logs.values():
            f.close()
        pool.shutdown()


def _within_one_code(got, want, what):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert got.shape == want.shape and diff.max() <= 1, f"{what}: {diff.max()} codes apart"


@pytest.mark.parametrize("key", ["uniform", "mixed"], ids=["one_adapter_padded_batch", "multi_lora"])
def test_mesh_server_matches_one_process_and_jax(launch, key):
    r0 = launch["ranks"][0]
    assert r0[key].shape == (len(UNIFORM if key == "uniform" else MIXED), H, H, 3)
    _within_one_code(r0[key], r0["refs"][key], "mesh server vs one-process server")
    _within_one_code(r0[key], launch["jax"][key], "mesh server vs JAX sample")
    np.testing.assert_array_equal(r0[f"{key}_again"], r0[key])
    stats = r0[f"{key}_stats"]
    assert stats["requests"] == 2 * len(UNIFORM if key == "uniform" else MIXED) and stats["batches"] == 2
    if key == "uniform":
        assert stats["padded_slots"] == 2


def test_register_lora_after_start_reaches_the_workers(launch):
    for key in ("uniform", "mixed", "rolling_ddpm", "rolling_dpm"):
        want, got = (r[f"{key}_loras"] for r in launch["ranks"])
        assert list(got) == list(want) == [None, "A", "B"]
        for name in ("A", "B"):
            assert sorted(got[name]) == sorted(want[name])
            for path, leaf in want[name].items():
                np.testing.assert_array_equal(got[name][path], leaf, err_msg=f"{key} {name} {path}")


@pytest.mark.parametrize("sched", ["ddpm", "dpm"])
def test_mesh_rolling_server_matches_one_process(launch, sched):
    r0 = launch["ranks"][0]
    assert r0[f"rolling_{sched}"].shape == (len(ROLL), H, H, 3)
    _within_one_code(r0[f"rolling_{sched}"], r0["refs"][f"rolling_{sched}"], f"rolling {sched}")
    assert r0[f"rolling_{sched}_stats"]["requests"] == len(ROLL)


def test_sample_parallel_over_the_mesh(launch):
    r0, r1 = launch["ranks"]
    np.testing.assert_array_equal(r0["parallel"], r1["parallel"])
    np.testing.assert_allclose(r0["parallel"], r0["refs"]["parallel"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(r0["parallel"], launch["jax"]["parallel"], atol=1e-3, rtol=0)


def test_quantized_mesh_server_runs_rank_0s_static_scales(launch):
    """w8a8 on every rank, calibrated on rank 0 alone: the server gives rank
    1 rank 0's static scales, and the images are within 1 code of one
    process's with the same scales."""
    r0, r1 = launch["ranks"]
    assert r0["quant_scales"] and all(a is not None for a in r0["quant_scales"].values())
    assert r1["quant_scales"] == r0["quant_scales"]
    _within_one_code(r0["quant"], r0["quant_one"], "quantized mesh server vs one process")


def test_serve_data_parallel_spawns_ranks_that_answer_as_one_process(launch):
    pngs = launch["pngs"]
    assert pngs["dp"].shape == (64, 64, 3)
    _within_one_code(pngs["dp"], pngs["one"], "serve --data_parallel 2 vs serve")


def test_a_failing_rank_ends_the_job(launch):
    failing = launch["failing"]
    assert failing["error"] is not None and failing["error"].returncode != 0
    assert failing["s"] < TIMEOUT_S
    assert "injected failure in rank 1's batch" in open(os.path.join(launch["logs"], "rank1.log")).read()


def test_refusals():
    from faceposegenerator_tpu_torch.core.mesh import make_mesh
    from faceposegenerator_tpu_torch.diffusion.parallel_sampler import sample_parallel
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.serving import RollingServer, SamplerServer

    data2 = make_mesh(data=2, world_size=2, rank=0, device="cpu")
    with pytest.raises(ValueError, match="data axis"):
        SamplerServer(object(), batch_size=3, mesh=data2, **KW)
    with pytest.raises(ValueError, match="data axis"):
        RollingServer(object(), batch_size=3, mesh=data2, **KW)
    with pytest.raises(ValueError, match="data axis"):
        SamplerServer(object(), batch_size=2, parallel_window=3, mesh=data2, **KW)
    with pytest.raises(ValueError, match="model axis of 1"):
        SamplerServer(object(), batch_size=2, mesh=make_mesh(data=1, model=2, world_size=2, rank=0, device="cpu"),
                      **KW)
    ids = torch.zeros((1, 77), dtype=torch.long)
    with pytest.raises(ValueError, match="data axis"):
        sample_parallel({"unet": None}, make_ddpm(num_inference_steps=S), ids, ids, window=3, mesh=data2)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), sys.argv[6])
