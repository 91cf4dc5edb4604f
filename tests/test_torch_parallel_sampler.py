"""The port's parallel-in-time sampler against the JAX package's, and its
routes: the pipeline's `parallel_window` and the engine's.

The tiny serving models of tests/test_torch_serving.py (64², fp32), 4 DDPM
steps, a window of 2, batch 2 with per-request adapters A and B (so the
adapters are tiled W× inside each CFG half), the same numpy noise on both
sides. At tolerance 0 every iteration accepts one step: n_iters = S, and
with a window of 1 the images are bit-equal to the sequential sampler's
(with a wider window the UNet runs W·2B rows, which the CPU's kernels round
otherwise than 2B rows). At tolerance 8 the window takes 2 steps once: 3
iterations on both sides. JAX compiles `sample_parallel` once per
tolerance (a static argument), both on worker threads.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.diffusion import schedulers as jsched
from faceposegenerator_tpu.diffusion.parallel_sampler import sample_parallel as jsample_parallel
from faceposegenerator_tpu_torch.core.mesh import make_mesh
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.core.tree import tree_map
from faceposegenerator_tpu_torch.diffusion.parallel_sampler import sample_parallel
from faceposegenerator_tpu_torch.diffusion.sampler import sample
from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
from faceposegenerator_tpu_torch.serving import GenerationRequest, SamplerServer

from test_torch_serving import build_pipes, one_torch_thread  # noqa: F401 (autouse)

S, W, H = 4, 2, 64
PROMPTS = ["face portrait photo of woman sks person", "face side-portrait photo of old man sks person"]
SCALE = np.array([1.0, 0.5], np.float32)
TOLERANCES = (0.0, 8.0)
# a wider window against the sequential chain: JAX's own bound
# (tests/test_parallel_sampler.py:71)
SEQ_TOL = 2e-4


def _noise():
    return np.random.default_rng(3).standard_normal((S + 1, 2, H // 8, H // 8, 4)).astype(np.float32)


def _jax_run(p, tolerance):
    jp = p["jpipe"]
    lora = jax.tree.map(lambda a, b: jnp.stack([a, b]), p["jloras"]["A"], p["jloras"]["B"])
    img, n = jsample_parallel(jp.params, jsched.make_ddpm(num_inference_steps=S), jp.tokenize(PROMPTS),
                              jp.tokenize([""] * 2), jax.random.key(0), models=jp.models, guidance_scale=5.0,
                              height=H, width=H, policy=JPOLICY, lora=lora, lora_scale=jnp.asarray(SCALE),
                              noise_override=jnp.asarray(_noise()), window=W, tolerance=tolerance, return_stats=True)
    return np.asarray(img), int(n)


@pytest.fixture(scope="module")
def setup():
    p = build_pipes()
    pool = ThreadPoolExecutor(max_workers=len(TOLERANCES))
    p["jax"] = {tol: pool.submit(_jax_run, p, tol) for tol in TOLERANCES}
    yield p
    pool.shutdown(wait=True)


def _port(p, **kw):
    pipe = p["pipe"]
    lora = tree_map(lambda a, b: torch.stack([a, b]), p["loras"]["A"], p["loras"]["B"])
    common = dict(guidance_scale=5.0, height=H, width=H, policy=PARITY_POLICY, lora=lora,
                  lora_scale=torch.from_numpy(SCALE), noise_override=_noise())
    ids, neg = pipe.tokenize(PROMPTS), pipe.tokenize([""] * 2)
    if "tolerance" not in kw:
        return sample(pipe.nets, make_ddpm(num_inference_steps=S), ids, neg, **common)
    return sample_parallel(pipe.nets, make_ddpm(num_inference_steps=S), ids, neg, return_stats=True, **common, **kw)


def test_tolerance_zero_walks_the_sequential_chain(setup):
    seq = _port(setup)
    one, n1 = _port(setup, window=1, tolerance=0.0)
    assert n1 == S and torch.equal(one, seq)
    wide, n2 = _port(setup, window=W, tolerance=0.0)
    assert n2 == S
    np.testing.assert_allclose(wide.numpy(), seq.numpy(), atol=SEQ_TOL, rtol=0)


@pytest.mark.parametrize("tolerance", TOLERANCES)
def test_matches_jax_sample_parallel(setup, tolerance):
    img, n = _port(setup, window=W, tolerance=tolerance)
    want, want_n = setup["jax"][tolerance].result()
    assert n == want_n == (S if tolerance == 0.0 else S - 1)
    np.testing.assert_allclose(img.numpy(), want, atol=3e-4, rtol=0)


def test_pipeline_and_engine_routes(setup):
    """`parallel_window` on the pipeline takes `sample_parallel` (and its
    errors for DPM and a guidance interval); on the engine at batch 1 and
    tolerance 0 it gives the sequential server's image within 1 uint8 code."""
    pipe = setup["pipe"]
    ids = pipe.tokenize(PROMPTS)
    kw = dict(input_ids=ids, num_inference_steps=S, height=H, width=H, seed=4)
    got = pipe(parallel_window=W, parallel_tolerance=0.0, **kw)
    want = pipe(**kw)
    np.testing.assert_allclose(got, want, atol=SEQ_TOL, rtol=0)
    with pytest.raises(ValueError, match="cfg_interval"):
        pipe(parallel_window=W, cfg_interval=(0, 1), **kw)
    pipe.set_scheduler("dpm")
    try:
        with pytest.raises(ValueError, match="ddpm"):
            pipe(parallel_window=W, **kw)
    finally:
        pipe.set_scheduler("ddpm")
    # a mesh of one rank takes the mesh path (its gather and broadcast are
    # no-ops) and gives the same images; a window that does not divide the
    # data axis raises
    noise = torch.from_numpy(_noise()[:, :1])
    plain, one_rank = (sample_parallel(pipe.nets, make_ddpm(num_inference_steps=S), ids[:1], ids[:1], window=W,
                                       tolerance=0.0, height=H, width=H, noise_override=noise, policy=pipe.policy,
                                       mesh=mesh) for mesh in (None, make_mesh(world_size=1, rank=0, device="cpu")))
    torch.testing.assert_close(one_rank, plain, rtol=0, atol=0)
    with pytest.raises(ValueError, match="data axis"):
        sample_parallel(pipe.nets, make_ddpm(num_inference_steps=S), ids, ids, window=W,
                        mesh=make_mesh(data=3, world_size=3, rank=0, device="cpu"))
    req = GenerationRequest(prompt=PROMPTS[0], seed=11)
    servers = [SamplerServer(pipe, batch_size=1, max_wait_s=0.0, num_inference_steps=S, height=H, width=H, **extra)
               for extra in (dict(parallel_window=W, parallel_tolerance=0.0), {})]
    try:
        par, seq = (srv.generate([req])[0].image for srv in servers)
    finally:
        for srv in servers:
            srv.shutdown()
    assert np.abs(par.astype(int) - seq.astype(int)).max() <= 1
