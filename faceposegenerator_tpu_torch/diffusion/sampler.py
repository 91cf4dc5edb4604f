"""txt2img sampler (port of `faceposegenerator_tpu/diffusion/sampler.py:59-406`):
CLIP on [uncond; cond] → S × (UNet on [x; x] → guidance → scheduler step) →
VAE decode → [0, 1], with DDPM or DPM-Solver++ 2M, and the opt-in
approximations of the turbo preset: a guidance interval (`cfg_interval`) and
DeepCache (`deepcache_interval`, `deepcache_depth`), and ToMe (`tome_*`).
Adapters may be per-request (`(B, r, in)` / `(B, out, r)` leaves and a
`(B,)` scale); `decode_chunk` decodes the batch in pieces.

The JAX package compiles this into one program; here `sample` draws the
noise and runs `_sample`, which `core.compile.jit` captures as one CUDA
graph per static key (JAX's `static_argnames`, and the port's `attn_impl`)
and replays. The loop is a Python loop whose step indices are host ints,
unrolled into the graph: the timesteps are one gather from the schedule's
device table, each step's coefficients are fp32 host scalars that the
schedule's `cache_key()` puts in the key, and no random number is drawn
inside it: the (S+1, B, h, w, 4) noise table is drawn before, from the
caller's generator, in the order the loop used to draw it (index 0, then
step i's noise at i + 1; DPM-Solver++ draws index 0 only). The JAX loop's
static segmentation is kept: under `cfg_interval=(i0, i1)` the steps
[0, i0) and [i1, S) run cond-only at batch B on the cond half of the text
context, each segment carries its own DeepCache cache, and a segment's
first step and every step whose index is a multiple of the interval run
the full UNet. ToMe's lattice tables are cached on the device by the
warm-up call.

`sample_data_parallel` and `sample_2d_parallel` run this loop on every
rank of a mesh, each on its rows of the batch (and its slice of the UNet).

`per_prompt_noise` draws a `noise_override` table whose slot streams depend
only on (identity, prompt) (sampler.py:413): the bits are the port's own,
from `core/rng.prompt_generator` (a `SeedSequence([identity, prompt])`), as
`core/rng.py` makes every stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.compile import jit, over_mesh, over_ranks
from ..core.precision import DEFAULT_POLICY, Policy
from ..core.rng import prompt_generator
from ..core.tree import tree_leaves, tree_map
from ..models import clip_text, unet2d, vae
from .schedulers import DDPMSchedule, DPMSolverSchedule


@dataclasses.dataclass(frozen=True)
class SamplerModels:
    """Configs of the three networks, and the attention impl they use."""

    text_cfg: clip_text.CLIPTextConfig = clip_text.SD21_TEXT_CONFIG
    unet_cfg: unet2d.UNetConfig = unet2d.SD21_UNET_CONFIG
    vae_cfg: vae.VAEConfig = vae.SD_VAE_CONFIG
    attn_impl: str = "auto"


# the static arguments of `_sample`: JAX's `sampler.sample` static_argnames
# (sampler.py:52-57) less `models` (here the modules carry their configs)
# and `unroll` (XLA's loop unrolling; a graph unrolls every step), plus the
# port's `attn_impl`
STATIC_ARGNAMES = ("guidance_scale", "height", "width", "policy", "scheduler", "attn_impl", "decode_chunk",
                   "deepcache_interval", "deepcache_depth", "tome_ratio", "tome_min_tokens", "tome_ops",
                   "cfg_interval", "return_trajectory")


@torch.inference_mode()
def sample(
    nets: dict,
    schedule,
    input_ids: torch.Tensor,
    negative_input_ids: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    guidance_scale: float = 5.0,
    height: int = 512,
    width: int = 512,
    policy: Policy = DEFAULT_POLICY,
    scheduler: str = "ddpm",
    attn_impl: str = "auto",
    lora: Optional[dict] = None,
    lora_scale=1.0,
    noise_override=None,
    decode_chunk: Optional[int] = None,
    deepcache_interval: int = 1,
    deepcache_depth: int = 1,
    tome_ratio: float = 0.0,
    tome_min_tokens: int = 4096,
    tome_ops: str = "attn",
    cfg_interval: Optional[tuple] = None,
    return_trajectory: bool = False,
    batch_rows: Optional[tuple] = None,
    mesh=None,
):
    """Generate (B, H, W, 3) fp32 images in [0, 1].

    nets: {"text_encoder": CLIPTextModel, "unet": UNet2DCondition,
    "vae": AutoencoderKL}. schedule: a DDPMSchedule (scheduler "ddpm") or a
    DPMSolverSchedule ("dpm"). input_ids / negative_input_ids: (B, 77) token
    ids. lora: {"unet": tree or None, "text_encoder": tree or None}; its
    leaves may carry a leading request axis, (B, r, in) / (B, out, r), with
    `lora_scale` a number or a (B,) tensor: slot b rides adapter b. On the
    CFG batch [uncond; cond] they tile ×2 so that slot b lines up with rows
    b and B + b; the cond-only steps of `cfg_interval` take them untiled
    (sampler.py:131-175).
    noise_override: (S+1, B, h, w, 4), the initial latent at index 0 and
    step i's noise at index i+1 (sampler.py:93-95), replacing `generator`;
    DPM-Solver++ draws no step noise and reads index 0 only.
    deepcache_interval=k > 1: full UNet on a segment's first step and on
    steps i % k == 0, the cached partial UNet otherwise (`forward_cached`).
    cfg_interval=(i0, i1): guidance only on steps i0 <= i < i1.
    tome_ratio > 0: ToMe in every UNet transformer of at least
    `tome_min_tokens` tokens, on every pass (`UNet2DCondition.forward`).
    decode_chunk: decode `decode_chunk` latents at a time when it divides
    B and is smaller than B (sampler.py:398-406); the whole batch otherwise.
    return_trajectory: also return the latents after each step, (S, B, h, w,
    4); exact paths only.
    batch_rows=(G, rows): these B prompts are rows `rows` of a batch of G
    (a data-parallel shard): `generator` draws the noise of all G rows, as
    one process does, and the rows are kept.
    mesh: the mesh this call runs on, where it runs on one.

    The loop runs in `_sample`, one captured CUDA graph per static key on
    the card (`core.compile`); a LoRA swap, a new seed or new prompts
    replay it. Over a mesh of more than one rank, or with a UNet placed
    over one (`parallel.tp`), it runs eagerly (`core.compile`'s argument
    rule).
    """
    expected = DDPMSchedule if scheduler == "ddpm" else DPMSolverSchedule if scheduler == "dpm" else None
    if expected is None:
        raise ValueError(scheduler)
    if not isinstance(schedule, expected):
        raise TypeError(f"scheduler {scheduler!r} takes a {expected.__name__}, got {type(schedule).__name__}")
    policy.configure_backends()
    device = nets["unet"].conv_in.weight.device
    B = input_ids.shape[0]
    h, w = height // 8, width // 8
    S = schedule.num_inference_steps
    if cfg_interval is not None:
        cfg_interval = (int(cfg_interval[0]), int(cfg_interval[1]))
        if not (0 <= cfg_interval[0] <= cfg_interval[1] <= S):
            raise ValueError(f"cfg_interval {cfg_interval} not within [0, {S}]")
    if return_trajectory and (deepcache_interval > 1 or tome_ratio > 0.0 or cfg_interval is not None):
        raise ValueError(
            "return_trajectory is a parity probe for the EXACT chain; "
            "it does not compose with deepcache/tome/cfg_interval"
        )
    if noise_override is not None:
        if not isinstance(noise_override, torch.Tensor):
            noise_override = torch.from_numpy(np.asarray(noise_override, np.float32))
        noise_override = noise_override.to(device=device, dtype=torch.float32)
        if noise_override.shape != (S + 1, B, h, w, 4):
            raise ValueError(f"noise_override {tuple(noise_override.shape)} != {(S + 1, B, h, w, 4)}")
    else:
        noise_override = draw_noise(generator, S, B, h, w, device, scheduler, batch_rows)
    ids = torch.cat([torch.as_tensor(negative_input_ids), torch.as_tensor(input_ids)]).to(device)
    if isinstance(lora_scale, torch.Tensor):
        lora_scale = lora_scale.to(device)
    schedule.device_timesteps(device)  # the table on the card before any capture
    return _sample(nets, schedule, ids, noise_override, lora, lora_scale, guidance_scale=guidance_scale,
                   height=height, width=width, policy=policy, scheduler=scheduler, attn_impl=attn_impl,
                   decode_chunk=decode_chunk, deepcache_interval=deepcache_interval,
                   deepcache_depth=deepcache_depth, tome_ratio=tome_ratio, tome_min_tokens=tome_min_tokens,
                   tome_ops=tome_ops, cfg_interval=cfg_interval, return_trajectory=return_trajectory,
                   ranks=1 if mesh is None else mesh.size)


def draw_noise(generator, S: int, B: int, h: int, w: int, device, scheduler: str = "ddpm",
               batch_rows: Optional[tuple] = None) -> torch.Tensor:
    """The (S+1, B, h, w, 4) fp32 noise table of a request, drawn from
    `generator` as the step loop drew it: index 0 the initial latent, index
    i + 1 step i's noise, each a (G, h, w, 4) draw of which rows `rows`
    are kept (`batch_rows=(G, rows)`, else all B). DPM-Solver++ draws
    index 0 only; its other rows are zeros, never read."""
    G, rows = batch_rows if batch_rows is not None else (B, slice(0, B))
    n = S + 1 if scheduler == "ddpm" else 1
    draws = [torch.randn((G, h, w, 4), generator=generator, device=device, dtype=torch.float32)[rows]
             for _ in range(n)]
    table = torch.stack(draws)
    if n < S + 1:
        table = torch.cat([table, table.new_zeros((S + 1 - n,) + tuple(table.shape[1:]))])
    return table


@jit(static_argnames=STATIC_ARGNAMES,
     eager_if=lambda nets, *a, ranks=1, **kw: over_ranks(ranks=ranks) or over_mesh(nets["unet"]))
def _sample(nets: dict, schedule, ids: torch.Tensor, noise: torch.Tensor, lora: Optional[dict], lora_scale, *,
            guidance_scale: float, height: int, width: int, policy: Policy, scheduler: str, attn_impl: str,
            decode_chunk: Optional[int], deepcache_interval: int, deepcache_depth: int, tome_ratio: float,
            tome_min_tokens: int, tome_ops: str, cfg_interval: Optional[tuple], return_trajectory: bool,
            ranks: int = 1):
    """The step loop and the decode of `sample`: ids the (2B, 77) [negative;
    prompt] ids on the card, noise the (S+1, B, h, w, 4) table; `ranks` the
    size of the mesh the call runs over (the argument rule)."""
    unet = nets["unet"]
    B = ids.shape[0] // 2
    S = schedule.num_inference_steps
    timesteps = schedule.device_timesteps(ids.device)
    lora = lora or {}
    # per-request adapters: the cond-only passes take them as given, the
    # CFG batch tiled ×2
    tome = dict(tome_ratio=tome_ratio, tome_min_tokens=tome_min_tokens, tome_ops=tome_ops)
    kw_cond = dict(policy=policy, lora=lora.get("unet"), lora_scale=lora_scale, attn_impl=attn_impl, **tome)
    leaves = tree_leaves(lora)
    if leaves and leaves[0].dim() == 3:
        lora = tree_map(lambda t: torch.cat([t, t]), lora)
        if isinstance(lora_scale, torch.Tensor) and lora_scale.dim() == 1:
            lora_scale = torch.cat([lora_scale, lora_scale])
    ctx = nets["text_encoder"](ids, policy, lora=lora.get("text_encoder"), lora_scale=lora_scale)
    kw = dict(policy=policy, lora=lora.get("unet"), lora_scale=lora_scale, attn_impl=attn_impl, **tome)

    def guided_eps(x, t, cond_only, cache, full):
        """ε̂ at step timestep t: CFG on [x; x] or cond-only on x; with
        DeepCache, the full pass (which refreshes the cache) or the partial
        one over `cache`."""
        lat, c, k = (x, ctx[B:], kw_cond) if cond_only else (torch.cat([x, x]), ctx, kw)
        if deepcache_interval > 1:
            eps, cache = unet.forward_cached(lat, t, c, depth=deepcache_depth,
                                             cached=None if full else cache, **k)
        else:
            eps = unet(lat, t, c, **k)
        if not cond_only:
            eps_u, eps_c = eps.chunk(2)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
        return eps, cache

    if cfg_interval is None:
        segments = [(0, S, False)]
    else:
        i0, i1 = cfg_interval
        segments = [(0, i0, True), (i0, i1, False), (i1, S, True)]
    x = noise[0]
    state = schedule.init_state(x) if scheduler == "dpm" else None
    traj = []
    for lo, hi, cond_only in segments:
        cache = None
        for i in range(lo, hi):
            full = i == lo or i % deepcache_interval == 0
            eps, cache = guided_eps(x, timesteps[i], cond_only, cache, full)
            if scheduler == "dpm":
                state, _ = schedule.step(eps, i, state)
                x = state[0]
            else:
                x, _ = schedule.step(eps, i, x, noise[i + 1])
            if return_trajectory:
                traj.append(x)

    if decode_chunk is not None and B > decode_chunk and B % decode_chunk == 0:
        images = torch.cat([nets["vae"].decode(z, policy, attn_impl=attn_impl) for z in x.split(decode_chunk)])
    else:
        images = nets["vae"].decode(x, policy, attn_impl=attn_impl)
    images = (images * 0.5 + 0.5).clamp(0.0, 1.0)
    if return_trajectory:
        return images, torch.stack(traj)
    return images


def per_prompt_noise(identity_index: int, prompt_idx, S: int, h: int, w: int, device) -> torch.Tensor:
    """(S+1, B, h, w, 4) fp32 `noise_override` on `device` whose slot b is
    the stream of (identity_index, prompt_idx[b]) (sampler.py:413-431): the
    model variants see the same latents for a prompt and different prompts
    different ones, whichever batch and slot a (variant, prompt) pair lands
    in (the packed sweep)."""
    streams = [torch.randn((S + 1, h, w, 4), generator=prompt_generator(identity_index, int(p), device),
                           device=device, dtype=torch.float32) for p in prompt_idx]
    return torch.stack(streams, dim=1)


def sample_data_parallel(mesh, nets: dict, schedule, input_ids, negative_input_ids, **kw):
    """Data-parallel sampling (sampler.py:433-448): the prompt batch shards
    over the mesh's "data" axis, each rank renders its rows with its own
    copy of the networks, and the images are gathered, so every rank
    returns the whole (B, H, W, 3) batch. B must divide the data axis.

    The noise is the one-process run's: every rank draws the global batch
    from the same `generator` and keeps its rows (`batch_rows`), or takes
    its rows of a global `noise_override` (S+1, B, h, w, 4). Per-sample
    adapters ((B, r, in) leaves, a (B,) scale) shard with their rows."""
    from ..core.mesh import DATA_AXIS, all_gather_rows, rows_of

    B = input_ids.shape[0]
    rows = rows_of(mesh, B)
    noise_override = kw.pop("noise_override", None)
    if noise_override is not None:
        noise_override = noise_override[:, rows]
    lora, scale = kw.pop("lora", None), kw.pop("lora_scale", 1.0)
    leaves = tree_leaves(lora)
    if leaves and leaves[0].dim() == 3:
        lora = tree_map(lambda t: t[rows], lora)
    if isinstance(scale, torch.Tensor) and scale.dim() == 1:
        scale = scale[rows]
    images = sample(nets, schedule, torch.as_tensor(input_ids)[rows], torch.as_tensor(negative_input_ids)[rows],
                    noise_override=noise_override, batch_rows=(B, rows), lora=lora, lora_scale=scale, mesh=mesh, **kw)
    if kw.get("return_trajectory"):
        images, traj = images
        return (all_gather_rows(mesh, images, DATA_AXIS),
                all_gather_rows(mesh, traj.transpose(0, 1).contiguous(), DATA_AXIS).transpose(0, 1))
    return all_gather_rows(mesh, images, DATA_AXIS)


def sample_2d_parallel(mesh, nets: dict, schedule, input_ids, negative_input_ids, **kw):
    """2-D parallel sampling (sampler.py:451-475): the batch shards over
    "data" and the UNet's attention and MLP over "model" (the Megatron
    placement of `parallel.tp`, a level whose head count does not divide
    the axis kept whole); the text encoder and the VAE stay whole on every
    rank. `nets["unet"]` must already be placed with
    `parallel.tp.shard_unet_params_tp(unet, mesh)`: placing it here would
    slice the caller's module on every call."""
    if mesh.model > 1 and not any(getattr(m, "tp", None) is not None for m in nets["unet"].modules()):
        raise ValueError("sample_2d_parallel needs a UNet placed by parallel.tp.shard_unet_params_tp "
                         f"over the mesh's {mesh.model} model ranks")
    return sample_data_parallel(mesh, nets, schedule, input_ids, negative_input_ids, **kw)
