"""Full-chain per-step parity: the port's sampler against an all-mirror loop
(port of `faceposegenerator_tpu/bridge/full_chain.py`).

The parity criterion is fp32 agreement at every denoising step over the
whole CLIP → UNet → scheduler → VAE chain, not model by model. This module
holds the wiring of the port's real `diffusion.sampler.sample` (with
`noise_override` and `return_trajectory`): the CFG batch order ([uncond;
cond]), the guidance combination, the noise-stream indexing (the initial
latent at index 0, step i's DDPM noise at index i+1), the scheduler update
between UNet calls, and the final scaled VAE decode.

The other side is a plain Python loop over the torch mirrors
(`bridge/torch_mirror.TUNet`/`TVAE`/`TCLIPText`), with the DDPM posterior
update written again here in numpy from the published equations (Ho et al.
2020 eq. 6-7, the "leading" timestep spacing and fixed_small variance: what
diffusers' DDPMScheduler.step does and the reference consumes at
`inference_ID-Booth.py:104`). Both sides take the same pre-drawn noise, so
every step compares at fp32 tolerance. The mirrors run on the device their
parameters are on; the DDPM update runs on the host.

Used by `cli parity --full_chain` (the same weight files loaded into both
sides) and by tests/test_torch_parity.py (tiny random mirrors).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def ddpm_step_np(
    eps: np.ndarray,
    i: int,
    x: np.ndarray,
    noise: np.ndarray,
    acp: np.ndarray,
    timesteps: np.ndarray,
    prev_timesteps: np.ndarray,
) -> np.ndarray:
    """One reverse DDPM step x_t -> x_{t-1}, fp32 numpy.

    Independent of `diffusion.schedulers.DDPMSchedule.step`: written from
    the DDPM posterior q(x_{t-1} | x_t, x0) mean and variance with epsilon
    prediction, fixed_small variance (floored at 1e-20), no sample clipping:
    the SD2.1 scheduler-config semantics.
    """
    t = int(timesteps[i])
    pt = int(prev_timesteps[i])
    a_t = np.float32(acp[t])
    a_prev = np.float32(acp[pt]) if pt >= 0 else np.float32(1.0)

    x = x.astype(np.float32)
    x0 = (x - np.sqrt(1.0 - a_t) * eps.astype(np.float32)) / np.sqrt(a_t)

    alpha_t = a_t / a_prev
    beta_t = 1.0 - alpha_t
    mean = (np.sqrt(a_prev) * beta_t / (1.0 - a_t)) * x0 + (
        np.sqrt(alpha_t) * (1.0 - a_prev) / (1.0 - a_t)
    ) * x
    if t > 0:
        var = np.clip((1.0 - a_prev) / (1.0 - a_t) * beta_t, 1e-20, None)
        return (mean + np.sqrt(var) * noise.astype(np.float32)).astype(np.float32)
    return mean.astype(np.float32)


def torch_chain_trajectory(
    text_fn: Callable[[np.ndarray], np.ndarray],
    tm_unet,
    tm_vae,
    ids: np.ndarray,
    neg_ids: np.ndarray,
    noise: np.ndarray,
    schedule,
    guidance_scale: float,
):
    """The sampler chain over the mirrors. Returns (traj, images): traj[i] =
    x after scheduler step i, (S, B, h, w, 4) NHWC fp32; images in [0, 1]
    NHWC fp32 (the postprocess of `sample`), both numpy.

    `text_fn(ids (2B, 77) int64) -> (2B, 77, D)` context (e.g. a `TCLIPText`
    forward); `noise` is the (S+1, B, h, w, 4) stream fed to both sides;
    `schedule` a `DDPMSchedule`, whose constant tables are shared while the
    step math here is independent.
    """
    device = next(tm_unet.parameters()).device
    acp = np.asarray(schedule.alphas_cumprod, np.float32)
    ts = np.asarray(schedule.timesteps)
    prev_ts = np.asarray(schedule.prev_timesteps)
    S = schedule.num_inference_steps
    B = ids.shape[0]

    # int64: torch embedding lookups take LongTensor indices
    ctx = text_fn(np.concatenate([neg_ids, ids], axis=0).astype(np.int64))
    ctx_t = torch.as_tensor(np.asarray(ctx, np.float32), device=device)

    x = noise[0].astype(np.float32)
    traj = np.zeros((S,) + x.shape, np.float32)
    with torch.no_grad():
        for i in range(S):
            lat = np.concatenate([x, x], axis=0)
            lat_t = torch.from_numpy(lat).to(device).permute(0, 3, 1, 2).contiguous()
            t_t = torch.tensor([int(ts[i])] * (2 * B), device=device)
            eps = tm_unet(lat_t, t_t, ctx_t).permute(0, 2, 3, 1).cpu().numpy()
            eps_u, eps_c = eps[:B], eps[B:]
            guided = eps_u + np.float32(guidance_scale) * (eps_c - eps_u)
            x = ddpm_step_np(guided, i, x, noise[i + 1], acp, ts, prev_ts)
            traj[i] = x
        img = tm_vae.decode(
            torch.from_numpy(x).to(device).permute(0, 3, 1, 2).contiguous()
        ).permute(0, 2, 3, 1).cpu().numpy()
    return traj, np.clip(img * 0.5 + 0.5, 0.0, 1.0)


def compare_full_chain(
    nets: dict,
    models,
    text_fn: Callable[[np.ndarray], np.ndarray],
    tm_unet,
    tm_vae,
    ids: np.ndarray,
    neg_ids: np.ndarray,
    *,
    steps: int = 30,
    guidance_scale: float = 5.0,
    height: int = 512,
    width: int = 512,
    seed: int = 0,
    scheduler_config=None,
) -> dict:
    """Run both sides on identical pre-drawn noise; report the per-step
    max-abs latent differences and the final image's. `nets`/`models` drive
    the port's `sample` (PARITY_POLICY: fp32, TF32 off; `models.attn_impl`:
    on the card "auto" takes the fp32 attention kernels); `text_fn`,
    `tm_unet` and `tm_vae` drive the mirror loop."""
    from ..core.precision import PARITY_POLICY
    from ..diffusion.sampler import sample
    from ..diffusion.schedulers import SchedulerConfig, make_ddpm

    sched = make_ddpm(scheduler_config or SchedulerConfig(), steps)
    B = ids.shape[0]
    h, w = height // 8, width // 8
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((steps + 1, B, h, w, 4)).astype(np.float32)

    img_p, traj_p = sample(
        nets, sched, torch.as_tensor(np.asarray(ids)), torch.as_tensor(np.asarray(neg_ids)),
        guidance_scale=float(guidance_scale), height=height, width=width, policy=PARITY_POLICY,
        attn_impl=models.attn_impl, noise_override=noise, return_trajectory=True,
    )
    traj_p = traj_p.float().cpu().numpy()
    img_p = img_p.float().cpu().numpy()

    traj_t, img_t = torch_chain_trajectory(text_fn, tm_unet, tm_vae, ids, neg_ids, noise, sched, guidance_scale)

    step_max = np.max(np.abs(traj_p - traj_t), axis=(1, 2, 3, 4))
    return {
        "steps": steps,
        "latent_max_abs_per_step": [float(v) for v in step_max],
        "latent_max_abs": float(step_max.max()),
        "image_max_abs": float(np.max(np.abs(img_p - img_t))),
    }
