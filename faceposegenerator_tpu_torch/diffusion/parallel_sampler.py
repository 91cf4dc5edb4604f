"""Parallel-in-time DDPM sampling: Picard iteration over a sliding window of
steps (port of `faceposegenerator_tpu/diffusion/parallel_sampler.py:61-226`,
ParaDiGMS, arXiv:2305.16317).

The batch-1 latency lever: hold W future latents and refine them together,

    x_{s+1+i} <- x_s + sum_{j<=i} ( f_{s+j}(x_{s+j}) - x_{s+j} ),

f_j one reverse step (UNet ε̂, the DDPM update, the pre-drawn step noise).
Every iteration is one UNet call over W·2B rows; the window then slides past
the prefix whose update changed by less than the tolerance, relative to the
step's own noise variance. Position 0 is computed from the settled x_s, so
the window moves at least one step an iteration, and `tolerance=0` walks
the sequential chain one step an iteration.

JAX runs the loop as a `while_loop` on the device; here it is an eager loop
whose stride is read back to the host once an iteration (one small copy).
The window is a batch axis, so more cards on one image is a placement of
that axis over a mesh (parallel_sampler.py:157-167): with `mesh=`, each of
the N data ranks runs W/N window positions with both CFG halves, combines
the guidance locally, and `all_gather_rows` gathers the guided ε of the
whole window; the Picard update and the acceptance test then run the same
on every rank, and rank 0's stride is broadcast, so that the ranks cannot
diverge.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.mesh import all_gather_rows, broadcast_object
from ..core.precision import DEFAULT_POLICY, Policy
from ..core.tree import tree_leaves, tree_map
from .schedulers import DDPM_COEFS, DDPMSchedule


@torch.inference_mode()
def sample_parallel(
    nets: dict,
    schedule: DDPMSchedule,
    input_ids: torch.Tensor,
    negative_input_ids: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    guidance_scale: float = 5.0,
    height: int = 512,
    width: int = 512,
    policy: Policy = DEFAULT_POLICY,
    attn_impl: str = "auto",
    window: int = 8,
    tolerance: float = 0.1,
    max_iters: Optional[int] = None,
    lora: Optional[dict] = None,
    lora_scale=1.0,
    noise_override=None,
    mesh=None,
    return_stats: bool = False,
    tome_ratio: float = 0.0,
    tome_min_tokens: int = 4096,
    tome_ops: str = "attn",
):
    """(B, H, W, 3) fp32 images in [0, 1], as `sampler.sample` gives them
    (DDPM only); with `return_stats=True`, `(images, n_iters)`, the number of
    Picard iterations run (n_iters == S: no gain).

    window: steps refined an iteration (the UNet runs on window·2B rows),
    at most S. tolerance: a window position is settled when the mean squared
    change of its update, worst sample, is at most (tolerance·σ_step)²; 0
    walks the sequential chain. Noise as `sample` draws it: `noise_override`
    (S+1, B, h, w, 4), or the initial latent then step i's noise from
    `generator`, in that order. Per-request adapters ((B, r, in) leaves, a
    (B,) scale) are tiled ×2 for CLIP's [uncond; cond] rows and W× inside
    each half of the UNet's [W·B uncond; W·B cond] rows (parallel_sampler.py:118-139).
    mesh: a `core.mesh.Mesh` whose "data" ranks split the window (W a
    multiple of the data axis); every rank returns the whole batch.
    """
    if not isinstance(schedule, DDPMSchedule):
        raise TypeError(f"sample_parallel takes a DDPMSchedule, got {type(schedule).__name__}")
    S = schedule.num_inference_steps
    W = min(window, S)
    data = 1 if mesh is None else mesh.data
    if W % data != 0:
        raise ValueError(f"window {W} must divide the mesh data axis ({data})")
    policy.configure_backends()
    unet = nets["unet"]
    device = unet.conv_in.weight.device
    B = input_ids.shape[0]
    h, w = height // 8, width // 8
    Wl = W // data  # this rank's window positions: lo, ..., lo + Wl - 1
    lo = 0 if mesh is None else mesh.data_index * Wl
    if max_iters is None:
        max_iters = 4 * S
    lora = lora or {}

    leaves = tree_leaves(lora)
    per_request = bool(leaves) and leaves[0].dim() == 3
    per_scale = isinstance(lora_scale, torch.Tensor) and lora_scale.dim() == 1
    text_lora, text_scale = lora.get("text_encoder"), lora_scale
    unet_lora, unet_scale = lora.get("unet"), lora_scale
    if per_request:
        text_lora = tree_map(lambda t: torch.cat([t, t]), text_lora)
        unet_lora = tree_map(lambda t: torch.cat([t.repeat(Wl, 1, 1)] * 2), unet_lora)
        if per_scale:
            text_scale = torch.cat([lora_scale, lora_scale])
            unet_scale = torch.cat([lora_scale.repeat(Wl)] * 2)

    ids = torch.cat([torch.as_tensor(negative_input_ids), torch.as_tensor(input_ids)]).to(device)
    ctx = nets["text_encoder"](ids, policy, lora=text_lora, lora_scale=text_scale)
    ctx_w = torch.cat([ctx[:B].repeat(Wl, 1, 1), ctx[B:].repeat(Wl, 1, 1)])

    if noise_override is not None:
        if not isinstance(noise_override, torch.Tensor):
            noise_override = torch.from_numpy(np.asarray(noise_override, np.float32))
        noise_override = noise_override.to(device=device, dtype=torch.float32)
        if noise_override.shape != (S + 1, B, h, w, 4):
            raise ValueError(f"noise_override {tuple(noise_override.shape)} != {(S + 1, B, h, w, 4)}")
        x_init, Z = noise_override[0], noise_override[1:]
    else:
        draws = [torch.randn((B, h, w, 4), generator=generator, device=device, dtype=torch.float32)
                 for _ in range(S + 1)]
        x_init, Z = draws[0], torch.stack(draws[1:])

    timesteps = schedule.device_timesteps(device)
    variance = schedule.device_coefs(device)[DDPM_COEFS.index("variance")]
    offs = torch.arange(W, device=device)
    kw = dict(policy=policy, lora=unet_lora, lora_scale=unet_scale, attn_impl=attn_impl,
              tome_ratio=tome_ratio, tome_min_tokens=tome_min_tokens, tome_ops=tome_ops)

    # X[i]: the guess for the latent after i steps, W rows of scratch past S;
    # every guess starts at x_T
    X = x_init.expand(S + W, B, h, w, 4).clone()
    s = n_iters = 0
    while s < S and n_iters < max_iters:
        pos = s + offs
        idxs = pos.clamp(0, S - 1)
        X_win = X[s: s + W]
        mine = X_win[lo: lo + Wl].reshape(Wl * B, h, w, 4)
        t2 = timesteps[idxs[lo: lo + Wl]].repeat_interleave(B).repeat(2)
        eps = unet(torch.cat([mine, mine]), t2, ctx_w, **kw)
        eps_u, eps_c = eps.chunk(2)
        g = eps_u + guidance_scale * (eps_c - eps_u)
        if mesh is not None:
            g = all_gather_rows(mesh, g.reshape(Wl, B * h, w, 4)).reshape(W * B, h, w, 4)
        flat = X_win.reshape(W * B, h, w, 4)
        f, _ = schedule.step_per_slot(g, idxs.repeat_interleave(B), flat, Z[idxs].reshape(W * B, h, w, 4))
        f = f.reshape(W, B, h, w, 4)
        new = torch.cumsum(torch.cat([f[:1], (f - X_win)[1:]]), dim=0)
        old = X[s + 1: s + 1 + W]
        err = ((new - old) ** 2).mean(dim=(2, 3, 4)).amax(dim=1)
        ok = (err <= tolerance**2 * variance[idxs]) | (pos >= S)
        ok[0] = True
        stride = int(torch.cumprod(ok.int(), 0).sum())
        if mesh is not None:
            stride = int(broadcast_object(mesh, stride))
        X[s + 1: s + 1 + W] = new
        s = min(s + stride, S)
        n_iters += 1

    images = nets["vae"].decode(X[S], policy, attn_impl=attn_impl)
    images = (images * 0.5 + 0.5).clamp(0.0, 1.0)
    if return_stats:
        return images, n_iters
    return images
