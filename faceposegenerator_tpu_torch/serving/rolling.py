"""Rolling (iteration-level) serving: continuous batching for diffusion
(port of `faceposegenerator_tpu/serving/rolling.py`).

`SamplerServer` forms a batch and runs the whole program; a request that
arrives one step after a launch waits for all of it. Here B persistent
slots each advance their own timestep every tick, so a request is admitted
into any free slot at once and leaves after exactly S ticks:

  _admit   CLIP on one request's [negative; positive] rows, written into the
           (2B, 77, D) context buffer; its noise stream (the one the batch
           engine draws for that seed) into the (S+1, B, h, w, 4) buffer;
           its initial latent into its slot.
  _tick    one step for every slot: the UNet on the [uncond; cond] 2B rows
           with per-slot timesteps and per-slot adapters (the stacked path,
           tiled ×2), then `step_per_slot`. Finished and free slots stay
           frozen: padding compute, as a padded batch is.
  _tick_dpm  the same with DPM-Solver++ 2M and per-slot m0/m1 history (a
           slot's step count is its step index; its first step never reads
           the previous occupant's m0).
  _decode1 a batch-1 VAE decode for each finished slot, so decode work stays
           one image an image.

The host mirrors every slot's step count (it admitted the slot and counts
the ticks), so the loop copies nothing from the card but finished images;
the step counters live on the card and advance inside the tick, and host
inputs go over by pinned, non-blocking copies. DeepCache, ToMe, the
guidance interval and parallel sampling keep state in step across a batch
and do not compose with slots; quantization composes (`pipe.quantize`).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..core.tree import tree_leaves, tree_map
from ..ops.image import quantize_u8
from .engine import GenerationResult, SamplerServer, log, to_device


class RollingServer(SamplerServer):
    """Continuous-batching `SamplerServer` (the same submit / generate /
    register_lora / stats / shutdown; `batch_size` is the slot count).
    Per-slot adapters always ride the stacked path, so mixed-identity
    traffic fills the slots."""

    def __init__(self, pipe, **kw):
        for bad in ("parallel_window", "deepcache_interval", "tome_ratio", "cfg_interval"):
            if kw.get(bad):
                raise ValueError(f"{bad} is not composable with RollingServer")
        kw["multi_lora"] = True
        super().__init__(pipe, **kw)

    @torch.inference_mode()
    def _admit(self, slot: int, req, ctx_buf, noise_buf, latents):
        """Write request `req` into `slot` of the buffers, in place."""
        pipe, B = self.pipe, self.batch_size
        ids = torch.cat([pipe.tokenize([req.negative_prompt]), pipe.tokenize([req.prompt])])
        lora, scale = self._loras[req.lora_id]
        ctx = pipe.nets["text_encoder"](to_device(ids, self.device), pipe.policy, lora=lora.get("text_encoder"),
                                        lora_scale=scale)  # (2, 77, D): [uncond; cond]
        ctx_buf[slot] = ctx[0]
        ctx_buf[B + slot] = ctx[1]
        stream = self._per_request_noise([req.seed])[:, 0]  # index 0 the initial latent, i + 1 step i's noise
        noise_buf[:, slot] = stream
        latents[slot] = stream[0]

    def _guided_eps(self, latents, step_idx, ctx_buf, lora, scale):
        """ε̂ of every slot at its own step (clamped to S - 1 for frozen slots)."""
        S = self.num_inference_steps
        safe = step_idx.clamp(0, S - 1)
        t = self._schedule.device_timesteps(latents.device)[safe]
        unet_lora = lora.get("unet")
        if tree_leaves(unet_lora):  # per-slot adapters: slot b rides rows b and B + b
            unet_lora = tree_map(lambda x: torch.cat([x, x]), unet_lora)
            scale = torch.cat([scale, scale])
        eps = self.pipe.nets["unet"](torch.cat([latents, latents]), torch.cat([t, t]), ctx_buf, self.pipe.policy,
                                     lora=unet_lora, lora_scale=scale, attn_impl=self.pipe.models.attn_impl)
        eps_u, eps_c = eps.chunk(2)
        return eps_u + self.guidance_scale * (eps_c - eps_u), safe

    @torch.inference_mode()
    def _tick(self, latents, step_idx, ctx_buf, noise_buf, lora, scale):
        """One DDPM step of every live slot (step_idx < S); returns the new
        (latents, step_idx)."""
        S, B = self.num_inference_steps, self.batch_size
        eps, safe = self._guided_eps(latents, step_idx, ctx_buf, lora, scale)
        step_noise = noise_buf[safe + 1, torch.arange(B, device=latents.device)]
        x_new, _ = self._schedule.step_per_slot(eps, safe, latents, step_noise)
        live = step_idx < S
        return torch.where(live[:, None, None, None], x_new, latents), torch.where(live, step_idx + 1, step_idx)

    @torch.inference_mode()
    def _tick_dpm(self, latents, m0, m1, step_idx, ctx_buf, lora, scale):
        """One DPM-Solver++ 2M step of every live slot; returns the new
        (latents, m0, m1, step_idx)."""
        S = self.num_inference_steps
        eps, safe = self._guided_eps(latents, step_idx, ctx_buf, lora, scale)
        x_new, m0_new, m1_new = self._schedule.step_per_slot(eps, safe, latents, m0, m1)
        live = step_idx < S
        mask = live[:, None, None, None]
        return (torch.where(mask, x_new, latents), torch.where(mask, m0_new, m0), torch.where(mask, m1_new, m1),
                torch.where(live, step_idx + 1, step_idx))

    @torch.inference_mode()
    def _decode1(self, latent) -> np.ndarray:
        """One slot's (h, w, 4) latent → (H, W, 3) uint8 on the host."""
        img = self.pipe.nets["vae"].decode(latent[None], self.pipe.policy, attn_impl=self.pipe.models.attn_impl)
        return quantize_u8((img * 0.5 + 0.5).clamp(0.0, 1.0))[0].cpu().numpy()

    def _run(self):
        B, S = self.batch_size, self.num_inference_steps
        h, w = self.height // 8, self.width // 8
        device = self.device
        # the host mirror: per slot (request, future, t_submit, t_admit) or
        # None, and the ticks since its admission
        meta = [None] * B
        steps = [S] * B
        self._completions = collections.deque(maxlen=4096)
        try:
            with torch.inference_mode():
                # the context's width and dtype, from one encode
                probe = self.pipe.nets["text_encoder"](torch.zeros((1, 77), dtype=torch.long, device=device),
                                                       self.pipe.policy)
                ctx_buf = probe.new_zeros((2 * B, 77, probe.shape[-1]))
                noise_buf = torch.zeros((S + 1, B, h, w, 4), dtype=torch.float32, device=device)
                latents = torch.zeros((B, h, w, 4), dtype=torch.float32, device=device)
                step_dev = torch.full((B,), S, dtype=torch.long, device=device)
                dpm = self.scheduler == "dpm"
                if dpm:
                    m0, m1 = torch.zeros_like(latents), torch.zeros_like(latents)

            while not self._stop.is_set():
                with self._pending_cv:
                    self._expire_deadlined_locked()
                    free = [i for i in range(B) if meta[i] is None]
                    take = [self._pending.popleft() for _ in range(min(len(free), len(self._pending)))]
                # into the mirror first: a failing admission fails every request taken
                for slot, (req, fut, t_sub) in zip(free, take):
                    meta[slot] = (req, fut, t_sub, time.perf_counter())
                for slot, (req, _, _) in zip(free, take):
                    self._admit(slot, req, ctx_buf, noise_buf, latents)
                    with torch.inference_mode():
                        step_dev[slot] = 0
                    steps[slot] = 0

                if all(m is None for m in meta):
                    with self._pending_cv:
                        self._pending_cv.wait_for(lambda: self._pending or self._stop.is_set(), timeout=0.1)
                    continue

                lora, scale = self._stacked_lora(tuple(m[0].lora_id if m else None for m in meta))
                t0 = time.perf_counter()
                if dpm:
                    latents, m0, m1, step_dev = self._tick_dpm(latents, m0, m1, step_dev, ctx_buf, lora, scale)
                else:
                    latents, step_dev = self._tick(latents, step_dev, ctx_buf, noise_buf, lora, scale)
                with self._stats_lock:
                    self._stats["batches"] += 1  # ticks
                    self._stats["batch_sizes"].append(sum(m is not None for m in meta))
                for i in range(B):
                    if meta[i] is not None:
                        steps[i] += 1

                for i in range(B):
                    if meta[i] is not None and steps[i] >= S:
                        req, fut, t_sub, t_adm = meta[i]
                        img = self._decode1(latents[i])  # the loop's one copy to the host
                        t1 = time.perf_counter()
                        with self._stats_lock:
                            self._stats["requests"] += 1
                            self._stats["queue_times"].append(t_adm - t_sub)
                            self._stats["batch_times"].append(t1 - t0)
                        self._completions.append(t1)
                        if not fut.done():
                            fut.set_result(GenerationResult(image=img, seed=req.seed, lora_id=req.lora_id,
                                                            queue_s=t_adm - t_sub, batch_s=t1 - t_adm))
                        meta[i] = None
        except Exception as e:  # fail the requests in flight and queued rather than hang them
            log.exception("rolling server failed")
            for m in meta:
                if m is not None and not m[1].done():
                    m[1].set_exception(e)
            self._fail_all_pending(e)
        err = RuntimeError("server shut down")
        for m in meta:
            if m is not None and not m[1].done():
                m[1].set_exception(err)
        self._fail_all_pending(err)

    def stats(self) -> dict:
        base = super().stats()
        comp = list(getattr(self, "_completions", ()))
        if len(comp) >= 2:
            base["images_per_s"] = round((len(comp) - 1) / (comp[-1] - comp[0]), 3)
        base["ticks"] = base.pop("batches")
        base.pop("padded_slots", None)
        return base

