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
inputs go over by pinned, non-blocking copies. The admission, the two
ticks and the decode are `core.compile.jit` functions (`_admit_core`,
`_tick_core`, `_tick_dpm_core`, `_decode1_core`, as JAX jits `_admit`,
`_tick`, `_tick_dpm` and `_decode1`): on the card each is one captured CUDA
graph, replayed every call (over a mesh of more than one rank, eagerly:
`core.compile`'s argument rule). The admitted slot is a device index, as
JAX keeps it a traced scalar, so B slots share one graph; the per-tick
stacked adapters and the buffers are inputs, copied into the graph's own.

DeepCache, ToMe, the guidance interval and parallel sampling keep state in
step across a batch and do not compose with slots; quantization composes
(`pipe.quantize`).

Over a mesh the B slots split over the data ranks, B/N contiguous slots a
rank (rolling.py:242-255). Rank 0 keeps the slot table and decides the
admissions; each tick it broadcasts a header that carries them (slot,
seed, adapter, token ids). Every rank admits into its own slots, running
CLIP on its own rows, and ticks its B/N slots; every rank mirrors every
slot's step count from the headers, so all know which slots finish. The
rank that owns a finished slot runs its batch-1 decode, and one
`all_reduce` of a zero-filled buffer brings the tick's finished images to
rank 0 (JAX replicates the latent and decodes it SPMD: the same image).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..core import mesh as mesh_lib
from ..core.compile import jit, over_ranks
from ..core.mesh import Header
from ..core.tree import tree_leaves, tree_map
from ..ops.image import quantize_u8
from .engine import TOKENS, GenerationResult, MeshFault, SamplerServer, log, to_device


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
        # the argument rule of core.compile: over more than one rank the
        # admissions, ticks and decodes run eagerly
        self._ranks = 1 if self.mesh is None else self.mesh.size

    def _admit(self, slot: int, req, ctx_buf, noise_buf, latents):
        """Write request `req` into `slot` of the buffers, in place."""
        pipe = self.pipe
        self._admit_ids(slot, pipe.tokenize([req.prompt])[0], pipe.tokenize([req.negative_prompt])[0], req.seed,
                        req.lora_id, ctx_buf, noise_buf, latents)

    @torch.inference_mode()
    def _admit_ids(self, slot: int, ids, neg, seed: int, lora_id, ctx_buf, noise_buf, latents):
        """Write a request given by its token ids into `slot` of this rank's
        buffers (the slot a row of `latents`), in place."""
        pipe, device = self.pipe, latents.device
        with self._loras_lock:
            lora, scale = self._loras[lora_id]
        stream = self._per_request_noise([seed])[:, 0]  # index 0 the initial latent, i + 1 step i's noise
        new = _admit_core(pipe.nets["text_encoder"], to_device(torch.stack([neg, ids]), device),
                          torch.full((1,), slot, dtype=torch.long, device=device), stream, ctx_buf, noise_buf,
                          latents, lora.get("text_encoder"), scale, policy=pipe.policy, ranks=self._ranks)
        for buf, value in zip((ctx_buf, noise_buf, latents), new):
            if value is not buf:  # a replay returns copies
                buf.copy_(value)

    def _tick(self, latents, step_idx, ctx_buf, noise_buf, lora, scale):
        """One DDPM step of every live slot (step_idx < S); returns the new
        (latents, step_idx)."""
        return _tick_core(self.pipe.nets["unet"], self._schedule, latents, step_idx, ctx_buf, noise_buf, lora,
                          scale, guidance_scale=self.guidance_scale, policy=self.pipe.policy,
                          attn_impl=self.pipe.models.attn_impl, ranks=self._ranks)

    def _tick_dpm(self, latents, m0, m1, step_idx, ctx_buf, lora, scale):
        """One DPM-Solver++ 2M step of every live slot; returns the new
        (latents, m0, m1, step_idx)."""
        return _tick_dpm_core(self.pipe.nets["unet"], self._schedule, latents, m0, m1, step_idx, ctx_buf, lora,
                              scale, guidance_scale=self.guidance_scale, policy=self.pipe.policy,
                              attn_impl=self.pipe.models.attn_impl, ranks=self._ranks)

    def _decode1(self, latent) -> np.ndarray:
        """One slot's (h, w, 4) latent → (H, W, 3) uint8 on the host."""
        return self._decode1_u8(latent).cpu().numpy()

    def _decode1_u8(self, latent) -> torch.Tensor:
        """One slot's (h, w, 4) latent → (H, W, 3) uint8 on the card."""
        return _decode1_core(self.pipe.nets["vae"], latent, policy=self.pipe.policy,
                             attn_impl=self.pipe.models.attn_impl, ranks=self._ranks)

    def _run(self):
        """Every rank's loop: rank 0 admits and sends each tick's header, the
        others follow it; all tick their own slots and decode their own
        finished ones."""
        B, S = self.batch_size, self.num_inference_steps
        h, w = self.height // 8, self.width // 8
        device = self.device
        front = self.is_front
        # this rank's slots: a contiguous range of the B, rows of its buffers
        mine = range(B) if self.mesh is None else range(B)[mesh_lib.rows_of(self.mesh, B)]
        Bl = len(mine)
        # every rank mirrors every slot: its adapter (or free) and its ticks
        # since admission; rank 0 also holds its (request, future, t_submit,
        # t_admit)
        slot_lora = [None] * B
        steps = [S] * B
        meta = [None] * B
        self._completions = collections.deque(maxlen=4096)
        try:
            with torch.inference_mode():
                # the context's width and dtype, from one encode
                probe = self.pipe.nets["text_encoder"](torch.zeros((1, TOKENS), dtype=torch.long, device=device),
                                                       self.pipe.policy)
                ctx_buf = probe.new_zeros((2 * Bl, TOKENS, probe.shape[-1]))
                noise_buf = torch.zeros((S + 1, Bl, h, w, 4), dtype=torch.float32, device=device)
                latents = torch.zeros((Bl, h, w, 4), dtype=torch.float32, device=device)
                step_dev = torch.full((Bl,), S, dtype=torch.long, device=device)
                dpm = self.scheduler == "dpm"
                if dpm:
                    m0, m1 = torch.zeros_like(latents), torch.zeros_like(latents)

            while True:
                if front:
                    if self._stop.is_set():
                        break
                    self._send_registrations()
                    header = self._admissions(meta, S)
                    if header is None:
                        self._beat()
                        continue
                    self._send(header)
                else:
                    header = self._recv()
                    if header.op == mesh_lib.OP_STOP:
                        break
                    if header.op != mesh_lib.OP_TICK:
                        raise MeshFault(f"unexpected header op {header.op} at a rolling server")
                for g, seed, a, ids, neg in zip(header.slots.tolist(), header.seeds.tolist(),
                                                header.adapters.tolist(), header.ids, header.neg):
                    with self._loras_lock:
                        slot_lora[g] = self._lora_names[a]
                    steps[g] = 0
                    if g in mine:
                        j = g - mine.start
                        self._admit_ids(j, ids, neg, seed, slot_lora[g], ctx_buf, noise_buf, latents)
                        with torch.inference_mode():
                            step_dev[j] = 0
                lora, scale = self._stacked_lora(tuple(slot_lora[g] for g in mine))
                t0 = time.perf_counter()
                if dpm:
                    latents, m0, m1, step_dev = self._tick_dpm(latents, m0, m1, step_dev, ctx_buf, lora, scale)
                else:
                    latents, step_dev = self._tick(latents, step_dev, ctx_buf, noise_buf, lora, scale)
                occupied = [g for g in range(B) if steps[g] < S]
                for g in occupied:
                    steps[g] += 1
                done = [g for g in occupied if steps[g] >= S]
                images = self._finished_images(done, mine, latents) if done else None
                for g in done:
                    slot_lora[g] = None
                if not front:
                    continue
                with self._stats_lock:
                    self._stats["batches"] += 1  # ticks
                    self._stats["batch_sizes"].append(len(occupied))
                for k, g in enumerate(done):
                    req, fut, t_sub, t_adm = meta[g]
                    t1 = time.perf_counter()
                    with self._stats_lock:
                        self._stats["requests"] += 1
                        self._stats["queue_times"].append(t_adm - t_sub)
                        self._stats["batch_times"].append(t1 - t0)
                    self._completions.append(t1)
                    if not fut.done():
                        fut.set_result(GenerationResult(image=images[k], seed=req.seed, lora_id=req.lora_id,
                                                        queue_s=t_adm - t_sub, batch_s=t1 - t_adm))
                    meta[g] = None
        except Exception as e:  # fail the requests in flight and queued rather than hang them
            log.exception("rolling server failed")
            err = e.__cause__ if isinstance(e, MeshFault) and e.__cause__ is not None else e
            for m in meta:
                if m is not None and not m[1].done():
                    m[1].set_exception(err)
            if self._distributed:  # the ranks are out of step: stop; join() raises it
                self._fault(err)
                return
            self._fail_all_pending(err)
        err = RuntimeError("server shut down")
        for m in meta:
            if m is not None and not m[1].done():
                m[1].set_exception(err)
        if front:
            self._stop_ranks()

    def _follow(self):
        self._run()

    def _admissions(self, meta, S):
        """Rank 0: take queued requests into free slots (into the table
        first: a failing admission fails every request taken) and return the
        tick's header, or None when no slot is occupied and none was taken."""
        with self._pending_cv:
            self._expire_deadlined_locked()
            free = [i for i in range(self.batch_size) if meta[i] is None]
            take = [self._pending.popleft() for _ in range(min(len(free), len(self._pending)))]
        for slot, (req, fut, t_sub) in zip(free, take):
            meta[slot] = (req, fut, t_sub, time.perf_counter())
        if all(m is None for m in meta):
            with self._pending_cv:
                self._pending_cv.wait_for(lambda: self._pending or self._registrations or self._stop.is_set(),
                                          timeout=0.1)
            return None
        reqs = [req for req, _, _ in take]
        with self._loras_lock:
            adapters = [self._lora_names.index(r.lora_id) for r in reqs]
        empty = torch.zeros((0, TOKENS), dtype=torch.long)
        return Header(mesh_lib.OP_TICK, len(reqs), slots=torch.tensor(free[:len(reqs)], dtype=torch.long),
                      seeds=torch.tensor([r.seed for r in reqs], dtype=torch.long),
                      adapters=torch.tensor(adapters, dtype=torch.long),
                      ids=self.pipe.tokenize([r.prompt for r in reqs]) if reqs else empty,
                      neg=self.pipe.tokenize([r.negative_prompt for r in reqs]) if reqs else empty)

    @torch.inference_mode()
    def _finished_images(self, done, mine, latents):
        """The (H, W, 3) uint8 images of the finished slots `done` (every
        rank knows them), each decoded by the rank that owns it; on rank 0
        on the host, None elsewhere."""
        if not self._distributed:
            return [self._decode1(latents[g - mine.start]) for g in done]
        out = torch.zeros((len(done), self.height, self.width, 3), dtype=torch.uint8, device=self.device)
        for k, g in enumerate(done):
            if g in mine:
                out[k] = self._decode1_u8(latents[g - mine.start])
        mesh_lib.all_reduce_(self.mesh, out)
        return out.cpu().numpy() if self.is_front else None

    def stats(self) -> dict:
        base = super().stats()
        comp = list(getattr(self, "_completions", ()))
        if len(comp) >= 2:
            base["images_per_s"] = round((len(comp) - 1) / (comp[-1] - comp[0]), 3)
        base["ticks"] = base.pop("batches")
        base.pop("padded_slots", None)
        return base



@jit(static_argnames=("policy",), eager_if=over_ranks)
@torch.inference_mode()
def _admit_core(text_encoder, ids, slot, stream, ctx_buf, noise_buf, latents, text_lora, scale, *, policy,
                ranks=1):
    """CLIP on one request's (2, 77) [negative; positive] ids into rows slot
    and B + slot of the (2B, 77, D) context buffer, its (S+1, h, w, 4)
    noise stream into column `slot` of the noise buffer and its initial
    latent into row `slot` of the latents; `slot` a (1,) device index.
    Writes in place and returns the three buffers."""
    B = latents.shape[0]
    ctx = text_encoder(ids, policy, lora=text_lora, lora_scale=scale)  # (2, 77, D): [uncond; cond]
    ctx_buf.index_copy_(0, torch.cat([slot, slot + B]), ctx)
    noise_buf.index_copy_(1, slot, stream[:, None])
    latents.index_copy_(0, slot, stream[:1])
    return ctx_buf, noise_buf, latents


def _guided_eps(unet, schedule, latents, step_idx, ctx_buf, lora, scale, guidance_scale, policy, attn_impl):
    """ε̂ of every slot at its own step (clamped to S - 1 for frozen slots)."""
    S = schedule.num_inference_steps
    safe = step_idx.clamp(0, S - 1)
    t = schedule.device_timesteps(latents.device)[safe]
    unet_lora = lora.get("unet")
    if tree_leaves(unet_lora):  # per-slot adapters: slot b rides rows b and B + b
        unet_lora = tree_map(lambda x: torch.cat([x, x]), unet_lora)
        scale = torch.cat([scale, scale])
    eps = unet(torch.cat([latents, latents]), torch.cat([t, t]), ctx_buf, policy, lora=unet_lora, lora_scale=scale,
               attn_impl=attn_impl)
    eps_u, eps_c = eps.chunk(2)
    return eps_u + guidance_scale * (eps_c - eps_u), safe


@jit(static_argnames=("guidance_scale", "policy", "attn_impl"), eager_if=over_ranks)
@torch.inference_mode()
def _tick_core(unet, schedule, latents, step_idx, ctx_buf, noise_buf, lora, scale, *, guidance_scale, policy,
               attn_impl, ranks=1):
    """One DDPM step of every live slot (step_idx < S); returns the new
    (latents, step_idx)."""
    S, B = schedule.num_inference_steps, latents.shape[0]
    eps, safe = _guided_eps(unet, schedule, latents, step_idx, ctx_buf, lora, scale, guidance_scale, policy,
                            attn_impl)
    step_noise = noise_buf[safe + 1, torch.arange(B, device=latents.device)]
    x_new, _ = schedule.step_per_slot(eps, safe, latents, step_noise)
    live = step_idx < S
    return torch.where(live[:, None, None, None], x_new, latents), torch.where(live, step_idx + 1, step_idx)


@jit(static_argnames=("guidance_scale", "policy", "attn_impl"), eager_if=over_ranks)
@torch.inference_mode()
def _tick_dpm_core(unet, schedule, latents, m0, m1, step_idx, ctx_buf, lora, scale, *, guidance_scale, policy,
                   attn_impl, ranks=1):
    """One DPM-Solver++ 2M step of every live slot; returns the new
    (latents, m0, m1, step_idx)."""
    S = schedule.num_inference_steps
    eps, safe = _guided_eps(unet, schedule, latents, step_idx, ctx_buf, lora, scale, guidance_scale, policy,
                            attn_impl)
    x_new, m0_new, m1_new = schedule.step_per_slot(eps, safe, latents, m0, m1)
    live = step_idx < S
    mask = live[:, None, None, None]
    return (torch.where(mask, x_new, latents), torch.where(mask, m0_new, m0), torch.where(mask, m1_new, m1),
            torch.where(live, step_idx + 1, step_idx))


@jit(static_argnames=("policy", "attn_impl"), eager_if=over_ranks)
@torch.inference_mode()
def _decode1_core(vae, latent, *, policy, attn_impl, ranks=1):
    """One slot's (h, w, 4) latent → (H, W, 3) uint8 on the card."""
    img = vae.decode(latent[None], policy, attn_impl=attn_impl)
    return quantize_u8((img * 0.5 + 0.5).clamp(0.0, 1.0))[0]
