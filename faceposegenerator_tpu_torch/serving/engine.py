"""The batch serving engine (port of `faceposegenerator_tpu/serving/engine.py`):
fixed-shape request batches over the eager sampler, LoRA hot-swap, and
per-request determinism.

One worker thread drains a bounded queue. It takes the oldest request,
extends the batch with queued requests of the same adapter (scanning in
place, so the others keep their arrival order), or with any requests under
`multi_lora=True`, where every slot carries its own adapter (leaves stacked
on a leading request axis, `ops/lora.py`'s per-sample path); waits up to
`max_wait_s` for stragglers; pads to `batch_size` by repeating the first
slot; and samples. Every batch has one shape, so the card sees the same
kernels at the same shapes batch after batch.

Each request's noise is its own seed's stream: an (S+1, h, w, 4) draw from
`core/rng.sampler_generator(seed)` on the card, stacked along the batch
axis into the sampler's `noise_override`. A request's image therefore does
not depend on which batch, slot or padding it rode. The images are
quantized to uint8 on the card before the one copy to the host.

The worker thread issues the sampling work and sets the pipeline's device
itself. An exception in a batch fails that batch's futures; one outside a
batch (collecting it) fails every pending request; nothing is swallowed.

Over a mesh (`mesh=`, a ("data", "model") `core.mesh.Mesh` with a model
axis of 1, one process a rank), rank 0 is the front: the queue, batching,
deadlines, backpressure, futures, `stats()` and HTTP are its alone. For
each batch it tokenizes and pads, and broadcasts a `core.mesh.Header`
(seeds, adapter indices, token ids); every rank then takes its rows
(`rows_of`), draws its requests' noise from their own seeds, samples them
with the one-process path's `sample` call and quantizes to uint8, and
`all_gather_rows` brings the images to rank 0. Under `parallel_window` the
request batch stays whole and `sample_parallel` shards the window instead.
The other ranks' worker threads follow the headers until rank 0's
`shutdown()` sends the stop; `join()` waits for that and raises what
stopped a rank. An adapter registered on rank 0 reaches every rank once,
at registration (`broadcast_tree`), through rank 0's worker thread, so that
the collectives of every rank keep one order; under `multi_lora` each rank
stacks only its own slots' adapters. A failure after a header went out
leaves the ranks out of step: it fails every pending request and stops the
server, and the rank's process is meant to exit non-zero. Idle, rank 0
sends a beat every `HEARTBEAT_S`, so that the ranks waiting for the next
header stay inside their process group's timeout.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import mesh as mesh_lib
from ..core.mesh import Header
from ..core.rng import sampler_generator
from ..core.tree import tree_map, tree_paths
from ..diffusion.schedulers import make_ddpm, make_dpm_solver
from ..ops.image import quantize_u8

log = logging.getLogger(__name__)
TOKENS = 77  # CLIP's context: every prompt is 77 token ids


def request_noise(seeds: Sequence[int], S: int, h: int, w: int, device) -> torch.Tensor:
    """(S+1, B, h, w, 4) fp32 noise on `device`: slot b is the stream of
    seed b alone (JAX `engine._batch_noise`; the bits are the port's own,
    from `sampler_generator`)."""
    return torch.stack([torch.randn((S + 1, h, w, 4), generator=sampler_generator(int(s), device), device=device,
                                    dtype=torch.float32) for s in seeds], dim=1)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device` without waiting for the card's queue: a
    pageable host-to-device copy synchronises the stream, a pinned one
    does not."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class QueueFull(RuntimeError):
    """Raised by submit() when the bounded queue is at capacity (HTTP 429)."""


class MeshFault(RuntimeError):
    """A failure after rank 0 sent a header: the ranks are out of step."""


@dataclasses.dataclass
class GenerationRequest:
    prompt: str
    negative_prompt: str = ""
    seed: int = 0
    lora_id: Optional[str] = None  # a name given to register_lora


@dataclasses.dataclass
class GenerationResult:
    image: np.ndarray  # (H, W, 3) uint8, quantized on the card
    seed: int
    lora_id: Optional[str]
    queue_s: float  # waiting for a batch slot
    batch_s: float  # the batch this request rode, to its images on the host


class SamplerServer:
    """Fixed-shape batching server over a `StableDiffusionPipeline`.

    `submit()` returns a Future, `generate()` blocks. `multi_lora=True`
    serves mixed-adapter batches (FIFO, stacked adapters cached per batch
    composition, LRU). `max_queue` (16 batches by default) bounds the queue
    (`QueueFull`); `request_timeout_s` fails a request still queued after
    that long with TimeoutError. `deepcache_*`, `tome_*`, `cfg_interval` and
    `parallel_window`/`parallel_tolerance` go to the sampler. `mesh`
    serves data-parallel over the mesh's ranks (the module's docstring):
    every rank constructs the server, in one order; rank 0's weights and
    static activation scales are broadcast to the others unless the
    pipeline was placed on this mesh by `to_mesh`.
    """

    HEARTBEAT_S = 1.0  # rank 0's idle beat over a mesh

    def __init__(
        self,
        pipe,
        batch_size: int = 8,
        max_wait_s: float = 0.05,
        num_inference_steps: int = 30,
        guidance_scale: float = 5.0,
        height: int = 512,
        width: int = 512,
        scheduler: str = "ddpm",
        lora_rank: int = 4,
        max_queue: Optional[int] = None,
        request_timeout_s: Optional[float] = None,
        mesh=None,
        multi_lora: bool = False,
        deepcache_interval: int = 1,
        deepcache_depth: int = 1,
        tome_ratio: float = 0.0,
        tome_ops: str = "attn",
        parallel_window: int = 0,
        parallel_tolerance: float = 0.1,
        cfg_interval: Optional[tuple] = None,
    ):
        if mesh is not None:
            if mesh.model != 1:
                raise ValueError(f"a server's mesh has a model axis of 1, as serve builds it; got {mesh.shape}")
            if batch_size % mesh.data != 0:
                raise ValueError(f"batch_size {batch_size} must divide the mesh data axis ({mesh.data})")
            window = min(int(parallel_window), num_inference_steps)
            if window > 0 and window % mesh.data != 0:
                raise ValueError(f"parallel window {window} must divide the mesh data axis ({mesh.data})")
        if scheduler not in ("ddpm", "dpm"):
            raise ValueError(
                f"unknown scheduler {scheduler!r}: serving supports 'ddpm' "
                "(exact 30-step path) or 'dpm' (few-step DPM-Solver++)"
            )
        self.parallel_window = int(parallel_window)
        self.parallel_tolerance = float(parallel_tolerance)
        if self.parallel_window > 0 and scheduler != "ddpm":
            raise ValueError("parallel_window requires the ddpm scheduler")
        self.cfg_interval = None if cfg_interval is None else tuple(cfg_interval)
        if self.cfg_interval is not None and self.parallel_window > 0:
            raise ValueError("cfg_interval is not composable with parallel_window yet")
        self.pipe = pipe
        self.mesh = mesh
        self.multi_lora = multi_lora
        self.deepcache_interval = int(deepcache_interval)
        self.deepcache_depth = int(deepcache_depth)
        self.tome_ratio = float(tome_ratio)
        self.tome_ops = str(tome_ops)
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = float(guidance_scale)
        self.height, self.width = height, width
        self.scheduler = scheduler
        self._schedule = (make_ddpm(pipe.scheduler_config, num_inference_steps) if scheduler == "ddpm"
                          else make_dpm_solver(pipe.scheduler_config, num_inference_steps))
        self.lora_rank = lora_rank
        self.max_queue = max_queue if max_queue is not None else 16 * batch_size
        self.request_timeout_s = request_timeout_s
        # the zero adapter: lora-less requests ride the adapter path too, and
        # every registered adapter must have its paths, shapes and dtypes
        self._loras: Dict[Optional[str], tuple] = {None: (self._zero_lora(), 1.0)}
        # registration order: a header names an adapter by its index here
        self._lora_names: List[Optional[str]] = [None]
        self._stack_cache: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        self._stack_cache_max = 32
        # a deque under a condition: batch collection scans for same-adapter
        # requests in place, so the others keep their arrival order
        self._pending: "collections.deque[tuple]" = collections.deque()
        self._pending_cv = threading.Condition()
        self._stats = {
            "requests": 0, "batches": 0, "padded_slots": 0,
            "batch_times": collections.deque(maxlen=1024),
            "batch_sizes": collections.deque(maxlen=1024),
            "queue_times": collections.deque(maxlen=4096),
        }
        self._stats_lock = threading.Lock()
        self._loras_lock = threading.Lock()
        self._stop = threading.Event()
        # rank 0 over a mesh: adapters waiting for the worker thread to send them
        self._registrations: "collections.deque[tuple]" = collections.deque()
        self._error: Optional[BaseException] = None
        self._last_sent = time.perf_counter()
        if self._distributed:
            from ..core.mesh import replicate
            from ..ops.quant import replicate_act_scales

            if getattr(pipe, "mesh", None) is not mesh:
                replicate(mesh, pipe.nets)
            replicate_act_scales(mesh, {"unet": pipe.nets["unet"], "vae": pipe.nets["vae"]})
        self._worker = threading.Thread(target=self._serve, daemon=True)
        self._worker.start()

    @property
    def device(self) -> torch.device:
        return self.pipe.device

    @property
    def _distributed(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    @property
    def is_front(self) -> bool:
        """Rank 0 of the mesh (or no mesh): the rank that takes requests."""
        return self.mesh is None or self.mesh.rank == 0

    # -- LoRA registry -------------------------------------------------------

    def _zero_lora(self) -> dict:
        from ..diffusion.lora_io import zero_lora

        return zero_lora(self.pipe.nets["unet"], self.pipe.nets["text_encoder"], rank=self.lora_rank,
                         dtype=self.pipe.policy.param_dtype)

    @staticmethod
    def _layout(tree) -> list:
        """(path, shape, dtype, device) of every leaf, by path (a tree
        carried from JAX has its dict keys sorted)."""
        return sorted(((path, tuple(leaf.shape), leaf.dtype, leaf.device) for path, leaf in tree_paths(tree)),
                      key=lambda e: e[0])

    def register_lora(self, name: str, path_or_tree, scale: float = 1.0):
        """Register a diffusers/peft LoRA checkpoint (its directory or
        `pytorch_lora_weights.safetensors`) or a {"unet", "text_encoder"}
        tree under `name`; requests select it by `lora_id=name`. Its paths,
        shapes, dtypes and device must be the zero adapter's (rank
        `lora_rank`, the standard targets, `policy.param_dtype`, the
        pipeline's device): anything else raises ValueError."""
        if isinstance(path_or_tree, str):
            from ..diffusion.lora_io import load_lora_safetensors

            tree = load_lora_safetensors(path_or_tree, self.pipe.nets["unet"], self.pipe.nets["text_encoder"],
                                         dtype=self.pipe.policy.param_dtype)
        else:
            tree = {"unet": path_or_tree.get("unet"), "text_encoder": path_or_tree.get("text_encoder")}
        if self._layout(tree) != self._layout(self._loras[None][0]):
            raise ValueError(
                f"lora {name!r} does not match the server's adapter structure (rank / targeted modules / "
                "dtype / device differ); construct SamplerServer with a matching lora_rank or convert the "
                "checkpoint to the server's rank"
            )
        if not self.is_front:
            raise RuntimeError(f"rank {self.mesh.rank} of a mesh server takes its adapters from rank 0")
        if not self._distributed:
            self._set_lora(name, tree, float(scale))
            return
        # the worker thread sends it between two steps: the ranks' collectives keep one order
        Header(mesh_lib.OP_REGISTER, name=name).encode(self.batch_size, TOKENS)  # a name too long raises here
        fut: Future = Future()
        with self._pending_cv:
            if self._stop.is_set():
                raise RuntimeError("server is shut down; register_lora rejected")
            self._registrations.append((name, tree, float(scale), fut))
            self._pending_cv.notify_all()
        fut.result()

    def _set_lora(self, name, tree, scale: float):
        with self._loras_lock:
            if name not in self._loras:
                self._lora_names.append(name)
            self._loras[name] = (tree, scale)
            self._stack_cache.clear()  # compositions of a replaced adapter are stale

    def _send_registrations(self):
        """Rank 0's worker thread: broadcast the adapters registered since the
        last step, each as a header and its leaves."""
        while True:
            with self._pending_cv:
                if not self._registrations:
                    return
                name, tree, scale, fut = self._registrations.popleft()
            try:
                self._send(Header(mesh_lib.OP_REGISTER, value=scale, name=name))
                mesh_lib.broadcast_tree(self.mesh, tree, self._loras[None][0])
            except Exception as e:
                fut.set_exception(e)
                raise MeshFault(f"sending adapter {name!r} failed: {e}") from e
            self._set_lora(name, tree, scale)
            fut.set_result(None)

    def _send(self, header: Header):
        """Rank 0: one header to every rank (nothing without other ranks)."""
        if self._distributed:
            mesh_lib.send_header(self.mesh, header, self.batch_size, TOKENS)
            self._last_sent = time.perf_counter()

    def _recv(self) -> Header:
        """Another rank: the next header that names a step of its loop; the
        beats are skipped and the adapters taken in here."""
        while True:
            h = mesh_lib.recv_header(self.mesh, self.batch_size, TOKENS)
            if h.op == mesh_lib.OP_IDLE:
                continue
            if h.op != mesh_lib.OP_REGISTER:
                return h
            self._set_lora(h.name, mesh_lib.broadcast_tree(self.mesh, None, self._loras[None][0]), h.value)

    def _beat(self):
        """Rank 0, idle: a beat once every HEARTBEAT_S."""
        if self._distributed and time.perf_counter() - self._last_sent >= self.HEARTBEAT_S:
            self._send(Header(mesh_lib.OP_IDLE))

    def join(self, timeout: Optional[float] = None):
        """Wait for this rank's worker thread to end (on rank 0 a
        `shutdown()`, elsewhere rank 0's stop) and raise the error that ended
        it, if one did."""
        self._worker.join(timeout)
        if self._error is not None:
            raise self._error

    # -- request path ---------------------------------------------------------

    def submit(self, request: GenerationRequest) -> Future:
        if not self.is_front:
            raise RuntimeError(f"rank {self.mesh.rank} of a mesh server takes no requests: submit to rank 0")
        if self._stop.is_set():
            raise RuntimeError("server is shut down; submit rejected")
        if request.lora_id not in self._loras:
            raise KeyError(f"unknown lora_id {request.lora_id!r}; register_lora first")
        seed = int(request.seed)
        if not (0 <= seed < 2**32):
            raise ValueError(f"seed must be in [0, 2**32), got {request.seed}")
        fut: Future = Future()
        with self._pending_cv:
            if len(self._pending) >= self.max_queue:
                raise QueueFull(f"request queue full ({self.max_queue} pending); retry later")
            self._pending.append((request, fut, time.perf_counter()))
            self._pending_cv.notify()
        return fut

    def generate(self, requests: Sequence[GenerationRequest]) -> List[GenerationResult]:
        futs = [self.submit(r) for r in requests]
        return [f.result() for f in futs]

    def stats(self) -> dict:
        """Counters are all-time; medians and throughput are over the recent
        bounded window."""
        with self._stats_lock:
            bt = sorted(self._stats["batch_times"])
            qt = sorted(self._stats["queue_times"])
            window_reqs = sum(self._stats["batch_sizes"])

            def med(xs):
                return xs[len(xs) // 2] if xs else 0.0

            return {
                "requests": self._stats["requests"],
                "batches": self._stats["batches"],
                "padded_slots": self._stats["padded_slots"],
                "p50_batch_s": round(med(bt), 4),
                "p50_queue_s": round(med(qt), 4),
                "images_per_s": round(window_reqs / max(sum(bt), 1e-9), 3),
            }

    def shutdown(self, wait: bool = True):
        """Stop serving (rank 0: the other ranks follow its stop)."""
        self._stop.set()
        with self._pending_cv:
            self._pending_cv.notify_all()
        if wait:
            self._worker.join(timeout=30)
        self._fail_all_pending(RuntimeError("server shut down"))

    def _fail_all_pending(self, exc: BaseException):
        with self._pending_cv:
            pending, self._pending = list(self._pending), collections.deque()
            registrations, self._registrations = list(self._registrations), collections.deque()
        for _, fut, _ in pending:
            if not fut.done():
                fut.set_exception(exc)
        for *_, fut in registrations:
            if not fut.done():
                fut.set_exception(exc)

    def _fault(self, err: BaseException, batch=None):
        """The ranks are out of step: fail the batch in flight and everything
        pending, and stop serving; `join()` raises `err`."""
        log.error("mesh server stopped: %s", err)
        self._error = err
        self._stop.set()
        for _, fut, _ in batch or ():
            if not fut.done():
                fut.set_exception(err)
        self._fail_all_pending(err)

    # -- worker ---------------------------------------------------------------

    def _stacked_lora(self, lora_ids: tuple):
        """(tree, (B,) fp32 scale) of a mixed batch: the adapters' leaves
        stacked on a leading request axis, cached per composition (LRU)."""
        with self._loras_lock:
            hit = self._stack_cache.get(lora_ids)
            if hit is not None:
                self._stack_cache.move_to_end(lora_ids)
                return hit
            pairs = [self._loras[i] for i in lora_ids]
        tree = tree_map(lambda *xs: torch.stack(xs), *[t for t, _ in pairs])
        scale = to_device(torch.tensor([s for _, s in pairs], dtype=torch.float32), self.device)
        with self._loras_lock:
            self._stack_cache[lora_ids] = (tree, scale)
            while len(self._stack_cache) > self._stack_cache_max:
                self._stack_cache.popitem(last=False)
        return tree, scale

    def _take_front(self, limit: int):
        """FIFO pop (multi_lora: every request fits every batch)."""
        return [self._pending.popleft() for _ in range(min(limit, len(self._pending)))]

    def _take_matching(self, lora_id, limit: int):
        """Up to `limit` pending requests of this lora_id, scanned in place so
        the others keep their arrival order (the oldest request always heads
        the next batch)."""
        taken, kept = [], []
        while self._pending and len(taken) < limit:
            item = self._pending.popleft()
            (taken if item[0].lora_id == lora_id else kept).append(item)
        self._pending.extendleft(reversed(kept))
        return taken

    def _expire_deadlined_locked(self):
        """Fail with TimeoutError the requests queued longer than the
        deadline. The caller holds `_pending_cv`."""
        if self.request_timeout_s is None:
            return
        now = time.perf_counter()
        kept = collections.deque()
        for item in self._pending:
            _, fut, t_sub = item
            if now - t_sub > self.request_timeout_s:
                if not fut.done():
                    fut.set_exception(TimeoutError(f"request exceeded deadline ({self.request_timeout_s}s in queue)"))
            else:
                kept.append(item)
        self._pending = kept

    def _collect_batch(self):
        """The oldest pending request and its same-adapter followers (any
        followers under multi_lora), up to batch_size, waiting up to
        max_wait_s for stragglers; None when nothing is pending."""
        with self._pending_cv:
            self._expire_deadlined_locked()
            if not self._pending_cv.wait_for(lambda: self._pending or self._registrations, timeout=0.1):
                return None
            if not self._pending:
                return None
            if self.multi_lora:
                take = self._take_front
            else:
                take = functools.partial(self._take_matching, self._pending[0][0].lora_id)
            batch = take(self.batch_size)
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.batch_size:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                # wake on new arrivals only: leftovers of other adapters stay
                # pending and must not spin this wait
                seen = len(self._pending)
                if not self._pending_cv.wait_for(lambda: len(self._pending) > seen, timeout=timeout):
                    break
                batch.extend(take(self.batch_size - len(batch)))
        return batch

    def _serve(self):
        """The worker thread: on the pipeline's card, then the serving loop
        (rank 0) or the loop that follows rank 0's headers."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self.is_front:
            self._run()
            return
        try:
            self._follow()
        except BaseException as e:  # join() raises it; the rank's process exits non-zero
            log.exception("mesh server rank %d failed", self.mesh.rank)
            self._error = e

    def _run(self):
        while not self._stop.is_set():
            batch = None
            try:
                self._send_registrations()
                batch = self._collect_batch()
                if batch is None:
                    self._beat()
                    continue
                self._execute(batch)
            except MeshFault as e:
                self._fault(e.__cause__ or e, batch)
                return
            except Exception as e:  # the worker must keep serving: report through the futures
                log.exception("serving batch failed")
                if batch:
                    for _, fut, _ in batch:
                        if not fut.done():
                            fut.set_exception(e)
                else:  # outside a batch: fail everything pending rather than hang its callers
                    self._fail_all_pending(e)
        self._stop_ranks()

    def _stop_ranks(self):
        """Rank 0's worker thread, leaving: the other ranks' stop, then fail
        what is left."""
        try:
            self._send(Header(mesh_lib.OP_STOP))
        except Exception as e:
            self._fault(e)
        self._fail_all_pending(RuntimeError("server shut down"))

    def _follow(self):
        """Ranks other than 0: run each batch rank 0 sends, until its stop."""
        while True:
            h = self._recv()
            if h.op == mesh_lib.OP_STOP:
                return
            if h.op != mesh_lib.OP_BATCH:
                raise MeshFault(f"unexpected header op {h.op} at a batch server")
            self._run_batch(h)

    def _per_request_noise(self, seeds: Sequence[int]) -> torch.Tensor:
        return request_noise(seeds, self._schedule.num_inference_steps, self.height // 8, self.width // 8,
                             self.device)

    def _execute(self, batch):
        t0 = time.perf_counter()
        pipe = self.pipe
        reqs = [b[0] for b in batch]
        n_pad = self.batch_size - len(reqs)
        padded = reqs + [reqs[0]] * n_pad
        with self._loras_lock:
            adapters = [self._lora_names.index(r.lora_id) for r in padded]
        header = Header(mesh_lib.OP_BATCH, len(padded), slots=torch.arange(len(padded)),
                        seeds=torch.tensor([r.seed for r in padded]), adapters=torch.tensor(adapters),
                        ids=pipe.tokenize([r.prompt for r in padded]),
                        neg=pipe.tokenize([r.negative_prompt for r in padded]))
        try:
            self._send(header)
            images = self._run_batch(header)
        except Exception as e:
            if self._distributed:  # the header went out: the ranks are out of step
                raise MeshFault(f"batch failed after its header: {e}") from e
            raise
        t1 = time.perf_counter()

        with self._stats_lock:
            self._stats["requests"] += len(reqs)
            self._stats["batches"] += 1
            self._stats["padded_slots"] += n_pad
            self._stats["batch_times"].append(t1 - t0)
            self._stats["batch_sizes"].append(len(reqs))
            self._stats["queue_times"].extend(t0 - b[2] for b in batch)

        for i, (req, fut, t_sub) in enumerate(batch):
            fut.set_result(GenerationResult(image=images[i], seed=req.seed, lora_id=req.lora_id,
                                            queue_s=t0 - t_sub, batch_s=t1 - t0))

    def _run_batch(self, h: Header) -> Optional[np.ndarray]:
        """Every rank: sample this rank's rows of the batch `h` names (all of
        them under `parallel_window` or without a mesh); rank 0 returns the
        (B, H, W, 3) uint8 images on the host, the others None."""
        from ..diffusion.parallel_sampler import sample_parallel
        from ..diffusion.sampler import sample

        pipe = self.pipe
        whole = self.mesh is None or self.parallel_window > 0
        rows = slice(0, h.count) if whole else mesh_lib.rows_of(self.mesh, h.count)
        with self._loras_lock:
            names = [self._lora_names[i] for i in h.adapters[rows].tolist()]
        noise = self._per_request_noise(h.seeds[rows].tolist())
        if self.multi_lora:
            lora, scale = self._stacked_lora(tuple(names))
        else:
            with self._loras_lock:
                lora, scale = self._loras[names[0]]
        common = dict(guidance_scale=self.guidance_scale, height=self.height, width=self.width, policy=pipe.policy,
                      attn_impl=pipe.models.attn_impl, lora=lora, lora_scale=scale, noise_override=noise,
                      tome_ratio=self.tome_ratio, tome_ops=self.tome_ops)
        if self.parallel_window > 0:
            images = sample_parallel(pipe.nets, self._schedule, h.ids[rows], h.neg[rows], window=self.parallel_window,
                                     tolerance=self.parallel_tolerance, mesh=self.mesh, **common)
        else:
            images = sample(pipe.nets, self._schedule, h.ids[rows], h.neg[rows], scheduler=self.scheduler,
                            deepcache_interval=self.deepcache_interval, deepcache_depth=self.deepcache_depth,
                            cfg_interval=self.cfg_interval, mesh=self.mesh, **common)
        images = quantize_u8(images)
        if not whole:
            images = mesh_lib.all_gather_rows(self.mesh, images)
        return images.cpu().numpy() if self.is_front else None
