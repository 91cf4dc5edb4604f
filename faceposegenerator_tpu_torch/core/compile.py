"""One program per static key: `jit` as CUDA graphs (port of
`faceposegenerator_tpu/core/compile.py`).

JAX's `compile.jit` is the `jax.jit` behind every hot entry point: a
request, a rolling tick or a train step is one compiled program, cached by
its static arguments and its argument shapes. Here `jit` gives the port the
same unit of work on the card, a captured CUDA graph, cached by the same
kind of key:

  - the values of the static arguments (`static_argnames`; an object with a
    `cache_key()` method, such as a schedule, by that key);
  - the tree structure of the other arguments, every tensor leaf's shape,
    dtype, device and `requires_grad`, and every other leaf's value (a
    Python number the function reads is baked into the graph);
  - the tensors the function reads that are not arguments: the parameters
    and buffers of every `nn.Module` among the arguments, by (data_ptr,
    shape, dtype), and the `compile_key()` of each submodule that has one
    (a quantized weight's static activation scale);
  - the switches that change which code runs: the attention route (an
    argument), the `Policy` (an argument), the TF32 flags, grad and
    inference mode, and every route a module registers with
    `register_route` (the GroupNorm routes of `ops.fused_gn` and
    `ops.fused_gn_conv`). A module-level switch that decides which kernels
    run registers its reader there: one that does not is not in the key,
    and a replay keeps the route it was captured on.

Values are not part of the key. A LoRA swap, a new seed, a new prompt or
`load_state_dict` (in-place copies, which keep every pointer) reuse the
graph, as JAX reuses its program. Rebinding a parameter (`pipe.quantize()`
replaces weights) changes the fingerprint and captures anew: JAX traces
its parameters as arguments, so a new tree retraces there too.

On a CUDA key the first call runs eagerly, on a side stream: the warm-up
that builds the kernels with `nvcc`, fills the `lru_cache`d device tables,
sets the kernels' shared-memory attributes and makes the cuBLAS and cuDNN
handles, none of which may happen inside a capture. It returns its result.
The second call copies its tensor arguments into static buffers, captures
`fn` on them with `torch.cuda.graph`, and replays it. Every later call
copies the new argument values into those buffers and replays. Each call
returns copies of the static outputs: JAX returns fresh arrays, and the
next replay must not overwrite what a caller holds. A function that
updates an argument in place (the train step's LoRA and optimizer state)
updates the static buffer and returns it, and the caller takes the copy.

The live keys of one wrapped function share one private memory pool (when
all its graphs are gone, the allocator may free it, and the next capture
starts another). Sharing is safe because their replays never overlap: a lock serialises the calls,
each replay runs on the caller's current stream, the inputs are copied in
before it on that stream and the outputs copied out after it, and a
key's static inputs and outputs stay allocated (outside the pool, or held
by its entry) for as long as the key lives, so no capture reuses them.
Only the temporaries of one capture are reused by the next.

The wrappers' launch counters (`ops.*.LAUNCHES`) are Python: a replay runs
none of it. The capture records each counter's increase while it ran `fn`,
and every replay adds that increase, so a count means "launched" whether
the kernels ran eagerly or from a graph.

There is no fallback: a capture or a replay that fails raises. A call runs
eagerly on the card in two ways only, both decided before any capture:

  - inside `disable()`, the counterpart of `jax.disable_jit()`;
  - the argument rule, `eager_if(*args, **kwargs)` of the wrapped
    function: a call made over a mesh of more than one rank (a `ranks`
    argument above 1: `over_ranks`; a mesh or a UNet placed over one:
    `over_mesh`), since gloo collectives cannot be captured and NCCL
    capture is later work, and the train step with a host-side detector
    (a `detect_fn` other than `full_image_boxes`: MTCNN's NMS runs in
    numpy).

On the CPU every call runs eagerly, but its key is recorded all the same,
so `_cache_size()` counts on the CPU what it counts on the card.

`machine_scoped_cache_dir` keys the build directories of the kernels
(`ops/_build.py`) and of the native loader (`native/`) by the toolchain
and the machine, as JAX keys its persistent compile cache by the host's
CPU flags: a library built elsewhere is rebuilt, never loaded.

JAX's `compiler_options_from_env` (TPU_SCOPED_VMEM_KIB,
XLA_COMPILER_OPTIONS) has no counterpart: it forwards options to XLA's TPU
compiler, the port runs no XLA, and its kernels' compiler flags are fixed
in `ops/_build.NVCC_FLAGS`.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import inspect
import itertools
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Callable, Optional

import torch

_disabled = 0
_disabled_lock = threading.Lock()
# the launch counters of the kernel wrappers, registered at their import
_COUNTERS: list = []
# readers of the module-level route switches, registered at their import
_ROUTES: list = []
# every wrapped function, for `clear_all`
_JITTED: "weakref.WeakSet[Jitted]" = weakref.WeakSet()
_SIDE_STREAMS: dict = {}


@contextlib.contextmanager
def disable():
    """Run every `jit` function eagerly inside the block, on every thread
    (`jax.disable_jit()`); the keys seen are not recorded."""
    global _disabled
    with _disabled_lock:
        _disabled += 1
    try:
        yield
    finally:
        with _disabled_lock:
            _disabled -= 1


def _side_stream() -> "torch.cuda.Stream":
    """This thread's stream on the current device for warm-ups and captures.
    A pool's blocks belong to the stream they were captured on, so the keys
    of one pool reuse each other's temporaries only if they are captured on
    one stream (a train step's two keys take ~31 GiB, not 62); and a thread
    must not launch into a stream that another thread is capturing."""
    key = (torch.cuda.current_device(), threading.get_ident())
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(key[0])
    return _SIDE_STREAMS[key]


def register_counters(counts: dict) -> dict:
    """Register a wrapper module's launch counter (name → launches) so that
    replays count; returns it."""
    _COUNTERS.append(counts)
    return counts


def register_route(read: Callable[[], object]) -> None:
    """Register a reader of a module's route switch (a hashable value): the
    key of every call carries what it returns then."""
    _ROUTES.append(read)


def _snapshot() -> list:
    return [dict(c) for c in _COUNTERS]


def _increase(before: list) -> list:
    return [{k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
            for c, b in zip(_COUNTERS, before + [{}] * (len(_COUNTERS) - len(before)))]


def over_mesh(*objs) -> bool:
    """The argument rule: True when any of `objs` is a mesh of more than one
    rank, or an `nn.Module` with a submodule placed over one (`tp`, by
    `parallel.tp`)."""
    from .mesh import Mesh

    for obj in objs:
        if isinstance(obj, Mesh) and obj.size > 1:
            return True
        if isinstance(obj, torch.nn.Module):
            if any(getattr(m, "tp", None) is not None and m.tp.mesh.size > 1 for m in obj.modules()):
                return True
    return False


def over_ranks(*args, ranks: int = 1, **kwargs) -> bool:
    """The argument rule for a function that takes `ranks`, the size of the
    mesh its call runs over: eager above one rank."""
    return ranks > 1


def module_fingerprint(m: torch.nn.Module) -> tuple:
    """(data_ptr, shape, dtype) of every parameter and buffer, and the
    `compile_key()` of every submodule that defines one."""
    tensors = tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in itertools.chain(m.parameters(), m.buffers()))
    extra = tuple(sub.compile_key() for sub in m.modules() if hasattr(sub, "compile_key"))
    return tensors, extra


def _routing() -> tuple:
    return (tuple(read() for read in _ROUTES), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.is_grad_enabled(), torch.is_inference_mode_enabled())


class _Walk:
    """One pass over a call's arguments: the key, the tensor leaves in
    order, the modules (held weakly by an entry) and the other objects
    (held strongly: a schedule's device tables are read by the graph)."""

    def __init__(self):
        self.tensors, self.modules, self.objects = [], [], []
        self.cuda = False

    def key(self, x):
        if isinstance(x, torch.Tensor):
            self.tensors.append(x)
            self.cuda |= x.is_cuda
            return ("T", tuple(x.shape), x.dtype, x.device, x.requires_grad)
        if isinstance(x, torch.nn.Module):
            self.modules.append(x)
            fp = module_fingerprint(x)
            self.cuda |= any(t.is_cuda for t in itertools.chain(x.parameters(), x.buffers()))
            return ("M", type(x).__name__, fp)
        if isinstance(x, dict):
            return ("D", tuple((k, self.key(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return ("L" if isinstance(x, list) else "U", tuple(self.key(v) for v in x))
        if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device)):
            return ("V", type(x).__name__, x)
        if isinstance(x, torch.Generator):
            raise TypeError("compile.jit: a torch.Generator cannot be an argument of a captured function; "
                            "draw its numbers before the call")
        self.objects.append(x)
        if hasattr(x, "cache_key"):
            return ("K", type(x).__name__, x.cache_key())
        return ("O", x)


def _substitute(x, it):
    """`x` with its tensor leaves replaced, in walk order, by `next(it)`."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if isinstance(x, dict):
        return {k: _substitute(v, it) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        out = [_substitute(v, it) for v in x]
        return out if isinstance(x, list) else tuple(out)
    return x


def _copy_out(x):
    """The tree `x` with every tensor leaf copied (detached)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _copy_out(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        out = [_copy_out(v) for v in x]
        return out if isinstance(x, list) else tuple(out)
    return x


def _tensor_leaves(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _tensor_leaves(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensor_leaves(v, out)
    return out


class _Entry:
    """A captured key: its graph, static inputs and outputs, the launches a
    replay adds, and what must outlive it."""

    def __init__(self, graph, static_in, static_out, launches, objects):
        self.graph, self.static_in, self.static_out, self.launches = graph, static_in, static_out, launches
        self.objects = objects


_WARM = object()  # a key seen once: warmed up eagerly, not captured yet


class Jitted:
    """A function run as one captured CUDA graph per key (see the module)."""

    def __init__(self, fn: Callable, static_argnames=(), eager_if: Optional[Callable] = None):
        self._fn = fn
        self._sig = inspect.signature(fn)
        self.static_argnames = tuple(static_argnames)
        unknown = set(self.static_argnames) - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"static_argnames {sorted(unknown)} are not parameters of {fn.__qualname__}")
        self._eager_if = eager_if
        self._entries: dict = {}
        self._pool = None
        self._lock = threading.RLock()
        functools.update_wrapper(self, fn)
        _JITTED.add(self)

    def _cache_size(self) -> int:
        """Keys seen (warmed up or captured; recorded on the CPU too)."""
        return len(self._entries)

    def clear(self) -> None:
        """Drop every key's graph, buffers and pool."""
        with self._lock:
            self._entries.clear()
            self._pool = None

    def pool_bytes(self) -> int:
        """Device bytes the captured keys hold: the private pool's segments
        (every capture's temporaries and outputs) and the static inputs."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        total = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                    if tuple(seg.get("segment_pool_id", ())) == pool)
        for e in list(self._entries.values()):
            if e is not _WARM:
                total += sum(t.numel() * t.element_size() for t in e.static_in)
        return total

    def _key(self, bound) -> tuple:
        walk = _Walk()
        parts = []
        for name, value in bound.arguments.items():
            if name in self.static_argnames:
                if hasattr(value, "cache_key"):
                    walk.objects.append(value)
                    value = ("K", type(value).__name__, value.cache_key())
                parts.append((name, "static", value))
            else:
                parts.append((name, walk.key(value)))
        key = (tuple(parts), _routing())
        hash(key)  # an unhashable static raises here, before any capture
        return key, walk

    def __call__(self, *args, **kwargs):
        if _disabled or (self._eager_if is not None and self._eager_if(*args, **kwargs)):
            return self._fn(*args, **kwargs)
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        key, walk = self._key(bound)
        if not walk.cuda:
            self._entries.setdefault(key, _WARM)
            return self._fn(*args, **kwargs)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._entries[key] = _WARM
                out = self._warm_up(bound)
                self._watch(key, walk.modules)
                return out
            if entry is _WARM:
                entry = self._entries[key] = self._capture(bound, walk)
                self._watch(key, walk.modules)
                return _copy_out(entry.static_out)
            with torch.no_grad():
                for dst, src in zip(entry.static_in, walk.tensors):
                    if dst.data_ptr() != src.data_ptr():
                        dst.copy_(src)
            entry.graph.replay()
            for counts, inc in zip(_COUNTERS, entry.launches):
                for k, v in inc.items():
                    counts[k] += v
            return _copy_out(entry.static_out)

    def _watch(self, key, modules) -> None:
        """Drop `key` when one of its modules is collected: its pointers may
        then belong to anything."""
        me = weakref.ref(self)  # the finalizer must not keep the graphs alive

        def drop(key=key):
            jitted = me()
            if jitted is not None:
                jitted._entries.pop(key, None)

        for m in modules:
            weakref.finalize(m, drop)

    def _warm_up(self, bound):
        main = torch.cuda.current_stream()
        side = _side_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._fn(*bound.args, **bound.kwargs)
        main.wait_stream(side)
        for t in _tensor_leaves(out, []):
            if t.is_cuda:
                t.record_stream(main)
        return out

    def _capture(self, bound, walk) -> _Entry:
        with torch.no_grad():
            static_in = [t.detach().clone() for t in walk.tensors]
        for s, t in zip(static_in, walk.tensors):
            s.requires_grad_(t.requires_grad)
        it = iter(static_in)
        args = _substitute(list(bound.args), it)
        kwargs = _substitute(dict(bound.kwargs), it)
        if all(e is _WARM for e in self._entries.values()):
            # a pool whose graphs are all gone is the allocator's to free
            # and cannot take a capture: start a new one
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        # torch.cuda.graph's entry without its flush of the pinned host
        # cache (the servers' copies use it): the allocator's cached blocks
        # and the pools of dead graphs go back to the card first, since a
        # capture cannot free them itself (a train step's capture takes ~31 GiB)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        stream = _side_stream()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                static_out = self._fn(*args, **kwargs)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        launches = _increase(before)
        graph.replay()
        return _Entry(graph, static_in, static_out, launches, list(walk.objects))


def jit(fn=None, *, static_argnames=(), eager_if: Optional[Callable] = None):
    """`fn` as a `Jitted`: one captured CUDA graph per key on the card (see
    the module). Usable as `jit(fn, static_argnames=…)` or as a decorator
    factory, as JAX's is; the result has `_cache_size()` and `clear()`.
    `eager_if(*args, **kwargs)`: the argument rule, True for a call that
    must run eagerly (see the module)."""
    if fn is None:
        return lambda f: jit(f, static_argnames=static_argnames, eager_if=eager_if)
    return Jitted(fn, static_argnames, eager_if)


def clear_all() -> None:
    """`clear()` every wrapped function: release their graphs and pools."""
    for j in list(_JITTED):
        j.clear()


# -- build directories --------------------------------------------------------


def _command_version(*cmd: str) -> str:
    """The output of a toolchain's version command, "" where it does not run."""
    try:
        r = subprocess.run(list(cmd), capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.strip() if r.returncode == 0 else ""


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        import platform

        return f"{platform.machine()}-{platform.processor()}"


def kernel_toolchain_tag(nvcc: str) -> str:
    """What a kernel library depends on besides its source: `nvcc --version`
    and the card's compute capability."""
    cap = torch.cuda.get_device_capability() if torch.cuda.is_available() else "no card"
    return f"{_command_version(nvcc, '--version')}\ncompute capability {cap}"


def native_toolchain_tag(gxx: str) -> str:
    """What the native loader depends on besides its source: the first line
    of `g++ --version` and the host's CPU flags."""
    return f"{(_command_version(gxx, '--version').splitlines() or [''])[0]}\n{_cpu_flags()}"


def machine_scoped_cache_dir(root, tag: str) -> Path:
    """`root / <hash of tag>`: a build directory of its own for each
    toolchain and machine (`tag` from `kernel_toolchain_tag` or
    `native_toolchain_tag`). Nothing is created."""
    return Path(root) / hashlib.sha1(tag.encode()).hexdigest()[:12]
