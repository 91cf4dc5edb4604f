"""The ("data", "model") mesh of ranks and its collectives (port of
`faceposegenerator_tpu/core/mesh.py`).

JAX lays a 2-D ("data", "model") `Mesh` over its devices and lets jit put
the collectives in. The port runs one rank per device, laid out rank-major,
`rank = data_index · model + model_index`, as JAX's process-major
`reshape(data, model)` lays the devices (mesh.py:44): the "model" ranks of
one data index are neighbours. A `Mesh` carries the shape, this rank's
coordinates, the process groups of its data column (the ranks with its
model index) and of its model row (the ranks with its data index), and its
device. The batch shards over "data"; the UNet's attention and MLP shard
over "model" (`parallel/tp.py`).

The collectives come from `all_reduce`, `broadcast` and `barrier` only,
the three that gloo also gives tensors on a card, so one code path serves
NCCL and the gloo rig alike: a gather is an `all_reduce` of a zero-filled
buffer into which each rank writes its rows. An axis of size 1 takes no
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .tree import tree_map, tree_paths

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    data: int
    model: int
    data_index: int
    model_index: int
    device: torch.device
    data_group: Optional[object] = None   # this rank's data column
    model_group: Optional[object] = None  # this rank's model row
    world_group: Optional[object] = None  # every rank of the mesh

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.data_index * self.model + self.model_index

    def group(self, axis: Optional[str]):
        """The process group of `axis` ("data", "model" or None: all ranks)."""
        return {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group, None: self.world_group}[axis]

    def axis_size(self, axis: Optional[str]) -> int:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model, None: self.size}[axis]

    def axis_index(self, axis: Optional[str]) -> int:
        return {DATA_AXIS: self.data_index, MODEL_AXIS: self.model_index, None: self.rank}[axis]


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: Optional[int] = None, model: int = 1, device=None, *,
              world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The 2-D ("data", "model") mesh over the job's ranks (mesh.py:25-45).

    With `data=None` the data axis takes every rank that `model` leaves. One
    process is a 1x1 mesh, so the same code path runs everywhere. Every
    rank must call this, in the same order as any other `make_mesh`: it
    creates the process groups. `device` defaults to the one
    `core.dist.init_distributed` bound, else the card. `world_size` and
    `rank` describe a job without creating groups (shapes and errors only).
    """
    from . import dist as _dist

    n, r = _world()
    groups = world_size is None
    n = n if world_size is None else world_size
    r = r if rank is None else rank
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if device is None and _dist.device() is not None:
        device = _dist.device()
    else:
        from .device import resolve_device

        device = resolve_device(device)
    mesh = Mesh(data, model, r // model, r % model, device)
    if groups and n > 1:
        # every rank creates every group, in one order
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if j == mesh.model_index:
                mesh.data_group = g
        for i in range(data):
            g = dist.new_group([i * model + j for j in range(model)])
            if i == mesh.data_index:
                mesh.model_group = g
        mesh.world_group = dist.group.WORLD
    return mesh


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def all_reduce_(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """Sum `t` in place over the ranks of `axis`; returns it."""
    if mesh.axis_size(axis) > 1:
        dist.all_reduce(t, group=mesh.group(axis))
    return t


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of a process group, differentiable: its
    backward sums the cotangents over the same ranks (JAX's psum and its
    transpose)."""
    return _AllReduce.apply(t, group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_gather_rows(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """Concatenate every rank's `t` of `axis` along dim 0, in rank order:
    each rank writes its rows into a zero-filled global buffer that an
    `all_reduce` sums. Every rank must hold the same number of rows."""
    size = mesh.axis_size(axis)
    if size == 1:
        return t
    n = t.shape[0]
    # a sum of zeros and one value is exact in any dtype; bool as uint8
    work = t.to(torch.uint8) if t.dtype == torch.bool else t
    out = torch.zeros((size * n,) + tuple(t.shape[1:]), dtype=work.dtype, device=t.device)
    i = mesh.axis_index(axis)
    out[i * n:(i + 1) * n] = work
    dist.all_reduce(out, group=mesh.group(axis))
    return out.bool() if t.dtype == torch.bool else out


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite `t` in place with global rank `src`'s copy; returns it."""
    if mesh.size > 1:
        dist.broadcast(t, src=src, group=mesh.world_group)
    return t


def broadcast_object(mesh: Mesh, value: float, src: int = 0) -> float:
    """A float of rank `src`, on every rank."""
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    return float(broadcast_(mesh, t, src)[0])


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

def rows_of(mesh: Mesh, global_rows: int) -> slice:
    """This rank's contiguous rows of a global batch sharded over "data"."""
    per = local_batch_size(mesh, global_rows)
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def _to_device(x, device):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a tree of global arrays (batch dim first, sharded
    over "data"), as tensors on the mesh's device."""
    def _rows(x):
        return _to_device(x, mesh.device)[rows_of(mesh, len(x))]

    return tree_map(_rows, batch)


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Make a tree of tensors, or a module's parameters and buffers, equal
    on every rank: global rank 0's copy, broadcast in place. Returns it."""
    if mesh.size == 1:
        return tree
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            broadcast_(mesh, t.data)
        return tree
    if isinstance(tree, dict) and any(isinstance(v, torch.nn.Module) for v in tree.values()):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    return tree_map(lambda t: broadcast_(mesh, t.data) if isinstance(t, torch.Tensor) else t, tree)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    n_data = mesh.shape[DATA_AXIS]
    if global_batch % n_data != 0:
        raise ValueError(f"global batch {global_batch} % data axis {n_data} != 0")
    return global_batch // n_data


def host_row_slice(global_rows: int, num_hosts: int, host_id: int) -> slice:
    """The contiguous row range of a global batch that host `host_id` owns
    (mesh.py:81-95): each host loads only its slice, and the slices in host
    order make the single-process batch. Contiguous, so that with the data
    axis host-major a host's rows land on its own ranks."""
    if global_rows % num_hosts != 0:
        raise ValueError(f"global rows {global_rows} % hosts {num_hosts} != 0")
    per = global_rows // num_hosts
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    return slice(host_id * per, (host_id + 1) * per)


def form_global_batch(mesh: Mesh, host_local_batch, num_hosts: int = 1, host_id: int = 0):
    """This rank's rows of the global batch, from the rows its host loaded
    (mesh.py:98-112): the host holds `host_row_slice(G, num_hosts,
    host_id)` of a global batch of G rows, and this rank takes its "data"
    shard of those, with no data moving between ranks. With one host the
    host's rows are the global batch (`shard_batch`)."""
    def _rows(x):
        x = _to_device(x, mesh.device)
        g = len(x) * num_hosts
        mine, host = rows_of(mesh, g), host_row_slice(g, num_hosts, host_id)
        if not (host.start <= mine.start and mine.stop <= host.stop):
            raise ValueError(f"rank rows {mine.start}:{mine.stop} are not among host {host_id}'s "
                             f"{host.start}:{host.stop}: the data axis must be host-major")
        return x[mine.start - host.start:mine.stop - host.start]

    return tree_map(_rows, host_local_batch)


# --------------------------------------------------------------------------
# the control channel
# --------------------------------------------------------------------------

OP_IDLE, OP_BATCH, OP_TICK, OP_REGISTER, OP_STOP = range(5)
_SCALARS = 3  # op, count, value (a float64's bits)


@dataclasses.dataclass
class Header:
    """One step of a mesh server, from rank 0. `count` entries, each a slot
    index, a seed, an adapter index and the (negative) prompt's token ids:
    a batch's requests in slot order (OP_BATCH) or a tick's admissions
    (OP_TICK). OP_REGISTER carries the adapter's name and its scale in
    `value` (every rank appends a new name to its registry, so the ranks'
    adapter indices agree); OP_IDLE keeps the ranks' collectives inside
    their timeout while the front waits; OP_STOP ends the ranks' loops."""

    op: int
    count: int = 0
    value: float = 0.0
    slots: Optional[torch.Tensor] = None     # (count,) int64
    seeds: Optional[torch.Tensor] = None     # (count,)
    adapters: Optional[torch.Tensor] = None  # (count,)
    ids: Optional[torch.Tensor] = None       # (count, tokens)
    neg: Optional[torch.Tensor] = None       # (count, tokens)
    name: Optional[str] = None

    @staticmethod
    def size(entries: int, tokens: int) -> int:
        """The int64 length of a header of at most `entries` entries."""
        return _SCALARS + entries * (3 + 2 * tokens)

    def encode(self, entries: int, tokens: int) -> torch.Tensor:
        h = torch.zeros(self.size(entries, tokens), dtype=torch.int64)
        body = h[_SCALARS:].view(entries, 3 + 2 * tokens)
        count = self.count
        if self.name is not None:
            raw = torch.tensor(list(self.name.encode()), dtype=torch.int64)
            if len(raw) > body.numel():
                raise ValueError(f"adapter name of {len(raw)} bytes: a header holds at most {body.numel()}")
            body.view(-1)[:len(raw)] = raw
            count = len(raw)
        elif count:
            body[:count, 0], body[:count, 1], body[:count, 2] = self.slots, self.seeds, self.adapters
            body[:count, 3:3 + tokens], body[:count, 3 + tokens:] = self.ids, self.neg
        h[0], h[1] = self.op, count
        h[2] = torch.tensor([self.value], dtype=torch.float64).view(torch.int64)[0]
        return h

    @classmethod
    def decode(cls, h: torch.Tensor, entries: int, tokens: int) -> "Header":
        op, count = int(h[0]), int(h[1])
        value = float(h[2:3].view(torch.float64)[0])
        body = h[_SCALARS:].view(entries, 3 + 2 * tokens)
        if op == OP_REGISTER:
            return cls(op, count, value, name=bytes(body.view(-1)[:count].tolist()).decode())
        rows = body[:count]
        return cls(op, count, value, rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3:3 + tokens], rows[:, 3 + tokens:])


def send_header(mesh: Mesh, header: Header, entries: int, tokens: int) -> None:
    """Rank 0: broadcast `header` to every rank of the mesh."""
    broadcast_(mesh, header.encode(entries, tokens).to(mesh.device))


def recv_header(mesh: Mesh, entries: int, tokens: int) -> Header:
    """Any other rank: the next header rank 0 sends."""
    h = torch.empty(Header.size(entries, tokens), dtype=torch.int64, device=mesh.device)
    return Header.decode(broadcast_(mesh, h).cpu(), entries, tokens)


@torch.no_grad()
def broadcast_tree(mesh: Mesh, tree, like, src: int = 0):
    """Rank `src`'s `tree` on every rank, leaf by leaf in `like`'s
    `tree_paths` order (the paths, shapes and dtypes must be `like`'s). On
    `src` it returns `tree`; elsewhere new buffers in `like`'s structure."""
    if mesh.rank == src:
        leaves = dict(tree_paths(tree))
        for path, _ in tree_paths(like):
            broadcast_(mesh, leaves[path].contiguous(), src)
        return tree
    out = tree_map(torch.empty_like, like)
    for _, leaf in tree_paths(out):
        broadcast_(mesh, leaf, src)
    return out
