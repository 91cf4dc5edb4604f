"""Multi-process runtime initialisation (port of
`faceposegenerator_tpu/core/dist.py`).

The reference's multi-process story is HF Accelerate over torch.distributed
and NCCL, configured from the launcher's environment, with rank-0 gating
(`accelerator.is_main_process`) and a `wait_for_everyone()` barrier before
the final export. The port runs one process per device, joined by
`torch.distributed`: where JAX runs one controller per host over its local
devices, the port runs `hosts · local_devices` ranks, laid out rank-major
(`core.mesh.make_mesh`).

This module is the one place process topology is decided:

- `init_distributed()`: idempotent `init_process_group`. NCCL when the
  device is a card, gloo on the CPU; `backend="gloo"` on a card only when
  the caller asks for it (two ranks sharing one card as a test rig), by
  argument or by FPG_BACKEND=gloo in the environment (what lets a command's
  `--data_parallel N` run N ranks on one card). There
  is no silent switch between backends, and NCCL with a rank whose card is
  not there raises naming both counts. Pass the coordinator address and
  the process counts, or set FPG_COORDINATOR / FPG_NUM_PROCESSES /
  FPG_PROCESS_ID, or launch under torch's own launcher (RANK, WORLD_SIZE,
  MASTER_ADDR, MASTER_PORT).
- `proc_info()`: (process_index, process_count, local/global devices).
- `is_coordinator()`: the rank-0 gate for checkpoint writes and logging.
- `barrier(name)`: `wait_for_everyone()`.
- `coordination_barrier(name)`: a barrier through the rendezvous store,
  no collective on a device.
- `shutdown()`: idempotent teardown.
- `spawn(cmds)`: run the ranks of a job as processes of this machine, and
  stop them all when one fails or the job outlives its time.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import subprocess
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

_INITIALIZED = False
_DEVICE: Optional[torch.device] = None

# Env vars whose presence means this host is part of a managed multi-host
# job (GKE/GCE TPU pod, SLURM, OpenMPI). When any is set and no launcher
# said how to join the job, running on as one process would give every host
# rank 0, so all of them pass the is_coordinator() gate and clobber each
# other's checkpoints: that raises instead.
_POD_ENV_VARS = (
    "TPU_WORKER_HOSTNAMES",
    "TPU_WORKER_ID",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "CLOUD_TPU_TASK_ID",
    "SLURM_JOB_ID",
    "OMPI_COMM_WORLD_SIZE",
)
# torch's launcher (torchrun) hands every process these
_TORCH_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class ProcInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def _bind_device(device: torch.device, backend: str, rank: int, world: int) -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` (or `cuda:rank`) for a card,
    the CPU otherwise. NCCL needs a card of its own for every rank."""
    if device.type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    count = torch.cuda.device_count()
    if device.index is not None:
        index = device.index
    elif backend == "nccl":
        index = int(os.environ.get("LOCAL_RANK", rank))
    else:  # the gloo rig: every rank on the one card it names, or cuda:0
        index = 0
    if index >= count:
        raise RuntimeError(
            f"{world} ranks on CUDA need a card each: rank {rank} wants cuda:{index}, but {count} "
            f"card{'s are' if count != 1 else ' is'} visible")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    platform: Optional[str] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> ProcInfo:
    """Connect this process to the job. Idempotent: a second call returns
    the current topology without initialising again (single-process runs
    call this too and get the trivial 1-process topology).

    Args default from FPG_COORDINATOR ("host:port") / FPG_NUM_PROCESSES /
    FPG_PROCESS_ID, so one launcher can fan out identical command lines.
    With all three absent this joins a torch launcher's job when its
    variables are set, and is a no-op otherwise.

    `platform`: "cpu" or "cuda" (the default: this rank's card). `backend`:
    None takes FPG_BACKEND when it is set, else NCCL for a card and gloo for
    the CPU; "gloo" on a card is the explicit rig of several ranks sharing
    one card. Every process group waits at most `timeout_s` for its peers.
    """
    global _INITIALIZED, _DEVICE
    coordinator_address = coordinator_address or os.environ.get("FPG_COORDINATOR")
    if num_processes is None and os.environ.get("FPG_NUM_PROCESSES"):
        num_processes = int(os.environ["FPG_NUM_PROCESSES"])
    if process_id is None and os.environ.get("FPG_PROCESS_ID"):
        process_id = int(os.environ["FPG_PROCESS_ID"])

    # A partial launcher configuration is an error, not a silent
    # single-process run: FPG_COORDINATOR set with FPG_NUM_PROCESSES unset
    # (or =1) would otherwise leave every host believing it is rank 0.
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if num_processes is None or (num_processes > 1 and (
                coordinator_address is None or process_id is None)):
            raise ValueError(
                "partial multi-process configuration: coordinator_address="
                f"{coordinator_address!r} num_processes={num_processes!r} "
                f"process_id={process_id!r} — a multi-process launch needs "
                "all three (FPG_COORDINATOR / FPG_NUM_PROCESSES / "
                "FPG_PROCESS_ID); unset all of them for single-process or "
                "real-pod auto-detection"
            )
        if num_processes == 1 and (coordinator_address is not None
                                   or (process_id or 0) != 0):
            raise ValueError(
                "contradictory configuration: num_processes=1 with a "
                f"coordinator_address={coordinator_address!r} / "
                f"process_id={process_id!r} — did the launcher mean to set "
                "FPG_NUM_PROCESSES?"
            )

    if not _INITIALIZED:
        device = torch.device(platform or "cuda")
        backend = backend or os.environ.get("FPG_BACKEND") or None
        if backend not in (None, "nccl", "gloo"):
            raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the NCCL backend needs a card; the CPU takes backend='gloo'")
        timeout = datetime.timedelta(seconds=timeout_s)
        if num_processes is not None and num_processes > 1:
            if not 0 <= process_id < num_processes:
                raise ValueError(f"process_id {process_id} not in [0, {num_processes})")
            bound = _bind_device(device, backend, process_id, num_processes)
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id, timeout=timeout)
            _DEVICE = bound
        elif (coordinator_address is None and num_processes is None
              and process_id is None):
            launched = [v for v in _TORCH_LAUNCH_VARS if os.environ.get(v)]
            pod_vars = [v for v in _POD_ENV_VARS if os.environ.get(v)]
            if len(launched) == len(_TORCH_LAUNCH_VARS):
                rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
                bound = _bind_device(device, backend, rank, world)
                dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                                        timeout=timeout)
                _DEVICE = bound
            elif pod_vars:
                raise RuntimeError(
                    "multi-process auto-detection failed on what looks like a managed pod host "
                    f"({', '.join(pod_vars)} set) with neither torch's launcher variables "
                    f"({', '.join(_TORCH_LAUNCH_VARS)}) nor FPG_COORDINATOR / FPG_NUM_PROCESSES / "
                    "FPG_PROCESS_ID set. Refusing to continue single-process: every host would claim "
                    "rank 0 and clobber shared checkpoints."
                )
        _INITIALIZED = True
    return proc_info()


def maybe_init_from_env(platform: Optional[str] = None, backend: Optional[str] = None) -> ProcInfo:
    """Driver entry hook: initialise the multi-process topology only when a
    launcher asked for it (FPG_COORDINATOR / FPG_NUM_PROCESSES set, or
    torch's launcher variables). Single-host runs see a no-op, so every
    driver can call this first."""
    if (os.environ.get("FPG_COORDINATOR") or os.environ.get("FPG_NUM_PROCESSES")
            or all(os.environ.get(v) for v in _TORCH_LAUNCH_VARS)):
        return init_distributed(platform=platform, backend=backend)
    return proc_info()


def proc_info() -> ProcInfo:
    """One device a process: the global device count is the world size."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        return ProcInfo(dist.get_rank(), world, 1, world)
    return ProcInfo(0, 1, 1, 1)


def device() -> Optional[torch.device]:
    """The device `init_distributed` bound this rank to, None before."""
    return _DEVICE


def is_coordinator() -> bool:
    return proc_info().process_index == 0


def coordination_barrier(name: str, timeout_s: float = 1200.0) -> None:
    """Barrier through the rendezvous store: no collective on a device. It
    aligns processes across a large start-up skew (imports, kernel builds)
    before the first collective, whose groups wait only `timeout_s` of
    `init_distributed`. No-op single-process."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    store = dist.distributed_c10d._get_default_store()
    world = dist.get_world_size()
    key = f"fpg_barrier/{name}"
    if store.add(key, 1) == world:
        store.set(key + "/go", "1")
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            store.wait([key + "/go"], datetime.timedelta(seconds=min(30.0, timeout_s)))
            return
        except RuntimeError:
            if time.monotonic() > deadline:
                raise


def shutdown() -> None:
    """Tear the process group down. Call it after a final `barrier()` so
    every process leaves together. Idempotent; single-process runs no-op."""
    global _INITIALIZED, _DEVICE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False
    _DEVICE = None


def barrier(name: str = "fpg_barrier") -> None:
    """Block until every process reaches this point
    (`accelerator.wait_for_everyone()`). No-op in single-process runs."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def free_port() -> int:
    """A TCP port that was free on localhost a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class SpawnError(RuntimeError):
    """A rank of `spawn` failed, or the job outlived its time:
    `returncode` is the first failure's exit code (124 for the time limit),
    `outputs` each rank's output."""

    def __init__(self, message: str, returncode: int, outputs: List[str]):
        super().__init__(message)
        self.returncode, self.outputs = returncode, outputs


def spawn(cmds: Sequence[Sequence[str]], env_for_rank: Optional[Callable[[int], dict]] = None,
          timeout: Optional[float] = None, log_dir: Optional[str] = None) -> List[str]:
    """Run `cmds[i]` as process i, all at once, and wait for every one.

    Each runs in this process's environment updated by `env_for_rank(i)`,
    with this package's root first on PYTHONPATH. When one exits non-zero,
    or `timeout` seconds pass, every process still running is killed and
    SpawnError is raised. With `log_dir`, process i's stdout and stderr go
    to log_dir/rank{i}.log (a file, not a pipe: with pipes, reading rank 0
    first deadlocks once a later rank fills its pipe and blocks in a
    collective that rank 0 is also in) and the logs' texts are returned;
    without it the processes write to this process's stdout and stderr,
    and the texts are empty."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    deadline = None if timeout is None else time.monotonic() + timeout
    procs, logs, outputs, rc = [], [], [], 0
    try:
        for i, cmd in enumerate(cmds):
            env = dict(os.environ, **(env_for_rank(i) if env_for_rank else {}))
            env["PYTHONPATH"] = os.pathsep.join(filter(None, (root, env.get("PYTHONPATH"))))
            logs.append(open(os.path.join(log_dir, f"rank{i}.log"), "w+") if log_dir else None)
            procs.append(subprocess.Popen(list(cmd), env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT if log_dir else None))
        while True:
            codes = [p.poll() for p in procs]
            rc = next((c for c in codes if c), 0)
            if rc or all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                rc = 124
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            if log is not None:
                log.seek(0)
                outputs.append(log.read())
                log.close()
            else:
                outputs.append("")
    if rc:
        what = f"outlived {timeout} s" if rc == 124 else f"exited with code {rc}"
        raise SpawnError(f"a rank {what}:\n" + "\n----\n".join(o[-3000:] for o in outputs if o), rc, outputs)
    return outputs
