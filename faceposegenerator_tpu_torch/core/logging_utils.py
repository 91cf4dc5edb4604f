"""Logging and observability (port of
`faceposegenerator_tpu/core/logging_utils.py:22-128`): the reference's
`AverageMeter` and throughput/ETA callback (`utils_logging.py:8-29`,
`utils_callbacks.py:150-189`), a file + stdout logger, a `torch.profiler`
trace context and a non-finite detector over tensor trees.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Optional

import torch

from .tree import tree_paths


def setup_logging(output_dir: Optional[str] = None, name: str = "fpg") -> logging.Logger:
    """File (`<output_dir>/training.log`) + stdout handlers (reference
    `utils_logging.py:30-46`)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "training.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class ThroughputLogger:
    """samples/sec and ETA every `frequency` steps."""

    def __init__(self, frequency: int = 50, total_steps: Optional[int] = None,
                 logger: Optional[logging.Logger] = None):
        self.frequency = frequency
        self.total_steps = total_steps
        self.logger = logger or logging.getLogger("fpg")
        self.t0 = time.time()
        self.last_step = 0

    def __call__(self, step: int, batch_size: int):
        if step % self.frequency != 0 or step == self.last_step:
            return None
        dt = time.time() - self.t0
        steps_done = step - self.last_step
        sps = steps_done * batch_size / dt if dt > 0 else 0.0
        info = {"step": step, "samples_per_sec": round(sps, 2)}
        if self.total_steps:
            remaining = (self.total_steps - step) / max(steps_done / dt, 1e-9)
            info["eta_hours"] = round(remaining / 3600, 3)
        self.logger.info(json.dumps(info))
        self.t0 = time.time()
        self.last_step = step
        return info


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """`torch.profiler` over the block (CPU and, where present, CUDA
    activity), written as a Chrome trace under `log_dir`."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1000)}.json"))


def nan_check(tree, name: str = "tree") -> bool:
    """Raise FloatingPointError naming the floating tensors of `tree` that
    hold a NaN or an infinity; True otherwise."""
    bad = [path for path, x in tree_paths(tree)
           if isinstance(x, torch.Tensor) and x.is_floating_point() and not bool(torch.isfinite(x).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")
    return True
