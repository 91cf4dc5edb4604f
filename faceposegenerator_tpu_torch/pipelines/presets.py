"""Named acceleration presets (port of `faceposegenerator_tpu/pipelines/presets.py`).

The exact path (30-step DDPM + CFG) stays the default; a preset is an
explicit opt-in that binds a stack of levers to one name:

  turbo    throughput stack: DPM-Solver++ 12 steps, DeepCache-4, guidance
           interval (2, 8), w8a8 UNet with calibrated static activation
           scales, int8 VAE decoder body;
  latency  batch-1 stack: DPM-Solver++ 20 steps, DeepCache-3, guidance
           interval (3, 13), unquantized.

The JAX module records what each stack measured on the TPU; the port's own
measurements on the card are in PERF.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

CALIBRATION_PROMPT = "face portrait photo of sks person"


@dataclass(frozen=True)
class Preset:
    """`scheduler`/`steps` pick the sampler; `deepcache_*` and
    `cfg_interval` are sampling kwargs; `quantize` is `pipe.quantize`'s
    mode, and `quant_calibrate_steps > 0` freezes static activation scales
    with `pipe.calibrate_quant`."""

    name: str
    scheduler: str  # "ddpm" | "dpm"
    steps: int
    deepcache_interval: int = 1
    deepcache_depth: int = 1
    cfg_interval: Optional[Tuple[int, int]] = None
    quantize: Optional[str] = None  # "w8a8" | "w8a8+vae"
    quant_calibrate_steps: int = 0
    note: str = ""

    def sample_kwargs(self) -> dict:
        """kwargs for `pipe(...)` / `sample(...)`."""
        kw: dict = {}
        if self.deepcache_interval > 1:
            kw["deepcache_interval"] = self.deepcache_interval
            if self.deepcache_depth != 1:
                kw["deepcache_depth"] = self.deepcache_depth
        if self.cfg_interval is not None:
            kw["cfg_interval"] = self.cfg_interval
        return kw

    def apply(self, pipe, calibrate: bool = True, **calib_kw) -> dict:
        """Swap the scheduler, quantize and calibrate `pipe`; returns
        `sample_kwargs()`. `calib_kw` goes to `pipe.calibrate_quant`; without
        `input_ids` or a prompt there, it calibrates on `CALIBRATION_PROMPT`
        through the pipeline's tokenizer."""
        pipe.set_scheduler(self.scheduler)
        if self.quantize:
            pipe.quantize(self.quantize)
            if calibrate and self.quant_calibrate_steps > 0:
                calib_kw.setdefault("prompt", [CALIBRATION_PROMPT])
                pipe.calibrate_quant(steps=self.quant_calibrate_steps, **calib_kw)
        return self.sample_kwargs()

    def mode_spec(self) -> str:
        """The JAX `accel-report --mode` string of exactly this preset."""
        parts = []
        if (self.scheduler, self.steps) != ("ddpm", 30):
            parts.append(f"scheduler={self.scheduler}:{self.steps}")
        if self.deepcache_interval > 1:
            spec = f"deepcache={self.deepcache_interval}"
            if self.deepcache_depth != 1:
                spec += f":{self.deepcache_depth}"
            parts.append(spec)
        if self.cfg_interval is not None:
            parts.append(f"cfg_interval={self.cfg_interval[0]}:{self.cfg_interval[1]}")
        if self.quantize:
            spec = "quantize=w8a8"
            if self.quantize.endswith("+vae"):
                spec += ",vae"
            if self.quant_calibrate_steps > 0:
                spec += f":static:{self.quant_calibrate_steps}"
            parts.append(spec)
        return "+".join(parts) if parts else "exact"


PRESETS: Dict[str, Preset] = {
    "turbo": Preset(
        name="turbo", scheduler="dpm", steps=12, deepcache_interval=4, cfg_interval=(2, 8),
        quantize="w8a8+vae", quant_calibrate_steps=8,
        note="throughput stack: DPM++(12) x DeepCache-4 x cfg_interval(2,8) x static w8a8 x int8 VAE",
    ),
    "latency": Preset(
        name="latency", scheduler="dpm", steps=20, deepcache_interval=3, cfg_interval=(3, 13),
        note="batch-1 stack: DPM++(20) x DeepCache-3 x cfg_interval(3,13), unquantized",
    ),
}


def get_preset(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(PRESETS)}") from None
