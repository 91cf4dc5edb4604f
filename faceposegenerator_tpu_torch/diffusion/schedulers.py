"""DDPM and DPM-Solver++ 2M schedulers (port of
`faceposegenerator_tpu/diffusion/schedulers.py:28-349`).

The tables live on the host as fp32 numpy arrays, and the sampler steps with
Python-int step indices, so every per-step coefficient is a host scalar
computed in fp32 as the JAX package computes it on the device: a step costs
the card a few elementwise ops and never a host sync. Training draws one
timestep per sample, so `add_noise` and `pred_original` also take a (B,)
timestep tensor and gather from the tables on the device.

Each schedule also holds its per-step coefficients as an fp32 table of
length S, made once with the schedule, from which `step` reads its
scalars. A captured sampler graph bakes those scalars in, so `cache_key()`
(the class, S, the settings and a hash of the tables) is part of its key:
two schedules with the same S and other betas never share a graph.
`step_per_slot` gathers the same values on the device by a (B,)
tensor of step indices (the rolling engine's slots and the parallel
sampler's window, which JAX writes as `jax.vmap(schedule.step)`), so row b
of its result is bit for bit `step` at `step_idx[b]` on that row.

SD2.1-base `scheduler_config.json` semantics: scaled_linear betas
0.00085 → 0.012 over 1000 steps, epsilon prediction, "leading" spacing with
steps_offset 1, fixed_small variance, no sample clipping.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear", "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # or "v_prediction", "sample"
    steps_offset: int = 1
    timestep_spacing: str = "leading"
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    variance_type: str = "fixed_small"
    # DPM-Solver++ (diffusers DPMSolverMultistepScheduler defaults)
    solver_order: int = 2
    algorithm_type: str = "dpmsolver++"
    lower_order_final: bool = True


def _make_betas(cfg: SchedulerConfig) -> np.ndarray:
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, T, dtype=np.float64) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, T, dtype=np.float64)
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(T, dtype=np.float64)
        return np.minimum(1 - alpha_bar((ts + 1) / T) / alpha_bar(ts / T), 0.999)
    raise ValueError(cfg.beta_schedule)


def inference_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending integer timesteps for a sampling run (schedulers.py:59-73)."""
    T = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        step_ratio = T // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        ts = ts + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1
    elif cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1].astype(np.int64)
    else:
        raise ValueError(cfg.timestep_spacing)
    return ts


def dpm_inference_timesteps(cfg: SchedulerConfig, num_inference_steps: int, spacing: str) -> np.ndarray:
    """Descending timesteps of diffusers `DPMSolverMultistepScheduler.
    set_timesteps` (schedulers.py:76-102): the linspace and leading
    spacings sample S+1 points and drop the last, not the DDPM `T//S` rule."""
    T = cfg.num_train_timesteps
    if spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps + 1).round()[::-1][:-1].astype(np.int64)
    elif spacing == "leading":
        step_ratio = T // (num_inference_steps + 1)
        ts = (np.arange(0, num_inference_steps + 1) * step_ratio).round()[::-1][:-1].astype(np.int64)
        ts = ts + cfg.steps_offset
    elif spacing == "trailing":
        step_ratio = T / num_inference_steps
        ts = np.arange(T, 0, -step_ratio).round().astype(np.int64) - 1
    else:
        raise ValueError(spacing)
    return ts


# the rows of DDPMSchedule.coefs: x̂0's sqrt(ᾱ_t) and sqrt(1 − ᾱ_t), the
# posterior mean's coefficients of x̂0 and x_t, the noise std, the variance
# (the parallel sampler's acceptance scale) and t > 0
DDPM_COEFS = ("sqrt_acp", "sqrt_1m", "x0_coef", "xt_coef", "std", "variance", "nonzero_t")
# the rows of DPMSolverSchedule.coefs: x̂0's sqrt(ᾱ) and sqrt(1 − ᾱ), σ_{i+1}/σ_i,
# the first- and second-order coefficients α_{i+1}·φ and 0.5·α_{i+1}·φ, the
# divisor r0 of the 2M difference, and whether step i is the final
# lower-order one
DPM_COEFS = ("sqrt_a", "sqrt_s", "ratio", "c1", "c2", "r0", "last")


def _cache_key(schedule, arrays: tuple, scalars: tuple) -> tuple:
    """The schedule's identity for `core.compile.jit`: its class, step
    count and settings, and a hash of its tables. A graph bakes each step's
    coefficients in, so two schedules share a graph only if these agree."""
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return (type(schedule).__name__, schedule.num_inference_steps, scalars, h.hexdigest())


def _on_device(schedule, name: str, device) -> torch.Tensor:
    """The schedule's table `name` on `device`, copied there on first use
    (timesteps as int64)."""
    key = (name, torch.device(device))
    if key not in schedule._device_tables:
        table = torch.from_numpy(getattr(schedule, name))
        schedule._device_tables[key] = (table.long() if name == "timesteps" else table).to(key[1])
    return schedule._device_tables[key]


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Constant DDPM tables; `timesteps` is the descending inference schedule."""

    betas: np.ndarray  # (T,) fp32
    alphas_cumprod: np.ndarray  # (T,) fp32
    timesteps: np.ndarray  # (S,) int32, descending
    prev_timesteps: np.ndarray  # (S,) int32, t - T//S (may be < 0)
    num_inference_steps: int = 0
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    prediction_type: str = "epsilon"
    # (len(DDPM_COEFS), S) fp32: the per-step scalars of `step`, and their
    # device copies by device
    coefs: np.ndarray = dataclasses.field(init=False, repr=False, compare=False)
    _device_tables: dict = dataclasses.field(init=False, repr=False, compare=False, default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "coefs", np.array([self._coefs(i) for i in range(len(self.timesteps))],
                                                   np.float32).reshape(-1, len(DDPM_COEFS)).T.copy())

    def cache_key(self) -> tuple:
        return _cache_key(self, (self.betas, self.alphas_cumprod, self.timesteps, self.prev_timesteps, self.coefs),
                          (self.clip_sample, self.clip_sample_range, self.prediction_type))

    @property
    def num_train_timesteps(self) -> int:
        return self.betas.shape[0]

    def _coefs(self, i: int) -> tuple:
        """The fp32 scalars of step position i, in DDPM_COEFS order."""
        t, prev_t = int(self.timesteps[i]), int(self.prev_timesteps[i])
        acp_t = self.alphas_cumprod[t]
        acp_prev = self._acp_prev(prev_t)
        beta_prod_t = np.float32(1.0) - acp_t
        alpha_t = acp_t / acp_prev
        beta_t = np.float32(1.0) - alpha_t
        x0_coef = (np.sqrt(acp_prev) * beta_t) / beta_prod_t
        xt_coef = np.sqrt(alpha_t) * (np.float32(1.0) - acp_prev) / beta_prod_t
        var = self.variance(t, prev_t)
        return (np.sqrt(acp_t), np.sqrt(np.float32(1.0) - acp_t), x0_coef, xt_coef, np.sqrt(var), var,
                np.float32(t > 0))

    def device_coefs(self, device) -> torch.Tensor:
        """`coefs` on `device`, copied there once."""
        return _on_device(self, "coefs", device)

    def device_timesteps(self, device) -> torch.Tensor:
        """`timesteps` as a long tensor on `device`, copied there once."""
        return _on_device(self, "timesteps", device)

    def _acp_prev(self, prev_t: int) -> np.float32:
        return self.alphas_cumprod[prev_t] if prev_t >= 0 else np.float32(1.0)

    def _acp_per_sample(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """alphas_cumprod[t] for a (B,) timestep tensor, fp32, shaped to
        broadcast against a (B, ...) tensor of `ndim` dims."""
        table = _on_device(self, "alphas_cumprod", t.device)
        return table[t.long()].reshape((-1,) + (1,) * (ndim - 1))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) at per-sample timesteps t (B,) (schedulers.py:134-140)."""
        acp = self._acp_per_sample(t, x0.dim()).to(x0.dtype)
        return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise

    def pred_original(self, model_out: torch.Tensor, t, x_t: torch.Tensor) -> torch.Tensor:
        """x̂0 from the model output in fp32, at an integer t (the sampler's
        form, coefficients on the host) or at per-sample timesteps, a (B,)
        tensor (the train step's form, schedulers.py:149-170)."""
        if isinstance(t, torch.Tensor):
            acp = self._acp_per_sample(t, x_t.dim())
            return self._x0(model_out, x_t, torch.sqrt(acp), torch.sqrt(1.0 - acp))
        acp = self.alphas_cumprod[t]
        return self._x0(model_out, x_t, float(np.sqrt(acp)), float(np.sqrt(np.float32(1.0) - acp)))

    def _x0(self, model_out, x_t, sqrt_acp, sqrt_1m) -> torch.Tensor:
        x32, o32 = x_t.float(), model_out.float()
        if self.prediction_type == "epsilon":
            x0 = (x32 - sqrt_1m * o32) / sqrt_acp
        elif self.prediction_type == "v_prediction":
            x0 = sqrt_acp * x32 - sqrt_1m * o32
        elif self.prediction_type == "sample":
            x0 = o32
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        return x0

    def variance(self, t: int, prev_t: int) -> np.float32:
        """fixed_small posterior variance, floored at 1e-20 (schedulers.py:174-180)."""
        acp_t = self.alphas_cumprod[t]
        acp_prev = self._acp_prev(prev_t)
        beta_t = np.float32(1.0) - acp_t / acp_prev
        var = (np.float32(1.0) - acp_prev) / (np.float32(1.0) - acp_t) * beta_t
        return np.maximum(var, np.float32(1e-20))

    def step(self, model_out: torch.Tensor, step_index: int, x_t: torch.Tensor,
             noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One reverse step x_t → x_{t-1} at `timesteps[step_index]`
        (schedulers.py:182-212); `noise` is pre-drawn N(0, 1) of x_t's shape.
        Returns (x_prev in x_t's dtype, x̂0 in fp32)."""
        sqrt_acp, sqrt_1m, x0_coef, xt_coef, std, _, nonzero_t = (float(c) for c in self.coefs[:, step_index])
        x0 = self._x0(model_out, x_t, sqrt_acp, sqrt_1m)
        mean = x0_coef * x0 + xt_coef * x_t.float()
        if nonzero_t:
            mean = mean + std * noise.float()
        return mean.to(x_t.dtype), x0

    def step_per_slot(self, model_out: torch.Tensor, step_idx: torch.Tensor, x_t: torch.Tensor,
                      noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """`step` with a step position per row: `step_idx` a (B,) tensor on
        x_t's device, each in [0, S). Row b equals `step(…, int(step_idx[b]),
        …)` on row b, bit for bit; the noise term is masked where t = 0."""
        c = self.device_coefs(x_t.device)[:, step_idx.long()].reshape(len(DDPM_COEFS), -1, *([1] * (x_t.dim() - 1)))
        sqrt_acp, sqrt_1m, x0_coef, xt_coef, std, _, nonzero_t = c
        x0 = self._x0(model_out, x_t, sqrt_acp, sqrt_1m)
        mean = x0_coef * x0 + xt_coef * x_t.float()
        mean = torch.where(nonzero_t > 0, mean + std * noise.float(), mean)
        return mean.to(x_t.dtype), x0


def make_ddpm(cfg: SchedulerConfig = SchedulerConfig(),
              num_inference_steps: Optional[int] = None) -> DDPMSchedule:
    betas = _make_betas(cfg)
    acp = np.cumprod(1.0 - betas)
    if num_inference_steps:
        ts = inference_timesteps(cfg, num_inference_steps)
        prev = ts - cfg.num_train_timesteps // num_inference_steps  # schedulers.py:224
        S = num_inference_steps
    else:
        ts = np.arange(cfg.num_train_timesteps)[::-1]
        prev = ts - 1
        S = 0
    return DDPMSchedule(
        betas=betas.astype(np.float32),
        alphas_cumprod=acp.astype(np.float32),
        timesteps=ts.astype(np.int32),
        prev_timesteps=prev.astype(np.int32),
        num_inference_steps=S,
        clip_sample=cfg.clip_sample,
        clip_sample_range=cfg.clip_sample_range,
        prediction_type=cfg.prediction_type,
    )


@dataclasses.dataclass(frozen=True)
class DPMSolverSchedule:
    """DPM-Solver++ 2M (schedulers.py:249-315): deterministic, so the state
    is (x, m0, m1, count), x and the last two data predictions in fp32 and
    the number of steps taken. σ, α and λ hold S+1 points, the last one the
    terminal α = 1, σ = 0."""

    alphas_cumprod: np.ndarray  # (T,) fp32
    timesteps: np.ndarray  # (S,) int32, descending
    sigma_t: np.ndarray  # (S+1,) fp32
    alpha_t: np.ndarray  # (S+1,) fp32
    lambda_t: np.ndarray  # (S+1,) fp32, log(α) - log(max(σ, 1e-10))
    num_inference_steps: int = 0
    prediction_type: str = "epsilon"
    solver_order: int = 2
    lower_order_final: bool = True
    # (len(DPM_COEFS), S) fp32: the per-step scalars of `step`, and their
    # device copies by device
    coefs: np.ndarray = dataclasses.field(init=False, repr=False, compare=False)
    _device_tables: dict = dataclasses.field(init=False, repr=False, compare=False, default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "coefs", np.array([self._coefs(i) for i in range(len(self.timesteps))],
                                                   np.float32).reshape(-1, len(DPM_COEFS)).T.copy())

    def cache_key(self) -> tuple:
        return _cache_key(self, (self.alphas_cumprod, self.timesteps, self.sigma_t, self.alpha_t, self.lambda_t,
                                 self.coefs), (self.prediction_type, self.solver_order, self.lower_order_final))

    def _coefs(self, i: int) -> tuple:
        """The fp32 scalars of step position i, in DPM_COEFS order."""
        acp = self.alphas_cumprod[int(self.timesteps[i])]
        alpha_tt = self.alpha_t[i + 1]
        h = self.lambda_t[i + 1] - self.lambda_t[i]
        phi = np.expm1(-h)
        h0 = self.lambda_t[i] - self.lambda_t[max(i - 1, 0)]
        r0 = h0 / (h if h != 0 else np.float32(1.0))
        S = self.num_inference_steps
        return (np.sqrt(acp), np.sqrt(np.float32(1.0) - acp), self.sigma_t[i + 1] / self.sigma_t[i],
                alpha_tt * phi, np.float32(0.5) * alpha_tt * phi, r0 if r0 != 0 else np.float32(1.0),
                np.float32(self.lower_order_final and S > 1 and i == S - 1))

    def device_coefs(self, device) -> torch.Tensor:
        """`coefs` on `device`, copied there once."""
        return _on_device(self, "coefs", device)

    def device_timesteps(self, device) -> torch.Tensor:
        """`timesteps` as a long tensor on `device`, copied there once."""
        return _on_device(self, "timesteps", device)

    def init_state(self, x: torch.Tensor):
        x = x.float()
        return (x, torch.zeros_like(x), torch.zeros_like(x), 0)

    def _x0(self, model_out, x_t, sqrt_a, sqrt_s) -> torch.Tensor:
        x32, o32 = x_t.float(), model_out.float()
        if self.prediction_type == "epsilon":
            return (x32 - sqrt_s * o32) / sqrt_a
        if self.prediction_type == "v_prediction":
            return sqrt_a * x32 - sqrt_s * o32
        return o32

    def data_prediction(self, model_out: torch.Tensor, step_index: int, x_t: torch.Tensor) -> torch.Tensor:
        """x̂0 from the model output at step position `step_index`, fp32."""
        return self._x0(model_out, x_t, float(self.coefs[0, step_index]), float(self.coefs[1, step_index]))

    def step(self, model_out: torch.Tensor, step_index: int, state):
        """One 2M update; returns (new state, x̂0). The first step, and the
        last one whenever S > 1 (`lower_order_final`, the JAX rule of
        schedulers.py:312-313, not diffusers' "below 15 steps"), fall back to
        first order. Coefficients are fp32 host scalars, combined in the JAX
        expression's order."""
        x, m0, _, count = state
        i = int(step_index)
        sqrt_a, sqrt_s, ratio, c1, c2, r0, last = (float(c) for c in self.coefs[:, i])
        x0 = self._x0(model_out, x, sqrt_a, sqrt_s)
        x_new = ratio * x.float() - c1 * x0
        if not (count < 1 or last):
            x_new = x_new - c2 * ((x0 - m0) / r0)
        return (x_new.to(x.dtype), x0, m0, count + 1), x0

    def step_per_slot(self, model_out: torch.Tensor, step_idx: torch.Tensor, x: torch.Tensor,
                      m0: torch.Tensor, m1: torch.Tensor):
        """`step` with a step position per row (the rolling engine's slots,
        JAX rolling.py:200-204): `step_idx` a (B,) tensor on x's device, each
        in [0, S), and a row's step count is its step position, so its first
        step and, under `lower_order_final`, its last take the first-order
        update. Returns (x_new, m0_new, m1_new) = (x_new, x̂0, m0); m1 is
        never read by the 2M update. Row b equals `step` at
        `int(step_idx[b])` with count `int(step_idx[b])` on row b, bit for
        bit."""
        idx = step_idx.long()
        c = self.device_coefs(x.device)[:, idx].reshape(len(DPM_COEFS), -1, *([1] * (x.dim() - 1)))
        sqrt_a, sqrt_s, ratio, c1, c2, r0, last = c
        x0 = self._x0(model_out, x, sqrt_a, sqrt_s)
        x1 = ratio * x.float() - c1 * x0
        x2 = x1 - c2 * ((x0 - m0) / r0)
        first = (idx < 1).reshape(last.shape) | (last > 0)
        return torch.where(first, x1, x2).to(x.dtype), x0, m0


def make_dpm_solver(cfg: SchedulerConfig = SchedulerConfig(), num_inference_steps: int = 30,
                    timestep_spacing: Optional[str] = None) -> DPMSolverSchedule:
    """`timestep_spacing=None` means "linspace", the DPMSolverMultistepScheduler
    class default (schedulers.py:318-349)."""
    betas = _make_betas(cfg)
    acp = np.cumprod(1.0 - betas)
    ts = dpm_inference_timesteps(cfg, num_inference_steps, timestep_spacing or "linspace")
    acp_path = np.concatenate([acp[ts], [1.0]])
    alpha_t = np.sqrt(acp_path)
    sigma_t = np.sqrt(1.0 - acp_path)
    lambda_t = np.log(alpha_t) - np.log(np.maximum(sigma_t, 1e-10))
    return DPMSolverSchedule(
        alphas_cumprod=acp.astype(np.float32),
        timesteps=ts.astype(np.int32),
        sigma_t=sigma_t.astype(np.float32),
        alpha_t=alpha_t.astype(np.float32),
        lambda_t=lambda_t.astype(np.float32),
        num_inference_steps=num_inference_steps,
        prediction_type=cfg.prediction_type,
        solver_order=cfg.solver_order,
        lower_order_final=cfg.lower_order_final,
    )
