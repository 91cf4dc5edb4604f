"""The port's DPM-Solver++ 2M against the JAX package's (schedulers.py:76-102,
249-349): the same timesteps, σ/α/λ tables within 1e-6 relative, and one
step of each kind (first order at the start, 2M, lower-order final) on the
same state within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.diffusion import schedulers as jsched
from faceposegenerator_tpu_torch.diffusion import schedulers


@pytest.mark.parametrize("steps,spacing", [(12, None), (20, None), (1, None), (12, "leading"), (12, "trailing")])
def test_dpm_tables_match_jax(steps, spacing):
    j = jsched.make_dpm_solver(num_inference_steps=steps, timestep_spacing=spacing)
    t = schedulers.make_dpm_solver(num_inference_steps=steps, timestep_spacing=spacing)
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    for name in ("sigma_t", "alpha_t", "lambda_t", "alphas_cumprod"):
        np.testing.assert_allclose(getattr(t, name), np.asarray(getattr(j, name)), rtol=1e-6, atol=0)
    assert (t.num_inference_steps, t.lower_order_final, t.solver_order) == (
        j.num_inference_steps, j.lower_order_final, j.solver_order)
    assert t.sigma_t[-1] == 0.0 and t.alpha_t[-1] == 1.0  # the terminal point


@pytest.mark.parametrize("index,count", [(0, 0), (5, 5), (11, 11)])
def test_dpm_step_matches_jax(index, count):
    """index 0: the first step, first order; 5: a 2M step; 11 of 12: the
    lower-order final step."""
    rng = np.random.default_rng(index)
    eps, x, m0, m1 = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(4))
    j = jsched.make_dpm_solver(num_inference_steps=12)
    t = schedulers.make_dpm_solver(num_inference_steps=12)
    (jx, jx0, jm0, jcount), _ = j.step(jnp.asarray(eps), index,
                                       (jnp.asarray(x), jnp.asarray(m0), jnp.asarray(m1), jnp.int32(count)))
    (tx, tx0, tm0, tcount), _ = t.step(torch.from_numpy(eps), index,
                                       tuple(torch.from_numpy(a) for a in (x, m0, m1)) + (count,))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tm0.numpy(), np.asarray(jm0))
    assert tcount == int(jcount) == count + 1
