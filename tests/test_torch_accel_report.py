"""The port's acceleration report and presets against the JAX package:
`parse_mode` on every preset's `mode_spec`, `_psnr`, `make_embed_fn_u8`
over the port's IResNet, and the turbo preset calibrating by prompt through
the tokenizer of the tiny diffusers directory of
tests/test_torch_checkpoints.py to JAX's static scales.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.evaluation import accel_report as jreport
from faceposegenerator_tpu.pipelines import presets as jpresets
from faceposegenerator_tpu_torch.evaluation import accel_report
from faceposegenerator_tpu_torch.pipelines import presets

from test_torch_checkpoints import jax_params, numpy_init, pipelines, write_model_dir


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfgs, params = jax_params(small=True)
    root = tmp_path_factory.mktemp("sd21")
    write_model_dir(root / "model", params, cfgs)
    (root / "lora").mkdir()
    return params, root


def test_accel_report_parses_every_preset_and_psnr_matches_jax():
    for name, p in presets.PRESETS.items():
        spec = p.mode_spec()
        assert spec == jpresets.PRESETS[name].mode_spec()
        assert accel_report.parse_mode(spec) == jreport.parse_mode(spec)
        kw, q = accel_report.parse_mode(spec)
        assert kw.get("scheduler_kind") == p.scheduler and kw.get("num_inference_steps") == p.steps
        assert q == (None if p.quantize is None else p.quantize + f":static:{p.quant_calibrate_steps}")
    for spec in ("tome=0.5:attn,xattn", "deepcache=3:2+attn=flash_int8", "exact=1"):
        try:
            want = jreport.parse_mode(spec)
        except ValueError:
            with pytest.raises(ValueError):
                accel_report.parse_mode(spec)
            continue
        assert accel_report.parse_mode(spec) == want
    # JAX parses a Picard window; the port, with no parallel sampler, refuses it
    assert jreport.parse_mode("parallel=8:0.1")[0]["parallel_window"] == 8
    with pytest.raises(ValueError, match="no parallel sampler"):
        accel_report.parse_mode("deepcache=3+parallel=8:0.1")
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    b = a.copy()
    b[1:] = np.clip(b[1:].astype(int) + rng.integers(-9, 10, b[1:].shape), 0, 255).astype(np.uint8)
    got, jgot = accel_report._psnr(a, b), jreport._psnr(a, b)
    assert got[0] == jgot[0] and got[0][0] is None
    np.testing.assert_array_equal(got[1], jgot[1])


def test_accel_report_embed_fn_matches_jax():
    """`make_embed_fn_u8`: uint8 images of 64² resized to 112², normalised,
    through IResNet r18, L2-normalised, within the 2e-4 of
    tests/test_torch_training.py of JAX's."""
    from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
    from faceposegenerator_tpu.models import iresnet as jiresnet
    from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.models import iresnet

    cfg = jiresnet.config_for("r18", num_features=64)
    params, state = numpy_init(jiresnet.init, cfg, 7)
    model = load_jax_params(iresnet.IResNet(iresnet.config_for("r18", num_features=64), device="cpu"), params, state)
    images = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    got = accel_report.make_embed_fn_u8(model, PARITY_POLICY)(images)
    want = jreport.make_embed_fn_u8(params, state, cfg, JPOLICY)(jnp.asarray(images))
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


def test_turbo_calibrates_by_prompt_as_jax(model_dir, tmp_path, monkeypatch):
    """`Preset.apply` without ids calibrates on CALIBRATION_PROMPT through
    the tokenizer; the static scales equal JAX's within the 1e-3 of
    tests/test_torch_turbo.py. The port's calibration draws JAX's latent and
    step noise (JAX calibrate_quant's key sequence), so both observe the
    same denoise, at 16² as there. The turbo preset with 2 calibration
    steps: over 2 steps the scales agree to ~5e-7 relative; by the 8th a
    dynamic activation code flips where the fp32 inputs differ in the last
    bit, and the chain moves the later scales by up to ~1%."""
    params, root = model_dir
    pipe, jpipe = pipelines((root / "model", params, None), root / "lora")
    preset = dataclasses.replace(presets.get_preset("turbo"), quant_calibrate_steps=2)
    jpreset = dataclasses.replace(jpresets.get_preset("turbo"), quant_calibrate_steps=2)
    key = jax.random.key(0)
    draws = []
    for _ in range(preset.quant_calibrate_steps + 1):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(sub, (1, 2, 2, 4), jnp.float32))))
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: draws.pop(0).reshape(shape))
    kw = preset.apply(pipe, height=16, width=16)
    assert pipe.scheduler_kind == "dpm" and kw["cfg_interval"] == (2, 8)
    # JAX's eager pass compiles each op alone; XLA's optimisation passes,
    # which change nothing in one op, take a third of that time
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        kw = jpreset.apply(jpipe, height=16, width=16)
    finally:
        jax.config.update("jax_disable_most_optimizations", was)
    assert jpipe.scheduler_kind == "dpm" and kw["cfg_interval"] == (2, 8)
    assert not draws
    pipe.save_quant_scales(str(tmp_path / "port.json"))
    jpipe.save_quant_scales(str(tmp_path / "jax.json"))
    got, want = (json.loads((tmp_path / f).read_text()) for f in ("port.json", "jax.json"))
    assert set(got) == set(want) and len(got) > 10
    np.testing.assert_allclose([got[k] for k in sorted(got)], [want[k] for k in sorted(got)], rtol=1e-3)
