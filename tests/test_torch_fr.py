"""The port's FR training pieces against the JAX package: training-mode
BatchNorm, IResNet in training mode (dropout, SE, remat), the margin heads,
the SGD step and the insightface state-dict converter.

Inputs are numpy arrays from a seed, both sides fp32 (JAX PARITY_POLICY with
the suite's "highest" matmul precision, the port's PARITY_POLICY). The
backbone is IResNet `depths=(1, 1, 1, 1)`, `fc_scale=1` at 16². The JAX
steps compile on a worker thread while the port's side runs.
"""

import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.models import iresnet as jir
from faceposegenerator_tpu.ops import norms as jnorms
from faceposegenerator_tpu.training import fr as jfr
from faceposegenerator_tpu.training import losses as jlosses
from faceposegenerator_tpu_torch.bridge import torch_weights
from faceposegenerator_tpu_torch.bridge.jax_params import export_jax_params, load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.core.tree import tree_paths
from faceposegenerator_tpu_torch.models import iresnet
from faceposegenerator_tpu_torch.ops import norms
from faceposegenerator_tpu_torch.training import fr
from faceposegenerator_tpu_torch.training import losses

TINY = dict(depths=(1, 1, 1, 1), fc_scale=1)
B, RES, CLASSES = 8, 16, 10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    return x, y


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3g} > {rel:g} × {scale:.3g}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_fr_steps(loss, steps=2):
    """2 JAX FR steps of the tiny backbone from init key 0, step keys
    fold_in(key(5), i); returns the initial and final trees, the losses and
    each step's dropout mask and ElasticCosFace normals."""
    cfg = jfr.FRConfig(num_classes=CLASSES, batch_size=B, loss=loss, network="iresnet18")
    base = jfr.backbone_config
    jfr.backbone_config = lambda c: dataclasses.replace(base(c), **TINY)
    try:
        params, state = jax.jit(lambda k: jfr.init_train_state(k, cfg))(jax.random.key(0))
        init = (_np(params), _np(state))
        optimizer = jfr.make_optimizer(cfg)
        opt_state = optimizer.init(params)
        step = jfr.make_train_step(cfg, optimizer, policy=JPOLICY, donate=False)
    finally:
        jfr.backbone_config = base
    x, y = _batch()
    losses_, draws = [], []
    for i in range(steps):
        key = jax.random.fold_in(jax.random.key(5), i)
        draws.append({"dropout": np.asarray(jax.random.bernoulli(key, 1 - cfg.dropout, (B, 512))),
                      "margin": np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (B,)))})
        params, state, opt_state, m = step(params, state, opt_state,
                                           {"images": jnp.asarray(x), "labels": jnp.asarray(y)}, key)
        losses_.append(float(m["loss"]))
    return cfg, init, (_np(params), _np(state)), losses_, draws


@pytest.fixture(scope="module", autouse=True)
def jax_steps():
    """Starts JAX's two FR runs when the module starts, on a worker thread."""
    pool = ThreadPoolExecutor(max_workers=1)
    futs = {loss: pool.submit(_jax_fr_steps, loss) for loss in ("AdaFace", "ArcFace")}
    yield futs
    pool.shutdown()


def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0.5, 2.0, (4, 5, 6, 16)).astype(np.float32)
    g, b = rng.normal(1, 0.1, 16).astype(np.float32), rng.normal(0, 0.1, 16).astype(np.float32)
    rm, rv = rng.normal(0, 1, 16).astype(np.float32), rng.uniform(0.5, 2, 16).astype(np.float32)
    want = jnorms.batch_norm_train(*map(jnp.asarray, (x, g, b, rm, rv)), momentum=0.1)
    got = norms.batch_norm_train(*map(torch.from_numpy, (x, g, b, rm, rv)), momentum=0.1)
    for w, t, what in zip(want, got, ("out", "running mean", "running var")):
        _close(t.numpy(), w, 1e-5, what)
    out, *_ = norms.batch_norm_train(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, (g, b, rm, rv)))
    assert out.dtype == torch.bfloat16
    # no group: nothing to reduce, global statistics or not (the group= cases
    # run on two ranks in tests/test_torch_data_parallel.py)
    alone = norms.batch_norm_train(*map(torch.from_numpy, (x, g, b, rm, rv)), momentum=0.1, global_stats=True)
    for w, t, what in zip(want, alone, ("out", "running mean", "running var")):
        _close(t.numpy(), w, 1e-5, what)


@pytest.mark.parametrize("use_se", [False, True])
def test_iresnet_train_and_eval_match_jax(use_se):
    cfg = jir.IResNetConfig(dropout=0.4, use_se=use_se, se_reduction=4, **TINY)
    params, state = jax.jit(jir.init, static_argnums=1)(jax.random.key(1), cfg)
    rng = np.random.default_rng(2)
    state = jax.tree.map(lambda s: s + 0.1 * rng.uniform(0, 1, s.shape).astype(np.float32), state)
    x = rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    key = jax.random.key(3)
    mask = np.asarray(jax.random.bernoulli(key, 0.6, (B, 512)))
    both = jax.jit(lambda p, s, x: (jir.apply(p, s, x, cfg, policy=JPOLICY, train=True, dropout_key=key),
                                    jir.apply(p, s, x, cfg, policy=JPOLICY)[0]))
    (want_train, want_state), want_eval = both(params, state, jnp.asarray(x))

    model = load_jax_params(iresnet.IResNet(iresnet.IResNetConfig(**dataclasses.asdict(cfg)), device="cpu"),
                            _np(params), _np(state))
    with torch.no_grad():
        got_train, got_state = model(torch.from_numpy(x), PARITY_POLICY, train=True,
                                     dropout_mask=torch.from_numpy(mask))
        got_eval = model(torch.from_numpy(x), PARITY_POLICY)
    _close(got_train.numpy(), want_train, 2e-4, "train embedding")
    _close(got_eval.numpy(), want_eval, 2e-4, "eval embedding")
    want_paths = dict(tree_paths(_np(want_state)))
    got_paths = dict(tree_paths(got_state))
    assert set(got_paths) == set(want_paths)
    for path, leaf in got_paths.items():
        _close(leaf.numpy(), want_paths[path], 1e-5, path)
    # remat recomputes each block in the backward: the same values and gradients
    x_t = torch.from_numpy(x)
    remat = iresnet.IResNet(dataclasses.replace(model.cfg, remat=True), device="cpu")
    remat.load_state_dict(model.state_dict())
    outs = []
    for m in (model, remat):
        out, _ = m(x_t, PARITY_POLICY, train=True, dropout_mask=torch.from_numpy(mask))
        outs.append((out, torch.autograd.grad(out.square().sum(), m.trainable_parameters(), allow_unused=True)))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for g1, g0 in zip(outs[1][1], outs[0][1]):
        if g0 is not None:
            torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-7)


def _head_inputs():
    rng = np.random.default_rng(4)
    emb = rng.normal(0, 1, (B, 32)).astype(np.float32)
    kernel = rng.normal(0, 0.01, (32, CLASSES)).astype(np.float32)
    labels = rng.integers(0, CLASSES, B).astype(np.int32)
    labels[3] = -1  # no margin for this row
    return emb, kernel, labels


@pytest.mark.parametrize("head", ["arcface", "cosface", "elastic", "elastic_plus", "adaface"])
def test_margin_heads_and_gradients_match_jax(head):
    emb, kernel, labels = _head_inputs()
    normals = np.asarray(jax.random.normal(jax.random.key(7), labels.shape))
    lab_ce = np.maximum(labels, 0)
    state = {"batch_mean": np.float32(19.0), "batch_std": np.float32(90.0)}

    def jax_fn(k, e):
        if head == "arcface":
            logits = jlosses.arcface_logits(k, e, jnp.asarray(labels))
        elif head == "cosface":
            logits = jlosses.cosface_logits(k, e, jnp.asarray(labels))
        elif head.startswith("elastic"):
            logits = jlosses.elastic_cosface_logits(k, e, jnp.asarray(labels), jax.random.key(7),
                                                    plus=head == "elastic_plus")
        else:
            n = jnp.linalg.norm(e, axis=1)
            logits, new = jlosses.adaface_logits(k, e / n[:, None], n, jnp.asarray(labels),
                                                 jax.tree.map(jnp.asarray, state))
            return logits, (jlosses.cross_entropy(logits, jnp.asarray(lab_ce)), new)
        return logits, (jlosses.cross_entropy(logits, jnp.asarray(lab_ce)), {})

    want, (_, want_state) = jax_fn(jnp.asarray(kernel), jnp.asarray(emb))
    grads = jax.grad(lambda k, e: jax_fn(k, e)[1][0], argnums=(0, 1))(jnp.asarray(kernel), jnp.asarray(emb))

    k_t = torch.from_numpy(kernel).requires_grad_(True)
    e_t = torch.from_numpy(emb).requires_grad_(True)
    lab_t = torch.from_numpy(labels).long()
    got_state = {}
    if head == "arcface":
        got = losses.arcface_logits(k_t, e_t, lab_t)
    elif head == "cosface":
        got = losses.cosface_logits(k_t, e_t, lab_t)
    elif head.startswith("elastic"):
        got = losses.elastic_cosface_logits(k_t, e_t, lab_t, normals=torch.from_numpy(normals),
                                            plus=head == "elastic_plus")
    else:
        n = torch.linalg.norm(e_t, dim=1)
        got, got_state = losses.adaface_logits(k_t, e_t / n[:, None], n, lab_t,
                                               {k: torch.tensor(v) for k, v in state.items()})
    loss = losses.cross_entropy(got, torch.from_numpy(lab_ce).long())
    g_k, g_e = torch.autograd.grad(loss, (k_t, e_t))
    _close(got.detach().numpy(), want, 1e-5, f"{head} logits")
    _close(g_k.numpy(), grads[0], 1e-5, f"{head} kernel gradient")
    _close(g_e.numpy(), grads[1], 1e-5, f"{head} embedding gradient")
    for key, value in got_state.items():
        _close(value.numpy(), want_state[key], 1e-5, f"adaface {key}")


@pytest.mark.parametrize("loss", ["AdaFace", "ArcFace"])
def test_fr_step_matches_jax_after_two_steps(jax_steps, loss):
    """Two SGD steps (clip 5, decay on every param, momentum 0.9) with JAX's
    dropout masks: the loss each step within 1e-5 relative; each param tree's
    leaves within 1e-4 of the largest |param| of the tree (a leaf that starts
    at zero, a bias or a BN shift, moves by a difference of two small steps,
    so its own max abs does not measure it), the BN running statistics and
    the AdaFace EMA within 1e-5 of the largest value of the state tree (a
    running mean of a centred activation is a small difference too)."""
    cfg, (p0, s0), (p1, s1), want_losses, draws = jax_steps[loss].result()
    params, state = fr.init_train_state(cfg, device="cpu", backbone_cfg=fr.backbone_config(cfg, **TINY))
    load_jax_params(params["backbone"], p0["backbone"], s0["bn"])
    with torch.no_grad():
        params["kernel"].copy_(torch.from_numpy(p0["kernel"]))
    optimizer = fr.make_optimizer(cfg)
    opt_state = optimizer.init(params)
    step = fr.make_train_step(cfg, optimizer, PARITY_POLICY)
    x, y = _batch()
    for i, d in enumerate(draws):
        params, state, opt_state, m = step(params, state, opt_state, {"images": x, "labels": y},
                                           draws={k: torch.from_numpy(v) for k, v in d.items()})
        assert abs(float(m["loss"]) - want_losses[i]) <= 1e-5 * abs(want_losses[i]), (i, float(m["loss"]))
    got = fr.fr_checkpoint_tree(params, state)
    want_p = dict(tree_paths(p1))
    got_p = dict(tree_paths(got["params"]))
    assert set(got_p) == set(want_p)
    scale = max(float(np.abs(v).max()) for v in want_p.values())
    for path, leaf in got_p.items():
        assert np.abs(leaf - want_p[path]).max() <= 1e-4 * scale, path
    want_s = dict(tree_paths(s1))
    scale = max(float(np.abs(v).max()) for v in want_s.values())
    for path, leaf in tree_paths(got["state"]):
        assert np.abs(leaf - want_s[path]).max() <= 1e-5 * scale, path


def test_optimizer_schedules_and_clip():
    """The step schedule is piecewise constant at epoch·steps_per_epoch; the
    plateau scheduler scales the rate after `plateau_patience` bad epochs;
    a gradient below the clip norm passes unscaled, one above is scaled to it."""
    cfg = fr.FRConfig(lr_schedule="step", lr_steps=(1, 2), batch_size=512)
    opt = fr.make_optimizer(cfg, steps_per_epoch=3)
    assert [opt.lr_of(c) for c in (0, 2, 3, 5, 6)] == pytest.approx([0.1, 0.1, 0.01, 0.01, 0.001])
    plateau = fr.PlateauScheduler(fr.FRConfig(plateau_patience=1))
    scales = [plateau.update(a) for a in (0.5, 0.6, 0.6, 0.6, 0.7)]
    assert scales == pytest.approx([1.0, 1.0, 1.0, 0.1, 0.1])
    opt_state = fr.make_optimizer(fr.FRConfig()).init({"backbone": iresnet.IResNet(iresnet.IResNetConfig(**TINY),
                                                                                      device="cpu"),
                                                        "kernel": torch.zeros(512, 3)})
    assert plateau.set_lr(opt_state, 0.025)["learning_rate"] == pytest.approx(0.0025)

    w = torch.zeros(4, requires_grad=True)
    for g, want in ((torch.tensor([0.3, 0.4, 0.0, 0.0]), [0.3, 0.4]), (torch.tensor([30.0, 40.0, 0, 0]), [3.0, 4.0])):
        opt = fr.SGDOptimizer(lr=1.0, max_grad_norm=5.0, weight_decay=0.0, momentum=0.0)
        params = {"backbone": types.SimpleNamespace(trainable_parameters=lambda: []), "kernel": w}
        with torch.no_grad():
            w.zero_()
        opt.update([g], opt.init(params), params)
        assert w[:2].tolist() == pytest.approx([-v for v in want])


def test_convert_iresnet_state_dict_loads_the_reference_layout():
    """A synthetic insightface state dict (bias-free convs, BN running
    statistics, the (c, h, w)-flatten fc) gives the JAX converter's tree, and
    the port's IResNet on it equals JAX's apply on that tree."""
    from faceposegenerator_tpu.bridge import torch_weights as jtw

    cfg = jir.IResNetConfig(depths=(1, 1, 1, 1), fc_scale=1)
    rng = np.random.default_rng(6)
    sd = {"conv1.weight": rng.normal(0, 0.2, (64, 3, 3, 3)), "prelu.weight": rng.uniform(0, 0.3, 64),
          "fc.weight": rng.normal(0, 0.02, (512, 512)), "fc.bias": rng.normal(0, 0.1, 512)}

    def bn(prefix, c):
        sd.update({f"{prefix}.weight": rng.uniform(0.5, 1.5, c), f"{prefix}.bias": rng.normal(0, 0.1, c),
                   f"{prefix}.running_mean": rng.normal(0, 0.1, c), f"{prefix}.running_var": rng.uniform(0.5, 2, c)})

    bn("bn1", 64)
    cin = 64
    for li, planes in enumerate(iresnet.STAGE_PLANES, start=1):
        p = f"layer{li}.0"
        bn(f"{p}.bn1", cin)
        sd[f"{p}.conv1.weight"] = rng.normal(0, 0.05, (planes, cin, 3, 3))
        bn(f"{p}.bn2", planes)
        sd[f"{p}.prelu.weight"] = rng.uniform(0, 0.3, planes)
        sd[f"{p}.conv2.weight"] = rng.normal(0, 0.05, (planes, planes, 3, 3))
        bn(f"{p}.bn3", planes)
        sd[f"{p}.downsample.0.weight"] = rng.normal(0, 0.1, (planes, cin, 1, 1))
        bn(f"{p}.downsample.1", planes)
        cin = planes
    bn("bn2", 512)
    bn("features", 512)
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}

    params, state = torch_weights.convert_iresnet_state_dict(sd, iresnet.IResNetConfig(**TINY))
    jparams, jstate = jtw.convert_iresnet_state_dict(sd, cfg)
    want = dict(tree_paths(_np({"p": jparams, "s": jstate})))
    got = dict(tree_paths({"p": params, "s": state}))
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    model = load_jax_params(iresnet.IResNet(iresnet.IResNetConfig(**TINY), device="cpu"), params, state)
    x = np.random.default_rng(7).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, x: jir.apply(p, s, x, cfg, policy=JPOLICY))(jparams, jstate, jnp.asarray(x))
    with torch.no_grad():
        _close(model(torch.from_numpy(x), PARITY_POLICY).numpy(), ref, 2e-4, "converted forward")
    exported, exported_state = export_jax_params(model)
    for path, leaf in tree_paths({"p": exported, "s": exported_state}):
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
