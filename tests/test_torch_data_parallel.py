"""The port's distribution (`core/dist.py`, `core/mesh.py`, `parallel/tp.py`
and the data-parallel paths of the sampler, the trainers and BatchNorm) on
gloo ranks on the CPU, held against the JAX package's one-device results.

One module-scoped launch (`core.dist.spawn`) runs, all at once, this file
as a script in a job of two ranks and in a job of three (the ranks import
no JAX, each runs on one torch thread), and `cli generate` from one
process and with `--data_parallel 2`; the parent computes JAX's results
on two worker threads meanwhile, and every test reads one leg of the
launch. The ports come from binding port 0; the launch and every process
group time out after 120 s, and no process outlives the fixture.

Legs and tolerances:
  - DP `sample_data_parallel` (4 prompts, 2 a rank; the pipeline after
    `to_mesh` with its LoRA set bit-equal to it) and 2-D
    `sample_2d_parallel` (data 1 × model 2: the heads, MLP and LoRA of
    every transformer block below level 0 split over the two ranks, level
    0's 3 heads whole on both), each under a rank-4 LoRA shared by the
    batch and under a per-sample one (a LoRA a row), against JAX `sample`
    on one device with the same LoRA and the same injected noise, the tiny
    sampler of tests/test_sampler_sharded_golden.py at 128² with 48
    channels and 3 heads at level 0, 2 DDPM steps: 1e-3.
  - The ID-Booth step on the global batch [3 instance; 3 class] against
    JAX's one-device step with its draws, the TINY bundle of
    tests/test_torch_training.py at 64² with the sampler's UNet heads: loss and metrics rtol 2e-4,
    updated LoRA atol 1e-6 rtol 1e-5, grad_norm rtol 1e-3, the LoRA
    bit-equal on every rank. Three placements: data 2 (cut contiguously,
    rank 0 holds only instance rows and rank 1 only class rows, so the
    triplet's negatives cross ranks); data 3 (2 rows a rank: rank 1 holds
    one instance and one class row, so the identity term's denominator sums
    over ranks 0 and 1 and rank 1's rows start at a global offset); and
    data 1 × model 2 (the UNet's blocks below level 0 and their LoRA split
    by head: the gradients of the split LoRA pairs summed over the model
    ranks, level 0's counted once). AdamW's first step moves a leaf by about lr·g/(|g| +
    eps): at the default eps 1e-8 a gradient near 1e-8 turns last-bit
    differences of g into a tenth of a step, so these legs train at eps
    1e-6 (`ADAM_EPS`), where the step is at most lr/eps = 100 times as
    sensitive as g.
  - K = 2 identities sharded over the 2 ranks (`shard_identity_axis`, no
    gradient collective): each identity against JAX's step on its batch
    (the step JAX's multi-identity program maps over K, so one compile
    serves both legs) and against the port's unsharded K = 2 stacked step:
    loss and metrics rtol 1e-5, the updated LoRA within 1e-5 (a tenth of
    one AdamW step at lr 1e-4): the second identity's batch has a gradient
    element that any rounding moves, 2.6e-6 against JAX and 2.5e-6 against
    the stacked step, which runs twice the rows through each GEMM.
  - The FR driver's DP step (global BatchNorm, AdaFace's EMA over the
    global norms) against JAX's one-device step of tests/test_torch_fr.py:
    loss rtol 2e-4, parameters 1e-4 and BN state 1e-5 of their tree's
    largest value.
  - `batch_norm_train(group=)` against JAX's `shard_map` with `axis_name` on
    2 of conftest's 8 CPU devices: 1e-5.
  - `run_identity` on 2 ranks (the TINY bundle itself, `RUN_CFG`; global
    batch 1 + 1: one row a rank, two steps) against the port's one-process
    run of the same mesh code: the
    same files, the epoch's losses rtol 1e-5, the last checkpoint's LoRA
    within 1e-5 (2.5e-7 to 1.0e-6 measured: two ranks sum in another order,
    and the CPU's GEMMs do not always round alike) and each optimizer moment
    within 1e-3 of that moment's largest value; rank 1 opened no file for
    writing under the run's directory. Then `run_identities_vmapped` with 2
    identities sharded one a rank against the unsharded stacked run, with
    the same tolerances and each identity's dataset random state equal.
  - `generate --data_parallel 2 --device cpu` from one command: two gloo
    ranks whose PNGs and grid, written by rank 0, are bit-equal to the
    one-process command's.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_cli import light_model_dir  # noqa: F401 (fixture)

TIMEOUT_S = 120.0
S, SAMPLE_RES, SAMPLE_B = 2, 128, 4
N, RES = 6, 64  # the ID-Booth batch: 3 instance + 3 class images
FR_B, FR_RES, FR_CLASSES = 8, 16, 10
FR_TINY = dict(depths=(1, 1, 1, 1), fc_scale=1)
# AdamW's first step moves a leaf by about lr·g/(|g| + eps): with the
# default eps 1e-8 a gradient near 1e-8 turns last-bit differences of g
# (two packages, or two summation orders) into a tenth of a step. At 1e-6
# the step is at most lr/eps = 100 times as sensitive as g
ADAM_EPS = 1e-6

# the UNets' heads are 3 at level 0 and 4 below (head_dim 16), so at model 2
# level 0 stays whole on each rank, as SD2.1's 5-head level 0 does: its
# attention takes no reduce and its LoRA gradients count once
SAMPLER_CFG = dict(text=dict(vocab_size=128, hidden_size=48, num_layers=2, num_heads=4, intermediate_size=96),
                   unet=dict(block_out_channels=(48, 64, 64, 64), cross_attention_dim=48, head_dim=16,
                             norm_groups=16),
                   vae=dict(block_out_channels=(32, 32, 32, 32)))
TRAIN_CFG = dict(text=dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64),
                 unet=dict(block_out_channels=(48, 64, 64, 64), cross_attention_dim=32, head_dim=16, norm_groups=8),
                 vae=dict(block_out_channels=(32, 32, 32, 32)))
# the drivers' legs train the TINY bundle of tests/test_torch_training.py
# from the driver's own init, B at zero: there AdamW's first step, about
# lr·g/(|g| + eps), turns the rounding of a gradient element near eps (two
# ranks sum in another order) into a sizeable part of a step, and which
# elements lie near eps depends on the nets
RUN_CFG = dict(TRAIN_CFG, unet=dict(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32, head_dim=8,
                                    norm_groups=8))


# --------------------------------------------------------------------------
# the ranks (this file run as a script; no JAX)
# --------------------------------------------------------------------------

def _port_nets(trees, cfgs, names=("text_encoder", "unet", "vae")):
    from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
    from faceposegenerator_tpu_torch.models import clip_text, unet2d, vae

    make = {"text_encoder": lambda: clip_text.CLIPTextModel(clip_text.CLIPTextConfig(**cfgs["text"]), device="cpu"),
            "unet": lambda: unet2d.UNet2DCondition(unet2d.UNetConfig(**cfgs["unet"]), device="cpu"),
            "vae": lambda: vae.AutoencoderKL(vae.VAEConfig(**cfgs["vae"]), device="cpu")}
    return {k: load_jax_params(make[k](), trees[k]) for k in names}


def _bundle(cfgs=TRAIN_CFG):
    from faceposegenerator_tpu_torch.models import clip_text, iresnet, unet2d, vae
    from faceposegenerator_tpu_torch.training import idbooth

    return idbooth.ModelBundle(text_cfg=clip_text.CLIPTextConfig(**cfgs["text"]),
                               unet_cfg=unet2d.UNetConfig(**cfgs["unet"]),
                               vae_cfg=vae.VAEConfig(**cfgs["vae"]),
                               arcface_cfg=iresnet.config_for("r18", num_features=64))


def _train_frozen(trees, cfgs=TRAIN_CFG):
    from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
    from faceposegenerator_tpu_torch.models import iresnet

    frozen = _port_nets(trees, cfgs)
    frozen["arcface"] = load_jax_params(iresnet.IResNet(_bundle(cfgs).arcface_cfg, device="cpu"),
                                        trees["arcface"]["params"], trees["arcface"]["state"])
    return frozen


def _lora(tree):
    from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch
    from faceposegenerator_tpu_torch.core.tree import tree_leaves

    lora = jax_tree_to_torch(tree, "cpu", torch.float32)
    for leaf in tree_leaves(lora):
        leaf.requires_grad_(True)
    return {"unet_lora": lora}


def _tensors(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _numpy(tree):
    from faceposegenerator_tpu_torch.core.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, tree)


def _dp_step(inp, mesh, frozen):
    """One ID-Booth step on this rank's rows of the global batch over `mesh`:
    (metrics, the updated LoRA, this rank's rows)."""
    from faceposegenerator_tpu_torch.core.mesh import rows_of
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.training import idbooth

    t = inp["train"]
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=RES, train_batch_size=N // 2,
                                adam_epsilon=ADAM_EPS)
    opt = idbooth.make_optimizer(cfg, total_steps=10)
    rows = rows_of(mesh, N)
    trainable = _lora(t["lora"])
    step = idbooth.make_train_step(cfg, _bundle(), opt, policy=PARITY_POLICY, mesh=mesh)
    batch = {k: v[rows] for k, v in _tensors(t["batch"]).items()}
    trainable, _, m = step(trainable, opt.init(trainable), frozen, batch, draws=_tensors(t["draws"]))
    return {"metrics": {k: float(v) for k, v in m.items()}, "lora": _numpy(trainable["unet_lora"]),
            "rows": (rows.start, rows.stop)}


def _span_main(inp, out, world):
    """The job of three ranks: the step with an instance row on rank 1."""
    from faceposegenerator_tpu_torch.core.mesh import make_mesh

    out["span_step"] = _dp_step(inp, make_mesh(data=world, device="cpu"), _train_frozen(inp["train"]["trees"]))


def _rank_main(inputs_path, out_dir, rank, world, port):
    torch.set_num_threads(1)
    from faceposegenerator_tpu_torch.core import dist

    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY

    inp = torch.load(inputs_path, weights_only=False)
    dist.init_distributed(f"127.0.0.1:{port}", world, rank, platform="cpu", timeout_s=TIMEOUT_S)
    PARITY_POLICY.configure_backends()
    out = {}
    (_span_main if world == 3 else _pair_main)(inp, out, world)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier("saved")
    dist.shutdown()


def _pair_main(inp, out, world):
    """The job of two ranks: every other leg."""
    from faceposegenerator_tpu_torch.bridge.jax_params import jax_tree_to_torch
    from faceposegenerator_tpu_torch.core import dist
    from faceposegenerator_tpu_torch.core.mesh import make_mesh, rows_of
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels, sample_2d_parallel, sample_data_parallel
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.parallel.tp import shard_unet_params_tp, tp_sharding_plan
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline
    from faceposegenerator_tpu_torch.training import idbooth, multi_identity

    rank = dist.proc_info().process_index
    dp = make_mesh(data=world, device="cpu")
    tp = make_mesh(data=1, model=world, device="cpu")

    # DP and 2-D sampling, under a LoRA shared by the batch and a per-sample one
    s = inp["sample"]
    nets = _port_nets(s["trees"], SAMPLER_CFG)
    kw = dict(noise_override=torch.from_numpy(s["noise"]), height=SAMPLE_RES, width=SAMPLE_RES,
              policy=PARITY_POLICY)
    ids, neg = torch.from_numpy(s["ids"]), torch.from_numpy(s["neg"])
    loras = {k: {"unet": jax_tree_to_torch(s[f"lora_{k}"], "cpu", torch.float32)} for k in ("shared", "per")}
    out["dp_images"] = {k: sample_data_parallel(dp, nets, make_ddpm(num_inference_steps=S), ids, neg, lora=lora,
                                                **kw).numpy() for k, lora in loras.items()}
    pipe = StableDiffusionPipeline(nets, SamplerModels(), PARITY_POLICY, mesh=dp)  # to_mesh: rank 0's weights
    pipe.set_lora(loras["shared"])
    out["pipe_images"] = pipe(input_ids=ids, negative_input_ids=neg, num_inference_steps=S, height=SAMPLE_RES,
                              width=SAMPLE_RES, noise_override=kw["noise_override"])
    tp_nets = dict(nets, unet=shard_unet_params_tp(_port_nets(s["trees"], SAMPLER_CFG, ("unet",))["unet"], tp))
    out["tp_plan"] = tp_sharding_plan(nets["unet"], world)
    out["tp_q_rows"] = sorted({m.q.weight.shape[0] for n, m in tp_nets["unet"].named_modules()
                               if type(m).__name__ == "Attention"})
    out["tp_images"] = {k: sample_2d_parallel(tp, tp_nets, make_ddpm(num_inference_steps=S), ids, neg, lora=lora,
                                              **kw).numpy() for k, lora in loras.items()}

    # the ID-Booth step on the [instance; class] batch cut over the ranks,
    # and on the whole batch with the UNet split by head
    t = inp["train"]
    frozen = _train_frozen(t["trees"])
    out["dp_step"] = _dp_step(inp, dp, frozen)
    tp_frozen = dict(frozen, unet=shard_unet_params_tp(_port_nets(t["trees"], TRAIN_CFG, ("unet",))["unet"], tp))
    out["tp_step"] = _dp_step(inp, tp, tp_frozen)
    del tp_frozen
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=RES, train_batch_size=N // 2,
                                adam_epsilon=ADAM_EPS)
    bundle = _bundle()
    opt = idbooth.make_optimizer(cfg, total_steps=10)

    # K = 2 identities sharded over the ranks, and the unsharded stacked step
    stacked = multi_identity.stack_pytrees([_lora(t["lora"]), _lora(t["lora2"])])
    batches = {k: torch.stack([torch.from_numpy(t["batch"][k]), torch.from_numpy(t["batch2"][k])])
               for k in t["batch"]}
    draws = [_tensors(t["draws"]), _tensors(t["draws2"])]
    mine = multi_identity.shard_identity_axis(dp, stacked)
    opt_k = opt.init(mine)
    step1 = idbooth.make_train_step(cfg, bundle, opt, policy=PARITY_POLICY, identities=1)
    mine, _, mk = step1(mine, opt_k, frozen, {k: v[rank:rank + 1] for k, v in batches.items()},
                        draws=[draws[rank]])
    gathered = multi_identity.gather_identity_axis(dp, mine)
    out["k2_sharded"] = {"lora": _numpy(gathered["unet_lora"]),
                         "metrics": {k: v.detach().numpy() for k, v in
                                     multi_identity.gather_identity_axis(dp, mk).items()}}
    if rank == 0:
        step2 = idbooth.make_train_step(cfg, bundle, opt, policy=PARITY_POLICY, identities=2)
        whole, _, mw = step2(stacked, opt.init(stacked), frozen, batches, draws=draws)
        out["k2_whole"] = {"lora": _numpy(whole["unet_lora"]), "metrics": {k: v.numpy() for k, v in mw.items()}}

    # the FR driver's DP step: global BatchNorm
    from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
    from faceposegenerator_tpu_torch.training import fr

    f = inp["fr"]
    fcfg = fr.FRConfig(**f["cfg"])
    params, state = fr.init_train_state(fcfg, device="cpu", backbone_cfg=fr.backbone_config(fcfg, **FR_TINY))
    load_jax_params(params["backbone"], f["p0"]["backbone"], f["s0"]["bn"])
    with torch.no_grad():
        params["kernel"].copy_(torch.from_numpy(f["p0"]["kernel"]))
    if "adaface" in f["s0"]:
        state["adaface"] = {k: torch.as_tensor(v) for k, v in f["s0"]["adaface"].items()}
    fopt = fr.make_optimizer(fcfg)
    frows = rows_of(dp, FR_B)
    params, state, _, fm = fr.make_train_step(fcfg, fopt, PARITY_POLICY, mesh=dp)(
        params, state, fopt.init(params), {"images": f["x"][frows], "labels": f["y"][frows]},
        draws=_tensors(f["draws"]))
    out["fr"] = {"loss": float(fm["loss"]), "tree": fr.fr_checkpoint_tree(params, state)}

    # batch_norm_train(group=): JAX's pmean of the local moments
    from faceposegenerator_tpu_torch.core.mesh import DATA_AXIS
    from faceposegenerator_tpu_torch.ops import norms

    b = inp["bn"]
    half = b["x"].shape[0] // world
    got = norms.batch_norm_train(torch.from_numpy(b["x"][rank * half:(rank + 1) * half]),
                                 *map(torch.from_numpy, (b["g"], b["b"], b["rm"], b["rv"])), momentum=0.1,
                                 group=dp.group(DATA_AXIS))
    out["bn"] = [t_.numpy() for t_ in got]

    # run_identity: 2 ranks, then rank 0 alone, the same mesh code
    writes = []
    if rank == 1:
        shared = (inp["run"]["out_dp"], inp["run"]["k_dp"])

        def audit(event, args):
            if event == "open" and isinstance(args[0], str) and args[0].startswith(shared):
                mode = args[1] if len(args) > 1 and isinstance(args[1], str) else ""
                flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
                if any(c in mode for c in "wax+") or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
                    writes.append(args[0])

        sys.addaudithook(audit)
    frozen = _train_frozen(inp["run"]["trees"], RUN_CFG)
    out["history"] = {"dp": _run_identity(inp, dp, inp["run"]["out_dp"], frozen)}
    _run_identities(inp, dp, "k_dp", frozen)
    out["rank_writes"] = writes
    dist.barrier("legs_done")
    if rank == 0:
        out["history"]["one"] = _run_identity(inp, make_mesh(world_size=1, rank=0, device="cpu"),
                                              inp["run"]["out_one"], frozen)
        _run_identities(inp, None, "k_one", frozen)


def _run_cfg():
    from faceposegenerator_tpu_torch.training import idbooth

    return idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=RES, train_batch_size=1, num_train_epochs=1,
                                 checkpointing_epochs=1, adam_epsilon=ADAM_EPS)


def _run_identity(inp, mesh, out, frozen):
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.training import idbooth_driver

    r = inp["run"]
    return idbooth_driver.run_identity(_run_cfg(), _bundle(RUN_CFG), frozen, r["instance_dir"], out,
                                       embeds_dir=r["embeds_dir"], class_dir=r["class_dir"], policy=PARITY_POLICY,
                                       instance_ids=r["ids"], class_ids=r["ids"][::-1].copy(), mesh=mesh)[1]


def _run_identities(inp, mesh, key, frozen):
    """Two identities stacked, sharded over the mesh's ranks when given."""
    from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
    from faceposegenerator_tpu_torch.training import multi_identity

    r = inp["run"]
    multi_identity.run_identities_vmapped(
        _run_cfg(), _bundle(RUN_CFG), frozen, [r["instance_dir"], r["instance_dir2"]],
        [os.path.join(r[key], "a"), os.path.join(r[key], "b")], embeds_dirs=[r["embeds_dir"], None],
        class_dir=r["class_dir"], policy=PARITY_POLICY, instance_ids=r["ids"], class_ids=r["ids"][::-1].copy(),
        mesh=mesh)


# --------------------------------------------------------------------------
# the parent: inputs, JAX's results, the launch
# --------------------------------------------------------------------------

def _jax_sampling(inp):
    """JAX's images under the shared LoRA (tiled to a LoRA a row, so that
    one compile serves both) and the per-sample one; JAX's `shard_map`
    BatchNorm; its FR step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
    from faceposegenerator_tpu.diffusion import make_ddpm as jmake_ddpm
    from faceposegenerator_tpu.diffusion.sampler import sample as jsample
    from faceposegenerator_tpu.ops import norms as jnorms
    s = inp["sample"]

    def images(lora):
        return np.asarray(jsample(
            s["trees"], jmake_ddpm(num_inference_steps=S), jnp.asarray(s["ids"]), jnp.asarray(s["neg"]),
            jax.random.key(0), models=inp["jax_sampler_models"], height=SAMPLE_RES, width=SAMPLE_RES,
            policy=JPOLICY, noise_override=jnp.asarray(s["noise"]), lora={"unet": lora}))

    res = {"images": {"shared": images(jax.tree.map(lambda a: np.stack([a] * SAMPLE_B), s["lora_shared"])),
                      "per": images(s["lora_per"])}}
    b = inp["bn"]
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    bn = jax.jit(jax.shard_map(
        lambda x, g, bb, rm, rv: jnorms.batch_norm_train(x, g, bb, rm, rv, momentum=0.1, axis_name="data"),
        mesh=mesh, in_specs=(P("data"), P(), P(), P(), P()), out_specs=(P("data"), P(), P())))
    res["bn"] = [np.asarray(a) for a in bn(*(jnp.asarray(b[k]) for k in ("x", "g", "b", "rm", "rv")))]
    res["fr"] = _jax_fr_step(inp["fr"])
    return res


def _jax_training(inp):
    """JAX's one-device ID-Booth step on each identity's batch."""
    import jax
    import jax.numpy as jnp

    from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
    from faceposegenerator_tpu.training import idbooth as jidbooth
    res = {}
    t = inp["train"]
    cfg = jidbooth.IDBoothConfig(which_loss="triplet_prior", resolution=RES, train_batch_size=N // 2,
                                 adam_epsilon=ADAM_EPS)
    opt = jidbooth.make_optimizer(cfg, total_steps=10)
    step = jidbooth.make_train_step(cfg, inp["jax_bundle"], opt, policy=JPOLICY, donate=False)
    for name, lora, batch, key in (("one", "lora", "batch", 0), ("two", "lora2", "batch2", 1)):
        trainable = {"unet_lora": t[lora]}
        new, _, m = step(trainable, opt.init(trainable), t["trees"], {k: jnp.asarray(v) for k, v in t[batch].items()},
                         jax.random.key(key))
        res[name] = {"lora": jax.tree.map(np.asarray, new["unet_lora"]), "metrics": {k: float(v) for k, v in m.items()}}
    return res


def _fr_cfg():
    from faceposegenerator_tpu.training import fr as jfr

    return jfr.FRConfig(num_classes=FR_CLASSES, batch_size=FR_B, loss="AdaFace", network="iresnet18")


def _with_tiny_backbone(fn):
    """Run `fn` with JAX's FR backbone config at the tiny depths."""
    import dataclasses

    from faceposegenerator_tpu.training import fr as jfr

    base = jfr.backbone_config
    jfr.backbone_config = lambda c: dataclasses.replace(base(c), **FR_TINY)
    try:
        return fn()
    finally:
        jfr.backbone_config = base


def _fr_inputs():
    """The tiny FR run's init (JAX's tree structure filled from numpy), its
    global batch and the step's draws (tests/test_torch_fr.py's)."""
    import jax

    from faceposegenerator_tpu.training import fr as jfr
    from test_torch_checkpoints import numpy_init
    from test_torch_fr import _batch

    cfg = _fr_cfg()
    p0, s0 = _with_tiny_backbone(lambda: numpy_init(lambda k, c: jfr.init_train_state(k, c), cfg, 7))
    s0["adaface"] = {"batch_mean": np.float32(20.0), "batch_std": np.float32(100.0)}
    key = jax.random.fold_in(jax.random.key(5), 0)
    draws = {"dropout": np.asarray(jax.random.bernoulli(key, 1 - cfg.dropout, (FR_B, 512))),
             "margin": np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (FR_B,)))}
    x, y = _batch()
    return {"cfg": {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}, "p0": p0, "s0": s0,
            "x": torch.from_numpy(x), "y": torch.from_numpy(y), "draws": draws, "key": key}


def _jax_fr_step(f):
    """JAX's one-device FR step from `_fr_inputs`: (loss, params, state)."""
    import jax
    import jax.numpy as jnp

    from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
    from faceposegenerator_tpu.training import fr as jfr

    cfg = _fr_cfg()
    params = jax.tree.map(jnp.asarray, f["p0"])
    optimizer = jfr.make_optimizer(cfg)
    step = _with_tiny_backbone(lambda: jfr.make_train_step(cfg, optimizer, policy=JPOLICY, donate=False))
    params, state, _, m = step(params, jax.tree.map(jnp.asarray, f["s0"]), optimizer.init(params),
                               {"images": jnp.asarray(f["x"].numpy()), "labels": jnp.asarray(f["y"].numpy())},
                               f["key"])
    return float(m["loss"]), jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _jax_draws(key):
    import jax
    import jax.numpy as jnp

    k_lat, k_noise, k_t = jax.random.split(key, 3)
    shape = (N, RES // 8, RES // 8, 4)
    return {"latent_noise": np.array(jax.random.normal(k_lat, shape, jnp.float32)),
            "noise": np.array(jax.random.normal(k_noise, shape, jnp.float32)),
            "timesteps": np.array(jax.random.randint(k_t, (N,), 0, 1000))}


def _inputs(tmp):
    import jax
    from PIL import Image

    from faceposegenerator_tpu.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu.models import clip_text as jclip
    from faceposegenerator_tpu.models import iresnet as jir
    from faceposegenerator_tpu.models import unet2d as junet
    from faceposegenerator_tpu.models import vae as jvae
    from faceposegenerator_tpu.training import idbooth as jidbooth
    from test_torch_checkpoints import numpy_init

    def cfgs(c):
        return jclip.CLIPTextConfig(**c["text"]), junet.UNetConfig(**c["unet"]), jvae.VAEConfig(**c["vae"])

    def trees(c, seed):
        tc, uc, vc = cfgs(c)
        return {"text_encoder": numpy_init(jclip.init, tc, seed), "unet": numpy_init(junet.init, uc, seed + 1),
                "vae": numpy_init(jvae.init, vc, seed + 2)}

    rng = np.random.default_rng(0)
    tc, uc, vc = cfgs(SAMPLER_CFG)
    sample = {"trees": trees(SAMPLER_CFG, 0), "ids": rng.integers(0, 128, (SAMPLE_B, 77)),
              "noise": rng.standard_normal((S + 1, SAMPLE_B, SAMPLE_RES // 8, SAMPLE_RES // 8, 4)).astype(np.float32)}
    sample["neg"] = np.zeros_like(sample["ids"])
    # rank-4 LoRAs of the sampler's UNet: Gaussian A and B, one for the
    # batch and one a row
    lrng = np.random.default_rng(7)
    shape = jax.eval_shape(lambda: junet.init_lora(jax.random.key(0), sample["trees"]["unet"], rank=4))

    def fill(lead):
        return jax.tree_util.tree_map_with_path(lambda path, leaf: (
            (0.25 if path[-1].key == "a" else 0.05) * lrng.standard_normal(lead + leaf.shape)).astype(np.float32),
            shape)

    sample["lora_shared"], sample["lora_per"] = fill(()), fill((SAMPLE_B,))
    ttc, tuc, tvc = cfgs(TRAIN_CFG)
    jbundle = jidbooth.ModelBundle(text_cfg=ttc, unet_cfg=tuc, vae_cfg=tvc,
                                   arcface_cfg=jir.config_for("r18", num_features=64))
    ap, ast = numpy_init(jir.init, jbundle.arcface_cfg, 3)
    ttrees = dict(trees(TRAIN_CFG, 10), arcface={"params": ap, "state": ast})

    def lora(seed):  # Gaussian A / rank, a small nonzero B: every LoRA leaf has a gradient
        r = np.random.default_rng(seed)

        def fill(path, leaf):
            scale = 0.25 if path[-1].key == "a" else 0.01
            return (scale * r.standard_normal(leaf.shape)).astype(np.float32)

        shape = jax.eval_shape(lambda: jidbooth.init_trainable(jax.random.key(0), jidbooth.IDBoothConfig(), jbundle,
                                                               ttrees["unet"]))
        return jax.tree_util.tree_map_with_path(fill, shape)["unet_lora"]

    def batch(seed):
        r = np.random.default_rng(seed)
        return {"pixel_values": r.uniform(-1, 1, (N, RES, RES, 3)).astype(np.float32),
                "input_ids": r.integers(0, 64, (N, 77)), "gt_embeds": r.standard_normal((N, 64)).astype(np.float32)}

    train = {"trees": ttrees, "lora": lora(1), "lora2": lora(2), "batch": batch(3), "batch2": batch(4),
             "draws": _jax_draws(jax.random.key(0)), "draws2": _jax_draws(jax.random.key(1))}
    brng = np.random.default_rng(5)
    bn = {"x": brng.normal(0.5, 2.0, (8, 5, 6, 16)).astype(np.float32),
          "g": brng.normal(1, 0.1, 16).astype(np.float32), "b": brng.normal(0, 0.1, 16).astype(np.float32),
          "rm": brng.normal(0, 1, 16).astype(np.float32), "rv": brng.uniform(0.5, 2, 16).astype(np.float32)}

    # run_identity's data: two 64² instance images with embeds, two class images
    run = {k: os.path.join(tmp, k) for k in ("instance_dir", "instance_dir2", "class_dir", "embeds_dir", "out_dp",
                                                "out_one", "k_dp", "k_one")}
    for k in ("instance_dir", "instance_dir2", "class_dir", "embeds_dir"):
        os.makedirs(run[k])
    irng = np.random.default_rng(6)
    for i in range(2):
        for k in ("instance_dir", "instance_dir2", "class_dir"):
            Image.fromarray(irng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)).save(
                os.path.join(run[k], f"{i}.png"))
        np.save(os.path.join(run["embeds_dir"], f"{i}.npy"), irng.standard_normal(64).astype(np.float32))
    np.save(os.path.join(tmp, "class_embed.npy"), irng.standard_normal(64).astype(np.float32))
    run["ids"] = irng.integers(0, 64, 77)
    run["trees"] = dict(trees(RUN_CFG, 20), arcface=ttrees["arcface"])
    return {"sample": sample, "train": train, "bn": bn, "run": run,
            "jax_sampler_models": SamplerModels(text_cfg=tc, unet_cfg=uc, vae_cfg=vc), "jax_bundle": jbundle}


_LAUNCH_ENV = ("FPG_COORDINATOR", "FPG_NUM_PROCESSES", "FPG_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR")


def _launch(inputs_path, tmp, model_dir):
    """Spawn, all at once: the job of two ranks, the job of three, and
    `cli generate` from one process and with `--data_parallel 2`. Returns
    each job's rank outputs."""
    from faceposegenerator_tpu_torch.core.dist import free_port, spawn

    jobs = {2: os.path.join(tmp, "pair"), 3: os.path.join(tmp, "span")}
    cmds = []
    for world, out in jobs.items():
        os.makedirs(out)
        port = free_port()
        cmds += [[sys.executable, os.path.abspath(__file__), inputs_path, out, str(r), str(world), str(port)]
                 for r in range(world)]
    lora_root = os.path.join(tmp, "loras")
    os.makedirs(os.path.join(lora_root, "DreamBooth", "id_3"))
    gen = [sys.executable, "-m", "faceposegenerator_tpu_torch.cli", "generate", "--model_dir", str(model_dir),
           "--lora_root", lora_root, "--steps", "2", "--batch_size", "2", "--num_prompts", "2", "--pack_variants",
           "--device", "cpu", "--output"]
    cmds += [gen + [os.path.join(tmp, "gen_one")], gen + [os.path.join(tmp, "gen_dp"), "--data_parallel", "2"]]
    logs = os.path.join(tmp, "logs")
    os.makedirs(logs)
    with pytest.MonkeyPatch.context() as mp:
        for k in _LAUNCH_ENV:
            mp.delenv(k, raising=False)
        spawn(cmds, lambda i: {"OMP_NUM_THREADS": "1"}, TIMEOUT_S, log_dir=logs)
    return {world: [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]
            for world, out in jobs.items()}


@pytest.fixture(scope="module")
def launch(tmp_path_factory, light_model_dir):  # noqa: F811 (fixture)
    tmp = str(tmp_path_factory.mktemp("dp"))
    inp = _inputs(tmp)
    inp["fr"] = _fr_inputs()
    pool = ThreadPoolExecutor(max_workers=2)
    jax_futures = [pool.submit(fn, inp) for fn in (_jax_training, _jax_sampling)]
    port_inp = {k: v for k, v in inp.items() if not k.startswith("jax_")}
    port_inp["fr"] = {k: v for k, v in inp["fr"].items() if k != "key"}
    path = os.path.join(tmp, "inputs.pt")
    torch.save(port_inp, path)
    try:
        jobs = _launch(path, tmp, light_model_dir)
    finally:
        jax_res = {k: v for f in jax_futures for k, v in f.result().items()}
        pool.shutdown()
    yield {"ranks": jobs[2], "span": jobs[3], "jax": jax_res, "inp": inp, "tmp": tmp}


def _close(got, want, atol, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    assert not bad.any(), f"{what}: max abs err {err.max():.3g} (atol {atol:g}, rtol {rtol:g})"


def _leaves(tree):
    from faceposegenerator_tpu_torch.core.tree import tree_paths

    return dict(tree_paths(tree))


LORAS = pytest.mark.parametrize("lora", ["shared", "per"], ids=["shared_lora", "per_sample_lora"])


@LORAS
def test_data_parallel_sampling_matches_one_device(launch, lora):
    """`sample_data_parallel`, and the pipeline placed by `to_mesh`."""
    want = launch["jax"]["images"][lora]
    for r in launch["ranks"]:
        assert r["dp_images"][lora].shape == want.shape == (SAMPLE_B, SAMPLE_RES, SAMPLE_RES, 3)
        _close(r["dp_images"][lora], want, 1e-3, 0.0, "DP images")
        if lora == "shared":
            np.testing.assert_array_equal(r["pipe_images"], r["dp_images"][lora])


@LORAS
def test_2d_parallel_sampling_matches_one_device(launch, lora):
    want = launch["jax"]["images"][lora]
    r0 = launch["ranks"][0]
    # level 0's 3 heads stay whole (48 q rows); the 4 heads below split in half
    plan = r0["tp_plan"]
    assert {k for k, v in plan.items() if not v} == {k for k in plan if k.startswith(("down_blocks.0.", "up_blocks.3."))}
    assert any(plan.values()) and r0["tp_q_rows"] == [32, 48]
    for r in launch["ranks"]:
        _close(r["tp_images"][lora], want, 1e-3, 0.0, "TP images")


def _check_steps(steps, rows, want):
    """Each rank's step against JAX's one-device step, the LoRA bit-equal
    across ranks."""
    assert [s["rows"] for s in steps] == rows
    w = _leaves(want["lora"])
    for s in steps:
        for k in ("loss", "instance_loss", "prior_loss", "id_loss"):
            _close(s["metrics"][k], want["metrics"][k], 0.0, 2e-4, k)
        _close(s["metrics"]["grad_norm"], want["metrics"]["grad_norm"], 0.0, 1e-3, "grad_norm")
        for path, leaf in _leaves(s["lora"]).items():
            _close(leaf, w[path], 1e-6, 1e-5, path)
    first = _leaves(steps[0]["lora"])
    for s in steps[1:]:
        assert all(np.array_equal(first[p], v) for p, v in _leaves(s["lora"]).items()), \
            "the replicated LoRA differs across ranks"


def test_dp_idbooth_step_with_the_split_batch_matches_one_device(launch):
    # rank 0 holds the instance rows, rank 1 the class rows
    _check_steps([r["dp_step"] for r in launch["ranks"]], [(0, 3), (3, 6)], launch["jax"]["one"])


def test_dp_idbooth_step_with_instance_rows_on_two_ranks_matches_one_device(launch):
    """Three ranks of 2 rows: rank 1 holds instance row 2 and class row 3,
    so the identity term's denominator sums over ranks 0 and 1, rank 1's
    embeddings start at global row 2 and its negative is global row 5."""
    _check_steps([r["span_step"] for r in launch["span"]], [(0, 2), (2, 4), (4, 6)], launch["jax"]["one"])


def test_tp_idbooth_step_matches_one_device(launch):
    """Data 1 × model 2: the whole batch on both ranks; the heads, MLP and
    LoRA of every transformer block below level 0 split over them, level
    0's whole on both."""
    _check_steps([r["tp_step"] for r in launch["ranks"]], [(0, 6), (0, 6)], launch["jax"]["one"])


def test_identities_sharded_over_ranks_match(launch):
    ranks, jax_res = launch["ranks"], launch["jax"]
    whole = ranks[0]["k2_whole"]
    for r in ranks:
        got = r["k2_sharded"]
        for i, name in enumerate(("one", "two")):
            want = jax_res[name]
            for k in ("loss", "instance_loss", "prior_loss", "id_loss"):
                _close(got["metrics"][k][i], want["metrics"][k], 0.0, 1e-5, f"identity {i} {k}")
                _close(got["metrics"][k][i], whole["metrics"][k][i], 0.0, 1e-5, f"identity {i} {k} vs stacked")
            w = _leaves(want["lora"])
            for path, leaf in _leaves(got["lora"]).items():
                _close(leaf[i], w[path], 1e-5, 1e-5, f"identity {i} {path}")
        wl = _leaves(whole["lora"])
        for path, leaf in _leaves(got["lora"]).items():
            _close(leaf, wl[path], 1e-5, 1e-5, f"{path} vs stacked")


def test_fr_driver_dp_step_takes_global_batch_norm(launch):
    want_loss, p1, s1 = launch["jax"]["fr"]
    from faceposegenerator_tpu_torch.core.tree import tree_paths

    for r in launch["ranks"]:
        _close(r["fr"]["loss"], want_loss, 0.0, 2e-4, "FR loss")
        got = r["fr"]["tree"]
        for want, tree, tol in ((p1, got["params"], 1e-4), (s1, got["state"], 1e-5)):
            w = dict(tree_paths(want))
            scale = max(float(np.abs(v).max()) for v in w.values())
            for path, leaf in tree_paths(tree):
                _close(leaf, w[path], tol * scale, 0.0, path)


def test_batch_norm_group_matches_jax_shard_map(launch):
    want_out, want_mean, want_var = launch["jax"]["bn"]
    half = want_out.shape[0] // 2
    for rank, r in enumerate(launch["ranks"]):
        out, mean, var = r["bn"]
        _close(out, want_out[rank * half:(rank + 1) * half], 1e-5, 1e-5, "out")
        _close(mean, want_mean, 1e-5, 1e-5, "running mean")
        _close(var, want_var, 1e-5, 1e-5, "running var")


def _close_state(a, b, what):
    """A checkpoint's state.npz against another: the LoRA within 1e-5, each
    optimizer moment within 1e-3 of the largest value of that moment's
    leaves (the gradient of an A factor starts near zero, so its own
    largest value does not measure it)."""
    scale = {}
    for k in b.files:
        kind = k.split("/")[1]
        scale[kind] = max(scale.get(kind, 0.0), float(np.abs(b[k]).max()))
    for k in a.files:
        tol = 1e-5 if k.startswith("trainable/") else 1e-3 * scale[k.split("/")[1]]
        _close(a[k], b[k], tol, 0.0, f"{what} {k}")


def test_run_identity_on_two_ranks_matches_one_process(launch):
    run = launch["inp"]["run"]
    assert launch["ranks"][1]["rank_writes"] == []
    names = sorted(os.listdir(run["out_dp"]))
    assert "pytorch_lora_weights.safetensors" in names and names == sorted(os.listdir(run["out_one"]))
    ckpt = [n for n in names if n.startswith("checkpoint-")]
    assert ckpt == ["checkpoint-0-2"]
    with np.load(os.path.join(run["out_dp"], ckpt[0], "state.npz")) as a, \
            np.load(os.path.join(run["out_one"], ckpt[0], "state.npz")) as b:
        assert set(a.files) == set(b.files)
        _close_state(a, b, "")
    one, two = (launch["ranks"][0]["history"][k] for k in ("one", "dp"))
    assert len(one) == len(two) == 1
    for k, v in one[0].items():
        _close(two[0][k], v, 0.0, 1e-5, f"history {k}")


def test_run_identities_sharded_over_ranks_matches_one_process(launch):
    """`run_identities_vmapped(mesh=)`: 2 identities, one a rank, against
    the unsharded stacked run: the same files, each identity's last
    checkpoint as above, its dataset random state equal (gathered to rank 0,
    which wrote every file)."""
    run = launch["inp"]["run"]
    assert launch["ranks"][1]["rank_writes"] == []
    for ident in ("a", "b"):
        dp, one = os.path.join(run["k_dp"], ident), os.path.join(run["k_one"], ident)
        names = sorted(os.listdir(dp))
        assert names == sorted(os.listdir(one)) and "checkpoint-0-2" in names
        ckpt = os.path.join("checkpoint-0-2")
        assert sorted(os.listdir(os.path.join(dp, ckpt))) == sorted(os.listdir(os.path.join(one, ckpt)))
        with open(os.path.join(dp, ckpt, "data_rng.json")) as f, open(os.path.join(one, ckpt, "data_rng.json")) as g:
            assert f.read() == g.read()
        with np.load(os.path.join(dp, ckpt, "state.npz")) as a, np.load(os.path.join(one, ckpt, "state.npz")) as b:
            assert set(a.files) == set(b.files)
            _close_state(a, b, ident)


def test_generate_data_parallel_spawns_ranks_that_write_the_same_pngs(launch):
    """`generate --data_parallel 2 --device cpu` from one command spawns two
    gloo ranks (one row of each packed batch of 2 a rank); rank 0 writes
    the PNGs and the grid, bit-equal to the one-process command's."""
    from PIL import Image

    one, dp = (os.path.join(launch["tmp"], k) for k in ("gen_one", "gen_dp"))

    def pngs(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                      for f in fs if f.endswith(".png"))

    names = pngs(one)
    assert len(names) == 3 * 2 + 1 and pngs(dp) == names
    for n in names:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(dp, n))),
                                      np.asarray(Image.open(os.path.join(one, n))), err_msg=n)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
