"""Multi-process pod rehearsal: the multi-host launch path, run as separate
processes on one machine (port of
`faceposegenerator_tpu/parallel/pod_rehearsal.py:52-409`).

JAX runs one process a host over its local devices; the port runs one
process a device, so a rehearsal of `processes` hosts with `local_devices`
devices each spawns `processes · local_devices` ranks joined by
`torch.distributed`, on the ("data", "model") = (processes, local_devices)
mesh: data-parallel across hosts, tensor-parallel within one.

What one run proves, end to end, on every rank:
  1. bring-up: the ranks connect (`core.dist.init_distributed`) and lay the
     mesh over themselves;
  2. host-local data loading: each host's ranks hold only that host's
     `host_row_slice` of the global batch, and `form_global_batch` gives
     each rank its rows with no data moving between ranks;
  3. the ID-Booth train step, data-parallel over hosts and tensor-parallel
     within one (`idbooth.make_train_step(mesh=)` over a UNet placed by
     `parallel.tp.shard_unet_params_tp`), and every rank computes the same
     loss;
  4. a checkpoint written by rank 0 alone, a barrier, and a restore on
     every rank that continues training to the same loss;
  5. `sample_2d_parallel` over the same mesh;
  6. the rolling server's tick functions (`RollingServer._admit`, `_tick`,
     `_decode1`) driven from a fixed admission schedule (global slot 0
     at tick 0, the rest at tick 1): each rank ticks its own slots, as a
     deployment whose ranks run in lockstep would.

Usage (also `cli pod-rehearsal`):
    python -m faceposegenerator_tpu_torch.parallel.pod_rehearsal \\
        --device cpu --processes 2 --local_devices 2
On the card, `--device cuda` runs NCCL with a card a rank; `--backend
gloo` lets several ranks share one card (a test rig).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from ..core.dist import SpawnError, free_port, spawn

PORT_DEFAULT = 18231


class _RehearsalTokenizer:
    """Token ids from a prompt's text (a seeded draw below `vocab`), for the
    tiny text encoder, which no real vocabulary fits."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, prompts):
        import zlib

        import numpy as np

        prompts = [prompts] if isinstance(prompts, str) else prompts
        return np.stack([np.random.default_rng(zlib.crc32(p.encode())).integers(0, self.vocab, 77)
                         for p in prompts])


# --------------------------------------------------------------------------
# worker body: runs in each spawned process
# --------------------------------------------------------------------------

def run_worker(process_id: int, num_processes: int, local_devices: int, port: int, ckpt_dir: str,
               device: str = "cpu", backend=None, timeout_s: float = 600.0) -> dict:
    """One rank's program; `process_id` is its rank among
    `num_processes · local_devices`. Returns the verdict dict it also prints."""
    import numpy as np
    import torch

    from ..core.checkpointing import CheckpointManager
    from ..core.dist import barrier, coordination_barrier, init_distributed, is_coordinator
    from ..core.dist import shutdown as dist_shutdown
    from ..core.mesh import (all_gather_rows, broadcast_object, form_global_batch, host_row_slice, make_mesh,
                             replicate, rows_of)
    from ..core.precision import PARITY_POLICY
    from ..core.rng import sampler_generator, train_step_generator
    from ..core.tree import tree_map
    from ..diffusion.sampler import SamplerModels, sample_2d_parallel
    from ..diffusion.schedulers import make_ddpm
    from ..models import clip_text, iresnet, unet2d, vae
    from ..pipelines.txt2img import StableDiffusionPipeline
    from ..serving.engine import GenerationRequest
    from ..serving.rolling import RollingServer
    from ..training import idbooth
    from .tp import shard_unet_params_tp

    world = num_processes * local_devices
    info = init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=process_id, platform=device,
                            backend=backend, timeout_s=timeout_s)
    assert info.process_count == world, info
    host = process_id // local_devices
    # DP across hosts, TP across each host's devices: ranks are host-major,
    # so the "model" ranks of one data index are one host's
    mesh = make_mesh(data=num_processes, model=local_devices)
    dev = mesh.device
    n_data, model_axis = mesh.data, mesh.model

    # tiny configs: shapes shrink, the program and its placement do not
    bundle = idbooth.ModelBundle(
        text_cfg=clip_text.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                                          intermediate_size=64),
        unet_cfg=unet2d.UNetConfig(block_out_channels=(32, 64, 64, 64), cross_attention_dim=32, head_dim=8),
        vae_cfg=vae.VAEConfig(block_out_channels=(32, 32, 32, 32)),
        arcface_cfg=iresnet.config_for("r18", num_features=64),
    )
    frozen = {
        "text_encoder": clip_text.CLIPTextModel(bundle.text_cfg, device=dev, seed=0),
        "unet": unet2d.UNet2DCondition(bundle.unet_cfg, device=dev, seed=1),
        "vae": vae.AutoencoderKL(bundle.vae_cfg, device=dev, seed=2),
        "arcface": iresnet.IResNet(bundle.arcface_cfg, device=dev, seed=3),
    }
    whole_unet = unet2d.UNet2DCondition(bundle.unet_cfg, device=dev, seed=1)  # the rolling leg's
    coordination_barrier("pre_first_collective")  # align start-up skew before any collective
    replicate(mesh, frozen)
    replicate(mesh, whole_unet)
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", resolution=64)
    trainable = idbooth.init_trainable(4, cfg, bundle, frozen["unet"])
    replicate(mesh, trainable)
    if model_axis > 1:
        shard_unet_params_tp(frozen["unet"], mesh)
    opt = idbooth.make_optimizer(cfg, total_steps=8)
    opt_state = opt.init(trainable)
    step = idbooth.make_train_step(cfg, bundle, opt, policy=PARITY_POLICY, mesh=mesh)

    # host-local loading: every host makes the same global batch from fixed
    # seeds and keeps only its contiguous rows
    rows = 2 * n_data
    rng = np.random.default_rng(10)
    gb = {
        "pixel_values": rng.uniform(-1, 1, (rows, 64, 64, 3)).astype(np.float32),
        "input_ids": rng.integers(0, 64, (rows, 77)),
        "gt_embeds": rng.standard_normal((rows, 64)).astype(np.float32),
    }
    sl = host_row_slice(rows, num_processes, host)
    batch = form_global_batch(mesh, {k: v[sl] for k, v in gb.items()}, num_processes, host)

    trainable, opt_state, m1 = step(trainable, opt_state, frozen, batch, train_step_generator(0, 0, dev))
    loss1 = float(m1["loss"])
    assert np.isfinite(loss1), f"non-finite loss {loss1}"

    # rank-0 checkpoint to the shared directory; everyone restores after a barrier
    mgr = CheckpointManager(ckpt_dir)
    if is_coordinator():
        mgr.save(0, 1, trainable, opt_state)
    barrier("ckpt_written")
    copy = tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad)
                    if isinstance(t, torch.Tensor) else t, (trainable, opt_state))
    t1r, o1r, _ep, _st = mgr.restore(mgr.latest(), *copy)

    _, _, m2 = step(trainable, opt_state, frozen, batch, train_step_generator(0, 1, dev))
    _, _, m2r = step(t1r, o1r, frozen, batch, train_step_generator(0, 1, dev))
    loss2, loss2r = float(m2["loss"]), float(m2r["loss"])
    assert np.isfinite(loss2)
    assert abs(loss2 - loss2r) < 1e-6, f"checkpoint round-trip diverged: {loss2} vs {loss2r}"

    # every rank must have computed the same losses
    all_losses = all_gather_rows(mesh, torch.tensor([[loss1, loss2]], dtype=torch.float64, device=dev), None)
    assert bool((all_losses == all_losses[0]).all()), all_losses.tolist()

    # serving path: 2-D parallel sampling over the same mesh
    models = SamplerModels(text_cfg=bundle.text_cfg, unet_cfg=bundle.unet_cfg, vae_cfg=bundle.vae_cfg)
    nets = {k: frozen[k] for k in ("text_encoder", "unet", "vae")}
    ids = torch.from_numpy(np.random.default_rng(20).integers(0, 64, (n_data, 77)))
    imgs = sample_2d_parallel(mesh, nets, make_ddpm(num_inference_steps=2), ids, torch.zeros_like(ids),
                              generator=sampler_generator(21, dev), height=64, width=64, policy=PARITY_POLICY)
    img_mean = float(imgs.double().mean())
    assert tuple(imgs.shape) == (n_data, 64, 64, 3) and np.isfinite(img_mean)

    # rolling leg: the tick functions from a fixed admission schedule, each
    # rank its own slots of B_r = n_data (the JAX slot axis over "data")
    S_r, B_r = 2, n_data
    pipe = StableDiffusionPipeline({"text_encoder": frozen["text_encoder"], "unet": whole_unet,
                                    "vae": frozen["vae"]}, models, PARITY_POLICY,
                                   tokenizer=_RehearsalTokenizer(bundle.text_cfg.vocab_size))
    mine = range(B_r)[rows_of(mesh, B_r)]
    server = RollingServer(pipe, batch_size=len(mine), num_inference_steps=S_r, height=64, width=64,
                           guidance_scale=5.0)
    try:
        h8 = 64 // 8
        with torch.inference_mode():
            ctx_buf = torch.zeros((2 * len(mine), 77, bundle.text_cfg.hidden_size), device=dev)
            noise_buf = torch.zeros((S_r + 1, len(mine), h8, h8, 4), device=dev)
            latents = torch.zeros((len(mine), h8, h8, 4), device=dev)
            step_dev = torch.full((len(mine),), S_r, dtype=torch.long, device=dev)
        steps_host = [S_r] * len(mine)
        lora, scale = server._stacked_lora((None,) * len(mine))
        for tick in range(S_r + 2):
            admit_now = [0] if tick == 0 else (list(range(1, B_r)) if tick == 1 else [])
            for g in admit_now:
                if g in mine:
                    j = g - mine.start
                    server._admit(j, GenerationRequest(prompt=f"rehearsal slot {g}", seed=30 + g), ctx_buf,
                                  noise_buf, latents)
                    with torch.inference_mode():
                        step_dev[j] = 0
                    steps_host[j] = 0
            latents, step_dev = server._tick(latents, step_dev, ctx_buf, noise_buf, lora, scale)
            steps_host = [s + 1 if s < S_r else s for s in steps_host]
        assert all(s >= S_r for s in steps_host), steps_host
        roll_mean = float(server._decode1(latents[0]).mean() / 255.0) if 0 in mine else 0.0
    finally:
        server.shutdown()
    roll_mean = broadcast_object(mesh, roll_mean, src=0)  # global slot 0 lives on rank 0
    assert np.isfinite(roll_mean), roll_mean

    barrier("done")
    verdict = {
        "process": process_id,
        "processes": num_processes,
        "global_devices": info.global_device_count,
        "mesh": {"data": int(n_data), "model": int(model_axis)},
        "loss1": loss1,
        "loss2": loss2,
        "loss2_restored": loss2r,
        "sample_mean": img_mean,
        "rolling_mean": roll_mean,
        "ok": True,
    }
    print("POD_REHEARSAL " + json.dumps(verdict), flush=True)
    dist_shutdown()
    return verdict


# --------------------------------------------------------------------------
# launcher: spawns the ranks and cross-checks their verdicts
# --------------------------------------------------------------------------

def launch(num_processes: int, local_devices: int, port: int = 0, timeout: float = 600.0,
           device: str = "cpu", backend=None) -> dict:
    """Spawn `num_processes · local_devices` ranks on this machine and check
    that their verdicts agree; returns the merged verdict. A rank that
    fails, or a run that outlives `timeout` seconds, stops every rank.
    `port` 0 takes a free one. Each rank runs on one torch thread."""
    port = port or free_port()
    world = num_processes * local_devices
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cmds = [[sys.executable, "-m", "faceposegenerator_tpu_torch.parallel.pod_rehearsal", "--worker",
                 "--process_id", str(i), "--processes", str(num_processes), "--local_devices", str(local_devices),
                 "--port", str(port), "--ckpt_dir", ckpt_dir, "--device", device, "--timeout", str(timeout)]
                + (["--backend", backend] if backend else []) for i in range(world)]
        try:
            outputs = spawn(cmds, lambda i: {"OMP_NUM_THREADS": "1"}, timeout, log_dir=ckpt_dir)
        except SpawnError as e:
            raise RuntimeError(f"pod rehearsal failed: {e}") from None
    verdicts = [json.loads(line[len("POD_REHEARSAL "):]) for out in outputs for line in out.splitlines()
                if line.startswith("POD_REHEARSAL ")]
    if len(verdicts) != world:
        raise RuntimeError("pod rehearsal failed:\n" + "\n----\n".join(o[-4000:] for o in outputs[-2:]))
    ref = verdicts[0]
    for v in verdicts[1:]:
        assert v["loss1"] == ref["loss1"] and v["loss2"] == ref["loss2"], verdicts
        assert v["global_devices"] == ref["global_devices"], verdicts
    merged = dict(ref)
    merged["process"] = "all"
    return merged


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local_devices", type=int, default=2)
    ap.add_argument("--port", type=int, default=PORT_DEFAULT, help="the coordinator's port; 0: a free one")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default: the card, or an error) or 'cpu'")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default NCCL on the card, gloo on the CPU; gloo lets ranks share one card")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--process_id", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt_dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=2400.0,
                    help="wall-clock budget of the run, and of every process group's wait")
    ap.add_argument("--out", default=None, help="write the merged verdict JSON here")
    args = ap.parse_args(argv)

    if args.worker:
        import torch

        torch.set_num_threads(1)
        run_worker(args.process_id, args.processes, args.local_devices, args.port, args.ckpt_dir,
                   device=args.device, backend=args.backend, timeout_s=args.timeout)
        return 0

    from ..core.device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise before spawning
    verdict = launch(args.processes, args.local_devices, args.port, timeout=args.timeout, device=args.device,
                     backend=args.backend)
    print(json.dumps(verdict))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
