"""Command-line entry points mirroring the reference's script surface (port
of `faceposegenerator_tpu/cli.py`).

    python -m faceposegenerator_tpu_torch.cli <command> [args]
    fpg-torch <command> [args]            (the installed script)

Commands ↔ reference scripts:
  train-idbooth   ↔ train_ID-Booth.py        (losses × identities sweep)
  generate        ↔ inference_ID-Booth.py    (prompt-grid synthesis sweep)
  extract-embeds  ↔ extract_ArcFace_embeds.py
  align-crop      ↔ utils/detect_align_crop_data.py
  train-fr        ↔ FR_training/train_FR.py
  test-fr         ↔ FR_training/test_FR.py
  dgm-eval        ↔ python -m dgm_eval
  pyeer           ↔ Evaluation/PyEER_analysis/analyse_pyeer_ID-Booth.py
  analyze         ↔ Evaluation/PyEER_analysis/analysis_scripts/
  fiqa            ↔ Evaluation/CR-FIQA/getQualityScore…
  pose            ↔ Evaluation/PoseEstimation notebook
  serve           ↔ (the HTTP serving front end over the batch engine)
  accel-report    ↔ (the acceleration modes' quality report)

Every command takes the JAX command's flags. The eleven that put a network
on a device also take `--device`: "cuda" (the default) is the card, and
without one they raise; "cpu" runs on the CPU. pyeer and analyze run on the
host. The command-line refusals (argparse errors) come before the device is
resolved and before any file is read.

Distribution (one process a device, joined by torch.distributed):
`generate --data_parallel N`, `serve --data_parallel N` and `train-idbooth
--identity_parallel N`, run from one shell command, spawn N ranks on the
first N cards (NCCL), or on the CPU with `--device cpu` (gloo); more ranks
than visible cards raise, unless FPG_BACKEND=gloo puts the ranks on one
card over gloo (a rig for checks, not for speed). `serve`'s rank 0 answers
HTTP on `--port`, the other ranks follow its batches (`serving/engine.py`).
Under a launcher's `FPG_COORDINATOR` / `FPG_NUM_PROCESSES` /
`FPG_PROCESS_ID` (or torch's own RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT) each process is one rank of the job, and the mesh flags take
the job's ranks. As in JAX, train-idbooth without `--identity_parallel`
and train-fr pass no mesh under such a launch: every process trains the
whole job. `pod-rehearsal` runs the multi-process rehearsal
(`parallel/pod_rehearsal.py`).

Not ported yet, so these raise and name their ROADMAP.md queue 1 items:
`parity` and `parity-all` (items 17-18, the torch mirror and full-chain
runbook).

Where this differs from the JAX commands:
  - random weights without a weight file (the ArcFace of train-idbooth and
    extract-embeds, CR-FIQA's backbone and quality head, 6DRepNet) come
    from the port's constructors seeded 0, 1 and 2 where JAX uses
    `jax.random.key(0)`, `key(1)` and `key(2)`: the weights differ from
    JAX's, and what must agree comes from files;
  - `extract-embeds --quant_calibrate B` draws its B uniform [-1, 1)
    batches of (32, 112, 112, 3) from a CPU `torch.Generator` seeded
    1000 + i, where JAX uses `jax.random.key(1000 + i)`;
  - train-idbooth's frozen networks are `from_pretrained`'s, bf16 on the
    card (JAX keeps fp32 numpy weights; both compute in bf16), and its
    model configs come from the directory's config.json files;
  - serve flushes its "serving on" line, so a parent reading a pipe sees it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_LAUNCH_ENV = ("FPG_COORDINATOR", "FPG_NUM_PROCESSES", "FPG_PROCESS_ID")


def _add_common(ap):
    ap.add_argument("--model_dir", default=None, help="local SD2.1 diffusers dir")
    ap.add_argument("--seed", type=int, default=0)


def _add_device(ap):
    ap.add_argument("--device", default="cuda", help="'cuda' (the default: the card, or an error) or 'cpu'")


def _reject_preset_conflicts(ap, args, flag_defaults: dict):
    """--preset owns the turbo knobs; an explicit turbo flag alongside it is
    ambiguous (which wins?) — refuse instead of silently overriding."""
    clashing = [
        f"--{name}" for name, default in flag_defaults.items()
        if getattr(args, name) != default
    ]
    if clashing:
        ap.error(
            f"--preset {args.preset} sets the acceleration knobs itself; "
            f"drop {', '.join(clashing)} (or drop --preset and set knobs "
            f"manually)"
        )


def _launched() -> bool:
    """This process is a rank of a launched job (FPG_* or torch's launcher)."""
    return any(os.environ.get(k) for k in _LAUNCH_ENV + ("WORLD_SIZE",))


def _spawn_ranks(command: str, argv, n: int, device: str, flag: str) -> None:
    """Run `command argv` as the n ranks of one job on this machine: one
    process a rank, on cards 0..n-1 (NCCL), on cuda:0 under FPG_BACKEND=gloo,
    or on the CPU (gloo), joined through FPG_COORDINATOR / FPG_NUM_PROCESSES
    / FPG_PROCESS_ID. A rank that fails stops the others, and the exit code
    is the first failure's."""
    import torch

    from .core.device import resolve_device
    from .core.dist import SpawnError, free_port, spawn

    if resolve_device(device).type == "cuda" and n > torch.cuda.device_count() and \
            os.environ.get("FPG_BACKEND") != "gloo":
        raise RuntimeError(f"--{flag} {n} runs a rank a card, but {torch.cuda.device_count()} "
                           f"card{'s are' if torch.cuda.device_count() != 1 else ' is'} visible")
    port = free_port()
    try:
        spawn([[sys.executable, "-m", "faceposegenerator_tpu_torch.cli", command, *argv]] * n,
              lambda i: dict(FPG_COORDINATOR=f"127.0.0.1:{port}", FPG_NUM_PROCESSES=str(n), FPG_PROCESS_ID=str(i),
                             LOCAL_RANK=str(i)))
    except SpawnError as e:
        raise SystemExit(e.returncode) from None


def _ranks_note(mesh) -> str:
    """", N data-parallel ranks over <backend>" for a job's mesh."""
    import torch.distributed as dist

    if mesh is None:
        return ""
    backend = dist.get_backend() if dist.is_available() and dist.is_initialized() else "one process"
    return f", {mesh.data} data-parallel rank{'s' if mesh.data > 1 else ''} over {backend}"


def _job_mesh(flag: str, n: int, device):
    """The ("data",) mesh of this launched job's ranks for `--flag n`."""
    from .core import dist
    from .core.mesh import make_mesh

    info = dist.init_distributed(platform=device.type)
    if n != info.process_count:
        raise ValueError(f"--{flag} {n} in a job of {info.process_count} ranks: they must agree")
    return make_mesh(data=n, device=dist.device() or device)


def _iresnet(cfg, device, weights=None, seed=0, dtype=None):
    """The port's IResNet of `cfg` on `device`: from an insightface `.pth`
    state dict (already loaded) when given, else random from `seed`."""
    import torch

    from .bridge.jax_params import load_jax_params
    from .bridge.torch_weights import convert_iresnet_state_dict
    from .models import iresnet

    model = iresnet.IResNet(cfg, device=device, dtype=dtype or torch.float32, seed=seed)
    if weights is not None:
        load_jax_params(model, *convert_iresnet_state_dict(weights, cfg))
    return model


def _fiqa_nets(network, weights_path, device):
    """CR-FIQA's backbone and quality head: from a checkpoint, or random
    (seeds 0 and 1)."""
    from .evaluation import fiqa
    from .models import iresnet

    cfg = iresnet.config_for(network)
    if weights_path:
        from .bridge.jax_params import load_jax_params
        from .bridge.torch_weights import load_torch_pth

        sd = load_torch_pth(weights_path)
        return (_iresnet(cfg, device, sd),
                load_jax_params(fiqa.init_qs_head(device=device), fiqa.convert_qs_from_state_dict(sd)))
    return _iresnet(cfg, device, seed=0), fiqa.init_qs_head(device=device, seed=1)


def _load_bins(specs):
    from .evaluation import verification

    bins = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        bins[name] = verification.load_bin(path)
    return bins


def cmd_train_idbooth(argv):
    ap = argparse.ArgumentParser(prog="train-idbooth")
    _add_common(ap)
    ap.add_argument("--source_folder", required=True)
    ap.add_argument("--output_folder", default="Trained_LoRA_Models")
    ap.add_argument("--class_data_dir", default=None)
    ap.add_argument("--embeds_root", default=None)
    ap.add_argument("--arcface_weights", default=None)
    ap.add_argument("--losses", nargs="+", default=["", "identity", "triplet_prior"])
    ap.add_argument("--num_train_epochs", type=int, default=32)
    ap.add_argument("--lora_rank", type=int, default=4)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument(
        "--vmap_identities", type=int, default=1,
        help="train K identities concurrently in one stacked step "
        "(K independent fine-tunes; see training.multi_identity)",
    )
    ap.add_argument(
        "--identity_parallel", type=int, default=0, metavar="N",
        help="shard the K stacked identities over an N-rank mesh, a card "
        "a rank (requires --vmap_identities)",
    )
    _add_device(ap)
    args = ap.parse_args(argv)
    if args.identity_parallel and args.vmap_identities < 2:
        ap.error("--identity_parallel requires --vmap_identities K >= 2")
    if args.model_dir is None:
        ap.error("--model_dir with SD2.1 weights is required for real training")
    if args.identity_parallel > 1 and not _launched():
        return _spawn_ranks("train-idbooth", argv, args.identity_parallel, args.device, "identity_parallel")

    from .core.device import resolve_device
    from .core.dist import maybe_init_from_env

    maybe_init_from_env(platform=args.device)
    device = resolve_device(args.device)
    extra = {}
    if args.identity_parallel:
        extra["mesh"] = _job_mesh("identity_parallel", args.identity_parallel, device)

    from .data.tokenizer import CLIPTokenizer
    from .pipelines.txt2img import StableDiffusionPipeline
    from .training import idbooth, idbooth_driver

    cfg = idbooth.IDBoothConfig(
        losses_to_test=tuple(args.losses),
        num_train_epochs=args.num_train_epochs,
        lora_rank=args.lora_rank,
        learning_rate=args.learning_rate,
        resolution=args.resolution,
        seed=args.seed,
    )
    pipe = StableDiffusionPipeline.from_pretrained(args.model_dir, device=device)
    m = pipe.models
    bundle = idbooth.ModelBundle(text_cfg=m.text_cfg, unet_cfg=m.unet_cfg, vae_cfg=m.vae_cfg)
    weights = None
    if args.arcface_weights:
        from .bridge.torch_weights import load_torch_pth

        weights = load_torch_pth(args.arcface_weights)
    dtype = pipe.policy.param_dtype
    frozen = dict(pipe.nets, arcface=_iresnet(bundle.arcface_cfg, device, weights, seed=0, dtype=dtype))
    tokenizer = CLIPTokenizer.from_pretrained(os.path.join(args.model_dir, "tokenizer"))
    idbooth_driver.run_experiment_sweep(
        cfg, bundle, frozen, args.source_folder, args.output_folder,
        tokenizer=tokenizer, embeds_root=args.embeds_root, class_dir=args.class_data_dir,
        vmap_identities=args.vmap_identities, **extra,
    )


def _parse_interval(spec):
    """"I0:I1" → (int, int) step-index guidance interval, or None."""
    if spec is None:
        return None
    lo, _, hi = str(spec).partition(":")
    return (int(lo), int(hi))


def cmd_generate(argv):
    ap = argparse.ArgumentParser(prog="generate")
    _add_common(ap)
    ap.add_argument("--lora_root", required=True)
    ap.add_argument("--output", default="Generated_Samples")
    ap.add_argument("--gender_dict", default=None)
    ap.add_argument("--checkpoint", default="checkpoint-31-6400")
    ap.add_argument("--num_prompts", type=int, default=21)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--guidance", type=float, default=5.0)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument(
        "--eval", action="store_true",
        help="score CR-FIQA + 6DRepNet pose on the batches on the card while "
             "generating (no PNG re-read); writes <output>/eval/fiqa_scores.txt "
             "and pose_stats.json",
    )
    ap.add_argument("--fiqa_weights", default=None, help="CR-FIQA .pth for --eval")
    ap.add_argument("--fiqa_network", default="r100")
    ap.add_argument(
        "--data_parallel", type=int, default=0, metavar="N",
        help="generate over an N-rank data-parallel mesh, a card a rank "
             "(batch_size must divide N)",
    )
    ap.add_argument(
        "--pack_variants", action="store_true",
        help="pack all model variants' prompts into shared fixed-shape "
             "batches with per-sample LoRA adapters (cross-variant noise "
             "identity preserved per prompt)",
    )
    ap.add_argument(
        "--deepcache", type=int, default=1, metavar="K",
        help="OPT-IN DeepCache approximation: full UNet every K-th denoise "
             "step, shallow-blocks + cached-deep-feature splice otherwise "
             "(1 = exact)",
    )
    ap.add_argument("--deepcache_depth", type=int, default=1)
    ap.add_argument(
        "--tome", type=float, default=0.0, metavar="RATIO",
        help="OPT-IN ToMe token merging before >=4096-token UNet "
             "self-attention (0.0 = exact; composable with --deepcache)",
    )
    ap.add_argument(
        "--cfg_interval", default=None, metavar="I0:I1",
        help="OPT-IN guidance interval (arXiv:2404.07724): apply CFG only "
             "at step indices [I0, I1); cond-only half-batch UNet outside",
    )
    ap.add_argument(
        "--quantize", default=None, choices=["w8a8", "w8a8+vae"],
        help="OPT-IN int8 UNet weights+activations (ops/quant.py, kernel "
             "K7); LoRA adapters still apply in bf16",
    )
    ap.add_argument(
        "--quant_calibrate", type=int, default=0, metavar="STEPS",
        help="with --quantize: freeze STATIC per-tensor activation scales "
             "from an eager STEPS-step calibration denoise "
             "(pipe.calibrate_quant) — removes the dynamic amax passes",
    )
    ap.add_argument(
        "--preset", default=None, metavar="NAME",
        help="named, quality-gated acceleration stack (pipelines/presets.py: "
             "'turbo' throughput / 'latency' batch-1) — sets scheduler, "
             "steps, and the turbo knobs; mutually exclusive with the "
             "individual turbo flags",
    )
    _add_device(ap)
    args = ap.parse_args(argv)

    preset = None
    if args.preset:
        from .pipelines.presets import get_preset

        preset = get_preset(args.preset)
        _reject_preset_conflicts(
            ap, args,
            dict(deepcache=1, tome=0.0, cfg_interval=None, quantize=None,
                 quant_calibrate=0, steps=30),
        )
    if args.data_parallel and args.batch_size % args.data_parallel != 0:
        ap.error(f"--batch_size {args.batch_size} must divide "
                 f"--data_parallel {args.data_parallel}")
    if args.data_parallel > 1 and not _launched():
        return _spawn_ranks("generate", argv, args.data_parallel, args.device, "data_parallel")

    from .core.device import resolve_device
    from .core.dist import maybe_init_from_env

    maybe_init_from_env(platform=args.device)
    device = resolve_device(args.device)
    mesh = None
    if args.data_parallel:
        mesh = _job_mesh("data_parallel", args.data_parallel, device)

    from .pipelines.sweep import run_sweep
    from .pipelines.txt2img import StableDiffusionPipeline

    pipe = StableDiffusionPipeline.from_pretrained(args.model_dir, device=device)
    if preset is not None:
        sample_kw = preset.apply(pipe)
        args.steps = preset.steps
        args.deepcache = sample_kw.get("deepcache_interval", 1)
        args.deepcache_depth = sample_kw.get("deepcache_depth", 1)
        civ = sample_kw.get("cfg_interval")
        args.cfg_interval = f"{civ[0]}:{civ[1]}" if civ else None
    else:
        pipe.set_scheduler("ddpm")
    if args.quantize:
        pipe.quantize(args.quantize)
        if args.quant_calibrate:
            pipe.calibrate_quant(
                ["face portrait photo of sks person"], steps=args.quant_calibrate
            )
    if mesh is not None:
        pipe.to_mesh(mesh)
    # every rank renders its rows and holds the whole batch; rank 0 writes
    coordinator = mesh is None or mesh.rank == 0

    on_images = None
    finish_eval = None
    if args.eval and coordinator:
        import numpy as np
        import torch

        from .evaluation import fiqa, pose

        quality_fn_u8 = fiqa.make_quality_fn_u8(*_fiqa_nets(args.fiqa_network, args.fiqa_weights, device))
        pose_fn_u8 = pose.make_pose_fn_u8(pose.init_sixdrepnet(device=device, seed=2))

        dev_evals, names, idents = [], [], []

        def on_images(model_name, identity, batch_names, dev_imgs):
            # (pitch, yaw, roll, quality) a slot, kept on the card until finish_eval
            _, q = quality_fn_u8(dev_imgs)
            dev_evals.append(torch.cat([pose_fn_u8(dev_imgs).float(), q.float()[:, None]], dim=1))
            for n in batch_names:
                if n is None:  # packed-mode pad slot: keep row alignment
                    names.append(None)
                    idents.append(None)
                elif model_name is None:  # packed: n is "<model>/<file>"
                    m, f = n.split("/", 1)
                    names.append(f"{m}/{identity}/{f}")
                    idents.append(f"{m}/{identity}")
                else:
                    names.append(f"{model_name}/{identity}/{n}")
                    idents.append(f"{model_name}/{identity}")

        def finish_eval():
            evals = torch.cat(dev_evals).cpu().numpy() if dev_evals else np.zeros((0, 4))
            eval_dir = os.path.join(args.output, "eval")
            os.makedirs(eval_dir, exist_ok=True)
            n_real = 0
            with open(os.path.join(eval_dir, "fiqa_scores.txt"), "w") as f:
                for n, s in zip(names, evals[:, 3]):
                    if n is not None:
                        f.write(f"{n} {float(s)}\n")
                        n_real += 1
            per_id = {}
            for ident, p in zip(idents, evals[:, :3]):
                if ident is not None:
                    per_id.setdefault(ident, []).append([float(v) for v in p])
            pose.aggregate_poses(per_id, os.path.join(eval_dir, "pose_stats.json"))
            print(json.dumps({"eval": eval_dir, "images": n_real}))

    run_sweep(
        pipe, args.lora_root, args.output,
        gender_dict_path=args.gender_dict, checkpoint=args.checkpoint,
        num_prompts=args.num_prompts, num_inference_steps=args.steps,
        guidance_scale=args.guidance, batch_size=args.batch_size, seed=args.seed,
        on_images=on_images, pack_variants=args.pack_variants,
        deepcache_interval=args.deepcache, deepcache_depth=args.deepcache_depth,
        tome_ratio=args.tome, cfg_interval=_parse_interval(args.cfg_interval), write=coordinator,
    )
    if finish_eval is not None:
        finish_eval()


def cmd_extract_embeds(argv):
    ap = argparse.ArgumentParser(prog="extract-embeds")
    ap.add_argument("--images_root", required=True)
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--arcface_weights", default=None)
    ap.add_argument("--mtcnn_weights", default=None)
    ap.add_argument("--streaming", action="store_true",
                    help="pipelined path: decode → batched detect → crop+embed "
                         "on the card in one call (uniform-size datasets)")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument(
        "--quantize", default=None, choices=["w8a8"],
        help="OPT-IN int8 IResNet body (ops/quant.py; stem/SE/fc stay bf16)",
    )
    ap.add_argument(
        "--quant_calibrate", type=int, default=0, metavar="BATCHES",
        help="with --quantize: freeze STATIC activation scales from "
             "forwards over BATCHES random calibration batches",
    )
    _add_device(ap)
    args = ap.parse_args(argv)

    from .core.device import resolve_device

    device = resolve_device(args.device)

    from .bridge.torch_weights import load_torch_pth
    from .models import iresnet, mtcnn
    from .pipelines.embed_extract import (
        calibrate_embed_quant,
        extract_embeddings_streaming,
        extract_folder_embeddings,
        make_arcface_embed_fn,
        make_crop_embed_fn,
    )

    weights = load_torch_pth(args.arcface_weights) if args.arcface_weights else None
    model = _iresnet(iresnet.IResNetConfig(), device, weights, seed=0)
    if args.quantize:
        import torch

        from .ops.quant import quantize_iresnet

        quantize_iresnet(model)
        if args.quant_calibrate:
            # ArcFace inputs are (x/255 - .5)/.5 ∈ [-1,1]; BN-stabilized
            # internals make the scales data-insensitive, so uniform-noise
            # calibration batches are serviceable without touching the
            # dataset (pass real crops via calibrate_embed_quant for the
            # by-the-book version)
            cal = [
                torch.rand((32, 112, 112, 3), generator=torch.Generator().manual_seed(1000 + i)) * 2.0 - 1.0
                for i in range(args.quant_calibrate)
            ]
            calibrate_embed_quant(model, cal)
    detector = None
    if args.mtcnn_weights:
        detector = mtcnn.MTCNN(mtcnn.convert_mtcnn_state_dict(load_torch_pth(args.mtcnn_weights)), device=device)
    if args.streaming:
        crop_embed = make_crop_embed_fn(model, device=device)
        report = extract_embeddings_streaming(
            args.images_root, args.output_root, crop_embed, detector,
            batch_size=args.batch_size,
        )
    else:
        embed_fn = make_arcface_embed_fn(model, device=device)
        report = extract_folder_embeddings(
            args.images_root, args.output_root, embed_fn, detector
        )
    print(json.dumps({"missing": len(report["files_without_faces"])}))


def cmd_align_crop(argv):
    ap = argparse.ArgumentParser(prog="align-crop")
    ap.add_argument("--input_root", required=True)
    ap.add_argument("--output_root", required=True)
    ap.add_argument("--mtcnn_weights", default=None)
    _add_device(ap)
    args = ap.parse_args(argv)

    from .core.device import resolve_device

    device = resolve_device(args.device)

    from .data.align_driver import align_dataset_sweep
    from .models import mtcnn

    params = None
    if args.mtcnn_weights:
        from .bridge.torch_weights import load_torch_pth

        params = mtcnn.convert_mtcnn_state_dict(load_torch_pth(args.mtcnn_weights))
    detector = mtcnn.MTCNN(params, device=device)
    reports = align_dataset_sweep(args.input_root, args.output_root, detector)
    print(json.dumps({m: len(r["missing_images"]) for m, r in reports.items()}))


def cmd_train_fr(argv):
    ap = argparse.ArgumentParser(prog="train-fr")
    ap.add_argument("--dataset_root", required=True, help="flat `<label>_<img>` dir")
    ap.add_argument("--output", default="FR_runs")
    ap.add_argument("--network", default="iresnet50")
    ap.add_argument("--loss", default="AdaFace")
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--num_epochs", type=int, default=200)
    ap.add_argument("--augment", default="hf")
    ap.add_argument("--val_bin", action="append", default=[], help="name=path.bin")
    _add_device(ap)
    args = ap.parse_args(argv)

    from .core.device import resolve_device
    from .core.dist import maybe_init_from_env

    maybe_init_from_env(platform=args.device)
    device = resolve_device(args.device)

    from .data.augment import get_aug_policy
    from .data.fr_dataset import FlatDirDataset
    from .training import fr, fr_driver

    cfg = fr.FRConfig(
        network=args.network, loss=args.loss, batch_size=args.batch_size,
        num_epochs=args.num_epochs,
    )
    dataset = FlatDirDataset(args.dataset_root, augment=get_aug_policy(args.augment))
    bins = _load_bins(args.val_bin)
    res = fr_driver.train_fr_run(cfg, dataset, args.output, val_bins=bins or None, device=device)
    print(json.dumps({"best_acc": res.get("best_acc")}))


def cmd_test_fr(argv):
    ap = argparse.ArgumentParser(prog="test-fr")
    ap.add_argument("--backbone", required=True)
    ap.add_argument("--network", default="iresnet50")
    ap.add_argument("--num_classes", type=int, required=True)
    ap.add_argument("--output_json", default="test_FR_results.json")
    ap.add_argument("--val_bin", action="append", default=[], required=False)
    _add_device(ap)
    args = ap.parse_args(argv)

    from .core.device import resolve_device

    device = resolve_device(args.device)

    from .training import fr, fr_driver

    cfg = fr.FRConfig(network=args.network, num_classes=args.num_classes)
    res = fr_driver.test_fr_run(cfg, args.backbone, _load_bins(args.val_bin), args.output_json, device=device)
    print(json.dumps(res))


def cmd_dgm_eval(argv):
    from .evaluation.dgm import main as dgm_main

    dgm_main(argv)


def cmd_pyeer(argv):
    ap = argparse.ArgumentParser(prog="pyeer")
    ap.add_argument("--synth_embeds_dir", required=True, help="dir of <id>_<img>.npy")
    ap.add_argument("--real_embeds_dir", default=None)
    ap.add_argument("--output", default="pyeer_out")
    ap.add_argument("--name", default="run")
    ap.add_argument("--min_samples", type=int, default=8)
    ap.add_argument("--skip_among", type=int, default=18)
    ap.add_argument("--skip_vs_real", type=int, default=17)
    args = ap.parse_args(argv)

    import numpy as np

    from .evaluation.pyeer_driver import analyse_from_embedding_files

    def load_dir(d):
        names, embs = [], []
        for f in sorted(os.listdir(d)):
            if f.endswith(".npy"):
                names.append(os.path.splitext(f)[0])
                embs.append(np.load(os.path.join(d, f)))
        return np.stack(embs), names

    synth, snames = load_dir(args.synth_embeds_dir)
    real, rnames = (None, None)
    if args.real_embeds_dir:
        real, rnames = load_dir(args.real_embeds_dir)
    res = analyse_from_embedding_files(
        synth, snames, real, rnames, output_dir=args.output, name=args.name,
        min_samples=args.min_samples, skip_among=args.skip_among,
        skip_vs_real=args.skip_vs_real,
    )
    if not res:
        print(
            f"warning: no score pairs produced — every identity may have fewer "
            f"than --min_samples={args.min_samples} embeddings",
            file=sys.stderr,
        )
    print(json.dumps(res, indent=2))


def cmd_analyze(argv):
    """Dataset-distribution / training-log analysis
    (`Evaluation/PyEER_analysis/analysis_scripts/` live parts:
    `analyse_dataset.py` gen/imp distribution + `plot_distributions.py`
    histogram + `plot_logs.py` curves). One of:
      --embeds_dir: per-identity embeddings → genuine/impostor score split
        (reference sampling convention), full EER stats JSON, score .npz,
        histogram PNG with the EER-threshold line;
      --logs: a core.trackers scalars.jsonl → per-metric curve PNGs."""
    ap = argparse.ArgumentParser(prog="analyze")
    ap.add_argument("--embeds_dir", default=None,
                    help="per-id .npy arrays, per-id subdirs, or flat <id>_<img>.npy")
    ap.add_argument("--logs", default=None, help="scalars.jsonl from core.trackers")
    ap.add_argument("--metric", action="append", default=[],
                    help="with --logs: metric to plot (repeatable; default all)")
    ap.add_argument("--output", default="analysis_out")
    ap.add_argument("--name", default="dataset")
    ap.add_argument("--num_ids", type=int, default=0, help="0 = all")
    ap.add_argument("--num_imgs", type=int, default=0, help="per id; 0 = all")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (args.embeds_dir or args.logs):
        ap.error("pass --embeds_dir and/or --logs")

    from .evaluation.analysis import dataset_distribution_report, plot_training_logs

    out = {}
    if args.embeds_dir:
        out["distribution"] = dataset_distribution_report(
            args.embeds_dir, args.output, name=args.name,
            num_ids=args.num_ids, num_imgs=args.num_imgs, seed=args.seed,
        )
    if args.logs:
        out["logs"] = plot_training_logs(
            args.logs, args.output, metrics=args.metric or None, name=args.name
        )
    print(json.dumps(out, indent=2))


def cmd_fiqa(argv):
    ap = argparse.ArgumentParser(prog="fiqa")
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--output", default="fiqa_scores.txt")
    ap.add_argument("--weights", default=None, help="CR-FIQA checkpoint (.pth)")
    ap.add_argument("--network", default="r100")
    _add_device(ap)
    args = ap.parse_args(argv)

    from .core.device import resolve_device

    device = resolve_device(args.device)

    from .evaluation import fiqa

    fn = fiqa.make_quality_fn(*_fiqa_nets(args.network, args.weights, device))
    scores = fiqa.score_dataset(args.image_dir, fn, args.output)
    print(json.dumps({"scored": len(scores)}))


def cmd_pose(argv):
    ap = argparse.ArgumentParser(prog="pose")
    ap.add_argument("--image_root", required=True)
    ap.add_argument("--output_json", default="poses.json")
    _add_device(ap)
    args = ap.parse_args(argv)

    from .core.device import resolve_device

    device = resolve_device(args.device)

    from .evaluation import pose

    fn = pose.make_pose_fn(pose.init_sixdrepnet(device=device, seed=0))
    res = pose.estimate_dataset_poses(args.image_root, fn, args.output_json)
    print(json.dumps(res["global"]))


def cmd_parity(argv):
    """Real-checkpoint step-parity runbook: not ported yet."""
    raise NotImplementedError(
        "parity needs the torch mirror and the full-chain leg, which the port does not have yet "
        "(ROADMAP.md queue 1, items 17-18: bridge/full_chain.py, bridge/torch_mirror.py)")


def cmd_parity_all(argv):
    """Day-one real-weights runbook over every parity leg: not ported yet."""
    raise NotImplementedError(
        "parity-all needs the torch mirror and the full-chain leg, which the port does not have yet "
        "(ROADMAP.md queue 1, items 17-18: bridge/full_chain.py, bridge/torch_mirror.py)")


def cmd_serve(argv):
    """Serving: fixed-shape batching HTTP server over the sampler
    (see serving/engine.py). LoRA checkpoints are registered at startup as
    --lora name=path pairs and selected per request via lora_id."""
    ap = argparse.ArgumentParser(prog="serve")
    _add_common(ap)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=50.0)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--guidance", type=float, default=5.0)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--scheduler", choices=("ddpm", "dpm"), default="ddpm")
    ap.add_argument(
        "--lora", action="append", default=[], metavar="NAME=CKPT_DIR",
        help="register a LoRA checkpoint (repeatable)",
    )
    ap.add_argument(
        "--data_parallel", type=int, default=0, metavar="N",
        help="serve over an N-device data-parallel mesh, a card a rank "
             "(batch_size must divide N); 0 = single device",
    )
    ap.add_argument("--max_queue", type=int, default=None)
    ap.add_argument("--request_timeout_s", type=float, default=None)
    ap.add_argument(
        "--multi_lora", action="store_true",
        help="heterogeneous batching: each request slot rides its own "
             "adapter (per-sample LoRA), so mixed-identity traffic packs "
             "full batches instead of fragmenting per LoRA",
    )
    ap.add_argument(
        "--rolling", action="store_true",
        help="continuous batching (serving/rolling.py): a persistent slot "
             "buffer where every request advances its own denoise step per "
             "tick; implies per-slot adapters",
    )
    ap.add_argument(
        "--deepcache", type=int, default=1, metavar="K",
        help="OPT-IN DeepCache approximation: full UNet every K-th denoise "
             "step, shallow-blocks + cached-deep-feature splice otherwise "
             "(1 = exact)",
    )
    ap.add_argument("--deepcache_depth", type=int, default=1)
    ap.add_argument(
        "--tome", type=float, default=0.0, metavar="RATIO",
        help="OPT-IN ToMe token merging before >=4096-token UNet "
             "self-attention (0.0 = exact; composable with --deepcache)",
    )
    ap.add_argument(
        "--parallel_window", type=int, default=0, metavar="W",
        help="OPT-IN latency mode: parallel-in-time Picard sampling over a "
             "W-step window (diffusion/parallel_sampler.py; ddpm only); "
             "meant for --batch_size 1",
    )
    ap.add_argument("--parallel_tol", type=float, default=0.1)
    ap.add_argument(
        "--cfg_interval", default=None, metavar="I0:I1",
        help="OPT-IN guidance interval (arXiv:2404.07724): apply CFG only "
             "at step indices [I0, I1); cond-only half-batch UNet outside",
    )
    ap.add_argument(
        "--quantize", default=None, choices=["w8a8", "w8a8+vae"],
        help="OPT-IN int8 UNet weights+activations (ops/quant.py); "
             "registered LoRA adapters still apply in bf16",
    )
    ap.add_argument(
        "--quant_calibrate", type=int, default=0, metavar="STEPS",
        help="with --quantize: freeze STATIC per-tensor activation scales "
             "from an eager STEPS-step calibration denoise before serving",
    )
    ap.add_argument(
        "--quant_scales", default=None, metavar="FILE",
        help="with --quantize: attach saved static act scales from FILE "
             "(pipe.load_quant_scales); with --quant_calibrate, SAVE the "
             "freshly calibrated scales to FILE instead",
    )
    ap.add_argument(
        "--preset", default=None, metavar="NAME",
        help="named, quality-gated acceleration stack (pipelines/presets.py: "
             "'turbo' throughput / 'latency' batch-1) — sets scheduler, "
             "steps, and the turbo knobs; mutually exclusive with the "
             "individual turbo flags and --rolling (rolling composes only "
             "with --quantize)",
    )
    _add_device(ap)
    args = ap.parse_args(argv)

    preset = None
    if args.preset:
        from .pipelines.presets import get_preset

        preset = get_preset(args.preset)
        if args.rolling:
            ap.error("--preset does not compose with --rolling (DeepCache "
                     "state is step-synchronized across slots; rolling "
                     "composes with --quantize and --scheduler dpm instead)")
        _reject_preset_conflicts(
            ap, args,
            dict(deepcache=1, tome=0.0, cfg_interval=None, quantize=None,
                 quant_calibrate=0, steps=30, scheduler="ddpm",
                 parallel_window=0),
        )
    if args.data_parallel and args.batch_size % args.data_parallel != 0:
        ap.error(f"--batch_size {args.batch_size} must divide "
                 f"--data_parallel {args.data_parallel}")
    if args.data_parallel > 1 and not _launched():
        return _spawn_ranks("serve", argv, args.data_parallel, args.device, "data_parallel")

    from .core.device import resolve_device
    from .core.dist import maybe_init_from_env

    maybe_init_from_env(platform=args.device)
    device = resolve_device(args.device)
    mesh = None
    if args.data_parallel:
        mesh = _job_mesh("data_parallel", args.data_parallel, device)
    front = mesh is None or mesh.rank == 0

    from .pipelines.txt2img import StableDiffusionPipeline
    from .serving import SamplerServer
    from .serving.http_api import serve_http, start_http_background

    pipe = StableDiffusionPipeline.from_pretrained(args.model_dir, device=device)
    if preset is not None:
        sample_kw = preset.apply(pipe)
        args.scheduler = preset.scheduler
        args.steps = preset.steps
        args.deepcache = sample_kw.get("deepcache_interval", 1)
        args.deepcache_depth = sample_kw.get("deepcache_depth", 1)
        civ = sample_kw.get("cfg_interval")
        args.cfg_interval = f"{civ[0]}:{civ[1]}" if civ else None
    else:
        pipe.set_scheduler(args.scheduler)
    # every rank quantizes; the server gives every rank rank 0's static scales
    if args.quantize:
        pipe.quantize(args.quantize)
        if args.quant_calibrate:
            if front:
                pipe.calibrate_quant(
                    ["face portrait photo of sks person"], steps=args.quant_calibrate
                )
                if args.quant_scales:
                    pipe.save_quant_scales(args.quant_scales)
        elif args.quant_scales:
            pipe.load_quant_scales(args.quant_scales)
    common = dict(batch_size=args.batch_size, max_wait_s=args.max_wait_ms / 1e3,
                  num_inference_steps=args.steps, guidance_scale=args.guidance,
                  height=args.size, width=args.size, scheduler=args.scheduler,
                  max_queue=args.max_queue, request_timeout_s=args.request_timeout_s, mesh=mesh)
    if args.rolling:
        from .serving import RollingServer

        server = RollingServer(pipe, **common)
    else:
        server = SamplerServer(
            pipe, multi_lora=args.multi_lora,
            deepcache_interval=args.deepcache, deepcache_depth=args.deepcache_depth,
            tome_ratio=args.tome,
            parallel_window=args.parallel_window, parallel_tolerance=args.parallel_tol,
            cfg_interval=_parse_interval(args.cfg_interval), **common,
        )
    if not front:  # follow rank 0's batches until its stop; a failure exits non-zero
        server.join()
        return
    for spec in args.lora:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--lora expects NAME=CKPT_DIR, got {spec!r}")
        server.register_lora(name, path)
    print(f"serving on http://{args.host}:{args.port} (batch {args.batch_size}, "
          f"{args.steps} steps, loras: {[s.split('=')[0] for s in args.lora] or '[]'}"
          f"{_ranks_note(mesh)})", flush=True)
    if mesh is None:
        serve_http(server, args.host, args.port)
        return
    # over a mesh: HTTP on a thread; this one waits on the server, whose
    # failure (the ranks out of step) ends the command non-zero
    httpd, _ = start_http_background(server, args.host, args.port)
    try:
        server.join()
    finally:
        httpd.shutdown()
        httpd.server_close()


def cmd_accel_report(argv):
    """Quality report for the opt-in acceleration modes on YOUR checkpoint:
    renders the same (prompt, seed) set exact and under each --mode spec,
    reports per-image PSNR + optional ArcFace identity cosine + the
    bit-identical fraction (evaluation/accel_report.py)."""
    ap = argparse.ArgumentParser(prog="accel-report")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--lora_dir", default=None, help="optional LoRA checkpoint to load first")
    ap.add_argument(
        "--mode", action="append", default=[], metavar="SPEC",
        help="mode spec, repeatable: deepcache=3, tome=0.5, cfg_interval=5:20, "
             "quantize=w8a8, attn=flash_int8, scheduler=dpm:20, "
             "or compositions joined with '+' "
             "(e.g. deepcache=3+cfg_interval=5:20)",
    )
    ap.add_argument("--prompt", action="append", default=[],
                    help="prompt, repeatable (default: one face-portrait prompt)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--guidance", type=float, default=5.0)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--scheduler", default="ddpm", choices=["ddpm", "dpm"])
    ap.add_argument("--arcface_pth", default=None,
                    help="ArcFace .pth — enables the identity-cosine rows")
    ap.add_argument("--arcface_network", default="r100")
    ap.add_argument(
        "--preset", action="append", default=[], metavar="NAME",
        help="report a named preset (pipelines/presets.py) — expands to the "
             "mode spec measuring EXACTLY that stack (Preset.mode_spec()); "
             "repeatable, composable with --mode",
    )
    ap.add_argument(
        "--seed_floor", action="store_true",
        help="also report the unrelated-sample PSNR floor (exact at seed vs "
             "exact at seed+1) — the reference point mode PSNRs are read "
             "against",
    )
    ap.add_argument("--output", default=None, help="write the report JSON here (also printed)")
    _add_device(ap)
    args = ap.parse_args(argv)
    if args.preset:
        from .pipelines.presets import get_preset

        args.mode.extend(get_preset(n).mode_spec() for n in args.preset)
    if not args.mode:
        ap.error("pass at least one --mode (or --preset)")

    from .core.device import resolve_device

    device = resolve_device(args.device)

    from .evaluation.accel_report import compare_modes, make_embed_fn_u8
    from .pipelines.txt2img import StableDiffusionPipeline

    pipe = StableDiffusionPipeline.from_pretrained(args.model_dir, device=device)
    pipe.set_scheduler(args.scheduler)
    if args.lora_dir:
        pipe.load_lora_weights(args.lora_dir)

    embed_fn = None
    if args.arcface_pth:
        from .bridge.torch_weights import load_torch_pth
        from .models import iresnet

        raw = load_torch_pth(args.arcface_pth)  # unwraps "state_dict" / "model" containers
        embed_fn = make_embed_fn_u8(_iresnet(iresnet.config_for(args.arcface_network), device, raw))

    prompts = args.prompt or ["photo of a person, portrait, high quality"]
    report = compare_modes(
        pipe, args.mode, prompts=prompts, seed=args.seed,
        num_inference_steps=args.steps, guidance_scale=args.guidance,
        height=args.height, width=args.width, embed_fn=embed_fn,
        seed_floor=args.seed_floor,
    )
    out = json.dumps(report, indent=2)
    print(out)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)


def cmd_pod_rehearsal(argv):
    """Multi-process pod-launch rehearsal (`parallel/pod_rehearsal.py`):
    JAX's flags, plus `--device` and `--backend`."""
    from .parallel import pod_rehearsal

    pod_rehearsal.main(argv)


COMMANDS = {
    "parity": cmd_parity,
    "pod-rehearsal": cmd_pod_rehearsal,
    "parity-all": cmd_parity_all,
    "serve": cmd_serve,
    "train-idbooth": cmd_train_idbooth,
    "generate": cmd_generate,
    "extract-embeds": cmd_extract_embeds,
    "align-crop": cmd_align_crop,
    "train-fr": cmd_train_fr,
    "test-fr": cmd_test_fr,
    "dgm-eval": cmd_dgm_eval,
    "pyeer": cmd_pyeer,
    "analyze": cmd_analyze,
    "fiqa": cmd_fiqa,
    "pose": cmd_pose,
    "accel-report": cmd_accel_report,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(sorted(COMMANDS)))
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; available: {', '.join(sorted(COMMANDS))}")
        return 2
    COMMANDS[cmd](rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
