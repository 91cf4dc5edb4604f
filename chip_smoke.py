"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final result line:
  1. environment: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: every kernel under faceposegenerator_tpu_torch/csrc, with nvcc;
  3. kernels against plain: each kernel at every shape the main paths give
     it, bf16 unit-normal inputs from a seed, against its plain PyTorch
     version in fp32 on the same inputs (max abs err <= 2e-2, mean <= 2e-3;
     for the backward kernels, of each gradient's max abs; the forward's
     log-sum-exp within 1e-3), timed beside that plain
     version, the PyTorch library call (`scaled_dot_product_attention`
     forward or its backward through autograd: a yardstick, used nowhere in
     the port) and the card's bound. The sampling shapes (K1, K2 forward)
     first, then the train shapes (K1, K2 with the log-sum-exp; K5, K6);
  4. txt2img: StableDiffusionPipeline.from_random at SD2.1-base widths in
     bf16 with a rank-4 UNet LoRA, first against its own plain-attention
     path on a small input, then 3 requests at batch 8, 512², 30 DDPM steps,
     CFG 5.0, swapping the LoRA before the third; each request must launch
     the d=64 kernel 960 times and the wide kernel once;
  5. train: the ID-Booth train step at its op point (SD2.1-base widths,
     ArcFace r100, random bf16 frozen weights, fp32 rank-4 LoRA, batch 4
     with prior preservation = 8 images of 512², triplet_prior, AdamW +
     cosine + clip 1.0), first the kernel path against the plain-attention
     path on 2(+2) images of 128² (loss within 1e-2 relative, LoRA gradient
     cosine >= 0.99), then 3 train steps, each of which must launch K1 32,
     K2 2, and K5 and K6 32 and 1 times per pass, move the LoRA and leave
     the frozen weights untouched.
The line before the last is a JSON object with one entry per kernel; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

MAX_ERR, MEAN_ERR, LSE_ERR = 2e-2, 2e-3, 1e-3
# (name, B, H, Sq, Skv, D, launches per request) at the txt2img op point:
# batch 8 under CFG is 16 UNet rows; 30 steps; the VAE decodes 8 images.
SHAPES = [
    ("self L0", 16, 5, 4096, 4096, 64, 150),
    ("self L1", 16, 10, 1024, 1024, 64, 150),
    ("self L2", 16, 20, 256, 256, 64, 150),
    ("self mid", 16, 20, 64, 64, 64, 30),
    ("cross L0", 16, 5, 4096, 77, 64, 150),
    ("cross L1", 16, 10, 1024, 77, 64, 150),
    ("cross L2", 16, 20, 256, 77, 64, 150),
    ("cross mid", 16, 20, 64, 77, 64, 30),
    ("vae mid", 8, 1, 4096, 4096, 512, 1),
]
# (name, B, H, Sq, Skv, D, launches per train step) at the train op point: 8
# UNet rows (4 instance + 4 class images); per step 5 transformers at each
# of the three outer levels and 1 in the mid block, each with one self- and
# one cross-attention; the VAE encodes 8 images and decodes 4 (x̂0).
TRAIN_SHAPES = [
    ("self L0", 8, 5, 4096, 4096, 64, 5),
    ("self L1", 8, 10, 1024, 1024, 64, 5),
    ("self L2", 8, 20, 256, 256, 64, 5),
    ("self mid", 8, 20, 64, 64, 64, 1),
    ("cross L0", 8, 5, 4096, 77, 64, 5),
    ("cross L1", 8, 10, 1024, 77, 64, 5),
    ("cross L2", 8, 20, 256, 77, 64, 5),
    ("cross mid", 8, 20, 64, 77, 64, 1),
    ("vae encode mid", 8, 1, 4096, 4096, 512, 1),  # forward only (no_grad)
    ("vae decode mid", 4, 1, 4096, 4096, 512, 1),
]
# dense bf16 tensor-core FLOP/s and memory bytes/s, from NVIDIA's data sheets
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12), "H100": (989e12, 3.35e12)}
STEP_LAUNCHES = {"flash_fwd_d64": 32, "flash_fwd_wide": 2, "flash_bwd_d64_dkv": 32, "flash_bwd_d64_dq": 32,
                 "flash_bwd_wide_dkv": 1, "flash_bwd_wide_dq": 1}
REPLACES = {
    "flash_fwd_d64": "faceposegenerator_tpu/ops/flash_attention.py:258",
    "flash_fwd_wide": "faceposegenerator_tpu/ops/flash_attention.py:104",
    "flash_bwd_d64_dkv": "faceposegenerator_tpu/ops/flash_attention.py:711",
    "flash_bwd_d64_dq": "faceposegenerator_tpu/ops/flash_attention.py:777",
    "flash_bwd_wide_dkv": "faceposegenerator_tpu/ops/flash_attention.py:542",
    "flash_bwd_wide_dq": "faceposegenerator_tpu/ops/flash_attention.py:585",
}


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no peak rates known for {name!r}")


def time_ms(fn, torch, target_ms: float = 200.0) -> float:
    """Mean device time of fn() over repeated launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    n = max(3, min(100, int(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _inputs(torch, g, b, h, sq, skv, d):
    """bf16 unit-normal q, k, v; self-attention as strided views of one fused
    q/k/v projection, as the UNet makes them."""
    if sq == skv:
        qkv = torch.randn(b, sq, 3, h, d, generator=g, device="cuda").to(torch.bfloat16)
        return qkv.unbind(2)
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, skv, h, d, generator=g, device="cuda").to(torch.bfloat16) for _ in "kv")
    return q, k, v


def _bound(card, flops, nbytes):
    peak_flops, peak_bw = peaks(card)
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _err(out, ref):
    e = (out.float() - ref.float()).abs()
    return e.max().item(), e.mean().item()


def check_kernels(torch, fa, card, shapes=SHAPES, with_lse=False, per="request"):
    """The forward kernels at `shapes`, with the log-sum-exp if asked."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, b, h, sq, skv, d, per_run in shapes:
        kernel = fa.flash_fwd_d64 if d == 64 else fa.flash_fwd_wide
        name = "flash_fwd_d64" if d == 64 else "flash_fwd_wide"
        q, k, v = _inputs(torch, g, b, h, sq, skv, d)
        scale = d**-0.5
        out = kernel(q, k, v, scale, with_lse=with_lse)
        torch.cuda.synchronize()
        lse_err = None
        if with_lse:
            out, lse = out
            ref, ref_lse = fa.attention_plain_lse(q.float(), k.float(), v.float(), scale)
            lse_err = (lse - ref_lse).abs().max().item()
        else:
            ref = fa.attention_plain(q.float(), k.float(), v.float(), scale)
        max_err, mean_err = _err(out, ref)
        del ref
        plain = fa.attention_plain_lse if with_lse else fa.attention_plain
        ms = time_ms(lambda: kernel(q, k, v, scale, with_lse=with_lse), torch)
        plain_ms = time_ms(lambda: plain(q, k, v, scale), torch)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), torch)
        # q, k, v read once, o (and lse) written once
        nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv) + (4.0 * b * h * sq if with_lse else 0.0)
        bound_ms, bound_by = _bound(card, 4.0 * b * h * sq * skv * d, nbytes)
        row = dict(kernel=name, shape=label, lse=with_lse, B=b, H=h, Sq=sq, Skv=skv, D=d, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=max_err, mean_abs_err=mean_err, lse_max_err=lse_err, **{f"launches_per_{per}": per_run})
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        if not (max_err <= MAX_ERR and mean_err <= MEAN_ERR) or (with_lse and not lse_err <= LSE_ERR):
            fail(f"{name} at {label}: max abs err {max_err} mean {mean_err} lse err {lse_err}")
        del q, k, v, out
        torch.cuda.empty_cache()
    return rows


def check_backward(torch, fa, card, shapes):
    """K5/K6 at the train shapes: the forward's own o and lse, a unit-normal
    dO, each gradient against attention_bwd_plain in fp32 on the same
    inputs; each pass timed alone, the pair beside the plain backward and
    SDPA's backward through autograd on the same tensors."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, b, h, sq, skv, d, per_step in shapes:
        kind = "d64" if d == 64 else "wide"
        fwd, bwd = (fa.flash_fwd_d64, fa.flash_bwd_d64) if d == 64 else (fa.flash_fwd_wide, fa.flash_bwd_wide)
        q, k, v = _inputs(torch, g, b, h, sq, skv, d)
        do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(torch.bfloat16)
        scale = d**-0.5
        o, lse = fwd(q, k, v, scale, with_lse=True)
        grads = bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        refs = fa.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale)
        errs = [_err(x, r) for x, r in zip(grads, refs)]
        # the gate is relative to each gradient's max abs: a key's dk and dv sum
        # over every query, so at 77 keys they reach ~4 and bf16 rounding alone
        # exceeds an absolute 2e-2
        norms = [r.abs().max().item() for r in refs]
        del refs, grads
        torch.cuda.empty_cache()
        ms = {p: time_ms(lambda p=p: bwd(q, k, v, o, lse, do, scale, passes=(p,)), torch) for p in ("dkv", "dq")}
        pair_ms = time_ms(lambda: bwd(q, k, v, o, lse, do, scale), torch)
        plain_ms = time_ms(lambda: fa.attention_bwd_plain(q, k, v, o, lse, do, scale), torch)
        torch.cuda.empty_cache()
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        dot = do.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), torch)
        del out, qt, kt, vt
        # q, o, dO, dq (Sq rows) and k, v, dk, dv (Skv rows) in bf16, lse and D in fp32
        unit = b * h * sq * skv * d
        io = 2.0 * b * h * d
        pair_bound, pair_by = _bound(card, 10.0 * unit, io * (4 * sq + 4 * skv) + 8.0 * b * h * sq)
        # each pass alone: S, dP, dV, dK (dK/dV pass) or S, dP, dQ (dQ pass)
        dkv_bound, dkv_by = _bound(card, 8.0 * unit, io * (2 * sq + 4 * skv) + 8.0 * b * h * sq)
        dq_bound, dq_by = _bound(card, 6.0 * unit, io * (3 * sq + 2 * skv) + 8.0 * b * h * sq)
        (dq_max, dq_mean), (dk_max, dk_mean), (dv_max, dv_mean) = errs
        row = dict(kernel=f"flash_bwd_{kind}", shape=label, B=b, H=h, Sq=sq, Skv=skv, D=d,
                   dkv_ms=ms["dkv"], dq_ms=ms["dq"], pair_ms=pair_ms, plain_ms=plain_ms, library_ms=library_ms,
                   pair_bound_ms=pair_bound, pair_bound_by=pair_by, dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by,
                   dq_bound_ms=dq_bound, dq_bound_by=dq_by,
                   dq_err=[dq_max, dq_mean], dk_err=[dk_max, dk_mean], dv_err=[dv_max, dv_mean],
                   grad_max_abs=norms, launches_per_step=per_step)
        print("kernel " + json.dumps(row), flush=True)
        rows.append(row)
        for name, (mx, mean), n in zip(("dq", "dk", "dv"), errs, norms):
            if not (mx <= MAX_ERR * n and mean <= MEAN_ERR * n):
                fail(f"flash_bwd_{kind} {name} at {label}: max abs err {mx} mean {mean}, "
                     f"gradient max abs {n} (limits 2e-2 and 2e-3 of it)")
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    return rows


def make_lora(unet, seed, torch):
    """A rank-4 UNet LoRA with nonzero B."""
    from faceposegenerator_tpu_torch.models.unet2d import init_lora

    g = torch.Generator(device="cuda").manual_seed(seed)
    tree = init_lora(unet, rank=4, generator=g, dtype=torch.bfloat16)

    def fill_b(node):
        if isinstance(node, dict):
            if "b" in node and "a" in node:
                node["b"] = (torch.randn(node["b"].shape, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
            else:
                for v in node.values():
                    fill_b(v)
        elif isinstance(node, list):
            for v in node:
                fill_b(v)

    fill_b(tree)
    return {"unet": tree, "text_encoder": None}


def run_pipeline(torch, fa, card_line):
    import numpy as np

    from faceposegenerator_tpu_torch.diffusion.sampler import SamplerModels
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    t0 = time.time()
    pipe = StableDiffusionPipeline.from_random(seed=0, dtype=torch.bfloat16)
    loras = [make_lora(pipe.nets["unet"], s, torch) for s in (10, 11)]
    pipe.set_lora(loras[0])
    torch.cuda.synchronize()
    print(f"pipeline: built at SD2.1-base widths in bf16 in {time.time() - t0:.1f} s", flush=True)

    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 49408, (8, 77), generator=g)

    # the kernel path against the plain-attention path on a small input
    small = dict(input_ids=ids[:2], num_inference_steps=2, height=128, width=128, seed=5)
    img_k = pipe(**small)
    plain = StableDiffusionPipeline(pipe.nets, SamplerModels(attn_impl="reference"), pipe.policy)
    plain.set_lora(loras[0])
    img_p = plain(**small)
    diff = np.abs(img_k - img_p)
    print(f"pipeline: kernels vs plain attention at 2×128², 2 steps, bf16: image diff max "
          f"{diff.max():.3e} mean {diff.mean():.3e} (limits 1e-1, 1e-2)", flush=True)
    if not (diff.max() <= 1e-1 and diff.mean() <= 1e-2):
        fail("the kernel path and the plain-attention path disagree")

    fa.reset_launch_counts()
    images, secs = [], []
    for r, seed in enumerate((0, 1, 2)):
        if r == 2:
            pipe.set_lora(loras[1])
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.time()
        img = pipe(input_ids=ids, num_inference_steps=30, guidance_scale=5.0, height=512, width=512, seed=seed)
        secs.append(time.time() - t0)
        d64 = fa.LAUNCHES["flash_fwd_d64"] - before["flash_fwd_d64"]
        wide = fa.LAUNCHES["flash_fwd_wide"] - before["flash_fwd_wide"]
        print(f"request {r}: seed {seed}, {secs[-1]:.3f} s, {8 / secs[-1]:.3f} img/s, "
              f"launches d64 {d64} wide {wide} ({card_line})", flush=True)
        if img.shape != (8, 512, 512, 3):
            fail(f"image shape {img.shape}")
        if not (np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0):
            fail("images not finite or outside [0, 1]")
        if d64 != 960 or wide != 1:
            fail(f"request {r} launched d64 {d64} and wide {wide} times, expected 960 and 1")
        images.append(img)
    launches = dict(fa.LAUNCHES)
    if float(np.abs(images[0] - images[1]).max()) < 1e-3:
        fail("images do not differ between seeds")
    if float(np.abs(images[1] - images[2]).max()) < 1e-3:
        fail("images do not change with the LoRA and seed")
    print(f"pipeline: bs8 512² 30-step DDPM CFG 5.0: {secs} s per request; steady "
          f"{min(secs[1:]):.3f} s = {8 / min(secs[1:]):.3f} img/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({card_line})", flush=True)
    return launches


# remat_identity recomputes the VAE decode in the backward; off at the op point
REMAT_IDENTITY = False


def build_train_op_point(torch):
    """The ID-Booth train op point on the card (bench.py:99-190 with
    BENCH_KIND=train): SD2.1-base widths, ArcFace r100, random bf16 frozen
    weights from seeds 0-3, batch 4 with prior preservation, triplet_prior."""
    from faceposegenerator_tpu_torch.core.precision import Policy
    from faceposegenerator_tpu_torch.models import clip_text, iresnet, unet2d, vae
    from faceposegenerator_tpu_torch.training import idbooth

    bf16 = torch.bfloat16
    models = idbooth.ModelBundle(arcface_cfg=iresnet.config_for("r100"))
    frozen = {
        "text_encoder": clip_text.CLIPTextModel(models.text_cfg, dtype=bf16, seed=0),
        "unet": unet2d.UNet2DCondition(models.unet_cfg, dtype=bf16, seed=1),
        "vae": vae.AutoencoderKL(models.vae_cfg, dtype=bf16, seed=2),
        "arcface": iresnet.IResNet(models.arcface_cfg, dtype=bf16, seed=3),
    }
    cfg = idbooth.IDBoothConfig(which_loss="triplet_prior", train_batch_size=4, remat_identity=REMAT_IDENTITY)
    return Policy(param_dtype=bf16, compute_dtype=bf16), models, frozen, cfg


def make_train_batch(torch, n, res, seed):
    """[instance; class] images in [-1, 1], token ids and ground-truth embeddings."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {
        "pixel_values": torch.rand(n, res, res, 3, generator=g, device="cuda") * 2 - 1,
        "input_ids": torch.randint(0, 49408, (n, 77), generator=g, device="cuda"),
        "gt_embeds": torch.randn(n, 512, generator=g, device="cuda"),
    }


def _frozen_checksum(torch, frozen):
    with torch.no_grad():
        return sum(float(p.double().sum() + p.double().abs().sum()) for m in frozen.values() for p in m.parameters())


def run_train(torch, fa, card_line):
    import dataclasses

    from faceposegenerator_tpu_torch.core.rng import train_step_generator
    from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
    from faceposegenerator_tpu_torch.training import idbooth

    t0 = time.time()
    policy, models, frozen, cfg = build_train_op_point(torch)
    torch.cuda.synchronize()
    print(f"train: op point built in {time.time() - t0:.1f} s (remat_identity={cfg.remat_identity})", flush=True)

    # the kernel path against the plain-attention path: one loss and gradient
    # on 2(+2) images of 128² with the same draws and a LoRA with nonzero B
    small = cfg.replace(train_batch_size=2, resolution=128)
    batch = make_train_batch(torch, 4, 128, seed=7)
    g = torch.Generator(device="cuda").manual_seed(8)
    lora = idbooth.init_trainable(4, small, models, frozen["unet"])
    leaves = idbooth.tree_leaves(lora)
    with torch.no_grad():
        for leaf in leaves[1::2]:  # the B factors
            leaf.copy_(0.01 * torch.randn(leaf.shape, generator=g, device="cuda"))
    draws = idbooth.draw((4, 16, 16, 4), 4, 1000, g, "cuda")
    got = {}
    for impl in ("auto", "reference"):
        loss_fn = idbooth.make_loss_fn(small, dataclasses.replace(models, attn_impl=impl), make_ddpm(), policy)
        loss, _ = loss_fn(lora, frozen, batch, draws=draws)
        grads = torch.autograd.grad(loss, leaves)
        got[impl] = (float(loss.detach()), torch.cat([x.float().flatten() for x in grads]))
    rel = abs(got["auto"][0] - got["reference"][0]) / abs(got["reference"][0])
    cos = float(torch.nn.functional.cosine_similarity(got["auto"][1], got["reference"][1], dim=0))
    print(f"train: kernels vs plain attention at 2(+2)×128², bf16: loss {got['auto'][0]:.6f} vs "
          f"{got['reference'][0]:.6f} (rel diff {rel:.3e}, limit 1e-2); LoRA gradient cosine {cos:.6f} "
          "(limit 0.99)", flush=True)
    if not (rel <= 1e-2 and cos >= 0.99):
        fail("the train step's kernel path and plain-attention path disagree")
    del got, lora, leaves, batch, draws

    trainable = idbooth.init_trainable(4, cfg, models, frozen["unet"])
    optimizer = idbooth.make_optimizer(cfg, total_steps=1000)
    opt_state = optimizer.init(trainable)
    step = idbooth.make_train_step(cfg, models, optimizer, policy=policy)
    batch = make_train_batch(torch, 8, 512, seed=5)
    checksum = _frozen_checksum(torch, frozen)
    expect = dict(STEP_LAUNCHES, flash_fwd_wide=3 if cfg.remat_identity else 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    secs = []
    for i in range(3):
        before = dict(fa.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.time()
        trainable, opt_state, metrics = step(trainable, opt_state, frozen, batch,
                                             train_step_generator(cfg.seed, i, "cuda"))
        vals = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        per = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        print(f"train step {i}: {secs[-1]:.3f} s, {json.dumps(vals)}, launches {json.dumps(per)} ({card_line})",
              flush=True)
        if not all(math.isfinite(v) for v in vals.values()) or set(vals) != {
                "loss", "instance_loss", "prior_loss", "id_loss", "grad_norm"} or not vals["grad_norm"] > 0:
            fail(f"train step {i}: metrics {vals}")
        if per != expect:
            fail(f"train step {i} launched {per}, expected {expect}")
    launches = dict(fa.LAUNCHES)
    moved = max(float(leaf.detach().abs().max()) for leaf in idbooth.tree_leaves(trainable)[1::2])
    if not moved > 0:
        fail("no LoRA B factor moved off zero")
    if _frozen_checksum(torch, frozen) != checksum:
        fail("the frozen weights changed")
    steady = min(secs[1:])
    print(f"train: bs4(+prior) 512² triplet_prior r100: {secs} s per step; steady {steady:.3f} s/step = "
          f"{4 / steady:.3f} train img/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
          f"LoRA B max {moved:.3e}; frozen weights unchanged ({card_line})", flush=True)
    return launches


def _kernel_entries(fwd_rows, bwd_rows, launches):
    kernels = []
    for name in ("flash_fwd_d64", "flash_fwd_wide"):
        mine = [r for r in fwd_rows if r["kernel"] == name]
        top = max(mine, key=lambda r: r["bound_ms"])  # the shape with the most work
        kernels.append(dict(
            name=name, route="cuda", source="faceposegenerator_tpu_torch/csrc/flash_fwd.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=top["library_ms"],
            shape=f"{top['shape']} B{top['B']}", lse_max_err=max(r["lse_max_err"] or 0.0 for r in mine),
        ))
    for kind in ("d64", "wide"):
        mine = [r for r in bwd_rows if r["kernel"] == f"flash_bwd_{kind}"]
        top = max(mine, key=lambda r: r["pair_bound_ms"])
        for p, errs in (("dkv", ("dk_err", "dv_err")), ("dq", ("dq_err",))):
            name = f"flash_bwd_{kind}_{p}"
            kernels.append(dict(
                name=name, route="cuda", source="faceposegenerator_tpu_torch/csrc/flash_bwd.cu",
                replaces=REPLACES[name], launches=launches[name],
                max_abs_err=max(r[e][0] for r in mine for e in errs), ms=top[f"{p}_ms"],
                plain_ms=top["plain_ms"], bound_ms=top[f"{p}_bound_ms"], bound_by=top[f"{p}_bound_by"],
                library_ms=top["library_ms"], shape=f"{top['shape']} B{top['B']}", pair_ms=top["pair_ms"],
            ))
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    try:
        from faceposegenerator_tpu_torch.ops import _build
        from faceposegenerator_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card_line, flush=True)
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.time()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    fwd_rows = check_kernels(torch, fa, card)
    fwd_rows += check_kernels(torch, fa, card, TRAIN_SHAPES, with_lse=True, per="step")
    bwd_rows = check_backward(torch, fa, card, [s for s in TRAIN_SHAPES if s[0] != "vae encode mid"])
    txt2img = run_pipeline(torch, fa, card_line)
    torch.cuda.empty_cache()
    train = run_train(torch, fa, card_line)
    launches = {n: txt2img[n] + train[n] for n in fa.LAUNCHES}
    print(f"launches on the main paths: txt2img {json.dumps(txt2img)}, train {json.dumps(train)}", flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"{name} was not launched on the main paths")

    print(json.dumps({"kernels": _kernel_entries(fwd_rows, bwd_rows, launches)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
