"""dgm-eval quality evaluation: encoders → representations → metrics (port of
`faceposegenerator_tpu/evaluation/dgm.py`).

Behavioral rebuild of the vendored layer6ai `dgm-eval` package the reference
drives (`Evaluation/dgm-eval/dgm_eval/__main__.py:17-90,142-231,308-371`):

  python -m faceposegenerator_tpu_torch.evaluation.dgm <real_dir> <gen_dir...> \
      --model dinov2 --metrics fd kd prdc vendi authpct --nsample 10000 [--device cpu]

  - the encoder registry, with JAX's eleven names and their preprocessing
    (PIL resample, size, mean and std): pixel, arcface (IResNet r100),
    dinov2, inception, sinception, clip, swav, simclr, mae, convnext,
    data2vec. A factory takes `weights_path` (a reference checkpoint,
    converted by `bridge.torch_weights`) or gives seeded random weights
    (`torch.Generator` seeded 0), and `device` (the card unless told "cpu");
    it returns an `Encoder`: PIL preprocessing on the host, the network on
    the device.
  - representations: batched encoding of an image tree with nsample
    subsampling (only when the dataset exceeds nsample + 2000, the
    reference's quirk), integer-aware file order, and an `.npz` cache keyed
    as JAX keys it.
  - per-set score JSON and an aggregate file, and the `--heatmaps` GradCAM
    grid.

The ViT encoders (dinov2, mae, clip) compute in bf16 and run their attention
on K1 (head dim 64); the CNNs and data2vec compute in fp32, as JAX does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import DEFAULT_POLICY
from .metrics import (
    authpct,
    ct_score,
    fls,
    frechet_distance,
    frechet_distance_inf,
    kernel_distance,
    per_class_vendi,
    prdc,
    sliced_wasserstein,
    vendi_score,
)

_ENCODERS: Dict[str, Callable[..., Callable]] = {}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def register_encoder(name: str, factory: Callable[..., Callable]):
    """factory(weights_path=None, device=None, **kw) -> encode((B, H, W, 3)
    uint8 -> (B, D) np.ndarray)."""
    _ENCODERS[name] = factory


class Encoder:
    """encode((B, H, W, 3) uint8) → (B, D) fp32 numpy: `preprocess` on the
    host (numpy in, numpy out), then `features`: `forward(model, x,
    DEFAULT_POLICY)` on `device`, under no grad (the CNNs compute in fp32
    whatever the policy; a parity check calls `forward` with its own).
    `gradcam_encode(images, tap)` and `gradcam_preprocess` are set where
    JAX attaches them (the `--heatmaps` encoders)."""

    def __init__(self, preprocess: Callable, forward: Optional[Callable], device, model=None,
                 gradcam_encode: Optional[Callable] = None, gradcam_preprocess: Optional[Callable] = None):
        self.preprocess = preprocess
        self.forward = forward
        self.device = device
        self.model = model
        self.gradcam_encode = gradcam_encode
        self.gradcam_preprocess = gradcam_preprocess

    def features(self, x: np.ndarray) -> np.ndarray:
        if self.forward is None:  # the pixel encoder: the preprocessed pixels are the features
            return x.reshape(len(x), -1)
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            return self.forward(self.model, x, DEFAULT_POLICY).float().cpu().numpy()

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return self.features(self.preprocess(batch))


def _cls_feature(model, x, policy):
    return model.cls_feature(x, policy)


def _with_policy(model, x, policy):
    return model(x, policy)


def _fp32(model, x, policy):
    return model(x)


def _pooled_feature(model, x, policy):
    return model.pooled_feature(x)


def _resize_norm_preprocess(size: int, mean, std, resample: str = "bicubic"):
    """uint8 batch → (B, size, size, 3) fp32 encoder input: PIL resize, then
    (x / 255 − mean) / std."""

    def preprocess(batch: np.ndarray) -> np.ndarray:
        from PIL import Image

        rs = Image.BICUBIC if resample == "bicubic" else Image.BILINEAR
        imgs = np.stack(
            [np.asarray(Image.fromarray(b).resize((size, size), rs), np.float32) for b in batch]
        )
        return (imgs / 255.0 - mean) / std

    return preprocess


def _load(weights_path: Optional[str]):
    """A checkpoint's state dict as numpy (`.safetensors` through the port's
    reader, anything else through `torch.load`), or None without one."""
    if not (weights_path and os.path.exists(weights_path)):
        return None
    from ..bridge.torch_weights import load_state_dict

    return load_state_dict(weights_path)


def _loaded(model, tree, state=None):
    from ..bridge.jax_params import load_jax_params

    return model if tree is None else load_jax_params(model, tree, state)


def _pixel_encoder(size: int = 32, device=None, **kw):
    device = resolve_device(device)
    return Encoder(_resize_norm_preprocess(size, 0.0, 1.0, "bilinear"), None, device)


def _arcface_encoder(weights_path: Optional[str] = None, device=None, **kw):
    from ..models import iresnet

    device = resolve_device(device)
    cfg = iresnet.config_for("r100")
    model = iresnet.IResNet(cfg, device=device, seed=0)
    sd = _load(weights_path)
    if sd is not None:
        from ..bridge.torch_weights import convert_iresnet_state_dict

        model = _loaded(model, *convert_iresnet_state_dict(sd, cfg))
    return Encoder(_resize_norm_preprocess(112, 0.5, 0.5, "bilinear"), _with_policy, device, model)


def _vit_encoder(model, device, mean, std):
    from .heatmaps import make_dinov2_gradcam_encoder

    pre = _resize_norm_preprocess(224, mean, std)
    return Encoder(pre, _cls_feature, device, model, make_dinov2_gradcam_encoder(model), pre)


def _dinov2_encoder(weights_path: Optional[str] = None, arch: str = "vitl14", device=None, **kw):
    """The reference's primary encoder: DINOv2 on 224² bicubic-resized,
    imagenet-normalized images; feature = final-LN CLS token
    (`dgm_eval/models/dinov2.py:31-59`). `weights_path`: a hub or
    transformers checkpoint (.safetensors/.pth/.bin)."""
    from ..bridge.torch_weights import convert_dinov2_state_dict
    from ..models import dinov2

    device = resolve_device(device)
    cfg = {"vitl14": dinov2.VITL14_CONFIG, "vitb14": dinov2.VITB14_CONFIG, "vits14": dinov2.VITS14_CONFIG}[arch]
    sd = _load(weights_path)
    model = _loaded(dinov2.DINOv2(cfg, device=device, seed=0), None if sd is None else convert_dinov2_state_dict(sd, cfg))
    return _vit_encoder(model, device, IMAGENET_MEAN, IMAGENET_STD)


def _mae_encoder(weights_path: Optional[str] = None, device=None, **kw):
    """MAE ViT-L/16: final-norm CLS features (timm forward_features,
    global_pool=False — `dgm_eval/models/mae.py:34-70`)."""
    from ..bridge.torch_weights import convert_dinov2_state_dict
    from ..models import dinov2

    device = resolve_device(device)
    cfg = dinov2.MAE_VITL16_CONFIG
    sd = _load(weights_path)
    tree = None if sd is None else convert_dinov2_state_dict(sd.get("model", sd), cfg)  # MAE nests under "model"
    model = _loaded(dinov2.DINOv2(cfg, device=device, seed=0), tree)
    return _vit_encoder(model, device, IMAGENET_MEAN, IMAGENET_STD)


def _clip_encoder(weights_path: Optional[str] = None, arch: str = "vitb32", device=None, **kw):
    """ln_post(CLS) without the projection (`dgm_eval/models/clip.py:40-70`)
    over bicubic-resized, CLIP-normalized images."""
    from ..bridge.torch_weights import convert_clip_vision_state_dict
    from ..models import clip_vision
    from .heatmaps import make_clip_gradcam_encoder

    device = resolve_device(device)
    cfg = {"vitb32": clip_vision.VITB32_CLIP_CONFIG, "vitl14": clip_vision.VITL14_CLIP_CONFIG}[arch]
    sd = _load(weights_path)
    model = _loaded(clip_vision.CLIPVision(cfg, device=device, seed=0),
                    None if sd is None else convert_clip_vision_state_dict(sd, cfg))
    pre = _resize_norm_preprocess(cfg.image_size, CLIP_MEAN, CLIP_STD)
    return Encoder(pre, _cls_feature, device, model, make_clip_gradcam_encoder(model), pre)


def _inception_encoder(weights_path: Optional[str] = None, device=None, **kw):
    """FID InceptionV3 2048-d features over [0, 1] inputs, resized to 299²
    on the device (`dgm_eval/models/inception.py:161-186`); a pytorch-fid
    `pt_inception` or torchvision state dict."""
    from ..bridge.torch_weights import convert_inception_state_dict
    from ..models import inception_v3
    from .heatmaps import make_inception_gradcam_encoder

    device = resolve_device(device)
    sd = _load(weights_path)
    model = _loaded(inception_v3.InceptionV3(device=device, seed=0),
                    None if sd is None else convert_inception_state_dict(sd))
    pre = lambda batch: np.asarray(batch, np.float32) / 255.0  # noqa: E731
    return Encoder(pre, _fp32, device, model, make_inception_gradcam_encoder(model), pre)


def _resnet_ssl_encoder(weights_path: Optional[str] = None, device=None, **kw):
    """SwAV's torchvision ResNet-50: 2048-d avgpool features over 224²
    imagenet-normalized inputs (`dgm_eval/models/swav.py:290-372`)."""
    from ..bridge.torch_weights import convert_resnet50_state_dict
    from ..models import resnet50
    from .heatmaps import make_swav_gradcam_encoder

    device = resolve_device(device)
    sd = _load(weights_path)
    model = _loaded(resnet50.ResNet50(device=device, seed=0), None if sd is None else convert_resnet50_state_dict(sd))
    pre = _resize_norm_preprocess(224, IMAGENET_MEAN, IMAGENET_STD, resample="bilinear")
    return Encoder(pre, _fp32, device, model, make_swav_gradcam_encoder(model), pre)


def _simclr_encoder(weights_path: Optional[str] = None, device=None, **kw):
    """SimCLRv2 r50_1x_sk1 2048-d avgpool features (`dgm_eval/models/
    simclr.py:16-200`); 224² inputs scaled to [0, 1] only."""
    from ..bridge.torch_weights import convert_simclr_state_dict, load_torch_pth
    from ..models import simclr_resnet

    device = resolve_device(device)
    tree = convert_simclr_state_dict(load_torch_pth(weights_path)) if weights_path and os.path.exists(weights_path) \
        else None
    model = _loaded(simclr_resnet.SimCLRResNet(device=device, seed=0), tree)
    return Encoder(_resize_norm_preprocess(224, 0.0, 1.0, "bilinear"), _fp32, device, model)


def _convnext_encoder(weights_path: Optional[str] = None, device=None, **kw):
    """timm convnext_large features: forward_features → global pool → head
    LN (1536-d) over 224² imagenet-normalized inputs
    (`dgm_eval/models/convnext.py:78-84`)."""
    from ..bridge.torch_weights import convert_convnext_state_dict
    from ..models import convnext
    from .heatmaps import make_convnext_gradcam_encoder

    device = resolve_device(device)
    cfg = convnext.CONVNEXT_LARGE
    sd = _load(weights_path)
    model = _loaded(convnext.ConvNeXt(cfg, device=device, seed=0),
                    None if sd is None else convert_convnext_state_dict(sd, cfg))
    pre = _resize_norm_preprocess(224, IMAGENET_MEAN, IMAGENET_STD)
    return Encoder(pre, _fp32, device, model, make_convnext_gradcam_encoder(model), pre)


def _data2vec_encoder(weights_path: Optional[str] = None, device=None, **kw):
    """Data2VecVision (BEiT) pooler_output — LayerNorm(mean of patch tokens)
    (`dgm_eval/models/data2vec.py:35-60`); 224² inputs, mean and std 0.5."""
    from ..bridge.torch_weights import convert_data2vec_state_dict
    from ..models import data2vec_vision

    device = resolve_device(device)
    cfg = data2vec_vision.D2V_LARGE_CONFIG
    sd = _load(weights_path)
    model = _loaded(data2vec_vision.Data2VecVision(cfg, device=device, seed=0),
                    None if sd is None else convert_data2vec_state_dict(sd, cfg))
    return Encoder(_resize_norm_preprocess(224, 0.5, 0.5), _pooled_feature, device, model)


register_encoder("pixel", _pixel_encoder)
register_encoder("arcface", _arcface_encoder)
register_encoder("dinov2", _dinov2_encoder)
register_encoder("inception", _inception_encoder)
register_encoder("sinception", _inception_encoder)  # same arch, SwAV-trained weights
register_encoder("clip", _clip_encoder)
register_encoder("swav", _resnet_ssl_encoder)
register_encoder("simclr", _simclr_encoder)
register_encoder("mae", _mae_encoder)
register_encoder("convnext", _convnext_encoder)
register_encoder("data2vec", _data2vec_encoder)


def _file_order_key(name: str):
    """Integer-aware ordering (`dataloaders.py` get_order quirk)."""
    nums = re.findall(r"\d+", os.path.basename(name))
    return (int(nums[0]) if nums else 0, name)


def list_dataset_images(path: str) -> List[str]:
    out = []
    for root, _, files in os.walk(path):
        for f in files:
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp")):
                out.append(os.path.join(root, f))
    return sorted(out, key=_file_order_key)


def image_labels(paths: List[str], root: str) -> np.ndarray:
    """Class labels from the first-level subdirectory (conditional layout)."""
    labels = []
    for p in paths:
        rel = os.path.relpath(p, root)
        parts = rel.split(os.sep)
        labels.append(parts[0] if len(parts) > 1 else "0")
    uniq = {lbl: i for i, lbl in enumerate(sorted(set(labels)))}
    return np.asarray([uniq[lbl] for lbl in labels])


def _subsample(paths: List[str], nsample: int, seed: int) -> List[str]:
    """nsample of them, only when the dataset exceeds nsample + 2000 (the
    reference's quirk)."""
    if len(paths) > nsample + 2000:
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.choice(len(paths), nsample, replace=False))
        paths = [paths[i] for i in idx]
    return paths


def compute_representations(
    path: str,
    encoder: Callable,
    encoder_name: str,
    nsample: int = 10000,
    seed: int = 0,
    batch_size: int = 64,
    cache_dir: Optional[str] = None,
):
    """Returns (reps (N, D), labels (N,)); the cache file of JAX's key."""
    paths = _subsample(list_dataset_images(path), nsample, seed)

    cache_path = None
    if cache_dir:
        digest = hashlib.sha1(
            json.dumps([encoder_name, path, nsample, seed, len(paths)]).encode()
        ).hexdigest()[:16]
        cache_path = os.path.join(cache_dir, f"reps_{encoder_name}_{digest}.npz")
        if os.path.exists(cache_path):
            data = np.load(cache_path, allow_pickle=False)
            return data["reps"], data["labels"]

    from PIL import Image

    reps = []
    for start in range(0, len(paths), batch_size):
        chunk = paths[start : start + batch_size]
        batch = np.stack([np.asarray(Image.open(p).convert("RGB"), np.uint8) for p in chunk])
        reps.append(encoder(batch))
    reps = np.concatenate(reps) if reps else np.zeros((0, 1))
    labels = image_labels(paths, path)

    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(cache_path, reps=reps, labels=labels)
    return reps, labels


def compute_scores(
    metrics: List[str],
    reps_real: np.ndarray,
    reps_gen: np.ndarray,
    labels_gen: Optional[np.ndarray] = None,
    nearest_k: int = 5,
    seed: int = 0,
    reps_test: Optional[np.ndarray] = None,
    device=None,
) -> Dict:
    """Metric dispatch (reference `compute_scores:142-231`). `ct` and `fls`
    need a held-out test set (reference `:198-225`). The distance matrices
    of prdc, authpct and ct run on `device` (the card unless told "cpu")."""
    scores: Dict = {}
    for m in metrics:
        if m in ("ct", "fls") and reps_test is None:
            continue  # reference also skips these without a test path
        if m == "ct":
            scores.update(ct_score(reps_real, reps_test, reps_gen, seed=seed, device=device))
            continue
        if m == "fls":
            scores.update(fls(reps_real, reps_test, reps_gen))
            continue
        if m == "fd":
            scores["fd"] = frechet_distance(reps_real, reps_gen)
        elif m == "fd_infinity":
            scores["fd_infinity"] = frechet_distance_inf(reps_real, reps_gen, seed=seed)
        elif m in ("kd", "kid", "mmd"):
            mean, std = kernel_distance(reps_real, reps_gen, seed=seed)
            scores["kd_value"] = mean
            scores["kd_variance"] = std
        elif m == "prdc":
            # realism only when requested, like the reference
            # (`__main__.py:171-180`): it is per-sample (in file order), not
            # an aggregate, so it is opt-in
            want_realism = "realism" in metrics
            out = prdc(reps_real, reps_gen, nearest_k=nearest_k, realism=want_realism, device=device)
            if want_realism:
                out["realism"] = np.asarray(out["realism"]).tolist()
            scores.update(out)
        elif m == "realism":
            if "prdc" not in metrics:
                raise ValueError("metric 'realism' requires 'prdc'")
        elif m == "vendi":
            scores["vendi"] = vendi_score(reps_gen)
            if labels_gen is not None and len(set(labels_gen.tolist())) > 1:
                scores["per_class_vendi"] = per_class_vendi(reps_gen, labels_gen)["mean_vendi"]
        elif m == "authpct":
            scores["authpct"] = authpct(reps_real, reps_gen, device=device)
        elif m == "sw":
            scores["sw_approx"] = sliced_wasserstein(reps_real, reps_gen, seed=seed)
        else:
            raise ValueError(f"unknown metric {m!r}")
    return scores


def _write_gradcam_grid(gen_path, encoder, reps_real, reps_gen, out_png, nsample, seed, count):
    """Reference `--heatmaps` (`__main__.py:358-364` → `heatmaps/heatmaps.py
    visualize_heatmaps`): sample images of the generated set, compute
    leave-one-out FD-sensitivity GradCAMs at the encoder's target layer,
    write one overlay grid PNG."""
    from PIL import Image

    from ..pipelines.sweep import save_image_grid
    from .heatmaps import GradCAM, overlay_heatmap

    paths = _subsample(list_dataset_images(gen_path), nsample, seed)  # compute_representations' paths
    rnd = np.random.RandomState(seed)
    k = min(count, len(paths))
    sel = rnd.choice(np.arange(len(paths)), size=k, replace=False)
    cam = GradCAM(encoder.gradcam_encode, reps_real, reps_gen, device=encoder.device)
    tiles = []
    for i in sel:
        u8 = np.asarray(Image.open(paths[int(i)]).convert("RGB"), np.uint8)
        inp = encoder.gradcam_preprocess(u8[None])
        heat, _ = cam.get_map(inp, int(i))
        tiles.append(overlay_heatmap(u8, heat))
    save_image_grid(np.stack(tiles), out_png, per_row=max(1, int(round(k**0.5))))


def main(argv=None):
    ap = argparse.ArgumentParser(description="dgm-eval equivalent")
    ap.add_argument("path", nargs="+", help="real dir followed by generated dir(s)")
    ap.add_argument("--model", default="pixel", help="encoder name")
    ap.add_argument("--metrics", nargs="+", default=["fd", "kd", "prdc", "vendi", "authpct"])
    ap.add_argument("--nsample", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--nearest_k", type=int, default=5)
    ap.add_argument("--output_dir", default="dgm_eval_out")
    ap.add_argument("--arcface_weights", default=None)
    ap.add_argument(
        "--encoder_weights", default=None,
        help="checkpoint for the chosen encoder (.safetensors/.pth/.bin)",
    )
    ap.add_argument("--test_path", default=None, help="held-out set for ct/fls")
    ap.add_argument(
        "--heatmaps", action="store_true",
        help="write FD-sensitivity GradCAM overlay grids (reference "
             "`--heatmaps`; inception/dinov2/mae/swav/clip/convnext)",
    )
    ap.add_argument("--heatmaps_count", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default: the card, or an error) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    weights = args.encoder_weights or args.arcface_weights
    encoder = _ENCODERS[args.model](weights_path=weights, device=device)
    real_path, gen_paths = args.path[0], args.path[1:]
    reps_real, _ = compute_representations(
        real_path, encoder, args.model, args.nsample, args.seed, args.batch_size,
        cache_dir=args.output_dir,
    )
    reps_test = None
    if args.test_path:
        reps_test, _ = compute_representations(
            args.test_path, encoder, args.model, args.nsample, args.seed,
            args.batch_size, cache_dir=args.output_dir,
        )
    os.makedirs(args.output_dir, exist_ok=True)
    all_scores = {}
    for gen in gen_paths:
        reps_gen, labels_gen = compute_representations(
            gen, encoder, args.model, args.nsample, args.seed, args.batch_size,
            cache_dir=args.output_dir,
        )
        scores = compute_scores(
            args.metrics, reps_real, reps_gen, labels_gen, args.nearest_k,
            args.seed, reps_test=reps_test, device=device,
        )
        name = os.path.basename(os.path.normpath(gen))
        all_scores[name] = scores
        with open(os.path.join(args.output_dir, f"scores_{name}.json"), "w") as f:
            json.dump(scores, f, indent=2)
        print(json.dumps({name: scores}))
        if args.heatmaps:
            if getattr(encoder, "gradcam_encode", None) is None:
                print(json.dumps({"heatmaps": f"unsupported for encoder {args.model!r}"}))
            else:
                out_png = os.path.join(args.output_dir, f"heatmaps_{args.model}_{name}_{args.seed}.png")
                _write_gradcam_grid(
                    gen, encoder, reps_real, reps_gen, out_png,
                    nsample=args.nsample, seed=args.seed, count=args.heatmaps_count,
                )
                print(json.dumps({"heatmaps": out_png}))
    with open(os.path.join(args.output_dir, "aggregate.json"), "w") as f:
        json.dump(all_scores, f, indent=2)
    return all_scores


if __name__ == "__main__":
    main()
