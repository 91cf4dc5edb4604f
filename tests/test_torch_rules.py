"""Rules the PyTorch port keeps: it never imports JAX or the JAX package,
its entry points do not fall back to the CPU, CPU tensors never count as
kernel launches, every CUDA source has a launch counter that chip_smoke.py
reports, no library kernel stands in for a hand-written one, the kernels
build without fast math, and its modules import without a CUDA toolkit."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import faceposegenerator_tpu_torch as port
from faceposegenerator_tpu_torch.ops import _build
from faceposegenerator_tpu_torch.ops import flash_attention as fa
from faceposegenerator_tpu_torch.ops import fused_gn as fg
from faceposegenerator_tpu_torch.ops import fused_gn_conv as fgc
from faceposegenerator_tpu_torch.ops import qdense as qd

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix="faceposegenerator_tpu_torch."))


def _run(code: str, env_extra=None, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules() + ["chip_smoke"]
    assert "faceposegenerator_tpu_torch.pipelines.txt2img" in mods
    assert "faceposegenerator_tpu_torch.training.idbooth" in mods
    for new in ("core.config", "core.logging_utils", "core.trackers", "core.checkpointing", "data.dreambooth",
                "pipelines.sweep", "training.idbooth_driver", "training.multi_identity", "training.losses",
                "training.fr", "training.fr_driver", "data.fr_dataset", "data.augment", "data.align",
                "data.align_driver", "evaluation.verification", "models.mtcnn", "models.mobilefacenet",
                "models.vit_face", "models.registry", "pipelines.embed_extract", "evaluation.dgm",
                "evaluation.heatmaps", "evaluation.metrics.prdc", "evaluation.eer", "evaluation.pairs",
                "evaluation.pyeer_driver", "evaluation.analysis", "models.dinov2", "models.clip_vision",
                "models.inception_v3", "models.resnet50", "models.simclr_resnet", "models.convnext",
                "models.data2vec_vision", "cli", "configs", "core.dist", "core.mesh", "parallel.tp",
                "parallel.pod_rehearsal"):
        assert f"faceposegenerator_tpu_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'faceposegenerator_tpu' or m.startswith('faceposegenerator_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_use_no_library_attention_or_compile():
    """No port module imports JAX or the JAX package, or calls
    `scaled_dot_product_attention`, `torch._int_mm` or `torch.compile`
    (chip_smoke.py times the first two as yardsticks only)."""
    for path in PORT_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            where = f"{path.relative_to(REPO)}:{getattr(node, 'lineno', '?')}"
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]] if node.level == 0 else []
            else:
                roots = []
            assert not {"jax", "faceposegenerator_tpu"} & set(roots), where
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("scaled_dot_product_attention", "_int_mm"), where
                assert not (node.attr == "compile" and isinstance(node.value, ast.Name)
                            and node.value.id == "torch"), where


def test_port_never_imports_cv2():
    """The card's machine is not known to have OpenCV: the port reproduces
    the JAX package's cv2 resamplings in numpy (`data/align.py`). No module of
    the port, nor chip_smoke.py, imports cv2, in its source or at run time."""
    for path in list(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert "cv2" not in roots, f"{path.relative_to(REPO)}:{node.lineno}"
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "sys.exit(1 if 'cv2' in sys.modules else 0)\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_never_imports_safetensors():
    """The card's machine has no `safetensors` package: the port reads and
    writes the format itself (`bridge/safetensors_io.py`). No module of the
    port, nor chip_smoke.py, imports it, in its source or at run time."""
    for path in list(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert "safetensors" not in roots, f"{path.relative_to(REPO)}:{node.lineno}"
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "sys.exit(1 if any(m.split('.')[0] == 'safetensors' for m in sys.modules) else 0)\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


# the least arguments that get each device-taking CLI command past argparse
CLI_MINIMAL = {
    "train-idbooth": ["--source_folder", "{d}/src", "--model_dir", "{d}/model"],
    "generate": ["--lora_root", "{d}/loras", "--model_dir", "{d}/model"],
    "extract-embeds": ["--images_root", "{d}/img", "--output_root", "{d}/out"],
    "align-crop": ["--input_root", "{d}/img", "--output_root", "{d}/out"],
    "train-fr": ["--dataset_root", "{d}/fr"],
    "test-fr": ["--backbone", "{d}/best_backbone.npz", "--num_classes", "4"],
    "fiqa": ["--image_dir", "{d}/img"],
    "pose": ["--image_root", "{d}/img"],
    "serve": ["--model_dir", "{d}/model"],
    "accel-report": ["--model_dir", "{d}/model", "--mode", "deepcache=2"],
    "dgm-eval": ["{d}/real", "{d}/gen", "--output_dir", "{d}/out"],
    "pod-rehearsal": ["--processes", "2", "--local_devices", "1"],
}
# the mesh flags spawn their ranks on the card: resolved before the spawn
CLI_MESH = {
    "generate": ["--lora_root", "{d}/loras", "--model_dir", "{d}/model", "--data_parallel", "2"],
    "train-idbooth": ["--source_folder", "{d}/src", "--model_dir", "{d}/model", "--vmap_identities", "2",
                      "--identity_parallel", "2"],
}


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch, tmp_path):
    from faceposegenerator_tpu_torch.evaluation.fiqa import init_qs_head
    from faceposegenerator_tpu_torch.evaluation.pose import init_sixdrepnet
    from faceposegenerator_tpu_torch.models.iresnet import IResNet
    from faceposegenerator_tpu_torch.models.repvgg import RepVGG
    from faceposegenerator_tpu_torch.models.unet2d import UNet2DCondition
    from faceposegenerator_tpu_torch.models.vae import AutoencoderKL
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    from faceposegenerator_tpu_torch.models import mobilefacenet, mtcnn, registry, vit_face
    from faceposegenerator_tpu_torch.pipelines import embed_extract
    from faceposegenerator_tpu_torch.training import fr, fr_driver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from_dir = lambda: StableDiffusionPipeline.from_pretrained(str(tmp_path))  # noqa: E731
    cfg = fr.FRConfig()
    fr_entries = (lambda: fr.init_train_state(cfg), lambda: fr_driver.train_fr_run(cfg, None, str(tmp_path / "fr")),
                  lambda: fr_driver.test_fr_run(cfg, str(tmp_path / "best_backbone.npz"), {}),
                  lambda: embed_extract.make_crop_embed_fn(None), lambda: embed_extract.make_arcface_embed_fn(None),
                  mtcnn.MTCNN, mtcnn.MTCNNNets, mobilefacenet.MobileFaceNet, vit_face.FaceViT,
                  lambda: registry.get_model("mbf"), lambda: registry.get_model("vit_t"),
                  lambda: registry.get_model("r18"))
    for entry in (StableDiffusionPipeline.from_random, from_dir, UNet2DCondition, AutoencoderKL, IResNet, RepVGG,
                  init_sixdrepnet, init_qs_head) + fr_entries + _eval_entries(tmp_path):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    # every CLI command that puts a network on a device, without --device:
    # the card, resolved before any file is read or written
    from faceposegenerator_tpu_torch import cli

    for k in cli._LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    cli_dir = tmp_path / "cli"
    cli_dir.mkdir()
    for command, argv in list(CLI_MINIMAL.items()) + list(CLI_MESH.items()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command] + [a.format(d=cli_dir) for a in argv])
    assert not any(cli_dir.iterdir())
    # the distribution entry points: the process group and the mesh
    from faceposegenerator_tpu_torch.core import dist, mesh
    from faceposegenerator_tpu_torch.parallel import pod_rehearsal

    for entry in (lambda: dist.init_distributed("127.0.0.1:1", 2, 0), mesh.make_mesh,
                  lambda: pod_rehearsal.main(["--processes", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def _eval_entries(tmp_path):
    """The quality-evaluation entry points: every registered encoder factory,
    the seven encoder modules, `dgm.main` at its default `--device cuda`,
    the distance matrix, GradCAM and the heatmap functions."""
    import numpy as np

    from faceposegenerator_tpu_torch.evaluation import dgm, heatmaps
    from faceposegenerator_tpu_torch.evaluation.metrics import authpct, prdc
    from faceposegenerator_tpu_torch.models import (clip_vision, convnext, data2vec_vision, dinov2, inception_v3,
                                                    resnet50, simclr_resnet)

    x = np.zeros((4, 2), np.float32)
    assert len(dgm._ENCODERS) == 11
    return tuple(dgm._ENCODERS.values()) + (
        dinov2.DINOv2, clip_vision.CLIPVision, inception_v3.InceptionV3, resnet50.ResNet50,
        simclr_resnet.SimCLRResNet, convnext.ConvNeXt, data2vec_vision.Data2VecVision,
        lambda: dgm.main([str(tmp_path), str(tmp_path), "--output_dir", str(tmp_path / "out")]),
        lambda: prdc(x, x), lambda: authpct(x, x), lambda: heatmaps.fit_real_gaussian(x),
        lambda: heatmaps.GradCAM(None, x, x), lambda: heatmaps.make_heatmap_fn(None, None, None))


def test_cpu_tensors_never_count_launches():
    from faceposegenerator_tpu_torch.ops.attention import dot_product_attention

    fa.reset_launch_counts()
    q = torch.randn(1, 64, 2, 64)
    fa.flash_fwd_d64(q, q, q, 0.125)
    w = torch.randn(1, 32, 1, 512)
    fa.flash_fwd_wide(w, w, w, 512**-0.5)
    dot_product_attention(q, q, q, kv_len=7)
    g = torch.randn(1, 64, 2, 64, requires_grad=True)
    dot_product_attention(g, g, g).sum().backward()
    o, lse = fa.attention_plain_lse(q, q, q, 0.125)
    fa.flash_bwd_d64(q, q, q, o, lse, o, 0.125)
    fa.flash_bwd_wide(w, w, w, w, torch.zeros(1, 1, 32), w, 512**-0.5)
    dot_product_attention(q, q, q, kv_len=7, impl="flash_int8")
    qd.reset_launch_counts()
    qd.qdense_kernel(torch.randn(3, 64), torch.ones(8, 64, dtype=torch.int8), torch.ones(8))
    fg.reset_launch_counts()
    fgc.reset_launch_counts()
    x = torch.randn(2, 4, 4, 32, requires_grad=True)
    fg.fused_group_norm(x, torch.ones(32), torch.zeros(32), 8, 1e-6, "silu").sum().backward()
    fgc.gn_silu_conv3x3(x, torch.ones(32), torch.zeros(32), torch.nn.Conv2d(32, 16, 3, padding=1), 8).sum().backward()
    # the fp32 instances, on fp32 CPU tensors
    x32 = torch.randn(1, 64, 2, 64, requires_grad=True)
    dot_product_attention(x32, x32, x32).sum().backward()
    fa.flash_fwd_f32(q, q, q, 0.125, with_lse=True)
    fa.flash_bwd_f32(q, q, q, o, lse, o, 0.125)
    fa.flash_attention_int8(q, q, q, 0.125)
    fa.int8_codes_plain(q, q, q, 0.125)
    qd.qdense_kernel(torch.randn(3, 64), torch.ones(8, 64, dtype=torch.int8), torch.ones(8), 0.1)
    # K7's wide instance and its quantize pass
    qd.qdense_kernel(torch.randn(3, 2560), torch.ones(8, 2560, dtype=torch.int8), torch.ones(8))
    qd.quantize_rows(torch.randn(3, 2560))
    fgc.gn_silu_conv3x3(torch.randn(1, 4, 4, 32), torch.ones(32), torch.zeros(32),
                        torch.nn.Conv2d(32, 16, 3, padding=1), 8)
    fgc.weight_split(torch.randn(16, 32, 3, 3))
    assert set(fa.LAUNCHES) == {"flash_fwd_d64", "flash_fwd_wide", "flash_bwd_d64_dkv", "flash_bwd_d64_dq",
                                "flash_bwd_wide_dkv", "flash_bwd_wide_dq", "flash_int8", "flash_fwd_f32",
                                "flash_bwd_f32_dkv", "flash_bwd_f32_dq", "flash_int8_f32", "flash_f32_split",
                                "flash_int8_amax", "flash_int8_codes"}
    assert all(n == 0 for n in fa.LAUNCHES.values())
    assert qd.LAUNCHES == {"qdense": 0, "qdense_f32": 0, "qdense_quant": 0}
    assert fg.LAUNCHES == {"fused_group_norm": 0}
    assert fgc.LAUNCHES == {"gn_silu_conv3x3": 0, "gn_silu_conv3x3_f32": 0, "gn_conv_f32_split": 0}


def test_every_cuda_source_has_a_counted_kernel_in_chip_smoke():
    """Each csrc/*.cu is the source of a kernel with a launch counter in
    `_build.KERNELS`, and chip_smoke.py's kernels line names every counted
    kernel, its source (from that table) and the TPU kernel it replaces."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    counted = set(fa.LAUNCHES) | set(qd.LAUNCHES) | set(fg.LAUNCHES) | set(fgc.LAUNCHES)
    assert set(chip_smoke.REPLACES) == counted == set(_build.SOURCE_OF)
    assert set(_build.KERNELS) == {p.stem for p in (PORT_DIR / "csrc").glob("*.cu")}
    for name, where in chip_smoke.REPLACES.items():
        path, line = where.split(":")
        assert "pallas_call" in (REPO / path).read_text() and int(line) > 0, name


def test_chip_smoke_kernels_line_names_every_counted_kernel():
    """chip_smoke.py's kernels line has one entry per counted kernel, the
    fp32 instances included, each with the contract's keys and its launch
    count from the main paths (rows made up here; the card fills them)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "tflops", "max_abs_err", "lse_max_err", "dkv_ms", "dq_ms",
            "pair_ms", "pair_bound_ms", "dkv_bound_ms", "dq_bound_ms", "dkv_tflops", "dq_tflops", "int_mm_ms",
            "bf16_linear_ms", "f32_linear_ms", "k1_ms", "f32_ms", "sdpa_ms", "attend_ms", "attend_bound_ms",
            "amax_ms", "amax_plain_ms", "amax_bound_ms", "codes_ms", "codes_plain_ms", "codes_bound_ms", "quant_ms",
            "quant_plain_ms", "quant_bound_ms", "launch_ms", "host_us")

    def row(kernel, **kw):
        return dict({k: 1.0 for k in keys}, kernel=kernel, shape="s", B=1, N=1, M=1, K=1, mode="static",
                    bound_by="operations", dkv_bound_by="operations", dq_bound_by="operations",
                    attend_bound_by="operations",
                    dq_err=[1.0, 0.1], dk_err=[1.0, 0.1], dv_err=[1.0, 0.1], **kw)

    f32 = {"fwd": [row("flash_fwd_f32")], "tf32": [1.0, 0.1, 1.0], "bwd": [row("flash_bwd_f32")],
           "split": [row("flash_f32_split")], "conv_split": [row("gn_conv_f32_split")],
           "conv": [row("gn_silu_conv3x3_f32")], "qdense": [row("qdense_f32")], "int8": [row("flash_int8_f32")],
           "gn": [row("fused_group_norm")]}
    launches = {name: i + 1 for i, name in enumerate(chip_smoke.REPLACES)}
    entries = chip_smoke._kernel_entries(
        [row("flash_fwd_d64"), row("flash_fwd_wide")], [row("flash_bwd_d64"), row("flash_bwd_wide")],
        [row("qdense")], [row("flash_int8")], [row("fused_group_norm")], [row("gn_silu_conv3x3")], f32, launches, {})
    assert sorted(e["name"] for e in entries) == sorted(chip_smoke.REPLACES)
    contract = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms"}
    for e in entries:
        assert contract <= set(e) and e["launches"] == launches[e["name"]], e
        assert e["source"] == f"faceposegenerator_tpu_torch/csrc/{_build.SOURCE_OF[e['name']]}.cu"


def test_kernels_build_without_fast_math():
    """Fast math would make the quantizers' division approximate and let the
    compiler contract the roundings K7 and K8 reproduce."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags


def test_cuda_sources_include_only_cuda_and_their_own_headers():
    """The kernels under csrc/ are written here: they include the CUDA
    toolkit's basic headers (cuda.h for the TMA tensor-map types) and each
    other, and nothing else (no JAX, no PyTorch, no library of finished
    kernels)."""
    allowed = {"cuda.h", "cuda_bf16.h", "cuda_runtime.h", "stdint.h"}
    sources = sorted((PORT_DIR / "csrc").glob("*.cu*"))
    assert {p.name for p in sources} >= {"flash_fwd.cu", "flash_bwd.cu", "flash_common.cuh", "sm90_common.cuh",
                                         "fused_gn.cu", "gn_conv.cu", "gn_common.cuh"}
    local = {p.name for p in sources}
    for path in sources:
        includes = [line.split()[1].strip('<>"') for line in path.read_text().splitlines()
                    if line.startswith("#include")]
        assert includes and set(includes) <= allowed | local, f"{path.name}: {includes}"


def test_ptxas_report_names_each_kernel_function(monkeypatch):
    """chip_smoke.py prints registers and spills per kernel function from
    nvcc's log: names demangled to the function's own, whatever namespace
    (nvcc 12.9 names the anonymous one after the file) or template."""
    from faceposegenerator_tpu_torch.ops import _build

    ns = "_GLOBAL__N__c9275e25_12_flash_fwd_cu_8d485bde"
    log = (f"ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}20flash_fwd_d64_kernelILi3EEEv14CUtensorMap_st' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN...\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers, 1024 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z12plain_kernelPf' for 'sm_90a'\n"
           "    8 bytes stack frame, 12 bytes spill stores, 24 bytes spill loads\n"
           "ptxas info    : Used 64 registers\n")
    monkeypatch.setattr(_build, "build_log", lambda name: log)
    rows = _build.ptxas_report("flash_fwd")
    assert [(r["function"], r["registers"], r["spill_stores"], r["spill_loads"]) for r in rows] == [
        ("flash_fwd_d64_kernel", 128, 0, 0), ("plain_kernel", 64, 12, 24)]


def test_kernel_module_imports_without_nvcc():
    r = _run(
        "import faceposegenerator_tpu_torch.ops.flash_attention as fa, "
        "faceposegenerator_tpu_torch.ops.qdense, faceposegenerator_tpu_torch.ops.quant, "
        "faceposegenerator_tpu_torch.ops.fused_gn, faceposegenerator_tpu_torch.ops.fused_gn_conv, "
        "faceposegenerator_tpu_torch.ops._build as b; "
        "assert not b._loaded; print(sorted(fa.LAUNCHES))",
        env_extra={"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"},
    )
    assert r.returncode == 0, r.stderr
    assert "flash_fwd_d64" in r.stdout


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
                           timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
