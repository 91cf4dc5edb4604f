"""The port's command line (`faceposegenerator_tpu_torch/cli.py`) and named
configs against the JAX package's.

- Parser surface: each of the 16 commands' ArgumentParser, captured in both
  packages by making `parse_args` raise with the parser (nothing runs):
  every action's option strings, dest, default, type, choices, nargs,
  required flag and class. The port's set is JAX's, plus `--device` on the
  thirteen commands that put a network on a device (parity and parity-all
  among them); pod-rehearsal also takes `--device`, and `--backend` besides.
- `main`: help lists the 16 commands (rc 0), an unknown command gives rc 2.
- The argparse refusals come before the device is resolved and before any
  file is read: without `--device cpu`, on a machine without a card, they
  still give SystemExit(2) (JAX's give the same).
- Without `--device`, each of the eleven resolves the card and raises
  without one (tests/test_torch_rules.py).
- Distribution from the command line: without `--device`, `generate
  --data_parallel 2`, `serve --data_parallel 2`, `train-idbooth
  --identity_parallel 2` and `pod-rehearsal` resolve the card before they
  spawn a rank and raise without one; a partial FPG_* launch raises JAX's
  error word for word; parity and parity-all resolve the card before they
  read a file (they run on the CPU in tests/test_torch_parity.py). `generate --data_parallel 2 --device cpu` spawns two
  gloo ranks whose PNGs are bit-equal to the one-process command's; the
  ranks' other paths run in tests/test_torch_data_parallel.py,
  tests/test_torch_pod_rehearsal.py and (`serve --data_parallel 2 --device
  cpu`) tests/test_torch_mesh_serving.py.
- The JAX command against the port's (`--device cpu`) on the same files:
  `pyeer` and `analyze` (printed JSON and written files within 1e-6; the
  plots by name: a curve 1e-7 away may move a pixel), `dgm-eval --model
  pixel --metrics fd` (FD within 1e-4 relative; the pixel encoder at 4² in
  both registries, as tests/test_torch_dgm.py has it: at its default 32²
  the 3072² eigendecompositions take minutes on a loaded machine), and,
  for the slice as a
  whole, `accel-report` on one tiny diffusers directory at 128², 2 DDPM
  steps, `--mode deepcache=2 --seed_floor`: the same keys, every PSNR
  within 0.1 dB. Both packages draw JAX's noise there: the port's sampler
  is handed JAX's stream for the seed (`jax_noise`), as tests/test_torch_
  sweep.py hands both sides one table. The two sides then differ by their
  bf16 roundings, which move a PSNR by ~0.01 dB.
- The port's `generate --device cpu` (512², 2 steps, batch 2, 2 prompts;
  unpacked, and packed with `--eval`) writes PNGs bit-equal to
  `run_sweep` called directly, and the eval files with one score per
  image. It runs on a directory beside the first whose UNet has no
  attention at its 64² level (`light_model_dir`), to keep 512² cheap.
- `configs.py`: each config equals JAX's field by field.
"""

import argparse
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faceposegenerator_tpu import cli as jcli
from faceposegenerator_tpu import configs as jconfigs
from faceposegenerator_tpu_torch import cli, configs

from test_torch_checkpoints import jax_params, numpy_init, write_model_dir
from test_torch_dgm import small_pixels  # noqa: F401 (fixture)
from test_torch_rules import CLI_MINIMAL
from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)

COMMANDS = sorted(jcli.COMMANDS)
DEVICE_COMMANDS = tuple(CLI_MINIMAL) + ("parity", "parity-all")
# pod-rehearsal's flag beyond JAX's and --device
PORT_EXTRA = {"pod-rehearsal": {
    (("--backend",), "backend", "None", None, "['nccl', 'gloo']", None, False, "_StoreAction"),
}}
PSNR_DB = 0.1


class _Parser(Exception):
    def __init__(self, parser):
        self.parser = parser


def _surface(module, command, monkeypatch):
    """{(option strings, dest, default, type, choices, nargs, required,
    class)} of the command's parser."""
    def capture(self, args=None, namespace=None):
        raise _Parser(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parser) as e:
            module.COMMANDS[command]([])
    return {(tuple(a.option_strings), a.dest, repr(a.default), a.type, repr(a.choices), a.nargs, a.required,
             type(a).__name__) for a in e.value.parser._actions}


DEVICE_ACTION = (("--device",), "device", "'cuda'", None, "None", None, False, "_StoreAction")


@pytest.mark.parametrize("command", COMMANDS)
def test_parser_surface_matches_jax(command, monkeypatch):
    want = _surface(jcli, command, monkeypatch)
    if command in DEVICE_COMMANDS:
        want = want | {DEVICE_ACTION}
    assert _surface(cli, command, monkeypatch) == want | PORT_EXTRA.get(command, set())


def test_main_help_and_unknown(capsys):
    assert sorted(cli.COMMANDS) == COMMANDS and len(COMMANDS) == 16
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "commands: " + ", ".join(COMMANDS)
    assert "train-idbooth" in out and "fpg-torch" in out
    assert cli.main(["nope"]) == 2
    assert "unknown command 'nope'" in capsys.readouterr().out


REFUSALS = {
    "generate preset + quantize": ["generate", "--model_dir", "{d}/none", "--lora_root", "{d}/none", "--preset",
                                   "turbo", "--quantize", "w8a8"],
    "generate preset + deepcache": ["generate", "--model_dir", "{d}/none", "--lora_root", "{d}/none", "--preset",
                                    "latency", "--deepcache", "2"],
    "serve preset + rolling": ["serve", "--model_dir", "{d}/none", "--preset", "latency", "--rolling"],
    "serve preset + scheduler": ["serve", "--model_dir", "{d}/none", "--preset", "turbo", "--scheduler", "dpm"],
    "identity_parallel without K >= 2": ["train-idbooth", "--source_folder", "{d}/none", "--model_dir", "{d}/none",
                                         "--identity_parallel", "1"],
    "train-idbooth without model_dir": ["train-idbooth", "--source_folder", "{d}/none"],
    "generate batch_size % data_parallel": ["generate", "--lora_root", "{d}/none", "--batch_size", "8",
                                            "--data_parallel", "3"],
    "analyze without input": ["analyze"],
    "accel-report without mode": ["accel-report", "--model_dir", "{d}/none"],
}


# JAX checks the batch size against the mesh after it loads the model
PORT_ONLY = ("generate batch_size % data_parallel",)


@pytest.mark.parametrize("case,package", [(c, p) for c in sorted(REFUSALS) for p in ("jax", "port")
                                          if p == "port" or c not in PORT_ONLY])
def test_refusals_come_before_the_device_and_the_files(case, package, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.format(d=tmp_path) for a in REFUSALS[case]]
    with pytest.raises(SystemExit) as e:
        (jcli if package == "jax" else cli).main(argv)
    assert e.value.code == 2
    assert not any(tmp_path.iterdir())


NO_CARD = (RuntimeError, "no CUDA device")
PARTIAL = (ValueError, "partial multi-process configuration")
MESH_REFUSALS = {
    "generate --data_parallel 2": (["generate", "--lora_root", "{d}/none", "--data_parallel", "2"], {}, NO_CARD),
    "serve --data_parallel 2": (["serve", "--model_dir", "{d}/none", "--data_parallel", "2"], {}, NO_CARD),
    "train-idbooth --identity_parallel 2": (["train-idbooth", "--source_folder", "{d}/none", "--model_dir",
                                             "{d}/none", "--vmap_identities", "2", "--identity_parallel", "2"], {},
                                            NO_CARD),
    "train-idbooth under FPG_NUM_PROCESSES": (["train-idbooth", "--source_folder", "{d}/none", "--model_dir",
                                               "{d}/none"], {"FPG_NUM_PROCESSES": "2"}, PARTIAL),
    "train-fr under FPG_COORDINATOR": (["train-fr", "--dataset_root", "{d}/none"], {"FPG_COORDINATOR": "h:1"},
                                       PARTIAL),
    # JAX's maybe_init_from_env reads FPG_PROCESS_ID only beside the other two
    "train-fr under FPG_PROCESS_ID": (["train-fr", "--dataset_root", "{d}/none"], {"FPG_PROCESS_ID": "0"}, NO_CARD),
    "parity": (["parity", "--model_dir", "{d}/none"], {}, NO_CARD),
    "parity-all": (["parity-all", "--weights_root", "{d}/none"], {}, NO_CARD),
    "pod-rehearsal": (["pod-rehearsal", "--processes", "2"], {}, NO_CARD),
}


@pytest.mark.parametrize("case", sorted(MESH_REFUSALS))
def test_unported_distribution_and_parity_raise_naming_their_item(case, tmp_path, monkeypatch):
    """Each distribution case stops before it spawns, loads or writes
    anything: the card resolved first, a partial launch refused as JAX
    refuses it; the parity commands too resolve the card before any file."""
    argv, env, (exc, match) = MESH_REFUSALS[case]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in cli._LAUNCH_ENV + ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(exc, match=match):
        cli.main([a.format(d=tmp_path) for a in argv])
    assert not any(tmp_path.iterdir())


def test_configs_equal_jax_field_by_field():
    for name in ("SD21_TRAIN", "FR_DEFAULT", "FR_AUGMENTED", "INFERENCE_DEFAULT"):
        got, want = dataclasses.asdict(getattr(configs, name)), dataclasses.asdict(getattr(jconfigs, name))
        assert got == want, name
    assert configs.FR_AUGMENTED_OUTPUT_PREFIX == jconfigs.FR_AUGMENTED_OUTPUT_PREFIX
    assert [f.name for f in dataclasses.fields(configs.InferenceDefaults)] == [
        f.name for f in dataclasses.fields(jconfigs.InferenceDefaults)]
    assert configs.FR_AUGMENTED is not configs.FR_DEFAULT


# --- the JAX command against the port's on the same files -------------------------------


def _run(module, argv, capsys):
    module.main(argv)
    return capsys.readouterr()


def _close(got, want, path="", tol=1e-6):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{path}.{k}", tol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}.{i}", tol)
    elif isinstance(want, float) and isinstance(got, (int, float)):
        assert got == pytest.approx(want, rel=tol, abs=tol), path
    else:
        assert got == want, path


_NUMBER = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _same_files(got_dir, want_dir):
    """The two directories hold the same file names; JSON, text and .npz
    contents agree within 1e-6, PNG plots by name."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for n in names:
        g, w = os.path.join(got_dir, n), os.path.join(want_dir, n)
        if n.endswith(".json"):
            _close(json.load(open(g)), json.load(open(w)), n)
        elif n.endswith(".npz"):
            gz, wz = np.load(g), np.load(w)
            assert sorted(gz.files) == sorted(wz.files)
            for k in wz.files:
                np.testing.assert_allclose(gz[k], wz[k], rtol=1e-6, atol=1e-6, err_msg=f"{n}:{k}")
        elif n.endswith((".csv", ".html", ".tex")):
            gt, wt = open(g).read(), open(w).read()
            assert _NUMBER.sub("#", gt) == _NUMBER.sub("#", wt), n
            np.testing.assert_allclose([float(x) for x in _NUMBER.findall(gt)],
                                       [float(x) for x in _NUMBER.findall(wt)], rtol=1e-6, atol=1e-6, err_msg=n)
        else:
            assert n.endswith(".png"), n


def _embeddings(root, flat):
    """Seeded embeddings of 4 identities × 10 images, flat `<id>_<img>.npy`
    or in per-identity folders."""
    rng = np.random.default_rng(11)
    for ident in range(4):
        centre = rng.standard_normal(64)
        for i in range(10):
            path = root / (f"{ident}_{i}.npy" if flat else f"{ident}/{i}.npy")
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, (centre + 0.8 * rng.standard_normal(64)).astype(np.float32))


def test_pyeer_matches_jax(tmp_path, capsys):
    _embeddings(tmp_path / "synth", flat=True)
    _embeddings(tmp_path / "real", flat=True)
    out = {}
    for name, module in (("jax", jcli), ("port", cli)):
        argv = ["pyeer", "--synth_embeds_dir", str(tmp_path / "synth"), "--real_embeds_dir", str(tmp_path / "real"),
                "--output", str(tmp_path / name), "--min_samples", "4", "--skip_among", "0", "--skip_vs_real", "0"]
        out[name] = json.loads(_run(module, argv, capsys).out)
    assert set(out["port"]) == {"AmongSynth", "SynthVsReal"}
    _close(out["port"], out["jax"])
    _same_files(tmp_path / "port", tmp_path / "jax")
    # an empty result warns on stderr in both
    for module in (jcli, cli):
        res = _run(module, ["pyeer", "--synth_embeds_dir", str(tmp_path / "synth"), "--output",
                            str(tmp_path / "empty"), "--min_samples", "50"], capsys)
        assert json.loads(res.out) == {} and "warning: no score pairs produced" in res.err


def test_analyze_matches_jax(tmp_path, capsys):
    _embeddings(tmp_path / "emb", flat=False)
    logs = tmp_path / "scalars.jsonl"
    logs.write_text("".join(json.dumps({"step": s, "loss": 1.0 / (s + 1), "lr": 1e-4}) + "\n" for s in range(6)))
    out = {}
    for name, module in (("jax", jcli), ("port", cli)):
        argv = ["analyze", "--embeds_dir", str(tmp_path / "emb"), "--logs", str(logs), "--output",
                str(tmp_path / name), "--name", "d", "--num_imgs", "8", "--seed", "3"]
        out[name] = json.loads(_run(module, argv, capsys).out)
    out["port"]["logs"] = [os.path.basename(p) for p in out["port"]["logs"]]
    out["jax"]["logs"] = [os.path.basename(p) for p in out["jax"]["logs"]]
    _close(out["port"], out["jax"])
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_dgm_eval_pixel_fd_matches_jax(small_pixels, tmp_path, capsys):
    from PIL import Image

    rng = np.random.default_rng(0)
    for split in ("real", "gen"):
        for ident in ("1", "2"):
            d = tmp_path / split / ident
            d.mkdir(parents=True)
            for i in range(4):
                Image.fromarray(rng.integers(0, 255, (48, 48, 3), np.uint8)).save(d / f"{i}.png")
    fd = {}
    for name, module, extra in (("jax", jcli, []), ("port", cli, ["--device", "cpu"])):
        argv = ["dgm-eval", str(tmp_path / "real"), str(tmp_path / "gen"), "--model", "pixel", "--metrics", "fd",
                "--nsample", "50", "--output_dir", str(tmp_path / name)] + extra
        fd[name] = json.loads(_run(module, argv, capsys).out.strip().splitlines()[-1])["gen"]["fd"]
    assert fd["port"] == pytest.approx(fd["jax"], rel=1e-4)


# --- the slice as a whole: accel-report and generate on one tiny diffusers directory -------


def _byte_tokenizer(tok_dir):
    """tests/test_accel_report.py's byte-level CLIP tokenizer: every byte
    unit and its word-final form, no merges, so any prompt tokenizes."""
    from faceposegenerator_tpu.data.tokenizer import bytes_to_unicode

    tok_dir.mkdir(parents=True, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for u in bytes_to_unicode().values():
        vocab.setdefault(u, len(vocab))
        vocab.setdefault(u + "</w>", len(vocab))
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (tok_dir / "merges.txt").write_text("#version: 0.2\n")


def _model_dir(root, cfgs, params):
    write_model_dir(root, params, cfgs, tokenizer=False)
    _byte_tokenizer(root / "tokenizer")
    return root


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfgs, params = jax_params(small=True)
    return _model_dir(tmp_path_factory.mktemp("cli") / "model", cfgs, params)


@pytest.fixture(scope="module")
def light_model_dir(tmp_path_factory):
    """`generate` renders at 512² (it has no --height), where a bf16 request
    of the small directory takes ~10 s on one CPU thread, most of it the
    4096-token attention of its top level: this UNet has attention only at
    its 32² level (the VAE decode, ~1.3 s an image, stays)."""
    from faceposegenerator_tpu.models import clip_text as jclip
    from faceposegenerator_tpu.models import unet2d as junet
    from faceposegenerator_tpu.models import vae as jvae

    small = jax_params(small=True)[0]
    cfgs = (junet.UNetConfig(block_out_channels=(32, 32), layers_per_block=1, down_block_has_attn=(False, True),
                             cross_attention_dim=small[2].hidden_size, head_dim=32), small[1], small[2])
    params = {"unet": numpy_init(junet.init, cfgs[0], 1), "vae": numpy_init(jvae.init, cfgs[1], 2),
              "text_encoder": numpy_init(jclip.init, cfgs[2], 0)}
    return _model_dir(tmp_path_factory.mktemp("cli") / "light", cfgs, params)


def jax_noise(seed, S, B, h, w):
    """JAX `sample`'s stream for `seed` without `noise_override`
    (sampler.py:157-161,236-239): the initial latent from the key's split,
    step i's noise from `fold_in(key, i)`; (S+1, B, h, w, 4)."""
    key, sub = jax.random.split(jax.random.key(seed))
    draws = [jax.random.normal(sub, (B, h, w, 4), jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(key, i), (B, h, w, 4), jnp.float32) for i in range(S)]
    return torch.from_numpy(np.stack([np.asarray(d) for d in draws]))


def test_accel_report_matches_jax(model_dir, tmp_path, capsys, monkeypatch):
    from faceposegenerator_tpu_torch.pipelines import txt2img

    plain_sample = txt2img.sample

    class Seed:
        def __init__(self, seed):
            self.seed = seed

    def sample_with_jax_noise(nets, schedule, input_ids, negative_input_ids, *, generator, **kw):
        kw["noise_override"] = jax_noise(generator.seed, schedule.num_inference_steps, input_ids.shape[0],
                                         kw["height"] // 8, kw["width"] // 8)
        return plain_sample(nets, schedule, input_ids, negative_input_ids, generator=None, **kw)

    monkeypatch.setattr(txt2img, "sampler_generator", lambda seed, device: Seed(seed))
    monkeypatch.setattr(txt2img, "sample", sample_with_jax_noise)
    reports = {}
    for name, module, extra in (("jax", jcli, []), ("port", cli, ["--device", "cpu"])):
        argv = ["accel-report", "--model_dir", str(model_dir), "--mode", "deepcache=2", "--prompt", "a face",
                "--steps", "2", "--height", "128", "--width", "128", "--seed_floor",
                "--output", str(tmp_path / f"{name}.json")] + extra
        reports[name] = json.loads(_run(module, argv, capsys).out)
        assert json.load(open(tmp_path / f"{name}.json")) == reports[name]
    got, want = reports["port"], reports["jax"]

    def psnrs(report, path=""):
        """{path: PSNR} of every PSNR entry, and the key paths."""
        out, keys = {}, set()
        if isinstance(report, dict):
            for k, v in report.items():
                keys.add(f"{path}.{k}")
                o, ks = psnrs(v, f"{path}.{k}")
                out.update(o)
                keys |= ks
        elif isinstance(report, list):
            for i, v in enumerate(report):
                o, ks = psnrs(v, f"{path}[{i}]")
                out.update(o)
                keys |= ks
        elif "psnr" in path.lower() and isinstance(report, (int, float)):
            out[path] = float(report)
        return out, keys

    (gp, gk), (wp, wk) = psnrs(got), psnrs(want)
    assert gk == wk
    assert wp and set(gp) == set(wp)
    for k in wp:
        assert abs(gp[k] - wp[k]) <= PSNR_DB, (k, gp[k], wp[k])


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed_eval"])
def test_generate_writes_what_run_sweep_writes(packed, light_model_dir, tmp_path, capsys):
    from PIL import Image

    from faceposegenerator_tpu_torch.core.tree import tree_leaves
    from faceposegenerator_tpu_torch.diffusion.lora_io import save_lora_safetensors, zero_lora
    from faceposegenerator_tpu_torch.pipelines import sweep
    from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

    model_dir = light_model_dir
    pipe = StableDiffusionPipeline.from_pretrained(str(model_dir), device="cpu")
    lora_root = tmp_path / "loras"
    tree = zero_lora(pipe.nets["unet"], pipe.nets["text_encoder"], dtype=pipe.policy.param_dtype)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for leaf in tree_leaves(tree["unet"]):
            leaf.copy_(0.05 * torch.randn(leaf.shape, generator=g))
    save_lora_safetensors(tree, str(lora_root / sweep.MODEL_VARIANTS[0] / "id_3" / "checkpoint-31-6400" /
                                    "pytorch_lora_weights.safetensors"))
    (lora_root / sweep.MODEL_VARIANTS[1] / "id_3").mkdir(parents=True)
    run = dict(num_prompts=2, num_inference_steps=2, batch_size=2)
    argv = ["generate", "--model_dir", str(model_dir), "--lora_root", str(lora_root), "--output",
            str(tmp_path / "cli"), "--steps", "2", "--batch_size", "2", "--num_prompts", "2", "--device", "cpu"]
    if packed:
        argv += ["--pack_variants", "--eval", "--fiqa_network", "r18"]
    out = _run(cli, argv, capsys).out
    sweep.run_sweep(pipe, str(lora_root), str(tmp_path / "direct"), pack_variants=packed, **run)

    def pngs(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                      for f in fs if f.endswith(".png"))

    names = pngs(tmp_path / "direct")
    assert len([n for n in names if "comparison_grids" not in n]) == 3 * 2
    assert pngs(tmp_path / "cli") == names
    for n in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "cli" / n)),
                                      np.asarray(Image.open(tmp_path / "direct" / n)), err_msg=n)
    if packed:
        assert json.loads(out.strip().splitlines()[-1]) == {"eval": str(tmp_path / "cli" / "eval"), "images": 6}
        rows = (tmp_path / "cli" / "eval" / "fiqa_scores.txt").read_text().splitlines()
        assert sorted(r.split()[0] for r in rows) == sorted(n for n in names if "comparison_grids" not in n)
        assert all(np.isfinite(float(r.split()[1])) for r in rows)
        stats = json.load(open(tmp_path / "cli" / "eval" / "pose_stats.json"))
        assert set(stats) >= {"global"}
    else:
        assert not (tmp_path / "cli" / "eval").exists()
