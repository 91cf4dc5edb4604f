"""The parity runbook of the port (`bridge/torch_mirror.py`,
`bridge/full_chain.py`, `cli parity` and `parity-all`) against the JAX
package's:

- every mirror the JAX package has (TUNet, TVAE, TInceptionV3, TResNet50,
  TConvNeXt, TSimCLRResNet, TPNet, TRNet, TONet), built from one torch seed
  in both packages: the same `state_dict` keys and values, bit-equal outputs;
- `TCLIPText`, new in the port, against `transformers.CLIPTextModel` on
  its weights: the same keys, last_hidden_state within 1e-5;
- the port's `torch_chain_trajectory` bit-equal to JAX's on the same
  mirrors, text function and noise;
- `compare_full_chain` (the port's sampler against the mirror loop) on a
  tiny directory over 30 DDPM steps within JAX's tolerances (latents 5e-3,
  step 0 5e-4, image 5e-3);
- `cli parity --device cpu` (CLIP, UNet per step, VAE decode, full chain,
  MTCNN) and `cli parity-all --device cpu` (plus an insightface arcface.pth
  written by `export_iresnet_state_dict`) on that directory: verdict pass,
  JAX's verdict keys.
"""

import json

import numpy as np
import pytest
import torch

from faceposegenerator_tpu.bridge import full_chain as jfull_chain
from faceposegenerator_tpu.bridge import torch_mirror as jmirror
from faceposegenerator_tpu.diffusion import make_ddpm as jmake_ddpm
from faceposegenerator_tpu.models import unet2d as junet
from faceposegenerator_tpu.models import vae as jvae
from faceposegenerator_tpu_torch import cli
from faceposegenerator_tpu_torch.bridge import full_chain, torch_mirror
from faceposegenerator_tpu_torch.bridge.safetensors_io import save_file
from faceposegenerator_tpu_torch.bridge.torch_weights import export_iresnet_state_dict
from faceposegenerator_tpu_torch.diffusion.schedulers import make_ddpm
from faceposegenerator_tpu_torch.models import clip_text, iresnet, unet2d, vae
from faceposegenerator_tpu_torch.pipelines.presets import PRESETS
from faceposegenerator_tpu_torch.pipelines.txt2img import StableDiffusionPipeline

from test_torch_checkpoints import SMALL, configs
from test_torch_serving import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tokenizer import grid_words, sd2_vocab, write_tokenizer_dir

UNET_CFG, VAE_CFG, TEXT_CFG = SMALL
CONV = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))
# name: (port factory, JAX factory, inputs (NCHW unless noted))
MIRRORS = {
    "TUNet": (lambda: torch_mirror.TUNet(unet2d.UNetConfig(**UNET_CFG)),
              lambda: jmirror.TUNet(junet.UNetConfig(**UNET_CFG)),
              lambda g: (torch.randn(2, 4, 8, 8, generator=g), torch.tensor([999, 10]),
                         torch.randn(2, 77, 64, generator=g))),
    "TVAE": (lambda: torch_mirror.TVAE(vae.VAEConfig(**VAE_CFG)), lambda: jmirror.TVAE(jvae.VAEConfig(**VAE_CFG)),
             lambda g: (torch.randn(1, 4, 4, 4, generator=g),)),
    "TInceptionV3": (torch_mirror.TInceptionV3, jmirror.TInceptionV3, lambda g: (torch.rand(1, 3, 75, 75, generator=g),)),
    "TResNet50": (torch_mirror.TResNet50, jmirror.TResNet50, lambda g: (torch.randn(1, 3, 32, 32, generator=g),)),
    "TConvNeXt": (lambda: torch_mirror.TConvNeXt(**CONV), lambda: jmirror.TConvNeXt(**CONV),
                  lambda g: (torch.randn(1, 3, 32, 32, generator=g),)),
    "TSimCLRResNet": (torch_mirror.TSimCLRResNet, jmirror.TSimCLRResNet,
                      lambda g: (torch.randn(1, 3, 32, 32, generator=g),)),
    "TPNet": (torch_mirror.TPNet, jmirror.TPNet, lambda g: (torch.randn(2, 3, 20, 24, generator=g),)),
    "TRNet": (torch_mirror.TRNet, jmirror.TRNet, lambda g: (torch.randn(3, 3, 24, 24, generator=g),)),
    "TONet": (torch_mirror.TONet, jmirror.TONet, lambda g: (torch.randn(3, 3, 48, 48, generator=g),)),
}


def _seeded(factory, seed):
    torch.manual_seed(seed)
    return factory().eval()


@pytest.mark.parametrize("name", sorted(MIRRORS))
def test_mirror_keys_weights_and_outputs_equal_jax(name):
    make, jmake, inputs = MIRRORS[name]
    mine, ref = _seeded(make, 3), _seeded(jmake, 3)
    sd, jsd = mine.state_dict(), ref.state_dict()
    assert list(sd) == list(jsd)
    for k in sd:
        assert torch.equal(sd[k], jsd[k]), k
    args = inputs(torch.Generator().manual_seed(4))
    with torch.no_grad():
        if name == "TVAE":
            got, want = mine.decode(*args), ref.decode(*args)
            img = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(5))
            for a, b in zip(mine.encode_moments(img), ref.encode_moments(img)):
                assert torch.equal(a, b)
        else:
            got, want = mine(*args), ref(*args)
    for a, b in zip(*((x,) if torch.is_tensor(x) else x for x in (got, want))):
        assert torch.equal(a, b), name


def test_clip_text_mirror_against_transformers(monkeypatch):
    # transformers would import TensorFlow and Flax where they are installed (~12 s): the test needs neither
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    cfg = clip_text.CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
    hf_cfg = transformers.CLIPTextConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                         intermediate_size=128, max_position_embeddings=77, hidden_act="gelu")
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(hf_cfg).eval()
    mine = torch_mirror.TCLIPText(cfg).eval()
    assert sorted(mine.state_dict()) == sorted(hf.state_dict())
    mine.load_state_dict(hf.state_dict())
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 1000, (2, 77)))
    with torch.no_grad():
        got, want = mine(ids), hf(ids).last_hidden_state
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    quick = torch_mirror.TCLIPText(clip_text.CLIPTextConfig(**{**cfg.__dict__, "hidden_act": "quick_gelu"}))
    quick.load_state_dict(mine.state_dict())
    with torch.no_grad():
        assert not torch.equal(quick(ids), got)


def _write_dir(root):
    """A tiny diffusers directory written from the mirrors (seed 0) with the
    port's safetensors writer, its config.json files and an SD2 tokenizer."""
    cfgs = unet2d.UNetConfig(**UNET_CFG), vae.VAEConfig(**VAE_CFG), clip_text.CLIPTextConfig(**TEXT_CFG)
    torch.manual_seed(0)
    for sub, m, name in (("unet", torch_mirror.TUNet(cfgs[0]), "diffusion_pytorch_model"),
                         ("vae", torch_mirror.TVAE(cfgs[1]), "diffusion_pytorch_model"),
                         ("text_encoder", torch_mirror.TCLIPText(cfgs[2]), "model")):
        (root / sub).mkdir(parents=True)
        save_file({k: v.detach().contiguous() for k, v in m.state_dict().items()}, str(root / sub / f"{name}.safetensors"))
    for sub, cfg in configs(*cfgs).items():
        (root / sub / "config.json").write_text(json.dumps(cfg))
    write_tokenizer_dir(root / "tokenizer", *sd2_vocab(grid_words()))
    return root


@pytest.fixture(scope="module")
def weights_root(tmp_path_factory):
    """sd/ (the tiny directory), arcface.pth (an r18 of the port, its convs
    bias-free, in insightface keys) and mtcnn/ (facenet-pytorch pnet.pt,
    rnet.pt, onet.pt of random mirrors)."""
    root = tmp_path_factory.mktemp("weights")
    _write_dir(root / "sd")
    r18 = iresnet.IResNet(iresnet.config_for("r18"), device="cpu", seed=1)
    with torch.no_grad():
        for m in r18.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.zero_()
    torch.save({k: torch.from_numpy(v) for k, v in export_iresnet_state_dict(r18).items()}, root / "arcface.pth")
    (root / "mtcnn").mkdir()
    torch.manual_seed(2)
    for name, cls in (("pnet", torch_mirror.TPNet), ("rnet", torch_mirror.TRNet), ("onet", torch_mirror.TONet)):
        torch.save(cls().state_dict(), root / "mtcnn" / f"{name}.pt")
    return root


def _mirrors(sd_dir):
    mirrors = []
    for cls, sub, cfg in ((torch_mirror.TCLIPText, "text_encoder", clip_text.CLIPTextConfig(**TEXT_CFG)),
                          (torch_mirror.TUNet, "unet", unet2d.UNetConfig(**UNET_CFG)),
                          (torch_mirror.TVAE, "vae", vae.VAEConfig(**VAE_CFG))):
        m = cls(cfg).eval()
        m.load_state_dict(cli._mirror_state(str(sd_dir), sub, "cpu"))
        mirrors.append(m)
    return mirrors


def test_chain_trajectory_bit_equal_jax(weights_root):
    text, unet, vae_ = _mirrors(weights_root / "sd")
    junet_m, jvae_m = jmirror.TUNet(junet.UNetConfig(**UNET_CFG)).eval(), jmirror.TVAE(jvae.VAEConfig(**VAE_CFG)).eval()
    junet_m.load_state_dict(unet.state_dict())
    jvae_m.load_state_dict(vae_.state_dict())
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 49408, (2, 77))
    neg = np.zeros_like(ids)
    noise = rng.standard_normal((5, 2, 8, 8, 4)).astype(np.float32)

    def text_fn(x):
        with torch.no_grad():
            return text(torch.from_numpy(x)).numpy()

    got = full_chain.torch_chain_trajectory(text_fn, unet, vae_, ids, neg, noise, make_ddpm(num_inference_steps=4), 5.0)
    want = jfull_chain.torch_chain_trajectory(text_fn, junet_m, jvae_m, ids, neg, noise,
                                              jmake_ddpm(num_inference_steps=4), 5.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    sched = make_ddpm(num_inference_steps=4)
    for i in range(4):
        np.testing.assert_array_equal(
            full_chain.ddpm_step_np(eps, i, x, eps, sched.alphas_cumprod, sched.timesteps, sched.prev_timesteps),
            jfull_chain.ddpm_step_np(eps, i, x, eps, sched.alphas_cumprod, sched.timesteps, sched.prev_timesteps))


def test_full_chain_30_steps_within_jax_tolerances(weights_root):
    text, unet, vae_ = _mirrors(weights_root / "sd")
    pipe = StableDiffusionPipeline.from_pretrained(str(weights_root / "sd"), dtype=torch.float32, device="cpu")
    ids = np.asarray(pipe.tokenizer(["face portrait photo of woman sks person"]), np.int64)
    neg = np.asarray(pipe.tokenizer([""]), np.int64)

    def text_fn(x):
        with torch.no_grad():
            return text(torch.from_numpy(x)).numpy()

    out = full_chain.compare_full_chain(pipe.nets, pipe.models, text_fn, unet, vae_, ids, neg, steps=30,
                                        height=64, width=64, seed=3)
    assert len(out["latent_max_abs_per_step"]) == 30
    assert out["latent_max_abs"] < 5e-3 and out["latent_max_abs_per_step"][0] < 5e-4, out
    assert out["image_max_abs"] < 5e-3, out


JAX_PARITY_KEYS = {"tolerance", "full_chain", "mtcnn", "model_dir", "steps", "eps_max_abs_per_step", "image_max_abs",
                   "unet_missing_keys", "unet_unexpected_keys", "vae_missing_keys", "vae_unexpected_keys", "pass"}


def test_cli_parity_and_parity_all_pass_on_the_cpu(weights_root, tmp_path, capsys):
    out = tmp_path / "parity.json"
    assert cli.main(["parity", "--model_dir", str(weights_root / "sd"), "--steps", "3", "--resolution", "64",
                     "--full_chain", "--mtcnn", str(weights_root / "mtcnn"), "--device", "cpu",
                     "--output", str(out)]) == 0
    verdict = json.loads(out.read_text())
    assert verdict["pass"] is True, verdict
    assert JAX_PARITY_KEYS <= set(verdict) and json.loads(capsys.readouterr().out) == verdict
    assert len(verdict["eps_max_abs_per_step"]) == 3 and max(verdict["eps_max_abs_per_step"]) < 5e-4
    assert verdict["text_max_abs"] < 5e-4 and verdict["text_missing_keys"] == verdict["unet_missing_keys"] == 0
    assert set(verdict["full_chain"]) == {"steps", "latent_max_abs_per_step", "latent_max_abs", "image_max_abs",
                                          "text_missing_keys", "pass"}
    assert max(verdict["mtcnn"]["net_max_abs"].values()) < 5e-3

    out = tmp_path / "all.json"
    assert cli.main(["parity-all", "--weights_root", str(weights_root), "--steps", "2", "--report_steps", "4",
                     "--resolution", "32", "--arcface_network", "r18",
                     "--device", "cpu", "--output", str(out)]) == 0
    verdict = json.loads(out.read_text())
    assert verdict["pass"] is True and verdict["skipped"] == []
    assert set(verdict["legs"]) == {"parity", "preset_quality"}
    leg = verdict["legs"]["parity"]
    assert leg["full_chain"]["pass"] and leg["mtcnn"]["pass"] and leg["arcface"]["embed_finite"]
    gates = verdict["legs"]["preset_quality"]["gates"]
    assert set(gates) == set(PRESETS)
    for g in gates.values():
        assert g["pass"] is True and g["seed_floor_psnr"] is not None and g["identity_cos_mean"] is not None
        assert set(g) == {"mode", "pass", "psnr_mean", "psnr_threshold", "seed_floor_psnr", "identity_cos_mean",
                          "identity_cos_threshold", "seed_floor_identity_cos"}
        # the default identity gate, relative to the seed floor's cosine
        assert g["identity_cos_threshold"] == round(
            1.0 - cli.GATE_IDENTITY_DISTANCE_RATIO * (1.0 - g["seed_floor_identity_cos"]), 4)
