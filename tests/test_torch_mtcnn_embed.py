"""The port's identity stack against the JAX package: MTCNN's nets, its
pyramid resize and stage crops, the bright-square cascade, the alignment
resamplings (the JAX package's call OpenCV; the port's reproduce it), the
embedding extraction paths, the quantized embedder and the alignment sweep.

Inputs are numpy arrays from a seed; both sides fp32 (JAX PARITY_POLICY, the
port's PARITY_POLICY). The cascade runs with `min_face_size=40` (three
pyramid scales on 96² images) and the embedder is IResNet
`depths=(1, 1, 1, 1)`.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from faceposegenerator_tpu.core.precision import PARITY_POLICY as JPOLICY
from faceposegenerator_tpu.data import align as jalign
from faceposegenerator_tpu.data import align_driver as jalign_driver
from faceposegenerator_tpu.models import iresnet as jir
from faceposegenerator_tpu.models import mtcnn as jmtcnn
from faceposegenerator_tpu.ops import quant as jquant
from faceposegenerator_tpu.pipelines import embed_extract as jembed
from faceposegenerator_tpu_torch.bridge.jax_params import load_jax_params
from faceposegenerator_tpu_torch.core.precision import PARITY_POLICY
from faceposegenerator_tpu_torch.data import align, align_driver
from faceposegenerator_tpu_torch.models import iresnet, mtcnn
from faceposegenerator_tpu_torch.ops import quant
from faceposegenerator_tpu_torch.pipelines import embed_extract

FACE_CFG = dict(depths=(1, 1, 1, 1))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), f"{what}: max abs err {err:.3g}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _square_images():
    """The JAX golden test's bright square (tests/test_data_pipelines.py:
    200-246), a bright rectangle and a black image, 96² fp32."""
    face = np.zeros((96, 96, 3), np.float32)
    face[24:72, 24:72] = 255.0
    face2 = np.zeros((96, 96, 3), np.float32)
    face2[8:56, 40:88] = 255.0
    return np.stack([face, face2, np.zeros_like(face)])


def _graded_squares():
    """Bright squares whose brightness rises from 246 to 255 across them,
    and a black image. On a uniform square every P-Net cell inside scores
    the same up to the last bit, so which box NMS keeps turns on rounding
    (the two packages' resizes round differently and keep different boxes of
    equal score); a graded square orders the cells by margins far above
    rounding, so the whole cascade can be compared."""
    out = []
    for y0, x0, s in ((24, 24, 48), (8, 40, 48), (30, 10, 56)):
        img = np.zeros((96, 96, 3), np.float32)
        yy, xx = np.mgrid[0:s, 0:s]
        img[y0 : y0 + s, x0 : x0 + s] = (246 + 9 * (yy + 2 * xx) / (3 * (s - 1)))[..., None]
        out.append(img)
    return np.stack(out + [np.zeros((96, 96, 3), np.float32)])


def _detectors():
    params = jmtcnn.brightness_cascade_params()
    return (mtcnn.MTCNN(_np(params), min_face_size=40, device="cpu"),
            jmtcnn.MTCNN(params=params, min_face_size=40))


def test_mtcnn_nets_match_jax_on_random_weights():
    params = jax.jit(jmtcnn.init)(jax.random.key(0))
    nets = load_jax_params(mtcnn.MTCNNNets("cpu"), _np(params))
    rng = np.random.default_rng(0)
    x12 = rng.normal(0, 1, (2, 31, 27, 3)).astype(np.float32)
    x24 = rng.normal(0, 1, (5, 24, 24, 3)).astype(np.float32)
    x48 = rng.normal(0, 1, (5, 48, 48, 3)).astype(np.float32)
    with torch.no_grad():
        got = [nets.pnet(torch.from_numpy(x12)), nets.rnet(torch.from_numpy(x24)), nets.onet(torch.from_numpy(x48))]
    want = [jmtcnn.pnet_apply(params["pnet"], x12), jmtcnn.rnet_apply(params["rnet"], x24),
            jmtcnn.onet_apply(params["onet"], x48)]
    for name, g, w in zip(("pnet", "rnet", "onet"), got, want):
        _close(g[0].numpy(), w[0], 1e-5, f"{name} prob")
        for k in range(1, len(g)):
            _close(g[k].numpy(), w[k], 1e-4, f"{name} output {k}")


def test_pyramid_resize_and_stage_crops_match_jax():
    imgs = np.random.default_rng(1).uniform(0, 255, (2, 64, 80, 3)).astype(np.float32)
    for sh, sw in ((46, 57), (20, 25), (13, 16), (90, 100)):
        want = jax.image.resize(jnp.asarray(imgs), (2, sh, sw, 3), "bilinear")
        got = mtcnn.pyramid_resize(torch.from_numpy(imgs), sh, sw)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-4 * 255, (sh, sw)
    boxes = np.array([[10.5, 3.2, 40.1, 33.0], [-8, -5, 20, 23], [60, 40, 95, 75], [0, 0, 80, 64],
                      [11.5, 12.5, 35.5, 36.5]], np.float32)
    idx = np.array([0, 1, 1, 0, 1])
    for size in (24, 48):
        want = jax.vmap(lambda i, b: jmtcnn._crop_zero_pad_single(jnp.asarray(imgs)[i], b, size))(idx, boxes)
        got = mtcnn.stage_crops(torch.from_numpy(imgs), torch.from_numpy(idx), torch.from_numpy(boxes), size)
        _close(got.numpy(), want, 1e-6, f"stage crops {size}")


def test_bright_square_cascade_matches_jax():
    """On the golden bright square the port passes JAX's golden checks (a top
    box centred on the square, prob > 0.9, landmarks at the configured
    fractions, nothing on black); on graded squares it keeps the same boxes,
    probabilities and points as JAX within 1e-3, batched and one by one."""
    ours, theirs = _detectors()
    face = _square_images()[0]
    boxes, probs, points = ours.detect(face, landmarks=True)
    x0, y0, x1, y1 = boxes[0]
    assert 24 <= (x0 + x1) / 2 <= 72 and 24 <= (y0 + y1) / 2 <= 72 and probs[0] > 0.9
    assert points[0].shape == (5, 2)
    np.testing.assert_allclose(points[0][2, 0], x0 + 0.5 * (x1 - x0), rtol=1e-5)
    assert ours.detect(_square_images()[2]) == (None, None)

    imgs = _graded_squares()
    got = ours.detect_batch(imgs, landmarks=True)
    want = theirs.detect_batch(imgs, landmarks=True)
    for b in range(len(imgs)):
        if want[0][b] is None:
            assert got[0][b] is None and got[1][b] is None and got[2][b] is None
            continue
        assert got[0][b].shape == want[0][b].shape
        for k, what in enumerate(("boxes", "probs", "points")):
            np.testing.assert_allclose(got[k][b], want[k][b], atol=1e-3, rtol=0, err_msg=f"image {b} {what}")
        single = ours.detect(imgs[b], landmarks=True)
        np.testing.assert_allclose(single[0], want[0][b], atol=1e-3, rtol=0)
    assert want[0][-1] is None


def _smooth(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(xx / (7.0 + seed)) * np.cos(yy / 11.0)
    return np.stack([base, base[::-1], 255 - base], -1).astype(np.uint8)


def test_norm_crop_and_bbox_crop_resize_match_jax_opencv():
    """At most 1 uint8 code apart, on at most 1 in 100 pixels."""
    rng = np.random.default_rng(2)
    for seed in range(3):
        img = _smooth(180, 150, seed)
        lm = np.array([[60, 80], [95, 78], [78, 100], [64, 120], [92, 121]], np.float32) + rng.normal(0, 3, (5, 2))
        lm = lm.astype(np.float32)
        for got, want in ((align.norm_crop(img, lm), jalign.norm_crop(img, lm)),
                          (align.norm_crop(img.astype(np.float32), lm), jalign.norm_crop(img.astype(np.float32), lm)),
                          (align.bbox_crop_resize(img, np.array([20.4, 31.6, 120.2, 160.9])),
                           jalign.bbox_crop_resize(img, np.array([20.4, 31.6, 120.2, 160.9]))),
                          (align.bbox_crop_resize(img, np.array([50, 40, 90, 85])),
                           jalign.bbox_crop_resize(img, np.array([50, 40, 90, 85]))),
                          (align.bbox_crop_resize(img, np.array([200, 200, 210, 220])),
                           jalign.bbox_crop_resize(img, np.array([200, 200, 210, 220])))):
            assert got.shape == want.shape and got.dtype == want.dtype
            diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
            assert diff.max() <= 1.0 and (diff > 1e-3).mean() <= 1e-2, (seed, diff.max(), (diff > 1e-3).mean())


def _write_tree(root, ids=2, per_id=3, black=1):
    os.makedirs(root, exist_ok=True)
    imgs = _graded_squares()
    rng = np.random.default_rng(3)
    for i in range(ids):
        d = os.path.join(root, f"id_{i}")
        os.makedirs(d, exist_ok=True)
        for j in range(per_id):
            shift = rng.integers(-8, 9, 2)
            img = np.roll(imgs[j % 3], tuple(shift), axis=(0, 1))
            Image.fromarray(img.astype(np.uint8)).save(os.path.join(d, f"img_{j}.png"))
        for j in range(black):
            Image.fromarray(np.zeros((96, 96, 3), np.uint8)).save(os.path.join(d, f"black_{j}.png"))
    return root


@pytest.fixture(scope="module")
def embedders():
    cfg = jir.IResNetConfig(**FACE_CFG)
    params, state = jax.jit(jir.init, static_argnums=1)(jax.random.key(4), cfg)
    model = load_jax_params(iresnet.IResNet(iresnet.IResNetConfig(**FACE_CFG), device="cpu"), _np(params), _np(state))
    return cfg, params, state, model


def _same_embeddings(a_root, b_root, missing_a, missing_b, rel):
    assert missing_a == missing_b
    files = sorted(os.path.join(d, f) for d in os.listdir(b_root) if os.path.isdir(os.path.join(b_root, d))
                   for f in os.listdir(os.path.join(b_root, d)))
    assert files and files == sorted(os.path.join(d, f) for d in os.listdir(a_root)
                                     if os.path.isdir(os.path.join(a_root, d)) for f in os.listdir(os.path.join(a_root, d)))
    for f in files:
        _close(np.load(os.path.join(a_root, f)), np.load(os.path.join(b_root, f)), rel, f)


def test_extract_folder_embeddings_matches_jax(tmp_path, embedders):
    cfg, params, state, model = embedders
    root = _write_tree(str(tmp_path / "images"))
    ours, theirs = _detectors()
    got = embed_extract.extract_folder_embeddings(
        root, str(tmp_path / "ours"), embed_extract.make_arcface_embed_fn(model, PARITY_POLICY, device="cpu"),
        detector=ours, batch_size=2)
    want = jembed.extract_folder_embeddings(
        root, str(tmp_path / "theirs"), jembed.make_arcface_embed_fn(params, state, cfg, JPOLICY),
        detector=theirs, batch_size=2)
    assert len(want["files_without_faces"]) == 2
    _same_embeddings(str(tmp_path / "ours"), str(tmp_path / "theirs"), got["files_without_faces"],
                     want["files_without_faces"], 2e-4)


def test_extract_embeddings_streaming_matches_jax(tmp_path, embedders):
    cfg, params, state, model = embedders
    root = _write_tree(str(tmp_path / "images"))
    ours, theirs = _detectors()
    got = embed_extract.extract_embeddings_streaming(
        root, str(tmp_path / "ours"), embed_extract.make_crop_embed_fn(model, PARITY_POLICY, device="cpu"),
        ours, batch_size=3)
    want = jembed.extract_embeddings_streaming(
        root, str(tmp_path / "theirs"), jembed.make_crop_embed_fn(params, state, cfg, JPOLICY), theirs,
        batch_size=3, use_native=False)
    _same_embeddings(str(tmp_path / "ours"), str(tmp_path / "theirs"), got["files_without_faces"],
                     want["files_without_faces"], 2e-4)
    with pytest.raises(NotImplementedError, match="item 13"):
        embed_extract.extract_embeddings_streaming(root, str(tmp_path / "n"), None, ours, use_native=True)


def _quantized_sites(tree, prefix=""):
    """The paths of JAX's quantized "w" leaves ({"q", "s"} dicts)."""
    out = []
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if k == "w" and isinstance(v, dict) and "q" in v:
            out.append(path)
        else:
            out += _quantized_sites(v, path)
    return out


def _quant_inputs():
    rng = np.random.default_rng(5)
    return (rng.normal(0, 1, (2, 14, 14, 128)).astype(np.float32),
            [rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32) for _ in range(2)],
            rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32))


def _jax_quantized(cfg, params, state):
    """JAX's side of the quantized-embedder test: the quantized tree, one
    quantized conv with a static scale, the calibrated tree and its forward."""
    xc, calib, x = _quant_inputs()
    qparams = jax.jit(jquant.quantize_iresnet)(params)
    conv = qparams["layer2"][0]["conv2"]
    one_conv = jquant.qconv2d(jnp.asarray(xc), {"w": dict(conv["w"], a=jnp.float32(0.03)), "b": conv["b"]})
    calibrated = jembed.calibrate_embed_quant(qparams, state, calib, cfg, JPOLICY)
    out, _ = jax.jit(lambda p, s, x: jir.apply(p, s, x, cfg, policy=JPOLICY))(calibrated, state, jnp.asarray(x))
    return _np(qparams), np.asarray(one_conv), _np(calibrated), np.asarray(out)


@pytest.fixture(scope="module", autouse=True)
def jax_quantized(embedders):
    """Starts JAX's side of the quantized test when the module starts (its
    calibration runs eagerly, op by op), on a worker thread."""
    pool = ThreadPoolExecutor(max_workers=1)
    yield pool.submit(_jax_quantized, *embedders[:3])
    pool.shutdown()


def test_quantized_embedder_matches_jax(embedders, jax_quantized):
    """quantize_iresnet quantizes the sites JAX's IRESNET_SKIP leaves (the
    stem skipped by its exact path, fc skipped, the blocks' conv1 quantized);
    on one input the quantized conv equals JAX's exactly; calibration gives
    each site's static scale within 1e-2 of JAX's; the calibrated embedder
    is within 2e-2 (max) and 3e-3 (mean) of JAX's max abs: a code that
    rounds the other way in one layer moves the next layer's amax, so the
    two differ by more than fp32 order."""
    cfg, params, state, _ = embedders
    qparams, want_conv, calibrated, want = jax_quantized.result()
    model = load_jax_params(iresnet.IResNet(iresnet.IResNetConfig(**FACE_CFG), device="cpu"), _np(params), _np(state))
    sites = quant.quantize_iresnet(model)
    assert sorted(sites) == sorted(_quantized_sites(qparams))
    assert "conv1/w" not in sites and "layer1/0/conv1/w" in sites
    # JAX's codes and scales carried over as they are (the port's
    # quantize_weight is held to JAX's in tests/test_torch_quant.py)
    model = load_jax_params(iresnet.IResNet(iresnet.IResNetConfig(**FACE_CFG), device="cpu"), qparams, _np(state))
    xc, calib, x = _quant_inputs()
    conv = model.layer2[0].conv2
    conv.weight.a = 0.03
    np.testing.assert_array_equal(quant.qconv2d(torch.from_numpy(xc), conv).detach().numpy(), want_conv)
    conv.weight.a = None
    embed_extract.calibrate_embed_quant(model, calib, PARITY_POLICY)
    for path, w in quant.quantized_sites(model).items():
        node = calibrated
        for key in path.split("/"):
            node = node[int(key)] if key.isdigit() else node[key]
        assert abs(w.a - float(node["a"])) <= 1e-2 * float(node["a"]), path
    with torch.no_grad():
        got = model(torch.from_numpy(x), PARITY_POLICY).numpy()
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert diff.max() <= 2e-2 * scale and diff.mean() <= 3e-3 * scale, (diff.max() / scale, diff.mean() / scale)


def test_align_images_matches_jax(tmp_path):
    root = _write_tree(str(tmp_path / "images"), per_id=2)
    ours, theirs = _detectors()
    got = align_driver.align_images(root, str(tmp_path / "ours"), ours)
    want = jalign_driver.align_images(root, str(tmp_path / "theirs"), theirs)
    assert got == want and len(want["missing_images"]) == 2
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names and len(names) == 5
    for name in names:
        if name.endswith(".jpg"):
            a = np.asarray(Image.open(tmp_path / "ours" / name), np.float64)
            b = np.asarray(Image.open(tmp_path / "theirs" / name), np.float64)
            assert np.abs(a - b).max() <= 2.0, name
