"""The port's native loader (`faceposegenerator_tpu_torch/native/`: its own
copy of loader.cpp behind a plain C interface, loaded with ctypes) against
the JAX package's CPython extension (`faceposegenerator_tpu.native`) on the
same records and payloads: `read_idx`, `read_records`, `decode_rgb` and
`decode_batch` bit-equal, corrupt payloads and records raising the same
`ValueError`, `write_png_batch` files byte-equal; and without g++ on PATH
the build error is reported, and `use_native=True` raises it.
"""

import io

import numpy as np
import pytest

from faceposegenerator_tpu import native as jnative
from faceposegenerator_tpu.data import recordio as jrecordio
from faceposegenerator_tpu_torch import native
from faceposegenerator_tpu_torch.data import recordio

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason=f"the JAX package's loader, the referee, is unavailable: {jnative.build_error()}")


def jpeg_bytes(rng, w, h, quality=95):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """An insightface-layout .rec/.idx: a meta record, then 12 JPEGs of
    mixed sizes (a 1-pixel-wide one among them) with scalar labels, and one
    with a 3-value label block."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("rec")
    rec, idx = str(d / "train.rec"), str(d / "train.idx")
    recs = [(np.asarray([1.0, 14.0], np.float32), b"")]
    sizes = [(112, 112)] * 8 + [(96, 130), (130, 96), (1, 7), (200, 200)]
    recs += [(np.asarray([float(i % 5)], np.float32), jpeg_bytes(rng, w, h)) for i, (w, h) in enumerate(sizes)]
    recs.append((np.asarray([3.0, 0.5, 0.25], np.float32), jpeg_bytes(rng, 112, 112)))
    jrecordio.write_records(rec, idx, recs)
    return rec, idx, recs


@pytest.fixture(scope="module")
def loaders():
    mine = native.load()
    assert mine is not None, native.build_error()
    return mine, jnative.load()


def test_read_idx_and_records_equal_jax(records, loaders):
    rec, idx, recs = records
    mine, ref = loaders
    assert mine.read_idx(idx) == ref.read_idx(idx)
    offsets = list(np.frombuffer(ref.read_idx(idx)[1], np.int64))
    got, want = mine.read_records(rec, offsets), ref.read_records(rec, offsets)
    assert got == want and len(got) == len(recs)
    # any order, repeats
    pick = [offsets[3], offsets[0], offsets[3], offsets[-1]]
    assert mine.read_records(rec, pick) == ref.read_records(rec, pick)
    assert mine.read_records(rec, []) == ref.read_records(rec, []) == []


def test_decode_rgb_and_batch_bit_equal_jax(records, loaders):
    _, _, recs = records
    mine, ref = loaders
    payloads = [p for _, p in recs[1:]]
    for p in payloads:
        assert mine.decode_rgb(p) == ref.decode_rgb(p)
    for size, threads in ((112, 4), (64, 1), (150, 8)):
        got = np.full((len(payloads), size, size, 3), np.nan, np.float32)
        want = np.full_like(got, np.nan)
        mine.decode_batch(payloads, got, size, threads)
        ref.decode_batch(payloads, want, size, threads)
        np.testing.assert_array_equal(got, want)


def test_corrupt_inputs_raise_as_jax(records, loaders, tmp_path):
    rec, idx, recs = records
    mine, ref = loaders
    out = np.empty((2, 112, 112, 3), np.float32)
    for loader in (mine, ref):
        with pytest.raises(ValueError, match="JPEG decode failed: Not a JPEG file"):
            loader.decode_batch([recs[1][1], b"not a jpeg"], out, 112, 2)
        with pytest.raises(ValueError, match="JPEG decode failed"):
            loader.decode_rgb(recs[1][1][:40])
        with pytest.raises(ValueError, match="output buffer too small"):
            loader.decode_batch([recs[1][1]] * 3, out, 112, 1)
    offsets = list(np.frombuffer(ref.read_idx(idx)[1], np.int64))
    for bad, what in (([offsets[1] + 4], "bad RecordIO magic"), ([10**9], "short read at record header")):
        for loader in (mine, ref):
            with pytest.raises(ValueError, match=what):
                loader.read_records(rec, bad)
    with pytest.raises(OSError):
        mine.read_records(str(tmp_path / "none.rec"), [0])
    with pytest.raises(OSError):
        mine.read_idx(str(tmp_path / "none.idx"))


def test_write_png_batch_byte_equal_jax(loaders, tmp_path):
    from PIL import Image

    mine, ref = loaders
    imgs = np.random.default_rng(1).integers(0, 256, (3, 40, 300, 3), np.uint8)  # rows over a 64 KB block
    paths = {k: [str(tmp_path / f"{k}{i}.png") for i in range(3)] for k in ("mine", "ref")}
    mine.write_png_batch(imgs, 40, 300, paths["mine"], 2)
    ref.write_png_batch(np.ascontiguousarray(imgs), 40, 300, paths["ref"], 2)
    for i, (a, b) in enumerate(zip(paths["mine"], paths["ref"])):
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(np.asarray(Image.open(a)), imgs[i])
    for loader in (mine, ref):
        with pytest.raises(ValueError, match="does not match"):
            loader.write_png_batch(imgs, 41, 300, paths["mine"], 2)
    with pytest.raises(OSError, match="open failed"):
        mine.write_png_batch(imgs[:1], 40, 300, [str(tmp_path / "no" / "dir.png")], 1)


def test_without_gxx_the_build_error_is_named(records, monkeypatch, tmp_path):
    """With no g++ on PATH and nothing built: `load()` gives None and
    `build_error()` names g++, `toolchain_missing()` says "g++",
    `MXFaceDataset(use_native=True)` raises with that reason, and
    `use_native=None` falls back to PIL."""
    rec, idx, _ = records
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_mod", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert native.toolchain_missing() == "g++"
    assert native.load() is None and not native.available()
    assert "g++ not found" in native.build_error()
    with pytest.raises(RuntimeError, match="native loader requested but unavailable: FileNotFoundError: g"):
        recordio.MXFaceDataset(rec, idx, use_native=True)
    ds = recordio.MXFaceDataset(rec, idx, use_native=None)
    assert ds._native is None and len(ds) == 13
    assert not (tmp_path / "build").exists()


def test_the_build_lands_under_build_native_keyed_by_the_source(loaders):
    mine, _ = loaders
    assert mine.path.parent == native.BUILD_DIR and mine.path.parent.parts[-2:] == ("build", "native")
    assert mine.path == native._target() and mine.path.exists()
    assert native.toolchain_missing() is None
