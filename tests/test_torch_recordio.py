"""The port's RecordIO layer (`faceposegenerator_tpu_torch/data/recordio.py`)
against the JAX package's on the same files: `write_records` byte-equal;
`read_idx`, `iter_records`, `unpack_record` equal; `MXFaceDataset`'s items,
`has_meta` and batches equal to JAX's, with the native path and without it;
sharded batches (`num_shards`/`shard_index`) concatenating to the global
batch; a batch whose payloads libjpeg rejects falling back to PIL for that
batch only, as JAX's does; and the port's `num_classes` for the FR driver.
"""

import io

import numpy as np
import pytest

from faceposegenerator_tpu import native as jnative
from faceposegenerator_tpu.data import recordio as jrecordio
from faceposegenerator_tpu_torch import native
from faceposegenerator_tpu_torch.data import recordio

from test_torch_native_loader import jpeg_bytes


def png_bytes(rng, w, h):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _records(seed, n, meta=True, sizes=None):
    rng = np.random.default_rng(seed)
    # insightface's meta record: [first identity record, end], 7 identities
    recs = [(np.asarray([float(n + 1), float(n + 8)], np.float32), b"")] if meta else []
    for i in range(n):
        w, h = (sizes or {}).get(i, (112, 112))
        recs.append((np.asarray([float(i % 7)], np.float32), jpeg_bytes(rng, w, h)))
    return recs


@pytest.fixture(scope="module")
def rec_files(tmp_path_factory):
    """The same records written by both packages: a meta record and 24
    JPEGs (two not at 112²), and a second file without the meta record."""
    d = tmp_path_factory.mktemp("rec")
    recs = _records(1, 24, sizes={5: (96, 130), 17: (140, 140)})
    paths = {}
    for name, mod in (("port", recordio), ("jax", jrecordio)):
        paths[name] = (str(d / f"{name}.rec"), str(d / f"{name}.idx"))
        mod.write_records(*paths[name], recs)
    nometa = (str(d / "nometa.rec"), str(d / "nometa.idx"))
    recordio.write_records(*nometa, _records(2, 6, meta=False))
    return paths, nometa, recs


def test_write_records_byte_equal_and_readers_equal(rec_files):
    paths, nometa, recs = rec_files
    for i in range(2):
        assert open(paths["port"][i], "rb").read() == open(paths["jax"][i], "rb").read()
    rec, idx = paths["port"]
    assert recordio.read_idx(idx) == jrecordio.read_idx(idx)
    got, want = list(recordio.iter_records(rec)), list(jrecordio.iter_records(rec))
    assert len(got) == len(want) == len(recs)
    for (gl, gp), (wl, wp) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        assert gl.dtype == wl.dtype and gp == wp
    with open(rec, "rb") as f:
        data = f.read()
    body = data[8: 8 + (np.frombuffer(data[4:8], np.uint32)[0] & ((1 << 29) - 1))]
    (gl, gp), (wl, wp) = recordio.unpack_record(body), jrecordio.unpack_record(body)
    np.testing.assert_array_equal(gl, wl)
    assert gp == wp == b""


@pytest.mark.parametrize("use_native", [False, True])
def test_dataset_items_and_batches_equal_jax(rec_files, use_native):
    paths, nometa, _ = rec_files
    ds = recordio.MXFaceDataset(*paths["port"], use_native=use_native)
    ref = jrecordio.MXFaceDataset(*paths["port"], use_native=use_native and jnative.available())
    assert (ds._native is not None) == use_native
    assert ds.has_meta == ref.has_meta is True and len(ds) == len(ref) == 24
    for i in (0, 5, 17, 23):
        (gx, gy), (wx, wy) = ds[i], ref[i]
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy
    got, want = list(ds.batches(8, shuffle=True, seed=3)), list(ref.batches(8, shuffle=True, seed=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["images"], w["images"])
        assert g["images"].dtype == np.float32 and g["labels"].dtype == np.int32
    assert ds.pil_batches == 0
    tail = list(ds.batches(10, shuffle=False, drop_last=False))
    assert [len(b["labels"]) for b in tail] == [10, 10, 4]
    plain = recordio.MXFaceDataset(*nometa, use_native=use_native)
    assert not plain.has_meta and len(plain) == 6


def test_native_batches_within_jax_gate_of_pil(rec_files):
    """The native decode against the PIL path on the 112² records (JAX's
    tests/test_native_loader.py gate: 1.5/255); PIL resizes with antialias,
    the native path plainly, so the two resized records are left out."""
    paths, _, _ = rec_files
    a = recordio.MXFaceDataset(*paths["port"], use_native=True)
    b = recordio.MXFaceDataset(*paths["port"], use_native=False)
    for bn, bp in zip(a.batches(8, seed=0), b.batches(8, seed=0)):
        np.testing.assert_array_equal(bn["labels"], bp["labels"])
    keep = [i for i in range(len(a)) if i not in (5, 17)]
    x = a._batch_native(np.asarray(keep))["images"]
    y = np.stack([b[i][0] for i in keep])
    assert np.abs(x - y).max() <= 1.5 / 255


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_batches_reconstruct_the_global_batch(rec_files, shards):
    paths, _, _ = rec_files
    ds = recordio.MXFaceDataset(*paths["port"], use_native=True)
    whole = list(ds.batches(8, seed=5))
    parts = [list(ds.batches(8 // shards, seed=5, num_shards=shards, shard_index=s)) for s in range(shards)]
    assert all(len(p) == len(whole) for p in parts)
    for bi, w in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[bi]["images"] for p in parts]), w["images"])
        np.testing.assert_array_equal(np.concatenate([p[bi]["labels"] for p in parts]), w["labels"])
    ref = list(jrecordio.MXFaceDataset(*paths["port"], use_native=False).batches(
        8 // shards, seed=5, num_shards=shards, shard_index=shards - 1))
    for g, w in zip(parts[-1], ref):
        np.testing.assert_array_equal(g["labels"], w["labels"])


def test_non_jpeg_batch_falls_back_to_pil_for_that_batch(tmp_path):
    """Batch 0 is all JPEG, batch 1 holds a PNG: the native path takes batch
    0, PIL batch 1 (counted in `pil_batches`), and the images equal JAX's
    dataset's on the same file."""
    rng = np.random.default_rng(11)
    recs = [(np.asarray([0.0, 9.0], np.float32), b"")]
    recs += [(np.asarray([float(i)], np.float32), png_bytes(rng, 112, 112) if i == 6 else jpeg_bytes(rng, 112, 112))
             for i in range(8)]
    rec, idx = str(tmp_path / "p.rec"), str(tmp_path / "p.idx")
    recordio.write_records(rec, idx, recs)
    ds = recordio.MXFaceDataset(rec, idx, use_native=True)
    got = list(ds.batches(4, shuffle=False))
    assert ds.pil_batches == 1
    want = list(jrecordio.MXFaceDataset(rec, idx, use_native=jnative.available()).batches(4, shuffle=False))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["images"], w["images"])
    np.testing.assert_array_equal(np.concatenate([b["labels"] for b in got]), np.arange(8))


def test_num_classes_for_the_fr_driver(rec_files, tmp_path):
    paths, _, _ = rec_files
    assert recordio.MXFaceDataset(*paths["port"], use_native=False).num_classes == 7
    recs = [(np.asarray([3.0, 12.0], np.float32), b"")] + rec_files[2][1:3]  # the meta record's count, unscanned
    recordio.write_records(str(tmp_path / "m.rec"), str(tmp_path / "m.idx"), recs)
    assert recordio.MXFaceDataset(str(tmp_path / "m.rec"), str(tmp_path / "m.idx"), use_native=False).num_classes == 9
    recs = [(np.asarray([4.0, 2.0], np.float32), jpeg_bytes(np.random.default_rng(3), 8, 8))]  # a label block
    recordio.write_records(str(tmp_path / "b.rec"), str(tmp_path / "b.idx"), recs)
    ds = recordio.MXFaceDataset(str(tmp_path / "b.rec"), str(tmp_path / "b.idx"), use_native=False)
    assert not ds.has_meta and ds.num_classes == 5 and ds[0][1] == 4
    assert native.available()
