"""mxnet RecordIO reader and writer for `.rec/.idx` face datasets (port of
`faceposegenerator_tpu/data/recordio.py`): `MXFaceDataset` without mxnet,
the layout the insightface training sets (ms1mv3 and the like) ship in:

  .idx  — "<key>\\t<byte offset>" lines
  .rec  — records of [magic u32 | lrecord u32][payload][pad to 4]
          where lrecord = (cflag << 29) | length
  payload — IRHeader {u32 flag; f32 label; u64 id; u64 id2} then, if
          flag > 0, `flag` extra f32 label values, then the JPEG bytes.

Record 0 carries dataset metadata (label = [id_start, id_end]) in the
insightface layout; image records have label = identity.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_MAGIC = 0xCED7230A
_IRHEADER = struct.Struct("<IfQQ")  # flag, label, id, id2


def read_idx(path: str) -> Dict[int, int]:
    """key -> byte offset."""
    out = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            key, off = line.split("\t")
            out[int(key)] = int(off)
    return out


def _read_record(f) -> Optional[bytes]:
    head = f.read(8)
    if len(head) < 8:
        return None
    magic, lrec = struct.unpack("<II", head)
    if magic != _MAGIC:
        raise ValueError(f"bad RecordIO magic {magic:#x}")
    length = lrec & ((1 << 29) - 1)
    data = f.read(length)
    pad = (-length) % 4
    if pad:
        f.read(pad)
    return data


def unpack_record(data: bytes) -> Tuple[np.ndarray, bytes]:
    """Returns (label array, payload bytes)."""
    flag, label, _id, _id2 = _IRHEADER.unpack_from(data)
    offset = _IRHEADER.size
    if flag > 0:
        labels = np.frombuffer(data, np.float32, count=flag, offset=offset)
        offset += 4 * flag
    else:
        labels = np.asarray([label], np.float32)
    return labels, data[offset:]


def iter_records(rec_path: str) -> Iterator[Tuple[np.ndarray, bytes]]:
    with open(rec_path, "rb") as f:
        while True:
            data = _read_record(f)
            if data is None:
                return
            yield unpack_record(data)


def write_records(rec_path: str, idx_path: str, records: List[Tuple[np.ndarray, bytes]]):
    """Writer (for tests and dataset conversion): records = [(labels, payload)]."""
    offsets = []
    with open(rec_path, "wb") as f:
        for labels, payload in records:
            labels = np.asarray(labels, np.float32)
            if len(labels) == 1:
                body = _IRHEADER.pack(0, float(labels[0]), 0, 0) + payload
            else:
                body = _IRHEADER.pack(len(labels), 0.0, 0, 0) + labels.tobytes() + payload
            offsets.append(f.tell())
            lrec = len(body)
            f.write(struct.pack("<II", _MAGIC, lrec))
            f.write(body)
            f.write(b"\x00" * ((-lrec) % 4))
    with open(idx_path, "w") as f:
        for i, off in enumerate(offsets):
            f.write(f"{i}\t{off}\n")


class MXFaceDataset:
    """RecordIO-backed FR dataset: (image [-1, 1] NHWC fp32, int label).

    `batches()` rides the native loader (`faceposegenerator_tpu_torch.native`)
    where it builds: pread record extraction and thread-parallel libjpeg
    decode/resize/normalise straight into the batch array, GIL released; it
    falls back to the per-item PIL path otherwise, and for a batch whose
    payloads libjpeg rejects. `use_native=True` raises where the loader cannot
    be built, `False` never builds it, `None` takes it where it builds.
    """

    def __init__(
        self,
        rec_path: str,
        idx_path: Optional[str] = None,
        image_size: int = 112,
        use_native: Optional[bool] = None,
        decode_threads: int = 8,
    ):
        self.rec_path = rec_path
        self.image_size = image_size
        self.decode_threads = decode_threads
        self._native = None
        if use_native is not False:
            from .. import native as _native_pkg

            self._native = _native_pkg.load()
            if use_native is True and self._native is None:
                raise RuntimeError(f"native loader requested but unavailable: {_native_pkg.build_error()}")
        idx_path = idx_path or os.path.splitext(rec_path)[0] + ".idx"
        self.offsets = read_idx(idx_path)
        self.keys = sorted(self.offsets)
        self._f = open(rec_path, "rb")
        # insightface layout: record 0 is metadata when its label spans ids
        first_labels, first_payload = self._read_at(self.keys[0])
        self.has_meta = len(first_payload) == 0 or (
            len(first_labels) >= 2 and first_payload[:2] != b"\xff\xd8"
        )
        self.image_keys = self.keys[1:] if self.has_meta else self.keys
        self._num_classes = None
        self.pil_batches = 0  # batches the native path handed to PIL

    def _read_at(self, key: int):
        self._f.seek(self.offsets[key])
        return unpack_record(_read_record(self._f))

    def __len__(self):
        return len(self.image_keys)

    @property
    def num_classes(self) -> int:
        """The number of identities (the port's addition, so that
        `training.fr_driver.train_fr_run` sizes its head from this dataset
        as it does from a `FlatDirDataset`): id_end - id_start from the meta
        record where there is one, else the largest image label + 1, read
        from the record headers once."""
        if self._num_classes is None and self.has_meta:
            labels, _ = self._read_at(self.keys[0])
            self._num_classes = int(labels[1] - labels[0])
        if self._num_classes is None:
            top = -1
            for key in self.image_keys:
                self._f.seek(self.offsets[key] + 8)
                flag, label = _IRHEADER.unpack(self._f.read(_IRHEADER.size))[:2]
                if flag > 0:
                    label = struct.unpack("<f", self._f.read(4))[0]
                top = max(top, int(label))
            self._num_classes = top + 1
        return self._num_classes

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        import io

        from PIL import Image

        labels, payload = self._read_at(self.image_keys[i])
        img = Image.open(io.BytesIO(payload)).convert("RGB")
        if img.size != (self.image_size, self.image_size):
            img = img.resize((self.image_size, self.image_size), Image.BILINEAR)
        x = np.asarray(img, np.float32) / 255.0
        return (x - 0.5) / 0.5, int(labels[0])

    def _batch_native(self, idx: np.ndarray) -> dict:
        """One batch through the native loader: pread the records, decode
        every JPEG on `decode_threads` threads into a preallocated [-1, 1]
        fp32 NHWC array."""
        offs = [self.offsets[self.image_keys[i]] for i in idx]
        recs = self._native.read_records(self.rec_path, offs)
        labels = np.asarray([np.frombuffer(lab, np.float32)[0] for lab, _ in recs], np.int32)
        out = np.empty((len(idx), self.image_size, self.image_size, 3), np.float32)
        self._native.decode_batch([payload for _, payload in recs], out, self.image_size, self.decode_threads)
        return {"images": out, "labels": labels}

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        """`num_shards`/`shard_index`: per-host data-parallel loading. Every
        host derives the same global order from `seed`, then reads and
        decodes only its contiguous `batch_size` slice of each global batch
        (`core.mesh.host_row_slice`); the slices in host order make the
        single-process batch."""
        from ..core.mesh import host_row_slice

        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        b_global = batch_size * num_shards
        rows = host_row_slice(b_global, num_shards, shard_index)
        n = len(order) // b_global if drop_last else -(-len(order) // b_global)
        for bi in range(n):
            idx = order[bi * b_global: (bi + 1) * b_global][rows]
            if self._native is not None:
                try:
                    yield self._batch_native(idx)
                    continue
                except ValueError:  # a payload libjpeg rejects (PNG, corrupt): PIL for this batch
                    self.pil_batches += 1
            imgs, labels = zip(*(self[i] for i in idx))
            yield {
                "images": np.stack(imgs).astype(np.float32),
                "labels": np.asarray(labels, np.int32),
            }
