"""FR training datasets (port of `faceposegenerator_tpu/data/fr_dataset.py:
24-174`): host-side loaders → NHWC numpy batches, bit-equal to the JAX
package's in order and content.

Behavioral rebuild of `FR_training/utils/dataset.py`:
  - `FlatDirDataset` ≈ `ArcBiFaceGANDataset` (:241-279): flat directory of
    `<label>_<img>.jpg`, label = int(prefix before "_"), resize 112,
    augmentation, [-1,1] normalize.
  - `FolderDataset` ≈ `FaceDatasetFolder`/`CustomImageFolder`: per-class
    subdirectories.
The CUDA-stream prefetcher (`DataLoaderX`, :16-71) is replaced by a simple
double-buffered thread; the train step copies each batch to the card.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.mesh import host_row_slice


def _load_image(path: str, size: int = 112) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


class FlatDirDataset:
    """`<root>/<label>_<name>.jpg` with label = int(prefix)."""

    def __init__(self, root: str, image_size: int = 112, augment=None, seed: int = 0):
        self.root = root
        self.image_size = image_size
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.files: List[str] = []
        self.labels: List[int] = []
        for f in sorted(os.listdir(root)):
            if not f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                continue
            try:
                label = int(f.split("_")[0])
            except ValueError:
                continue
            self.files.append(f)
            self.labels.append(label)
        uniq = sorted(set(self.labels))
        self.label_map = {l: i for i, l in enumerate(uniq)}
        self.num_classes = len(uniq)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        img = _load_image(os.path.join(self.root, self.files[i]), self.image_size)
        if self.augment is not None:
            img = self.augment(img, self.rng)
        x = img.astype(np.float32) / 255.0
        return (x - 0.5) / 0.5, self.label_map[self.labels[i]]

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        epoch: int = 0,
        order_seed: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """`num_shards`/`shard_index`: per-host DP loading — each host takes
        its contiguous `batch_size` row slice of every global batch of
        `batch_size · num_shards`, deriving the identical global order from
        (order_seed, epoch) on every host; concatenating shard batches in
        host order reconstructs the single-process sequence (the reference
        gets this from Accelerate's dataloader wrap, `train_FR.py:227-229`)."""
        order = np.arange(len(self))
        if shuffle:
            if num_shards > 1:
                np.random.default_rng((order_seed, epoch)).shuffle(order)
            else:
                self.rng.shuffle(order)
        b_global = batch_size * num_shards
        n = len(order) // b_global if drop_last else -(-len(order) // b_global)
        rows = host_row_slice(b_global, num_shards, shard_index)
        for bi in range(n):
            idx = order[bi * b_global : (bi + 1) * b_global][rows]
            imgs, labels = zip(*(self[i] for i in idx))
            yield {
                "images": np.stack(imgs).astype(np.float32),
                "labels": np.asarray(labels, np.int32),
            }


class FolderDataset(FlatDirDataset):
    """Per-class subdirectories `<root>/<class>/<img>`."""

    def __init__(self, root: str, image_size: int = 112, augment=None, seed: int = 0):
        self.root = root
        self.image_size = image_size
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.files, self.labels = [], []
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.label_map = {c: i for i, c in enumerate(classes)}
        for c in classes:
            for f in sorted(os.listdir(os.path.join(root, c))):
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.files.append(os.path.join(c, f))
                    self.labels.append(c)
        self.num_classes = len(classes)

    def __getitem__(self, i: int):
        img = _load_image(os.path.join(self.root, self.files[i]), self.image_size)
        if self.augment is not None:
            img = self.augment(img, self.rng)
        x = img.astype(np.float32) / 255.0
        return (x - 0.5) / 0.5, self.label_map[self.labels[i]]


def prefetch(iterator, depth: int = 2):
    """Background-thread prefetcher (replaces `BackgroundGenerator`)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    END = object()

    def worker():
        for item in iterator:
            q.put(item)
        q.put(END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is END:
            break
        yield item


def merge_synthetic_datasets(
    synth_root: str,
    real_root: str,
    output_root: str,
    samples_per_id: Optional[int] = None,
) -> int:
    """Combine N synthetic samples/ID with real images into one flat FR
    training dir (reference `utils/augmentation_with_synthetic_data.py`).
    Returns the number of files copied."""
    import shutil

    os.makedirs(output_root, exist_ok=True)
    count = 0
    per_id: Dict[str, int] = {}
    for root in (synth_root, real_root):
        if not root or not os.path.isdir(root):
            continue
        for f in sorted(os.listdir(root)):
            if not f.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            ident = f.split("_")[0]
            if root == synth_root and samples_per_id is not None:
                if per_id.get(ident, 0) >= samples_per_id:
                    continue
                per_id[ident] = per_id.get(ident, 0) + 1
            shutil.copy(os.path.join(root, f), os.path.join(output_root, f))
            count += 1
    return count
