"""The safetensors file format, read and written without the `safetensors`
package (the card's machine does not have it).

A file is an 8-byte little-endian header length N, N bytes of a JSON header,
then the raw little-endian bytes of every tensor:

    {"<name>": {"dtype": "F32", "shape": [320, 4, 3, 3], "data_offsets": [begin, end]},
     ..., "__metadata__": {"format": "pt"}}

with offsets counted from the first byte after the header. The tensors tile
the data region exactly, in any order. `load_file` returns torch tensors in
the file's dtypes; `load_numpy` returns numpy arrays, BF16 widened to fp32
(exact; numpy has no bfloat16). `save_file` takes torch tensors (on any
device, moved to the host one at a time) or numpy arrays.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_NUMPY = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
          np.dtype(np.int64): "I64", np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
          np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL"}
# a header larger than this is not a safetensors file (the package's own limit)
MAX_HEADER = 100_000_000


def read_header(path: str) -> Tuple[dict, int]:
    """(header, byte offset of the data region). Raises ValueError on a
    truncated or malformed header, or on tensors that do not tile the data
    region."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated safetensors header length")
        n = int.from_bytes(head, "little")
        if n > MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes does not fit a {size}-byte file")
        raw = f.read(n)
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: malformed safetensors header: {e}") from None
    spans = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info.get("dtype") not in DTYPES:
            raise ValueError(f"{path}: {name}: unknown dtype {info.get('dtype')!r}")
        begin, end = info["data_offsets"]
        numel = int(np.prod(info["shape"], dtype=np.int64))
        if end - begin != numel * DTYPES[info["dtype"]].itemsize:
            raise ValueError(f"{path}: {name}: {end - begin} bytes for shape {info['shape']} {info['dtype']}")
        spans.append((begin, end))
    pos = 0
    for begin, end in sorted(spans):
        if begin != pos:
            raise ValueError(f"{path}: tensors do not tile the data region (gap or overlap at byte {pos})")
        pos = end
    if 8 + n + pos != size:
        raise ValueError(f"{path}: data region holds {size - 8 - n} bytes, the header {pos}")
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU in its own dtype."""
    header, start = read_header(path)
    with open(path, "rb") as f:
        f.seek(start)
        buf = torch.from_numpy(np.fromfile(f, dtype=np.uint8))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = buf[begin:end]
        if begin % dtype.itemsize:  # the view needs an aligned start
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def load_numpy(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the file as a numpy array; BF16 comes back as fp32."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in load_file(path).items()}


def _entry(value) -> Tuple[str, list, int]:
    if isinstance(value, torch.Tensor):
        if value.dtype not in _NAMES:
            raise ValueError(f"safetensors cannot hold {value.dtype}")
        return _NAMES[value.dtype], list(value.shape), value.numel() * value.element_size()
    a = np.asarray(value)
    name = "BF16" if a.dtype.name == "bfloat16" else _NUMPY.get(a.dtype)
    if name is None:
        raise ValueError(f"safetensors cannot hold {a.dtype}")
    return name, list(a.shape), a.nbytes


def _bytes(value) -> memoryview:
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().reshape(-1).cpu()
        return memoryview(t.view(torch.uint8).numpy())
    return memoryview(np.ascontiguousarray(value).reshape(-1).view(np.uint8))


def save_file(tensors: Mapping[str, object], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (name → torch tensor or numpy array) to `path`, in
    name order, the header padded with spaces to a multiple of 8 bytes."""
    header, offset = {}, 0
    names = sorted(tensors)
    for name in names:
        dtype, shape, nbytes = _entry(tensors[name])
        header[name] = {"dtype": dtype, "shape": shape, "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in names:
            f.write(_bytes(tensors[name]))
