"""The native (C++) data-loader core (port of
`faceposegenerator_tpu/native/__init__.py`): pread-based RecordIO reads,
thread-parallel libjpeg decode → bilinear resize → [-1, 1] normalise
straight into a preallocated float32 batch, and a stored-deflate PNG writer.

The source is the port's own copy, `loader.cpp`, with a plain C interface.
`load()` compiles it on first use with

    g++ -O3 -shared -fPIC -std=c++17 loader.cpp -o <lib> -ljpeg -lpthread

into `build/native/<toolchain>/` at the repository root (`.gitignore`d;
`build_dir()`: a hash of the `g++ --version` line and the host's CPU
flags), named by a hash of the source and the command, and loads it with ctypes, which releases the
GIL for each call, as the JAX package's CPython extension does. It needs
g++ and libjpeg (`jpeglib.h`), and no Python headers. As in JAX, the loader
is optional: `load()` returns None where it cannot be built, `build_error()`
says why, and the callers fall back to PIL unless they were asked for the
native path (`use_native=True`), which then raises with that reason.

`load()` returns an object with JAX's five functions and their meanings:

    read_idx(path) -> (keys int64 bytes, offsets int64 bytes)
    read_records(path, offsets) -> [(labels f32 bytes, payload bytes)]
    decode_batch(payloads, out, size, nthreads) -> None
        out: a writable float32 buffer of [n, size, size, 3]
    decode_rgb(payload) -> (rgb8 bytes, width, height)
    write_png_batch(images_u8, h, w, paths, nthreads) -> None
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg", "-lpthread"]
_IRHEADER = struct.Struct("<IfQQ")  # flag, label, id, id2
_ERRLEN = 512

_LOCK = threading.Lock()
_mod = None
_build_error: str | None = None


def build_dir() -> Path:
    """`BUILD_DIR/<hash>`: the directory of this g++ and this host's CPU
    (`core.compile.machine_scoped_cache_dir`), so a `build/` copied to
    another machine rebuilds the loader instead of loading a foreign one."""
    from ..core.compile import machine_scoped_cache_dir, native_toolchain_tag

    return machine_scoped_cache_dir(BUILD_DIR, native_toolchain_tag(shutil.which("g++") or "g++"))


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS + LIBS).encode())
    return build_dir() / f"libfpg_loader-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile loader.cpp unless its library exists; returns the library."""
    target = _target()
    if target.exists():
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found on PATH: the native loader needs g++ and libjpeg")
    target.parent.mkdir(parents=True, exist_ok=True)
    # a per-process temporary: concurrent first builds never write one file
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {r.returncode}): {r.stderr.strip()}")
    os.replace(tmp, target)
    return target


def toolchain_missing() -> str | None:
    """What the build lacks on this machine, before trying it: "g++" when no
    g++ is on PATH, "jpeglib.h" when g++ cannot include it; None when both
    are there (a failure to build or link then is a fault)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++"
    r = subprocess.run([gxx, "-E", "-x", "c++", "-"], input="#include <stdio.h>\n#include <jpeglib.h>\n",
                       capture_output=True, text=True)
    return None if r.returncode == 0 else "jpeglib.h"


class _Loader:
    """The five functions over the built library's C entry points."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        pp = ctypes.POINTER(ctypes.c_void_p)
        sig = {
            "fpg_free": (None, [P]),
            "fpg_read_idx": (I64, [ctypes.c_char_p, pp, pp]),
            "fpg_read_records": (I, [ctypes.c_char_p, P, I64, P, pp, ctypes.c_char_p, I]),
            "fpg_decode_batch": (I, [P, P, I64, P, I, I, ctypes.c_char_p, I]),
            "fpg_decode_rgb": (I, [ctypes.c_char_p, I64, pp, ctypes.POINTER(I), ctypes.POINTER(I),
                                   ctypes.c_char_p, I]),
            "fpg_write_png_batch": (I, [P, I64, I, I, P, I, ctypes.c_char_p, I]),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        self.lib, self.path = lib, path

    def _take(self, ptr: ctypes.c_void_p, nbytes: int) -> bytes:
        try:
            return ctypes.string_at(ptr, nbytes) if nbytes else b""
        finally:
            self.lib.fpg_free(ptr)

    def read_idx(self, path: str):
        keys, offs = ctypes.c_void_p(), ctypes.c_void_p()
        n = self.lib.fpg_read_idx(os.fsencode(path), ctypes.byref(keys), ctypes.byref(offs))
        if n < 0:
            raise OSError(f"cannot open {path}")
        return self._take(keys, 8 * n), self._take(offs, 8 * n)

    def read_records(self, path: str, offsets):
        offs = np.ascontiguousarray(np.asarray(list(offsets), np.int64).reshape(-1))
        n = len(offs)
        lengths = np.zeros(n, np.int64)
        bodies, err = ctypes.c_void_p(), ctypes.create_string_buffer(_ERRLEN)
        rc = self.lib.fpg_read_records(os.fsencode(path), offs.ctypes.data, n, lengths.ctypes.data,
                                       ctypes.byref(bodies), err, _ERRLEN)
        if rc:
            raise (OSError if rc == 1 else ValueError)(err.value.decode())
        buf = self._take(bodies, int(lengths.sum()))
        out, at = [], 0
        for length in lengths.tolist():
            body, at = buf[at: at + length], at + length
            if len(body) < _IRHEADER.size:
                raise ValueError("record shorter than IRHeader")
            flag = _IRHEADER.unpack_from(body)[0]
            if flag > 0:
                end = _IRHEADER.size + 4 * flag
                if len(body) < end:
                    raise ValueError("record label block truncated")
                out.append((body[_IRHEADER.size: end], body[end:]))
            else:
                out.append((body[4:8], body[_IRHEADER.size:]))  # the scalar label
        return out

    def decode_batch(self, payloads, out, size: int, nthreads: int) -> None:
        payloads = list(payloads)
        n = len(payloads)
        dst = np.frombuffer(out, np.uint8)
        if not dst.flags.writeable:
            raise TypeError("decode_batch needs a writable output buffer")
        if dst.nbytes < 4 * size * size * 3 * n:
            raise ValueError("output buffer too small")
        ptrs = (ctypes.c_char_p * max(n, 1))(*payloads)  # bytes only, as JAX's extension takes
        lengths = np.asarray([len(p) for p in payloads] or [0], np.int64)
        err = ctypes.create_string_buffer(_ERRLEN)
        if self.lib.fpg_decode_batch(ptrs, lengths.ctypes.data, n, dst.ctypes.data, int(size), int(nthreads),
                                     err, _ERRLEN):
            raise ValueError(f"JPEG decode failed: {err.value.decode()}")

    def decode_rgb(self, payload):
        payload = bytes(payload)
        rgb, w, h = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
        err = ctypes.create_string_buffer(_ERRLEN)
        if self.lib.fpg_decode_rgb(payload, len(payload), ctypes.byref(rgb), ctypes.byref(w), ctypes.byref(h),
                                   err, _ERRLEN):
            raise ValueError(f"JPEG decode failed: {err.value.decode()}")
        return self._take(rgb, w.value * h.value * 3), w.value, h.value

    def write_png_batch(self, images, h: int, w: int, paths, nthreads: int) -> None:
        paths = [os.fsencode(p) for p in paths]
        n = len(paths)
        if n == 0:
            return
        src = np.frombuffer(images, np.uint8)
        per = int(h) * int(w) * 3
        if per == 0 or src.nbytes != per * n:
            raise ValueError("buffer does not match [n, h, w, 3] uint8")
        names = (ctypes.c_char_p * n)(*paths)
        err = ctypes.create_string_buffer(_ERRLEN)
        if self.lib.fpg_write_png_batch(src.ctypes.data, n, int(h), int(w), names, int(nthreads), err, _ERRLEN):
            raise OSError(err.value.decode())


def load():
    """The loader (an object with the five functions), or None where it
    cannot be built (then `build_error()` says why)."""
    global _mod, _build_error
    if _mod is not None:
        return _mod
    if _build_error is not None:
        return None
    with _LOCK:
        if _mod is not None:
            return _mod
        try:
            _mod = _Loader(_build())
        except Exception as e:  # no g++ / libjpeg / a load failure: the callers fall back
            _build_error = f"{type(e).__name__}: {e}"
            return None
    return _mod


def available() -> bool:
    return load() is not None


def build_error() -> str | None:
    """Why the native loader is unavailable (None when it loaded)."""
    load()
    return _build_error
