"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc` into its own shared library with a plain C
interface under `build/kernels/<toolchain>/` at the repository root
(`build_dir()`: `core.compile.machine_scoped_cache_dir` of `nvcc --version`
and the card's compute capability), named by a hash of the source and the
flags, so an edited source rebuilds, an unchanged one is reused, and a
`build/` copied to a machine with another toolkit or card is rebuilt there,
never loaded. The library is loaded with `ctypes`. Nothing here runs at import
time: the first kernel launch builds what it needs, and `build_all` builds
every source at once (one `nvcc` process per source, started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# the C entry point of each kernel, by the source that defines it
KERNELS = {
    "flash_fwd": ("flash_fwd_d64", "flash_fwd_wide"),
    "flash_bwd": ("flash_bwd_d64_dkv", "flash_bwd_d64_dq", "flash_bwd_wide_dkv", "flash_bwd_wide_dq"),
    "flash_f32": ("flash_fwd_f32", "flash_bwd_f32_dkv", "flash_bwd_f32_dq", "flash_f32_split"),
    "flash_int8": ("flash_int8", "flash_int8_f32", "flash_int8_amax", "flash_int8_codes"),
    "qdense": ("qdense", "qdense_f32", "qdense_quant"),
    "fused_gn": ("fused_group_norm",),
    "gn_conv": ("gn_silu_conv3x3", "gn_silu_conv3x3_f32", "gn_conv_f32_split"),
}
SOURCE_OF = {kernel: src for src, kernels in KERNELS.items() for kernel in kernels}

_loaded: dict[str, ctypes.CDLL] = {}
_build_dir: list = []  # this process's build_dir(), computed once


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build_dir() -> Path:
    """`build/kernels/<hash>`: this toolkit's and this card's directory."""
    if not _build_dir:
        from ..core.compile import kernel_toolchain_tag, machine_scoped_cache_dir

        _build_dir.append(machine_scoped_cache_dir(BUILD_ROOT, kernel_toolchain_tag(_nvcc())))
    return _build_dir[0]


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for `csrc/<name>.cu` unless its library exists. Returns
    (target, job) where job is None or (process, temporary output)."""
    target = _target(name)
    if target.exists():
        return target, None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    with open(target.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {rc}):\n" + target.with_suffix(".log").read_text()
        )
    os.replace(tmp, target)


def build_all() -> dict[str, Path]:
    """Build every `csrc/*.cu` in parallel; returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    for n, (target, job) in started.items():
        _finish(n, target, job)
    return {n: t for n, (t, _) in started.items()}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill report) for a built source."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _innermost(mangled: str) -> str:
    """The function's own name in an Itanium-mangled name: the last
    <length><identifier> of `_ZN...E` (namespaces first), or of `_Z...`."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        if not mangled.startswith("_ZN"):
            break
    return name


def ptxas_report(name: str) -> list[dict]:
    """Per kernel function of a built source, what ptxas reported: its own
    name, registers and spill bytes."""
    rows, cur = [], None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(function=_innermost(m.group(1)), mangled=m.group(1))
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def sass_hgmma(name: str) -> dict[str, list[int]]:
    """Per kernel function of a built source, [HGMMA instructions, those
    with TF32 operands] in its SASS (`cuobjdump -sass` of the library)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(_target(name))], capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(_innermost(m.group(1)), [0, 0])
        elif cur is not None and "HGMMA" in line:
            cur[0] += 1
            cur[1] += "TF32" in line
    return counts


def sass_ops(name: str, ops=("IGMMA", "HGMMA", "IMMA", "I2F", "I2FP", "F2I", "F2IP", "MUFU")) -> list[dict]:
    """Per kernel function (each template instance) of a built source, its
    own name and how many SASS instructions of each opcode in `ops` it has
    (the opcode before its first dot: IGMMA.64x128x32.S8.S8 counts as
    IGMMA), from `cuobjdump -sass`."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(_target(name))], capture_output=True, text=True, check=True).stdout
    rows, cur = [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = dict(function=_innermost(m.group(1)), **dict.fromkeys(ops, 0))
            rows.append(cur)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur is not None and m and m.group(1) in ops:
            cur[m.group(1)] += 1
    return rows


def kernel(name: str):
    """The C entry point of kernel `name` from its source's library."""
    return getattr(load(SOURCE_OF[name]), name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        target, job = _start(name)
        _finish(name, target, job)
        lib = _loaded[name] = ctypes.CDLL(str(target))
    return lib
