"""Flash-attention kernels for the card, their launch counts, their plain
PyTorch versions and the autograd Function that joins them (port of
`faceposegenerator_tpu/ops/flash_attention.py:1084`, `flash_attention`, and
its custom VJP, `:966-1081`).

CUDA kernels replace the Pallas kernels of the sampling and training
paths:

  `flash_fwd_d64`       K1, `_fwd_kernel_packed` (:258): every UNet
                        attention, head dim 64 (csrc/flash_fwd.cu);
  `flash_fwd_wide`      K2, `_fwd_kernel` (:104): head dim % 128 == 0, the
                        VAE's one 512-dim head (csrc/flash_fwd.cu);
  `flash_bwd_d64_dkv`,  K5, `_bwd_kernel_packed_dkv` (:711) and
  `flash_bwd_d64_dq`    `_bwd_kernel_packed_dq` (:777) (csrc/flash_bwd.cu);
  `flash_bwd_wide_dkv`, K6, `_bwd_kernel_plain_dkv` (:542) and
  `flash_bwd_wide_dq`   `_bwd_kernel_plain_dq` (:585) (csrc/flash_bwd.cu);
  `flash_int8`          K8, `_fwd_kernel_packed_int8` (:1108): the int8
                        attention of `flash_attention_int8` (:1261), head
                        dim 64, inference only, any key length
                        (csrc/flash_int8.cu);
  `flash_int8_amax`,    its two quantize launches: the per-tensor amax of
  `flash_int8_codes`    q, k and v, then their codes in the attention's
                        layouts and its two scale constants, on the device;
  `flash_fwd_f32`,      the fp32 instance of K1/K2 and of K5/K6: JAX sends
  `flash_bwd_f32_dkv`,  fp32 as well as bf16 to its kernels
  `flash_bwd_f32_dq`    (`flash_supported`, :87-101), any head dim in
                        {64, 128, 256, 384, 512}, 3xTF32 on the tensor
                        cores (csrc/flash_f32.cu);
  `flash_f32_split`     their pre-pass: each fp32 operand split into tf32 hi
                        and lo planes, natural or transposed (one launch per
                        fp32 forward or backward call);
  `flash_int8_f32`      K8 writing fp32 for fp32 q, k, v.

`kernel_for(dtype, head_dim, backward)` names the entry points a dtype and
head dim go to, before any launch, or None where JAX's `flash_supported`
refuses them. All take (B, S, H, D) tensors of one dtype (bf16 for K1, K2,
K5, K6, K8; fp32 for the f32 instances) whose head dim is contiguous; other
strides are passed to the kernel, so the q/k/v views split out of a fused
projection need no copy. The forward kernels also write the per-row
log-sum-exp (B, H, Sq) fp32 when asked (`with_lse=True`); the backward
kernels recompute the normalised p from it. A CPU tensor goes to the plain
version; a CUDA tensor goes to its kernel or raises. Each wrapper adds one to
`LAUNCHES[name]` where it launches its kernel, and nowhere else; a forward
launch that writes the log-sum-exp also adds one to `LSE_LAUNCHES[name]`.
Where a wrapper launches, it also adds the FLOPs of the function it computes
to `core.flops.count_kernel` (4·B·H·Sq·Skv·D a forward, 10· a backward pair).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.flops import count_kernel
from . import _build
from .qdense import INV127, quantize

LAUNCHES = {
    "flash_fwd_d64": 0, "flash_fwd_wide": 0,
    "flash_bwd_d64_dkv": 0, "flash_bwd_d64_dq": 0,
    "flash_bwd_wide_dkv": 0, "flash_bwd_wide_dq": 0, "flash_int8": 0,
    "flash_fwd_f32": 0, "flash_bwd_f32_dkv": 0, "flash_bwd_f32_dq": 0, "flash_int8_f32": 0,
    "flash_f32_split": 0, "flash_int8_amax": 0, "flash_int8_codes": 0,
}
LSE_LAUNCHES = {"flash_fwd_d64": 0, "flash_fwd_wide": 0, "flash_fwd_f32": 0}
_WIDE_DIMS = (128, 256, 384, 512)
_F32_DIMS = (64, *_WIDE_DIMS)
_INT32_MAX = 2**31 - 1
_fns: dict = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LSE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def kernel_for(dtype: torch.dtype, head_dim: int, backward: bool = False):
    """The kernel entry points that attention over `dtype` at `head_dim`
    goes to on the card: the forward's name, or the backward's (dK/dV, dQ)
    pair; None where JAX's `flash_supported` (flash_attention.py:87-101)
    refuses the inputs (a dtype other than fp32 and bf16, a head dim that is
    neither 64 nor a multiple of 128), which `impl="auto"` sends to the
    plain einsum. The kernels' own limits (head dim at most 512) raise at
    launch."""
    if dtype not in (torch.float32, torch.bfloat16) or (head_dim != 64 and head_dim % 128):
        return None
    kind = "f32" if dtype == torch.float32 else "d64" if head_dim == 64 else "wide"
    if backward:
        return f"flash_bwd_{kind}_dkv", f"flash_bwd_{kind}_dq"
    return f"flash_fwd_{kind}"


def _logits(q, k, scale, kv_len):
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[1]:
        logits[..., kv_len:] = float("-inf")
    return logits


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, kv_len: Optional[int] = None
) -> torch.Tensor:
    """The kernels' function in plain PyTorch (`ops/attention.py:23-39` of
    the JAX package): fp32 logits and softmax, keys >= kv_len masked to
    -inf, weights rounded to q's dtype before P·V, fp32 accumulation."""
    w = torch.softmax(_logits(q, k, scale, kv_len), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype)


def attention_plain_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, kv_len: Optional[int] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """`attention_plain` that also returns each row's log-sum-exp of the
    scaled logits, (B, H, Sq) fp32 in natural-log units (the JAX kernels'
    `save_lse`, flash_attention.py:148-153,271-274)."""
    logits = _logits(q, k, scale, kv_len)
    lse = torch.logsumexp(logits, dim=-1)
    w = torch.exp(logits - lse[..., None]).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float()).to(q.dtype), lse


def attention_bwd_plain(q, k, v, o, lse, do, scale: float, kv_len: Optional[int] = None):
    """The backward kernels' function in fp32 PyTorch: p recomputed from
    lse, D = rowsum(dO∘O), dV = pᵀ·dO with p rounded to q's dtype,
    dS = p∘(dP − D) rounded to q's dtype, dQ = scale·dS·k, dK = scale·dSᵀ·q.
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    p = torch.exp(_logits(q, k, scale, kv_len) - lse.float()[..., None])
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    dd = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, Sq, 1)
    ds = (p * (dp - dd)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 `x` rounded to tf32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as `cvt.rna.tf32.f32` does: half a tf32 ulp (bit
    12) added to the magnitude bits, the 13 low bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of csrc/sm90_common.cuh `tf32_split`:
    hi = rna_tf32(x), lo = rna_tf32(x − hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


# Position c of each group of 8 in the transposed layout holds key
# _KEY_PERM[c], so that a thread's accumulator registers are the tf32 A
# fragment of the next product as they are (csrc/flash_f32.cu).
_KEY_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def f32_split_plain(x: torch.Tensor, transposed: bool) -> torch.Tensor:
    """`flash_f32_split`'s output for one (B, S, H, D) operand in plain
    PyTorch: (2, B·H, S, D) hi/lo planes, or transposed (2, B·H, D, S_pad),
    S_pad = S rounded up to 64, keys permuted within groups of 8 and zero
    past S."""
    b, s, h, d = x.shape
    planes = torch.stack(tf32_split_plain(x.float())).permute(0, 1, 3, 2, 4).reshape(2, b * h, s, d)
    if not transposed:
        return planes
    pad = -(-s // 64) * 64
    out = torch.zeros((2, b * h, pad, d), dtype=torch.float32, device=x.device)
    out[:, :, :s] = planes
    perm = (torch.arange(pad).view(-1, 8)[:, list(_KEY_PERM)]).reshape(-1).to(x.device)
    return out.index_select(2, perm).transpose(2, 3).contiguous()


def f32_split(specs) -> list[torch.Tensor]:
    """Split each (tensor, transposed) of `specs` (fp32 (B, S, H, D) tensors
    of one B, H and D) into the layout of `f32_split_plain`: on the card in
    one `flash_f32_split` launch, for CPU tensors by the plain version."""
    if not specs[0][0].is_cuda:
        return [f32_split_plain(t, tr) for t, tr in specs]
    b, _, h, d = specs[0][0].shape
    outs, vals = [], []
    for t, tr in specs:
        s = t.shape[1]
        shape = (2, b * h, d, -(-s // 64) * 64) if tr else (2, b * h, s, d)
        out = torch.empty(shape, dtype=torch.float32, device=t.device)
        outs.append(out)
        vals += [t.data_ptr(), out.data_ptr(), *t.stride()[:3], s, int(tr)]
    _call("flash_f32_split", (ctypes.c_longlong * len(vals))(*vals), len(specs), b, h, d,
          torch.cuda.current_stream(specs[0][0].device).cuda_stream)
    return outs


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # the C signatures in csrc/flash_fwd.cu, flash_bwd.cu, flash_f32.cu and flash_int8.cu
    "flash_fwd_d64": [_PTR] * 5 + [_INT] * 16 + [_FLOAT, _PTR],
    "flash_fwd_wide": [_PTR] * 5 + [_INT] * 17 + [_FLOAT, _PTR],
    "flash_bwd_d64_dkv": [_PTR] * 8 + [_INT] * 5 + [_PTR, _FLOAT, _PTR],
    "flash_bwd_d64_dq": [_PTR] * 7 + [_INT] * 4 + [_PTR, _FLOAT, _PTR],
    "flash_bwd_wide_dkv": [_PTR] * 8 + [_INT] * 6 + [_PTR, _FLOAT, _PTR],
    "flash_bwd_wide_dq": [_PTR] * 7 + [_INT] * 5 + [_PTR, _FLOAT, _PTR],
    "flash_int8": [_PTR] * 5 + [_INT] * 5 + [_PTR],
    "flash_fwd_f32": [_PTR] * 5 + [_INT] * 9 + [_FLOAT, _PTR],
    "flash_bwd_f32_dkv": [_PTR] * 10 + [_INT] * 6 + [_PTR, _FLOAT, _PTR],
    "flash_bwd_f32_dq": [_PTR] * 8 + [_INT] * 6 + [_PTR, _FLOAT, _PTR],
    "flash_f32_split": [_PTR] + [_INT] * 4 + [_PTR],
    "flash_int8_f32": [_PTR] * 5 + [_INT] * 5 + [_PTR],
    "flash_int8_amax": [_PTR] * 5 + [_INT] * 5 + [_PTR],
    "flash_int8_codes": [_PTR] * 9 + [_INT] * 4 + [_FLOAT, _INT, _PTR],
}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = _build.kernel(name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _call(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _aligned(t) -> bool:
    """A contiguous head dim and 16-byte aligned rows."""
    per16 = 16 // t.element_size()
    return t.stride(-1) == 1 and not t.data_ptr() % 16 and not any(s % per16 for s in t.stride()[:3])


def _check(name: str, *tensors) -> None:
    dev = tensors[0].device
    want = torch.float32 if "_f32" in name else torch.bfloat16
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA device")
        if t.dtype != want:
            raise ValueError(f"{name} takes {want} tensors, got {t.dtype}")
        if not _aligned(t):
            raise ValueError(f"{name} needs a contiguous head dim and 16-byte aligned rows")
        if max(t.stride()) > _INT32_MAX:
            raise ValueError(f"{name}: strides exceed int32")


def _shapes(name: str, q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, S, H, D) tensors")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    kv_end = skv if kv_len is None else min(skv, int(kv_len))
    if kv_end < 1 or sq < 1:
        raise ValueError("flash attention needs at least one query and one key")
    return b, sq, skv, h, d, kv_end


def _head_dim_ok(name: str, d: int) -> None:
    if name.startswith("flash_fwd_d64") or name.startswith("flash_bwd_d64"):
        if d != 64:
            raise ValueError(f"{name} takes head dim 64, got {d}")
    elif "_f32" in name:
        if d not in _F32_DIMS:
            raise ValueError(f"{name} takes head dim in {_F32_DIMS}, got {d}")
    elif d not in _WIDE_DIMS:
        raise ValueError(f"{name} takes head dim in {_WIDE_DIMS}, got {d}")


def _launch_fwd(name: str, q, k, v, scale: float, kv_len, with_lse: bool):
    b, sq, skv, h, d, kv_end = _shapes(name, q, k, v, kv_len)
    _head_dim_ok(name, d)
    _check(name, q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    lse_ptr = None if lse is None else lse.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name == "flash_fwd_f32":
        qs, ks, vt = f32_split([(q, False), (k, False), (v, True)])
        _call(name, qs.data_ptr(), ks.data_ptr(), vt.data_ptr(), o.data_ptr(), lse_ptr, b, h, sq, skv, kv_end, d,
              *o.stride()[:3], float(scale), stream)
    else:
        strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]]
        head = [b, h, sq, kv_end] + ([d] if name != "flash_fwd_d64" else [])
        _call(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr, *head, *strides,
              float(scale), stream)
    count_kernel(name, 4.0 * b * h * sq * skv * d)
    if not with_lse:
        return o
    LSE_LAUNCHES[name] += 1
    return o, lse


def _fwd(name: str, q, k, v, scale: float, kv_len, with_lse: bool):
    if not q.is_cuda:
        if with_lse:
            return attention_plain_lse(q, k, v, scale, kv_len)
        return attention_plain(q, k, v, scale, kv_len)
    return _launch_fwd(name, q, k, v, scale, kv_len, with_lse)


def flash_fwd_d64(q, k, v, scale: float, kv_len: Optional[int] = None, with_lse: bool = False):
    """K1: attention at head dim 64 over (B, S, H, 64); with `with_lse`,
    returns (o, lse) with lse (B, H, Sq) fp32."""
    return _fwd("flash_fwd_d64", q, k, v, scale, kv_len, with_lse)


def flash_fwd_wide(q, k, v, scale: float, kv_len: Optional[int] = None, with_lse: bool = False):
    """K2: attention at head dim 128, 256, 384 or 512 over (B, S, H, D)."""
    return _fwd("flash_fwd_wide", q, k, v, scale, kv_len, with_lse)


def flash_fwd_f32(q, k, v, scale: float, kv_len: Optional[int] = None, with_lse: bool = False):
    """The fp32 instance of K1/K2: fp32 (B, S, H, D) at head dim 64, 128,
    256, 384 or 512."""
    return _fwd("flash_fwd_f32", q, k, v, scale, kv_len, with_lse)


def flash_fwd(q, k, v, scale: float, kv_len: Optional[int] = None, with_lse: bool = False):
    """The forward kernel `kernel_for` names for q's dtype and head dim; a
    CPU tensor takes the plain version, inputs that no kernel takes raise."""
    name = kernel_for(q.dtype, q.shape[-1])
    if name is None and q.is_cuda:
        raise ValueError(f"no attention kernel takes {q.dtype} at head dim {q.shape[-1]}")
    return _fwd(name or "flash_fwd_d64", q, k, v, scale, kv_len, with_lse)


def _bwd(kind: str, q, k, v, o, lse, do, scale: float, kv_len, passes=("dkv", "dq")):
    """Launch the dK/dV pass and the dQ pass of `kind` ("d64", "wide" or "f32");
    `passes` may name one of them alone (its gradients come back, the
    others are None), which is how chip_smoke.py times each kernel."""
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, o, lse, do, scale, kv_len)
    return _launch_bwd(kind, q, k, v, o, lse, do, scale, kv_len, passes)


def _launch_bwd(kind: str, q, k, v, o, lse, do, scale: float, kv_len, passes):
    dkv, dqn = f"flash_bwd_{kind}_dkv", f"flash_bwd_{kind}_dq"
    b, sq, skv, h, d, kv_end = _shapes(dkv, q, k, v, kv_len)
    _head_dim_ok(dkv, d)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError(f"{dkv}: o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"{dkv} takes a contiguous fp32 lse on q's device")
    if not _aligned(do):
        do = do.contiguous()
    _check(dkv, q, k, v, do)
    dd = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()  # rowsum(dO∘O), (B, H, Sq)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) if "dq" in passes else None
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device) if "dkv" in passes else None
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device) if "dkv" in passes else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # S recomputed, dP, and dV + dK (the dK/dV pass) and/or dQ (the dQ pass)
    count_kernel(f"flash_bwd_{kind}", (4.0 + 4.0 * (dk is not None) + 2.0 * (dq is not None)) * b * h * sq * skv * d)
    if kind == "f32":
        _launch_bwd_f32(q, k, v, do, lse, dd, dq, dk, dv, kv_end, scale, stream)
        return dq, dk, dv
    outs = [t if t is not None else q for t in (dq, dk, dv)]  # strides only
    strides = (ctypes.c_longlong * 21)(*(s for t in (q, k, v, do, *outs) for s in t.stride()[:3]))
    wide = [d] if kind != "d64" else []
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr())
    if dk is not None:
        _call(dkv, *ptrs, dk.data_ptr(), dv.data_ptr(), b, h, sq, skv, kv_end, *wide, strides,
              float(scale), stream)
    if dq is not None:
        _call(dqn, *ptrs, dq.data_ptr(), b, h, sq, kv_end, *wide, strides, float(scale), stream)
    return dq, dk, dv


def _launch_bwd_f32(q, k, v, do, lse, dd, dq, dk, dv, kv_end, scale, stream) -> None:
    """The fp32 passes asked for (dk/dv and/or dq not None) after one split
    launch of the operands they read: natural q, k, v, dO and transposed q,
    dO for the dK/dV pass, transposed k for the dQ pass."""
    b, sq, h, d = q.shape
    specs = [(q, False), (k, False), (v, False), (do, False)]
    if dk is not None:
        specs += [(q, True), (do, True)]
    if dq is not None:
        specs += [(k, True)]
    bufs = f32_split(specs)
    qs, ks, vs, dos = (t.data_ptr() for t in bufs[:4])
    head = (b, h, sq, k.shape[1], kv_end, d)
    if dk is not None:
        qt, dot = bufs[4].data_ptr(), bufs[5].data_ptr()
        strides = (ctypes.c_longlong * 6)(*dk.stride()[:3], *dv.stride()[:3])
        _call("flash_bwd_f32_dkv", qs, ks, vs, dos, qt, dot, lse.data_ptr(), dd.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), *head, strides, float(scale), stream)
    if dq is not None:
        strides = (ctypes.c_longlong * 3)(*dq.stride()[:3])
        _call("flash_bwd_f32_dq", qs, ks, vs, dos, bufs[-1].data_ptr(), lse.data_ptr(), dd.data_ptr(),
              dq.data_ptr(), *head, strides, float(scale), stream)


def flash_bwd_d64(q, k, v, o, lse, do, scale: float, kv_len: Optional[int] = None,
                  passes=("dkv", "dq")):
    """K5: (dq, dk, dv) at head dim 64 from the forward's o and lse and the
    output gradient do; two launches, dK/dV then dQ."""
    return _bwd("d64", q, k, v, o, lse, do, scale, kv_len, passes)


def flash_bwd_wide(q, k, v, o, lse, do, scale: float, kv_len: Optional[int] = None,
                   passes=("dkv", "dq")):
    """K6: the same at head dim 128, 256, 384 or 512."""
    return _bwd("wide", q, k, v, o, lse, do, scale, kv_len, passes)


def flash_bwd_f32(q, k, v, o, lse, do, scale: float, kv_len: Optional[int] = None,
                  passes=("dkv", "dq")):
    """The fp32 instance of K5/K6: fp32 tensors at head dim 64, 128, 256,
    384 or 512."""
    return _bwd("f32", q, k, v, o, lse, do, scale, kv_len, passes)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the JAX `_flash_attention` custom
    VJP): the forward runs the kernel `kernel_for` names (K1/K2, or their
    fp32 instance) with the log-sum-exp and saves q, k, v, o and lse; the
    backward runs K5/K6 or their fp32 instance. CPU tensors take the plain
    versions.

        o = FlashAttention.apply(q, k, v, scale, kv_len)
    """

    @staticmethod
    def forward(ctx, q, k, v, scale: float, kv_len: Optional[int]):
        o, lse = flash_fwd(q, k, v, scale, kv_len, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.kv_len = scale, kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        kind = "f32" if q.dtype == torch.float32 else "d64" if q.shape[-1] == 64 else "wide"
        dq, dk, dv = _bwd(kind, q, k, v, o, lse, do, ctx.scale, ctx.kv_len)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# K8: int8 attention (SageAttention-style, arXiv:2410.02367), inference only
# ---------------------------------------------------------------------------

_INT8_BLOCK_K = 4096  # JAX's DEFAULT_BLOCK_K: p is quantized against this block's row max
NEG_INF = -1e30


def attention_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """`flash_attention_int8`'s function in plain PyTorch: per-tensor int8
    codes of q, k and v; logits (q8·k8ᵀ)·(sq·sk·scale) with keys >= kv_len
    masked (per-tensor scales over every batch row, head and key,
    flash_attention.py:1202-1210); in blocks of 4096 keys (one at 512², whose
    latent has 64² tokens; two at 640², whose latent has 80² = 6400) the
    online softmax of the JAX kernel: p = exp(s − m) against the running row max,
    p8 = trunc(p·127 + 0.5), o = Σ(p8·v8)·(sv/127) / Σp. The integer products
    run in fp32, exact while |Σ| < 2²⁴: always for q8·k8ᵀ at head dim 64
    (≤ 127²·64), and for p8·v8 unless nearly all of a row's weight sits on
    keys whose v codes share a sign and a magnitude near 127."""
    (q8, sq), (k8, sk), (v8, sv) = (quantize(t) for t in (q, k, v))
    c_qk, c_v = sq * sk * scale, sv * INV127
    skv = k.shape[1]
    kv_end = skv if kv_len is None else min(skv, int(kv_len))
    b, sq_len, h, d = q.shape
    m = torch.full((b, h, sq_len, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq_len, 1), device=q.device)
    acc = torch.zeros((b, h, sq_len, d), device=q.device)
    for k0 in range(0, skv, _INT8_BLOCK_K):
        kb, vb = k8[:, k0:k0 + _INT8_BLOCK_K], v8[:, k0:k0 + _INT8_BLOCK_K]
        s = torch.einsum("bqhd,bkhd->bhqk", q8, kb) * c_qk
        if kv_end < k0 + kb.shape[1]:
            s[..., max(kv_end - k0, 0):] = NEG_INF
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        p8 = torch.trunc(p * 127.0 + 0.5)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p8, vb) * c_v
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype)


# The attention reads V's codes transposed, (B·H, 64, Skv rounded up to
# _INT8_TILE), and within each block of 32 keys in the order in which its
# score fragments hold them, so that those fragments are the s8 A operand of
# the P·V product as they are (see csrc/flash_int8.cu): position
# 16·half + 4·t + e holds key 16·half + 2·t + e (e < 2) or 16·half + 8 + 2·t + e − 2.
_V_PERM = torch.tensor([half * 16 + (2 * t + e if e < 2 else 8 + 2 * t + e - 2)
                        for half in range(2) for t in range(4) for e in range(4)])
_INT8_TILE = 128  # the kernel's key tile


def v_keys(n: int) -> torch.Tensor:
    """The key at each of n positions (n % 32 == 0) of the transposed V codes."""
    return torch.arange(0, n, 32).repeat_interleave(32) + _V_PERM.repeat(n // 32)


def int8_codes_plain(q, k, v, scale: float):
    """What `flash_int8_amax` and `flash_int8_codes` write, in plain PyTorch:
    q8 (B·H, Sq, 64) and k8 (B·H, Skv, 64) int8, V's codes transposed and
    permuted (B·H, 64, Skv_p) int8, zero past Skv, and the constants
    (c_qk, c_v) fp32, the codes and constants of `attention_int8_plain`."""
    (q8, sq), (k8, sk), (v8, sv) = (quantize(t) for t in (q, k, v))
    b, _, h, d = q.shape
    skv = k.shape[1]
    pad = -(-skv // _INT8_TILE) * _INT8_TILE
    heads = [t.permute(0, 2, 1, 3).reshape(b * h, -1, d).to(torch.int8) for t in (q8, k8)]
    vt = torch.zeros((b * h, d, pad), dtype=torch.int8, device=q.device)
    vt[..., :skv] = v8.permute(0, 2, 3, 1).reshape(b * h, d, skv).to(torch.int8)
    vt = vt.index_select(-1, v_keys(pad).to(q.device))
    return heads[0], heads[1], vt, torch.stack([sq * sk * scale, sv * INV127])


def _int8_args(q, k, v, kv_len=None):
    """The checked launch arguments of K8's three launches: (B, Sq, Skv, H,
    kv_end, the 9 (b, s, h) strides of q, k, v, fp32 flag, stream)."""
    b, sq, skv, h, d, kv_end = _shapes("flash_int8", q, k, v, kv_len)
    if d != 64:
        raise ValueError(f"flash_int8 takes head dim 64, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_int8 takes bf16 or fp32 tensors of one dtype, got {q.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_int8: every tensor must lie on one CUDA device")
    if max(b * h * max(sq, skv) * d, b * h * d * (skv + _INT8_TILE)) > _INT32_MAX:
        raise ValueError("flash_int8: the codes exceed int32 indexing")
    if not all(_aligned(t) for t in (q, k, v)):
        raise ValueError("flash_int8 needs a contiguous head dim and 16-byte aligned rows")
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v) for s in t.stride()[:3]))
    return (b, sq, skv, h, kv_end, strides, int(q.dtype == torch.float32),
            torch.cuda.current_stream(q.device).cuda_stream)


def int8_amax(q, k, v, ws, args=None) -> None:
    """`flash_int8_amax`: max |x| of CUDA q, k and v (aligned as `_aligned`
    says) into ws[0:3] (fp32)."""
    b, sq, skv, h, _, strides, f32, stream = args or _int8_args(q, k, v)
    _call("flash_int8_amax", q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, ws.data_ptr(), b, h, sq, skv, f32,
          stream)


def int8_quantize(q, k, v, ws, scale: float, args=None):
    """`flash_int8_codes`: the codes of q, k and v against the amax in
    ws[0:3], as `int8_codes_plain` lays them out, and (c_qk, c_v) into
    ws[4:6]; returns (q8, k8, vt)."""
    b, sq, skv, h, _, strides, f32, stream = args or _int8_args(q, k, v)
    dev = q.device
    q8 = torch.empty((b * h, sq, 64), dtype=torch.int8, device=dev)
    k8 = torch.empty((b * h, skv, 64), dtype=torch.int8, device=dev)
    vt = torch.empty((b * h, 64, -(-skv // _INT8_TILE) * _INT8_TILE), dtype=torch.int8, device=dev)
    _call("flash_int8_codes", q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, ws.data_ptr(), q8.data_ptr(),
          k8.data_ptr(), vt.data_ptr(), ws.data_ptr() + 16, b, h, sq, skv, float(scale), f32, stream)
    return q8, k8, vt


def int8_codes(q, k, v, scale: float, args=None):
    """`int8_codes_plain`'s outputs for CUDA q, k, v in two launches: returns
    (q8, k8, vt, ws), ws fp32 with q's, k's and v's amax in [0:3] and
    (c_qk, c_v) in [4:6]."""
    args = args or _int8_args(q, k, v)
    ws = torch.empty(8, dtype=torch.float32, device=q.device)
    int8_amax(q, k, v, ws, args)
    return (*int8_quantize(q, k, v, ws, scale, args), ws)


def int8_attend(q8, k8, vt, ws, shape, dtype, kv_end: int) -> torch.Tensor:
    """The attention launch on `int8_codes`' outputs: o (B, Sq, H, 64) in
    `dtype` (bf16: `flash_int8`, fp32: `flash_int8_f32`)."""
    b, sq, h, _ = shape
    o = torch.empty(shape, dtype=dtype, device=q8.device)
    name = "flash_int8_f32" if dtype == torch.float32 else "flash_int8"
    _call(name, q8.data_ptr(), k8.data_ptr(), vt.data_ptr(), o.data_ptr(), ws.data_ptr() + 16, b, h, sq,
          k8.shape[1], kv_end, torch.cuda.current_stream(q8.device).cuda_stream)
    count_kernel(name, 4.0 * b * h * sq * k8.shape[1] * 64)
    return o


def _launch_int8(q, k, v, scale: float, kv_len):
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    args = _int8_args(q, k, v, kv_len)
    q8, k8, vt, ws = int8_codes(q, k, v, scale, args)
    return int8_attend(q8, k8, vt, ws, q.shape, q.dtype, args[4])


def flash_attention_int8(q, k, v, scale: float, kv_len: Optional[int] = None) -> torch.Tensor:
    """K8: int8 attention over (B, S, H, 64) (`flash_attention_int8`,
    flash_attention.py:1261), writing q's dtype: bf16 q, k, v go to
    `flash_int8`, fp32 ones to `flash_int8_f32` (the same codes: the
    quantizer takes any float dtype, as JAX's does), after the two quantize
    launches. Any key length, as JAX's. A CPU tensor takes
    `attention_int8_plain`; a CUDA tensor takes the kernels or raises. Other
    head dims are the caller's to send to the exact kernels (`ops.attention`)."""
    if not q.is_cuda:
        return attention_int8_plain(q, k, v, scale, kv_len)
    return _launch_int8(q, k, v, scale, kv_len)
