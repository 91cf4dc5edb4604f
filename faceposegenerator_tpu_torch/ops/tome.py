"""ToMe token merging for the UNet's level-0 transformers (opt-in; port of
`faceposegenerator_tpu/ops/tome.py`).

Token Merging for Stable Diffusion (Bolya & Hoffman, arXiv:2303.17604):
before an op, merge the `r` most redundant tokens into their most similar
neighbours; run the op on the reduced set; copy each merged token's output
back from the token it merged into. `tome_ratio=0.0` (the default) is the
exact path.

As in the JAX package: the dst set is one token per 2×2 cell at a fixed
top-left position; the similarity is one cosine-similarity product summed
in fp32 (bf16 operands on the tensor cores, `_scores`); the merge count `r` is a Python int, rounded down to a multiple of 256 at
≥ 2048 tokens (4096 tokens at ratio 0.5 → 2048 survivors, K1's shape on the
card) and of 8 below. Ties break as JAX breaks them: the sort by redundancy
is stable, and each src token joins the first dst token of its best score.
The merge sums in fp32 and divides by the group sizes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def merge_count(n_tokens: int, ratio: float, sx: int = 2, sy: int = 2, lane_multiple: int = None) -> int:
    """min(ratio·N, Ns) rounded down to `lane_multiple` (256 at ≥ 2048
    tokens, 8 below)."""
    if lane_multiple is None:
        lane_multiple = 256 if n_tokens >= 2048 else 8
    n_dst = -(-n_tokens // (sx * sy))  # ceil for non-divisible grids
    n_src = n_tokens - n_dst
    r = min(int(n_tokens * ratio), n_src)
    return max(r - r % lane_multiple, 0)


@functools.lru_cache(maxsize=None)
def _lattice(h: int, w: int, sx: int, sy: int):
    """(dst_idx, src_idx) numpy token ids: dst = the top-left token of every
    sy×sx cell, src = the rest."""
    ids = np.arange(h * w, dtype=np.int64).reshape(h, w)
    dst_mask = np.zeros((h, w), dtype=bool)
    dst_mask[::sy, ::sx] = True
    return ids[dst_mask], ids[~dst_mask]


@functools.lru_cache(maxsize=None)
def _lattice_on(h: int, w: int, sx: int, sy: int, device: str):
    dst, src = _lattice(h, w, sx, sy)
    return torch.from_numpy(dst).to(device), torch.from_numpy(src).to(device)


def _scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·bᵀ in fp32, as JAX's einsum with preferred_element_type fp32. bf16
    values are exact in TF32, so on the card bf16 operands take the tensor
    cores' TF32 products (each exact, summed in fp32) instead of FFMA; fp32
    operands keep fp32 products."""
    tf32 = a.is_cuda and a.dtype == torch.bfloat16
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = saved or tf32
    try:
        return torch.bmm(a.float(), b.float().transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@dataclasses.dataclass(frozen=True)
class ToMeMatch:
    """The indices that tie merge() and unmerge() to one matching."""

    dst_idx: torch.Tensor   # (Nd,) token ids of the dst lattice
    src_idx: torch.Tensor   # (Ns,) token ids of the src set
    merged: torch.Tensor    # (B, r) positions in the src set, most redundant first
    unmerged: torch.Tensor  # (B, Ns - r) surviving src positions
    match: torch.Tensor     # (B, r) the dst-set position each merged src token joins
    n_tokens: int
    r: int


def build_match(metric: torch.Tensor, h: int, w: int, r: int, sx: int = 2, sy: int = 2) -> ToMeMatch:
    """Bipartite soft matching on `metric` (B, N, C), N = h·w: the
    transformer block's input hidden states, tomesd's choice."""
    B, N, C = metric.shape
    assert N == h * w, (N, h, w)
    dst_idx, src_idx = _lattice_on(h, w, sx, sy, str(metric.device))
    a = metric[:, src_idx]
    b = metric[:, dst_idx]
    a = a * torch.rsqrt((a * a).sum(-1, keepdim=True) + 1e-6)
    b = b * torch.rsqrt((b * b).sum(-1, keepdim=True) + 1e-6)
    scores = _scores(a, b)  # (B, Ns, Nd)
    node_max, node_idx = scores.max(dim=-1)  # the first index of the max, as jnp.argmax
    order = torch.argsort(-node_max, dim=-1, stable=True)  # redundant first, as jnp.argsort
    merged, unmerged = order[:, :r], order[:, r:]
    match = node_idx.gather(1, merged)
    return ToMeMatch(dst_idx=dst_idx, src_idx=src_idx, merged=merged, unmerged=unmerged, match=match,
                     n_tokens=N, r=r)


def merge(x: torch.Tensor, m: ToMeMatch) -> torch.Tensor:
    """(B, N, C) → (B, N - r, C): [surviving src tokens; dst tokens with
    their merge groups averaged in]."""
    B, _, C = x.shape
    xsrc = x[:, m.src_idx]
    un = xsrc.gather(1, m.unmerged[..., None].expand(-1, -1, C))
    mg = xsrc.gather(1, m.merged[..., None].expand(-1, -1, C))
    acc = x[:, m.dst_idx].float().scatter_add_(1, m.match[..., None].expand(-1, -1, C), mg.float())
    cnt = torch.ones(B, m.dst_idx.shape[0], device=x.device).scatter_add_(
        1, m.match, torch.ones(m.match.shape, device=x.device))
    return torch.cat([un, (acc / cnt[..., None]).to(x.dtype)], dim=1)


def unmerge(y: torch.Tensor, m: ToMeMatch) -> torch.Tensor:
    """(B, N - r, C) → (B, N, C): surviving tokens return to their places,
    each merged token takes its dst group's output (ToMe's copy-back),
    through one position map and one gather."""
    B, _, C = y.shape
    n_keep = m.src_idx.shape[0] - m.r  # survivors come first
    dev = y.device
    inv = torch.empty(B, m.n_tokens, dtype=torch.long, device=dev)
    inv[:, m.dst_idx] = n_keep + torch.arange(m.dst_idx.shape[0], device=dev)
    inv.scatter_(1, m.src_idx[m.unmerged], torch.arange(n_keep, device=dev).expand(B, -1))
    inv.scatter_(1, m.src_idx[m.merged], n_keep + m.match)
    return y.gather(1, inv[..., None].expand(-1, -1, C))
