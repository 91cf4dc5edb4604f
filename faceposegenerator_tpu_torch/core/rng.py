"""Explicit generators (port of `faceposegenerator_tpu/core/rng.py:23`).

The per-identity seed contract is kept: `sampler_generator(i)` gives every
model variant the same noise for identity i. The bits are torch's, not
JAX's; parity tests inject the same numpy noise into both packages instead.
"""

from __future__ import annotations

import torch


def sampler_generator(identity_index: int, device) -> torch.Generator:
    """Per-identity generation generator on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(identity_index))
    return g
