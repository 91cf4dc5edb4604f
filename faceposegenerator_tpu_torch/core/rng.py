"""Explicit generators (port of `faceposegenerator_tpu/core/rng.py:23,35`).

The per-identity seed contract is kept: `sampler_generator(i)` gives every
model variant the same noise for identity i, `train_step_generator` gives
each train step its own stream, stateless in the step number, and
`prompt_generator` each (identity, prompt) pair its own (the stream JAX
derives as `fold_in(sampler_key(identity), prompt)`). The bits are torch's,
not JAX's; parity tests inject the same numpy noise into both packages
instead.
"""

from __future__ import annotations

import numpy as np
import torch


def sampler_generator(identity_index: int, device) -> torch.Generator:
    """Per-identity generation generator on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(identity_index))
    return g


def _pair_generator(a: int, b: int, device) -> torch.Generator:
    """A generator on `device` seeded from the pair (a, b) by
    `np.random.SeedSequence`: distinct pairs get independent streams."""
    state = np.random.SeedSequence([int(a), int(b)]).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state) & (2**63 - 1))
    return g


def train_step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step `step` under run seed `seed` on `device`
    (the port's `train_step_key`, `fold_in(key, step)`): distinct steps and
    seeds get independent streams, and a step's stream does not depend on
    the steps before it."""
    return _pair_generator(seed, step, device)


def prompt_generator(identity_index: int, prompt_index: int, device) -> torch.Generator:
    """The generator of prompt `prompt_index` of identity `identity_index`
    on `device` (the sweep's `fold_in(sampler_key(identity), prompt)`)."""
    return _pair_generator(identity_index, prompt_index, device)
