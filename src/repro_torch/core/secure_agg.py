"""Mask-based secure aggregation at device speed, the counterpart of the
JAX package's ``repro/core/secure_agg.py``.

Pairwise PRG masks (Bonawitz et al. style): parties i < j share a seed;
party i adds +PRG(seed_ij), party j adds -PRG(seed_ij). Each individual
contribution is masked from the aggregator, while the SUM over all
parties is the sum of the plaintexts because the masks cancel.

The mesh-mode VFL step (``core/vfl_step.py``) masks each party's bottom
output with these before the sum over the ``pod`` axis. A pair's seed is
a pure function of (base seed, lo, hi), and each draw comes from an
explicit ``torch.Generator`` on the device the mask is made on. A CPU and
a CUDA generator give different streams from one seed, so both parties
of a pair must draw on one device type, or their masks do not cancel.
The port's draws are not the JAX package's (``jax.random`` cannot be
reproduced): only sums, never masked contributions, compare across the
two packages.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data``, a pure function of
    both (``jax.random.fold_in``'s role)."""
    return int(np.random.SeedSequence([int(seed), int(data)])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def pair_seed(base: int, i: int, j: int) -> int:
    """The seed parties ``i`` and ``j`` share, the same from either."""
    lo, hi = (i, j) if i < j else (j, i)
    return fold_in(fold_in(base, lo), hi)


def pairwise_mask(base_seed: int, party: int, n_parties: int, shape,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = "cpu") -> torch.Tensor:
    """Net mask party ``party`` must ADD to its contribution: the sum of
    +N(0, 1) draws for each partner above it and -draws for each below,
    in f32 on ``device``."""
    device = torch.device(device)
    mask = torch.zeros(shape, dtype=torch.float32, device=device)
    for other in range(n_parties):
        if other == party:
            continue
        g = torch.Generator(device).manual_seed(
            pair_seed(base_seed, party, other))
        m = torch.randn(shape, generator=g, dtype=torch.float32,
                        device=device)
        mask = mask + m if party < other else mask - m
    return mask.to(dtype)


def mask_contribution(base_seed: int, party: int, n_parties: int,
                      x: torch.Tensor) -> torch.Tensor:
    return x + pairwise_mask(base_seed, party, n_parties, x.shape, x.dtype,
                             x.device)


def aggregate(masked: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of masked contributions == sum of plaintexts (masks cancel),
    added in order on the first one's device."""
    out = masked[0]
    for m in masked[1:]:
        out = out + m.to(out.device)
    return out
