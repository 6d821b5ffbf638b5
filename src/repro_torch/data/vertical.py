"""Vertical feature partitioning: split one dataset into per-party
silos with misaligned ID spaces — the input expected by the VFL
protocols (matching is then part of the protocol, not the pipeline).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.protocols.base import MasterData, MemberData


def vertical_partition(ids: Sequence[str], x: np.ndarray, y: np.ndarray,
                       widths: Sequence[int], *, overlap: float = 1.0,
                       seed: int = 0, shuffle_members: bool = True
                       ) -> Tuple[MasterData, List[MemberData]]:
    """Split features (n, d) into [master | member0 | member1 | ...].

    ``widths``: feature count per member (master keeps the remainder).
    ``overlap``: fraction of master rows present in each member silo.
    """
    rng = np.random.default_rng(seed)
    n, d = x.shape
    assert sum(widths) < d, "master must keep at least one feature"
    cuts = np.cumsum([d - sum(widths)] + list(widths))
    master = MasterData(list(ids), y, x[:, :cuts[0]])
    members = []
    for j, w in enumerate(widths):
        xs = x[:, cuts[j]:cuts[j + 1]]
        m = int(overlap * n)
        keep = rng.permutation(n)[:m]
        if not shuffle_members:
            keep = np.sort(keep)
        members.append(MemberData([ids[i] for i in keep], xs[keep]))
    return master, members
