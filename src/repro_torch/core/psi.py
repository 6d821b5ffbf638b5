"""Private set intersection — the VFL record-matching phase (paper §1:
"the first phase aims to identify common samples across all
participants").

Two constructions:

- ``salted_hash_intersection`` — both parties hash IDs with a shared
  salt and compare digests (fast; hides IDs from eavesdroppers but not
  from each other — the paper's baseline matcher).
- ``DHPsi`` — Diffie-Hellman commutative-exponentiation PSI: each party
  blinds hashed IDs with a private exponent; double-blinded values are
  compared so neither party learns non-intersecting IDs.
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

# 512-bit safe prime (p = 2q+1), RFC 3526-style generation, fixed for
# reproducibility of the protocol transcript sizes. P_HEX is q itself
# (the search result is pinned: the previous seed value sat ~74k odd
# candidates before the first safe prime, costing ~30s of Miller-Rabin
# per process at import of the PSI group).
P_HEX = (
    "d6fce03bb15d1e6fbd4ac31f1e90bd6c05e08974ab7a1a23fcf25cb51e63ffff"
    "f8c4e3a9cbf0b2788d24d330b06cd7d1e1a1c339d8e9e19b219e8e834bb10cef"
)


def _safe_prime() -> int:
    # deterministic search from a fixed seed value for reproducibility
    q = int(P_HEX, 16) | 1
    from repro_torch.core.he import _is_probable_prime
    while True:
        if _is_probable_prime(q) and _is_probable_prime(2 * q + 1):
            return 2 * q + 1
        q += 2


_P_CACHE: List[int] = []


def group_prime() -> int:
    if not _P_CACHE:
        _P_CACHE.append(_safe_prime())
    return _P_CACHE[0]


def _hash_to_group(item: str, p: int) -> int:
    h = int.from_bytes(hashlib.sha256(item.encode()).digest(), "big")
    return pow(h % p, 2, p)       # square -> quadratic residue subgroup


def salted_hash_intersection(ids_a: Sequence[str], ids_b: Sequence[str],
                             salt: str) -> List[str]:
    ha = {hashlib.sha256((salt + i).encode()).hexdigest(): i for i in ids_a}
    hb = {hashlib.sha256((salt + i).encode()).hexdigest() for i in ids_b}
    return sorted(i for h, i in ha.items() if h in hb)


@dataclass
class DHPsi:
    """One side of the DH-PSI protocol."""

    secret: int = field(default_factory=lambda: secrets.randbits(256) | 1)

    def blind(self, ids: Sequence[str]) -> List[int]:
        p = group_prime()
        return [pow(_hash_to_group(i, p), self.secret, p) for i in ids]

    def blind_again(self, blinded: Sequence[int]) -> List[int]:
        p = group_prime()
        return [pow(int(b), self.secret, p) for b in blinded]


def dh_psi(ids_a: Sequence[str], ids_b: Sequence[str]
           ) -> Tuple[List[str], int]:
    """Run both sides in-process (tests / local mode). Returns
    (intersection as A's ids, transcript elements exchanged)."""
    a, b = DHPsi(), DHPsi()
    ya = a.blind(ids_a)                 # A -> B
    yb = b.blind(ids_b)                 # B -> A
    yab = b.blind_again(ya)             # B -> A (double-blinded A ids)
    yba = a.blind_again(yb)             # A keeps
    common = set(yba) & set(yab)
    inter = [i for i, v in zip(ids_a, yab) if v in common]
    return sorted(inter), len(ya) + len(yb) + len(yab)
