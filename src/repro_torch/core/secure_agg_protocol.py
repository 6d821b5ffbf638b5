"""Pairwise-masked secure aggregation over the PartyCommunicator
(Bonawitz et al. style), for the message-passing execution modes.

Key agreement: every member publishes g^a mod p (the PSI group prime) to
every other member through the communicator; each pair derives the
shared secret g^{ab}, hashes it into a seed, and uses a counter-based
PRG to produce per-round masks. Member i adds +PRG(seed_ij, round) for
j > i and -PRG for j < i; the sum over members telescopes to zero, so
the master — who only ever receives masked tensors — learns exactly the
aggregate embedding and nothing about individual contributions.

Note the privacy model matches the paper's HE layer (protect individual
member data from the aggregator); with a single member there is no
second party to pair with and masking degenerates (as in the original
protocol).
"""
from __future__ import annotations

import hashlib
import secrets
from typing import Dict, List

import numpy as np

from repro_torch.comm.base import PartyCommunicator
from repro_torch.core.psi import group_prime


class PairwiseMasker:
    """One member's side of the key agreement + mask generation."""

    def __init__(self, comm: PartyCommunicator, me: str,
                 members: List[str]):
        self.me = me
        self.members = sorted(members)
        self.idx = self.members.index(me)
        p = group_prime()
        g = 4  # square => generator of the QR subgroup
        self._secret = secrets.randbits(256)
        mine = pow(g, self._secret, p)
        blob = np.frombuffer(mine.to_bytes(96, "big"), np.uint8)
        for other in self.members:
            if other != me:
                comm.send(other, "secagg/pub", {"v": blob})
        self.seeds: Dict[str, int] = {}
        for other in self.members:
            if other == me:
                continue
            their = int.from_bytes(
                bytes(bytearray(comm.recv(other, "secagg/pub").tensor("v"))),
                "big")
            shared = pow(their, self._secret, p)
            self.seeds[other] = int.from_bytes(
                hashlib.sha256(shared.to_bytes(96, "big")).digest()[:8],
                "big")

    # PRG masks live on a fixed dyadic grid: gaussians clipped to
    # |z| <= 8 and rounded to multiples of 2^-10. Every grid value and
    # every sum of a few thousand of them is exactly representable in
    # float32 (magnitudes stay far below 2^23 ulp-1 territory), so the
    # +/- streams of a pair cancel to exactly 0.0 in ANY summation
    # order — the masked sum equals the plain sum bit-for-bit whenever
    # the data itself sums exactly (tests/test_secure_agg_props.py).
    # Clipping 8-sigma tails costs nothing statistically and is what
    # bounds the sums into the exact range.
    _GRID = np.float32(1024.0)

    def _prg(self, seed: int, rnd: int, shape) -> np.ndarray:
        rng = np.random.default_rng(np.uint64((seed + rnd) % 2**63))
        z = rng.standard_normal(shape).astype(np.float32)
        return np.round(np.clip(z, -8.0, 8.0) * self._GRID) / self._GRID

    def mask(self, rnd: int, shape) -> np.ndarray:
        m = np.zeros(shape, np.float32)
        for other, seed in self.seeds.items():
            sign = 1.0 if self.me < other else -1.0
            m += sign * self._prg(seed, rnd, shape)
        return m
