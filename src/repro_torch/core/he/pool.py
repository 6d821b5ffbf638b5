"""Precomputed-randomness pool for Paillier encryption (DESIGN.md §3.4).

Paillier encryption is Enc(m) = (1 + m*n) * r^n mod n^2; the r^n blinding
factor is the entire cost (one full-width modexp) and is independent of
the message. This pool amortizes it two ways:

1. *Fixed-base comb*: blindings are generated as h^(n*k) for a one-time
   random base h: precompute table[i][j] = (h^n)^(j * 2^(w*i)) once,
   then each fresh r^n = prod over nonzero w-bit digits of k — ~n_bits/w
   modular mults and NO squarings, ~6x cheaper than a cold pow().
   (The blinding then ranges over the subgroup <h> rather than all of
   Z_n^*; an acceptable tradeoff for a prototyping toolbox, noted in
   DESIGN.md §3.4.)
2. *Background fill*: an optional daemon thread keeps the pool topped
   up between training steps, so hot-path encryption is two mults.

``take()`` never blocks: it pops a pooled value or generates inline.
"""
from __future__ import annotations

import math
import secrets
import threading
from collections import deque
from typing import Optional

from repro_torch.core.he.paillier import PublicKey


class RandomnessPool:
    def __init__(self, pub: PublicKey, window: int = 4):
        self.pub = pub
        self._n_sq = pub.n_sq
        self._nbits = pub.n.bit_length()
        self._window = window
        self._mask = (1 << window) - 1
        self._nwin = (self._nbits + window - 1) // window
        while True:
            h = secrets.randbelow(pub.n - 3) + 2
            if math.gcd(h, pub.n) == 1:
                break
        base = pow(h, pub.n, self._n_sq)        # one-time full modexp
        # comb table: _tab[i][j] = base^(j << (w*i)), j in 0..2^w-1
        self._tab = []
        cur = base
        for _ in range(self._nwin):
            row = [1] * (1 << window)
            row[1] = cur
            for j in range(2, 1 << window):
                row[j] = (row[j - 1] * cur) % self._n_sq
            self._tab.append(row)
            cur = (row[-1] * cur) % self._n_sq  # cur^(2^w)
        self._items: deque = deque()
        self._cv = threading.Condition()
        self._alive = False
        self._thread: Optional[threading.Thread] = None
        self._generated = 0
        # hot-path accounting: a hit popped a pooled blinding (two-mult
        # encryption); a fallback generated inline on the caller's
        # critical path — sustained fallbacks mean the prefetch target
        # is too small for the training cadence (e.g. pipeline_depth
        # outpacing the background filler)
        self.hits = 0
        self.fallbacks = 0

    # -- generation ----------------------------------------------------------
    def _gen(self) -> int:
        k = 0
        while k == 0:
            k = secrets.randbits(self._nbits)
        acc = 1
        for i in range(self._nwin):
            d = (k >> (i * self._window)) & self._mask
            if d:
                acc = (acc * self._tab[i][d]) % self._n_sq
        self._generated += 1
        return acc                              # = (h^k)^n mod n^2

    # -- pool API ------------------------------------------------------------
    def take(self) -> int:
        with self._cv:
            rn = self._items.popleft() if self._items else None
            self._cv.notify_all()
        if rn is not None:
            self.hits += 1
            return rn
        self.fallbacks += 1
        return self._gen()

    def prefill(self, count: int) -> None:
        for _ in range(count):
            rn = self._gen()
            with self._cv:
                self._items.append(rn)

    def start(self, target: int = 64) -> None:
        """Spawn a background filler keeping ~target items pooled."""
        if self._thread is not None:
            return
        self._alive = True

        def loop():
            while self._alive:
                with self._cv:
                    while self._alive and len(self._items) >= target:
                        self._cv.wait(0.25)
                    if not self._alive:
                        return
                rn = self._gen()                # outside the lock
                with self._cv:
                    self._items.append(rn)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._alive = False
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def stats(self) -> dict:
        """Hot-path counters: pooled hits vs inline fallbacks (and the
        total blindings generated, background + inline)."""
        return {"hits": self.hits, "fallbacks": self.fallbacks,
                "generated": self._generated, "pooled": len(self)}

    # -- convenience ---------------------------------------------------------
    def encrypt_int(self, m: int) -> int:
        return self.pub.encrypt_int(m, rn=self.take())
