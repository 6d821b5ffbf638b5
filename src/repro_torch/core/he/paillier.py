"""Paillier additively-homomorphic encryption (the paper's HE layer).

Pure-python big-int implementation: keygen (Miller-Rabin primes),
encrypt/decrypt, ciphertext addition, plaintext scalar multiplication,
and a vectorized fixed-point codec for float tensors. Used by the
arbitered logistic-regression protocol: the master encrypts residuals,
members compute encrypted gradients (X^T r under HE = scalar-mult +
add), the arbiter (key holder) decrypts.

Decryption is CRT-accelerated (DESIGN.md §3.3): the key holder knows
the factorization n = p*q, so ``c^lam mod n^2`` splits into two
half-width exponentiations mod p^2 and q^2 recombined by the Chinese
remainder theorem — ~3-4x fewer bit operations than the textbook path.

TPU note (DESIGN.md §3.5): 2048-bit modular arithmetic has no MXU/VPU
analogue — this layer is CPU-side by necessity; the device-path privacy
equivalent is mask-based secure aggregation (secure_agg.py).
"""
from __future__ import annotations

import math
import secrets
from dataclasses import dataclass
from typing import Iterable, List, Tuple

import numpy as np

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47]


def _is_probable_prime(n: int, rounds: int = 24) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        cand = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(cand):
            return cand


@dataclass(frozen=True)
class PublicKey:
    n: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n

    @property
    def n_bytes(self) -> int:
        """Wire width of the modulus."""
        return (self.n.bit_length() + 7) // 8

    @property
    def cipher_bytes(self) -> int:
        """Wire width of one ciphertext (< n^2)."""
        return (2 * self.n.bit_length() + 7) // 8

    def encrypt_int(self, m: int, rn: int = None) -> int:
        """Encrypt; ``rn`` is an optional precomputed blinding r^n mod n^2
        (see pool.RandomnessPool) that turns encryption into two mults."""
        m %= self.n
        if rn is None:
            r = secrets.randbelow(self.n - 2) + 1
            rn = pow(r, self.n, self.n_sq)
        # g = n + 1  =>  g^m = 1 + m*n (mod n^2)
        return ((1 + m * self.n) * rn) % self.n_sq

    def add(self, c1: int, c2: int) -> int:
        return (c1 * c2) % self.n_sq

    def mul_scalar(self, c: int, k: int) -> int:
        return pow(c, k % self.n, self.n_sq)


def _L(x: int, n: int) -> int:
    return (x - 1) // n


@dataclass(frozen=True)
class PrivateKey:
    pub: PublicKey
    lam: int
    mu: int
    # CRT acceleration (optional: p == 0 disables it and decrypt_int
    # falls back to the textbook full-width path)
    p: int = 0
    q: int = 0
    hp: int = 0             # L_p(g^{p-1} mod p^2)^-1 mod p
    hq: int = 0
    p_inv_q: int = 0        # p^-1 mod q

    def decrypt_int(self, c: int) -> int:
        if self.p:
            return self.decrypt_int_crt(c)
        return self.decrypt_int_plain(c)

    def decrypt_int_plain(self, c: int) -> int:
        n = self.pub.n
        x = pow(c, self.lam, self.pub.n_sq)
        m = (_L(x, n) * self.mu) % n
        return m if m <= n // 2 else m - n      # centered representative

    def decrypt_int_crt(self, c: int) -> int:
        """Decrypt mod p^2 and q^2 separately, CRT-recombine."""
        p, q, n = self.p, self.q, self.pub.n
        p_sq, q_sq = p * p, q * q
        mp = _L(pow(c % p_sq, p - 1, p_sq), p) * self.hp % p
        mq = _L(pow(c % q_sq, q - 1, q_sq), q) * self.hq % q
        m = (mp + p * ((mq - mp) * self.p_inv_q % q)) % n
        return m if m <= n // 2 else m - n


def keygen(bits: int = 512) -> Tuple[PublicKey, PrivateKey]:
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits // 2)
        if p != q:
            break
    n = p * q
    lam = math.lcm(p - 1, q - 1)
    pub = PublicKey(n)
    # mu = (L(g^lam mod n^2))^-1 mod n; with g = n+1, L(g^lam) = lam mod n
    mu = pow(lam % n, -1, n)
    g = n + 1
    hp = pow(_L(pow(g, p - 1, p * p), p), -1, p)
    hq = pow(_L(pow(g, q - 1, q * q), q), -1, q)
    return pub, PrivateKey(pub, lam, mu, p, q, hp, hq, pow(p, -1, q))


# ---------------------------------------------------------------------------
# fixed-point float vectors (vectorized numpy encode/decode)
# ---------------------------------------------------------------------------

SCALE_BITS = 32


def encode_fixed(x: np.ndarray, scale_bits: int = SCALE_BITS) -> np.ndarray:
    """float array -> flat int64 fixed-point array (round-to-nearest)."""
    flat = np.asarray(x, np.float64).ravel()
    if flat.size and not np.isfinite(flat).all():
        raise ValueError("fixed-point encode: input has NaN/inf")
    scaled = np.rint(flat * float(1 << scale_bits))
    if scaled.size and np.abs(scaled).max() >= 2.0 ** 62:
        raise OverflowError("fixed-point encode overflows int64; "
                            "reduce magnitude or scale_bits")
    return scaled.astype(np.int64)


def decode_fixed(vals: Iterable[int], shape,
                 scale_bits: int = SCALE_BITS) -> np.ndarray:
    """ints (python or numpy, any magnitude) -> float array / 2^scale."""
    arr = np.fromiter((float(v) for v in vals), np.float64)
    return (arr / float(1 << scale_bits)).reshape(shape)


def encrypt_vector(pub: PublicKey, x: np.ndarray, pool=None) -> np.ndarray:
    take = pool.take if pool is not None else (lambda: None)
    return np.array([pub.encrypt_int(int(m), rn=take())
                     for m in encode_fixed(x)],
                    dtype=object).reshape(np.shape(x))


def decrypt_vector(priv: PrivateKey, c: np.ndarray,
                   scale_bits: int = SCALE_BITS, pool=None,
                   chunk: int = 64) -> np.ndarray:
    """Decrypt a ciphertext array. With ``pool`` (a
    :class:`~repro_torch.core.he.decrypt_pool.DecryptPool`) the ciphertexts
    stream through the worker pool in ``chunk``-sized pieces; without
    one, the serial path binds the CRT dispatch once instead of
    re-resolving it per element."""
    cts = [int(v) for v in np.ravel(c)]
    if pool is not None:
        flat = pool.decrypt_many(cts, chunk=chunk)
    else:
        dec = priv.decrypt_int_crt if priv.p else priv.decrypt_int_plain
        flat = [dec(v) for v in cts]
    return decode_fixed(flat, np.shape(c), scale_bits)


def add_cipher(pub: PublicKey, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([pub.add(int(x), int(y))
                     for x, y in zip(np.ravel(a), np.ravel(b))],
                    dtype=object).reshape(np.shape(a))


def matvec_cipher(pub: PublicKey, x_plain: np.ndarray,
                  c_vec: np.ndarray) -> np.ndarray:
    """X^T @ Enc(r) done homomorphically: Enc(sum_i X[i,j] * r[i]).

    x_plain: (n, d) float; c_vec: (n,) ciphertexts (fixed-point encoded).
    Result: (d,) ciphertexts at DOUBLE scale (2*SCALE_BITS).

    This is the scalar reference path — one modexp per matrix element.
    The production path is packing.packed_matvec (K values per
    ciphertext, shared-squaring multi-exponentiation).
    """
    n, d = x_plain.shape
    x_int = encode_fixed(x_plain).reshape(n, d)
    out = []
    for j in range(d):
        acc = pub.encrypt_int(0)
        for i in range(n):
            acc = pub.add(acc, pub.mul_scalar(int(c_vec[i]),
                                              int(x_int[i, j])))
        out.append(acc)
    return np.array(out, dtype=object)
