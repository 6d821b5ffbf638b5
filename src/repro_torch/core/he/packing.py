"""SIMD-style ciphertext packing for Paillier (DESIGN.md §3.2).

A Paillier plaintext is a ~n-bit integer; our fixed-point values need
only ~2*SCALE_BITS + log2(batch) bits, so one plaintext can carry
K = (n_bits - 2) // slot_bits values in disjoint bit-ranges ("slots").
Slots hold *signed* values in balanced-digit representation: the packed
integer is sum_j v_j * 2^(j*slot_bits) computed over Z (borrows between
slots are absorbed by ordinary integer arithmetic), and decoding peels
balanced digits d in (-2^(s-1), 2^(s-1)] from the bottom up. This makes
packed ciphertexts closed under homomorphic addition and plaintext
multiplication as long as every slot stays below its guard-bit budget.

The packed homomorphic matvec computes X^T @ Enc(r) with one
exponentiation per (sample, K-feature chunk) instead of one per matrix
element: Enc(r_i)^{pack(X[i, chunk])} = Enc(pack_j(X[i,j] * r_i)), and
the product over samples accumulates all K dot products at once. A
per-slot offset keeps every exponent positive (no modular inverses) at
the cost of one extra "ones" column whose slot recovers sum_i r_i for
the exact integer correction at decrypt time.

All exponentiations inside one batch share Straus interleaved
multi-exponentiation tables: ~w-bit windows, squarings shared across
all bases — the dominant cost drops from |exp| squarings per sample to
|exp| squarings per *chunk*.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.he.paillier import PublicKey

GUARD_BITS = 4          # headroom on top of the worst-case slot bound


# ---------------------------------------------------------------------------
# balanced-digit packing
# ---------------------------------------------------------------------------


def pack_signed(vals: Sequence[int], slot_bits: int) -> int:
    """Pack signed ints (|v| < 2^(slot_bits-1)) into one integer."""
    acc = 0
    for j, v in enumerate(vals):
        acc += int(v) << (j * slot_bits)
    return acc


def unpack_signed(packed: int, slot_bits: int, count: int) -> List[int]:
    """Inverse of pack_signed — balanced-digit extraction."""
    out = []
    half = 1 << (slot_bits - 1)
    mask = (1 << slot_bits) - 1
    v = int(packed)
    for _ in range(count):
        d = v & mask
        if d >= half:
            d -= 1 << slot_bits
        out.append(d)
        v = (v - d) >> slot_bits
    return out


def max_slots(pub: PublicKey, slot_bits: int) -> int:
    """How many slots fit one plaintext (sign bit + margin reserved)."""
    k = (pub.n.bit_length() - 2) // slot_bits
    if k < 1:
        raise ValueError(
            f"slot of {slot_bits} bits does not fit a "
            f"{pub.n.bit_length()}-bit Paillier plaintext; use a larger "
            f"key or smaller fixed-point values")
    return k


def encrypt_packed(pub: PublicKey, vals: Sequence[int], slot_bits: int,
                   pool=None) -> List[int]:
    """Encrypt ints K-per-ciphertext; one modexp carries K values."""
    k = max_slots(pub, slot_bits)
    take = pool.take if pool is not None else (lambda: None)
    return [pub.encrypt_int(pack_signed(vals[c:c + k], slot_bits),
                            rn=take())
            for c in range(0, len(vals), k)]


def decrypt_packed(priv, cts: Sequence[int], slot_bits: int,
                   count: int) -> List[int]:
    """Decrypt packed ciphertexts back into ``count`` signed ints."""
    k = max_slots(priv.pub, slot_bits)
    out: List[int] = []
    for ct in cts:
        take = min(k, count - len(out))
        out.extend(unpack_signed(priv.decrypt_int(int(ct)), slot_bits,
                                 take))
    return out


# ---------------------------------------------------------------------------
# Straus interleaved multi-exponentiation
# ---------------------------------------------------------------------------


def pow_tables(bases: Sequence[int], mod: int,
               window: int = 4) -> List[List[int]]:
    """Per-base tables of powers 0..2^w-1, shared across multi_pow calls."""
    size = 1 << window
    tabs = []
    for b in bases:
        b = int(b) % mod
        t = [1] * size
        t[1] = b
        for j in range(2, size):
            t[j] = (t[j - 1] * b) % mod
        tabs.append(t)
    return tabs


def multi_pow(exps: Sequence[int], mod: int, tables: List[List[int]],
              window: int = 4) -> int:
    """prod_i base_i^{exps_i} mod ``mod`` with shared squarings.

    Exponents must be non-negative. Cost ~ max_bits squarings total
    (instead of per base) + one table mult per nonzero window digit.
    """
    nbits = max((int(e).bit_length() for e in exps), default=0)
    if nbits == 0:
        return 1
    mask = (1 << window) - 1
    acc = 1
    for wpos in range((nbits + window - 1) // window - 1, -1, -1):
        if acc != 1:
            for _ in range(window):
                acc = (acc * acc) % mod
        shift = wpos * window
        for t, e in zip(tables, exps):
            d = (int(e) >> shift) & mask
            if d:
                acc = (acc * t[d]) % mod
    return acc


# ---------------------------------------------------------------------------
# packed homomorphic matvec
# ---------------------------------------------------------------------------


def matvec_slot_plan(pub: PublicKey, x_int: np.ndarray,
                     r_bound: int) -> Dict[str, int]:
    """Slot geometry for a packed X^T r: width from the exact worst-case
    magnitude of sum_i (x_ij + off) * r_i, K from the key capacity."""
    b, _ = x_int.shape
    r_bound = max(int(r_bound), 1)
    xb = int(np.abs(x_int).max()) if x_int.size else 0
    off = 1 << max(xb.bit_length(), 1)
    colsum = int(np.abs(x_int).astype(object).sum(axis=0).max()) \
        if x_int.size else 0
    bound = max((colsum + b * off) * r_bound,          # feature slots
                (off + 1) * b * r_bound)               # the ones column
    slot_bits = bound.bit_length() + 1 + GUARD_BITS
    return {"slot_bits": slot_bits, "k": max_slots(pub, slot_bits),
            "off_bits": off.bit_length() - 1}


def packed_matvec(pub: PublicKey, x_int: np.ndarray,
                  ciphers: Sequence[int], r_bound: int,
                  pool=None, window: int = 4,
                  ) -> Tuple[List[int], Dict[str, int]]:
    """Homomorphic X^T @ Enc(r) with K dot products per ciphertext.

    x_int: (B, d) int64 fixed-point features; ciphers: B ciphertexts
    Enc(r_i); r_bound: bound on |r_i| (fixed-point int). Returns
    (ciphertexts, info); slots hold [g_0..g_{d-1}, (off+1)*sum_i r_i]
    at product scale. Decode with unpack_matvec.
    """
    b, d = x_int.shape
    assert len(ciphers) == b, "one ciphertext per sample expected"
    info = matvec_slot_plan(pub, x_int, r_bound)
    slot_bits, k, off = info["slot_bits"], info["k"], \
        1 << info["off_bits"]
    info["count"] = d
    tabs = pow_tables(ciphers, pub.n_sq, window)
    rows = x_int.tolist()                       # python ints, fast access
    cts: List[int] = []
    d_tot = d + 1                               # + the ones column
    for c0 in range(0, d_tot, k):
        cols = range(c0, min(d_tot, c0 + k))
        exps = []
        for i in range(b):
            row = rows[i]
            acc = 0
            for t, j in enumerate(cols):
                v = off + (row[j] if j < d else 1)
                acc += v << (t * slot_bits)
            exps.append(acc)
        ct = multi_pow(exps, pub.n_sq, tabs, window)
        if pool is not None:                    # re-randomize
            ct = (ct * pool.take()) % pub.n_sq
        cts.append(ct)
    return cts, info


def unpack_matvec(plains: Sequence[int], slot_bits: int, k: int,
                  off_bits: int, count: int) -> List[int]:
    """Decode decrypted packed-matvec plaintexts into ``count`` gradient
    ints at product scale (2*SCALE_BITS for SCALE_BITS inputs)."""
    off = 1 << off_bits
    slots: List[int] = []
    remaining = count + 1
    for v in plains:
        take = min(k, remaining - len(slots))
        slots.extend(unpack_signed(int(v), slot_bits, take))
    if len(slots) != count + 1:
        raise ValueError("packed matvec: slot count mismatch")
    s_slot = slots[count]
    if s_slot % (off + 1):
        raise ValueError("packed matvec: corrupted ones-column slot")
    s = s_slot // (off + 1)                     # sum_i r_i, exact
    return [slots[j] - off * s for j in range(count)]
