"""Homomorphic-encryption layer (Paillier), grown from a single module
into packing / CRT / pool submodules (DESIGN.md §3):

- paillier:  keygen, encrypt/decrypt (CRT-accelerated), fixed-point
             codec, scalar homomorphic ops — the reference path.
- packing:   SIMD-style slot packing (K values per ciphertext), the
             packed homomorphic matvec, Straus multi-exponentiation.
- pool:      precomputed r^n blinding pool (fixed-base comb + optional
             background fill) making hot-path encryption two mults.
- decrypt_pool: arbiter-side process pool CRT-decrypting ciphertext
             chunks in parallel with order-preserving reassembly and
             attributed worker-crash propagation (DESIGN.md §10.1).

``from repro_torch.core import he`` keeps working: everything public is
re-exported here.
"""
from repro_torch.core.he.paillier import (SCALE_BITS, PrivateKey, PublicKey,
                                          _is_probable_prime, add_cipher,
                                          decode_fixed, decrypt_vector,
                                          encode_fixed, encrypt_vector, keygen,
                                          matvec_cipher)
from repro_torch.core.he.packing import (GUARD_BITS, decrypt_packed,
                                         encrypt_packed, matvec_slot_plan,
                                         max_slots, multi_pow, pack_signed,
                                         packed_matvec, pow_tables,
                                         unpack_matvec, unpack_signed)
from repro_torch.core.he.decrypt_pool import (DecryptPool, DecryptSession,
                                              DecryptWorkerError)
from repro_torch.core.he.pool import RandomnessPool

__all__ = [
    "SCALE_BITS", "GUARD_BITS", "PublicKey", "PrivateKey", "keygen",
    "encode_fixed", "decode_fixed", "encrypt_vector", "decrypt_vector",
    "add_cipher", "matvec_cipher", "pack_signed", "unpack_signed",
    "max_slots", "encrypt_packed", "decrypt_packed", "multi_pow",
    "pow_tables", "matvec_slot_plan", "packed_matvec", "unpack_matvec",
    "RandomnessPool", "DecryptPool", "DecryptSession",
    "DecryptWorkerError",
]
