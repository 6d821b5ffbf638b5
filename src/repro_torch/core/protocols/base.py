"""Protocol layer scaffolding: config, data containers, the matching
phase, deterministic batching, and the protocol registry.

A protocol is a subclass of :class:`~repro_torch.core.protocols.driver.
VFLProtocol` — lifecycle hooks (``match`` / ``setup`` /
``on_batch_master`` / ``on_batch_member`` / ``arbiter_round`` /
``predict_*`` / ``finalize``) driven by the shared training driver.
Hooks speak only through the typed channel — never touching another
party's raw data — and the same class runs unchanged in thread /
process / socket modes (the paper's seamless-switching claim, validated
by tests against recorded seed traces).
"""
from __future__ import annotations

import hashlib
import importlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.comm import schema
from repro_torch.comm.schema import Field, TypedChannel
from repro_torch.core import psi


@dataclass
class VFLConfig:
    protocol: str = "linreg"
    epochs: int = 3
    batch_size: int = 64
    lr: float = 0.05
    l2: float = 0.0
    seed: int = 0
    he_bits: int = 256            # Paillier key size (tests keep it small)
    # batched-HE path: pack K gradient values per Paillier ciphertext and
    # use the shared-squaring multi-exponentiation matvec (DESIGN.md §3).
    # False falls back to the scalar one-modexp-per-element reference.
    he_packed: bool = True
    embedding_dim: int = 16       # split-nn bottom output width
    hidden: Tuple[int, ...] = (32,)
    use_psi: bool = True          # DH-PSI vs salted-hash matching
    record_every: int = 1
    # async exchange engine (DESIGN.md §7): how many training rounds the
    # master announces ahead of the one it is computing. 1 = strictly
    # synchronous lock-step (bit-identical to the recorded seed traces);
    # D >= 2 = bounded-staleness pipelining — members run their forward
    # stage up to D-1 steps ahead of the last gradient they applied, so
    # compute overlaps in-flight exchanges.
    pipeline_depth: int = 1
    # keep the final short batch of each epoch (True reproduces the old
    # silent tail-drop; every party derives the tail identically either
    # way, so modes always agree on batch boundaries)
    drop_last: bool = False
    # int8-compress split-NN activation/gradient exchanges (4x payload
    # reduction; error feedback keeps training unbiased). Beyond-paper.
    compress: bool = False
    # Bonawitz-style secure aggregation for split-NN: members agree on
    # pairwise DH seeds (exchanged member<->member over the
    # communicator) and mask their embeddings; masks cancel in the
    # master's sum, so the master only ever sees the aggregate.
    secure_agg: bool = False
    # straggler tolerance (elastic clusters): at pipeline_depth >= 2, a
    # member whose per-round contribution misses this deadline (seconds)
    # has its LAST delivered message substituted (bounded staleness) and
    # the straggle recorded in CommStats. 0 = disabled (wait forever,
    # i.e. the transport timeout).
    round_deadline_s: float = 0.0
    # member-side LRU cache of per-row feature-slice embeddings for the
    # predict/serve path (docs/serving.md): recsys query streams repeat
    # hot users, so members answering EVAL rounds skip the bottom-model
    # forward for cached row ids. Capacity in rows; 0 = disabled.
    # Invalidated whenever a fit phase starts (parameters change).
    serve_cache_rows: int = 0
    # key-sharded multi-arbiter decryption (DESIGN.md §10.3): N >= 2
    # runs N arbiter agents ("arbiter", "arbiter1", ...), each with its
    # OWN Paillier keypair decrypting a contiguous slice of every
    # member's gradient columns. The master encrypts the residual once
    # per arbiter key; no single arbiter ever sees a full gradient.
    # (Key-per-shard, not threshold cryptography — documented tradeoff.)
    n_arbiters: int = 1
    # streamed ciphertext rounds (DESIGN.md §10.2): split each
    # Enc(gradient) message into up to this many schema-framed chunks
    # isent back-to-back, so the arbiter starts decrypting chunk 0
    # while later chunks are still on the wire. 0/1 = single message
    # (the seed wire format, bit-identical traces).
    he_stream_chunks: int = 0
    # arbiter-side decrypt worker pool (DESIGN.md §10.1): CRT
    # decryption fans out over this many OS processes (bigint pow holds
    # the GIL). 0 = inline serial decryption (the seed path).
    he_decrypt_workers: int = 0
    # Gaussian noising defense (docs/privacy.md): each party adds
    # N(0, (noise_sigma * rms(signal))^2) noise to the label-bearing
    # exchange it emits — members noise split-NN embeddings before
    # sending, the arbiter noises decrypted logreg gradients before
    # returning them. Deterministic per (seed, round, party); 0.0 is
    # bit-identical to the un-noised path (no rng is ever constructed).
    noise_sigma: float = 0.0
    # adversarial exchange capture (docs/privacy.md): when True every
    # party records the plaintext payloads it sends and receives on the
    # label-bearing message types (split-NN embeddings, decrypted logreg
    # gradients, step announcements) into an in-memory ExchangeCapture
    # exported through ``Driver.result()["capture"]``. Off by default —
    # the tap is a ``None`` check on the hot path and capture-off runs
    # are trace-bit-identical to the seed fixtures (tested).
    capture_exchanges: bool = False
    # composable member tower (DESIGN.md §12, repro_torch.models.tower): a
    # tuple of block configs ("embed:tokens=8,dim=32", "attn_block:
    # heads=4", "mlp:hidden=64") resolved by the tower factory into the
    # member bottom model. Empty = the legacy one-block MLP tower built
    # from ``hidden``/``embedding_dim`` (bit-identical to seed traces).
    tower: Tuple[str, ...] = ()
    # master-side tower: bottom half uses ``tower``/``hidden`` like a
    # member; this configures the top model over the summed embeddings.
    # Empty = the legacy MLP from ``hidden``.
    top_tower: Tuple[str, ...] = ()
    # model-parallel sharding of the member tower over N local devices
    # (launch/mesh.py x sharding/rules.py). 1 = unsharded single-device
    # params (the default; no mesh is ever constructed).
    tower_shard: int = 1


@dataclass
class MasterData:
    ids: List[str]
    y: np.ndarray                  # (n, n_items) targets
    x: Optional[np.ndarray] = None  # master's own feature slice (n, d_m)


@dataclass
class MemberData:
    ids: List[str]
    x: np.ndarray                  # (n, d_p)


def _select(ids: Sequence[str], order: Sequence[str], arr: np.ndarray
            ) -> np.ndarray:
    idx = {v: i for i, v in enumerate(ids)}
    rows = [idx[o] for o in order]
    return arr[rows]


def defense_noise(cfg: "VFLConfig", arr: np.ndarray, step: int,
                  key: str) -> np.ndarray:
    """Gaussian defense noise for one exchanged tensor
    (``cfg.noise_sigma``; docs/privacy.md): zero-mean with standard
    deviation ``noise_sigma * rms(arr)``, so the knob is a
    signal-relative noise floor rather than an absolute scale the
    caller would have to retune per protocol. Deterministic per
    (cfg.seed, step, key) — reruns and restarted agents add the exact
    same noise — and seeded via sha256, so streams for different
    rounds/parties are independent. Callers only invoke this when
    ``noise_sigma > 0``; at 0.0 no rng is ever constructed and the
    exchange stays bit-identical to the un-noised path."""
    rms = float(np.sqrt(np.mean(np.square(np.asarray(arr,
                                                     np.float64)))))
    if rms == 0.0:
        rms = 1.0
    digest = hashlib.sha256(
        f"noise/{cfg.seed}/{step}/{key}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "big"))
    return rng.normal(0.0, cfg.noise_sigma * rms,
                      np.shape(arr)).astype(np.asarray(arr).dtype)


# ---------------------------------------------------------------------------
# phase 1: record matching
# ---------------------------------------------------------------------------

schema.message("psi/a_blinded", {"v": Field("uint8", 2)},
               doc="master ids blinded with the master's DH secret")
schema.message("psi/a_double", {"v": Field("uint8", 2)},
               doc="master's blinded ids re-blinded by a member")
schema.message("psi/b_blinded", {"v": Field("uint8", 2)},
               doc="member ids blinded with the member's DH secret")
schema.message("match/salt", {"salt": Field("bytes", 1)},
               doc="shared salt for hash-based matching")
schema.message("match/hashes", {"h": Field("uint8", 2)},
               doc="member's salted id digests")
schema.message("match/order", {"ids": Field("bytes", 1)},
               doc="agreed sample order (sorted common ids)")


def master_match(ch: TypedChannel, data: MasterData,
                 cfg: VFLConfig) -> List[str]:
    """Master drives ID matching; returns the agreed sample order."""
    common = set(data.ids)
    if cfg.use_psi:
        me = psi.DHPsi()
        blinded = me.blind(data.ids)
        for m in ch.members:
            ch.send(m, "psi/a_blinded", {"v": _ints_to_arr(blinded)})
            double_a = ch.recv(m, "psi/a_double").tensor("v")
            b_blinded = ch.recv(m, "psi/b_blinded").tensor("v")
            double_b = {int(x) for x in
                        _arr_to_ints(_ints_to_arr(me.blind_again(
                            _arr_to_ints(b_blinded))))}
            mine = [i for i, v in zip(data.ids, _arr_to_ints(double_a))
                    if int(v) in double_b]
            common &= set(mine)
    else:
        salt = hashlib.sha256(str(cfg.seed).encode()).hexdigest()
        for m in ch.members:
            ch.send(m, "match/salt", {"salt": _str_arr(salt)})
            theirs = ch.recv(m, "match/hashes").tensor("h")
            their_set = {bytes(bytearray(h)) for h in theirs}
            mine = [i for i in data.ids
                    if hashlib.sha256((salt + i).encode()).digest()
                    in their_set]
            common &= set(mine)
    order = sorted(common)
    payload = {"ids": np.array([i.encode() for i in order], dtype="S64")}
    for m in ch.members:
        ch.send(m, "match/order", payload)
    return order


def member_match(ch: TypedChannel, data: MemberData,
                 cfg: VFLConfig) -> List[str]:
    if cfg.use_psi:
        me = psi.DHPsi()
        a_blinded = ch.recv("master", "psi/a_blinded").tensor("v")
        ch.send("master", "psi/a_double",
                {"v": _ints_to_arr(me.blind_again(_arr_to_ints(a_blinded)))})
        ch.send("master", "psi/b_blinded",
                {"v": _ints_to_arr(me.blind(data.ids))})
    else:
        salt = _arr_str(ch.recv("master", "match/salt").tensor("salt"))
        buf = b"".join(hashlib.sha256((salt + i).encode()).digest()
                       for i in data.ids)
        hashes = np.frombuffer(buf, np.uint8).reshape(len(data.ids), 32)
        ch.send("master", "match/hashes", {"h": hashes})
    order = [b.decode() for b in
             ch.recv("master", "match/order").tensor("ids")]
    return order


# big ints <-> uint8 matrices for transport through the tensor codec.
# (NOT numpy "S" dtypes: those strip trailing NUL bytes and corrupt
# binary data — only text ids may use them.)
def _ints_to_arr(vals: Sequence[int], width: int = 96) -> np.ndarray:
    buf = b"".join(v.to_bytes(width, "big") for v in vals)
    return np.frombuffer(buf, np.uint8).reshape(len(vals), width)


def _arr_to_ints(arr: np.ndarray) -> List[int]:
    return [int.from_bytes(bytes(bytearray(row)), "big") for row in arr]


def _str_arr(s: str) -> np.ndarray:
    return np.array([s.encode()], dtype="S128")


def _arr_str(a: np.ndarray) -> str:
    return bytes(a[0]).decode()


# ---------------------------------------------------------------------------
# deterministic batching (every party derives the same boundaries)
# ---------------------------------------------------------------------------


def batch_order(n: int, cfg: VFLConfig, epoch: int) -> np.ndarray:
    """Deterministic permutation every party derives identically."""
    rng = np.random.default_rng(cfg.seed * 1000 + epoch)
    return rng.permutation(n)


def batch_bounds(n: int, cfg: VFLConfig) -> List[Tuple[int, int]]:
    """(lo, hi) slice bounds into the epoch permutation. The tail batch
    (up to batch_size-1 samples) is kept unless ``cfg.drop_last`` — the
    seed code silently dropped it, so those samples were never trained.
    """
    bs = cfg.batch_size
    bounds = [(lo, min(lo + bs, n)) for lo in range(0, n, bs)]
    if cfg.drop_last and bounds and bounds[-1][1] - bounds[-1][0] < bs:
        bounds.pop()
    return bounds


def batches(n: int, cfg: VFLConfig, epoch: int):
    perm = batch_order(n, cfg, epoch)
    for lo, hi in batch_bounds(n, cfg):
        yield perm[lo:hi]


def fit_rows(arr, n: int):
    """Fit ``arr`` to ``n`` rows along axis 0: identity when it already
    matches, else truncate or zero-pad. Stale contributions substituted
    for a down/straggling peer can carry a different (tail-)batch row
    count than the round being computed; this keeps the master's math
    shape-consistent until the peer catches up."""
    if arr.shape[0] == n:
        return arr
    if arr.shape[0] > n:
        return arr[:n]
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


# ---------------------------------------------------------------------------
# protocol registry
# ---------------------------------------------------------------------------

PROTOCOLS: Dict[str, Type] = {}      # name -> VFLProtocol subclass


def register(cls) -> type:
    """Register a VFLProtocol subclass under ``cls.name`` (decorator)."""
    PROTOCOLS[cls.name] = cls
    return cls


def resolve_protocol(name: str) -> Type:
    """Look up a protocol class by registry name, or import one given a
    ``"module:ClassName"`` spec (lets spawned worker processes resolve
    user-defined protocols that were never imported in their parent)."""
    if name in PROTOCOLS:
        return PROTOCOLS[name]
    if ":" in name:
        modname, clsname = name.split(":", 1)
        cls = getattr(importlib.import_module(modname), clsname)
        PROTOCOLS.setdefault(name, cls)
        return cls
    raise KeyError(f"unknown protocol {name!r} "
                   f"(registered: {sorted(PROTOCOLS)})")
