"""Arbitered VFL logistic regression with Paillier HE (paper §2: the
Arbiter "performs the distribution of encryption keys and calculation of
the gradients concerning the master and members"), on the lifecycle API.

Flow per batch:
1. parties send partial logits to the master (plaintext — logits are
   aggregates, not raw data),
2. the master computes the residual r = sigma(z) - y, ENCRYPTS it with
   the arbiter's Paillier public key (blinding factors come from a
   precomputed randomness pool, so hot-path encryption is two mults),
   and broadcasts Enc(r) to members,
3. each member computes its encrypted gradient X_p^T Enc(r) using only
   homomorphic scalar-mult/add (it never sees r) — by default via the
   *packed* matvec: K gradient slots per ciphertext, one exponentiation
   per (sample, chunk) with shared Straus tables (DESIGN.md §3),
4. members send Enc(g_p) to the arbiter, who decrypts (CRT-accelerated)
   and returns g_p to the owning member only. Packing means the arbiter
   decrypts ~d/K ciphertexts instead of d.

So: members never see residuals (which leak label information), the
master never sees member gradients, and the arbiter never sees features.
Ciphertext wire widths are derived from the key size, carried in
metadata, and enforced by the message schema at decode (no hardcoded
widths — 2048-bit keys transport unharmed). The master additionally
publishes the fixed-point bound max|r_i| so members can size slots
tightly; that single magnitude is the only extra leakage (DESIGN.md
§3.6).

The decryption round pipelines end to end (DESIGN.md §10):

* ``cfg.he_stream_chunks > 1`` streams each Enc(g_p) as schema-framed
  chunks over ``isend``, so the arbiter starts decrypting chunk 0
  while later chunks are still on the wire;
* ``cfg.he_decrypt_workers > 0`` fans chunk decryption out over an
  arbiter-side process pool (``he.DecryptPool``) with order-preserving
  reassembly and attributed worker-crash propagation;
* at ``cfg.pipeline_depth >= 2`` the member *defers* the gradient
  apply one round: it sends Enc(g) for round t, applies round t-1's
  decrypted gradient, and only consumes round t's reply inside round
  t+1 — the arbiter's decrypt of round t overlaps the master's round
  t+1 logit gather and the member's next matvec instead of serializing
  the whole federation behind it;
* ``cfg.n_arbiters >= 2`` key-shards decryption: each arbiter holds
  its OWN keypair and decrypts a contiguous slice of every member's
  gradient columns, so no single key holder sees a full gradient
  (key-per-shard, not threshold cryptography — DESIGN.md §10.3).

All four knobs default off; the default wire format and depth-1 math
are bit-identical to the serial decrypt path (the recorded seed
traces).

Predict needs no HE at all: partial logits aggregate exactly as in
training, the master applies the sigmoid, and the arbiter sits the
phase out.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.comm import codec, schema
from repro_torch.comm.schema import Field
from repro_torch.core import he
from repro_torch.core.protocols import base
from repro_torch.core.protocols.driver import VFLProtocol

schema.message("he/pubkey",
               {"n": Field("uint8", 1, width_meta="n_bytes")},
               doc="arbiter's Paillier modulus, width self-declared")
schema.message("logreg/setup", {"items": Field("int64", 1)})
schema.message("logreg/z", {"z": Field("float64", 2)}, stepped=True,
               doc="partial logits for the current batch")
schema.message("logreg/enc_resid",
               {"r": Field("uint8", 2, width_meta="width")}, stepped=True,
               doc="Enc(residual), one ciphertext row per sample "
                   "(one message per key shard at n_arbiters >= 2)")
schema.message("logreg/enc_grad",
               {"g": Field("uint8", 2, width_meta="width")}, stepped=True,
               doc="member's encrypted gradient (packed or scalar); "
                   "meta 'parts' marks a streamed chunk sequence")
schema.message("logreg/grad", {"g": Field("float64", 1)}, stepped=True,
               doc="decrypted gradient, returned to the owner only")
schema.message("logreg/pred_z", {"z": Field("float64", 2)}, stepped=True,
               doc="partial logits for a predict query")


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


@base.register
class LogRegHEProtocol(VFLProtocol):
    name = "logreg_he"
    needs_arbiter = True
    supports_pipeline = True

    def setup(self) -> None:
        cfg, ch = self.cfg, self.ch
        self.arbiters: List[str] = [w for w in ch.world
                                    if w.startswith("arbiter")]
        if self.is_arbiter:
            self.pub, self.priv = he.keygen(cfg.he_bits)
            n_arr = np.frombuffer(
                self.pub.n.to_bytes(self.pub.n_bytes, "big"), np.uint8)
            ch.broadcast("he/pubkey", {"n": n_arr},
                         targets=["master"] + ch.members,
                         meta={"n_bytes": str(self.pub.n_bytes)})
            self.decrypted = 0    # Paillier decryption ops (ciphertexts)
            self.values = 0       # gradient values recovered from them
            self.dpool = he.DecryptPool(self.priv,
                                        workers=cfg.he_decrypt_workers)
            return
        self.pubs = []
        for arb in self.arbiters:
            msg = ch.recv(arb, "he/pubkey")
            self.pubs.append(he.PublicKey(
                int.from_bytes(msg.tensor("n").tobytes(), "big")))
        self.pub = self.pubs[0]
        self.width = self.pub.cipher_bytes
        d = self.data
        if self.is_master:
            # prefetch scales with the announce window: at depth D the
            # master can be encrypting D rounds of residuals before the
            # background filler sees an idle gap — a fixed target would
            # drain and push blinding generation onto the hot path
            target = 2 * cfg.batch_size * max(1, int(cfg.pipeline_depth))
            self.pools = [he.RandomnessPool(p) for p in self.pubs]
            for pool in self.pools:
                pool.start(target=target)
            self.y = base._select(d.ids, self.order, d.y).astype(np.float64)
            self.x = base._select(d.ids, self.order, d.x).astype(np.float64) \
                if d.x is not None else None
            self.items = self.y.shape[1]
            assert self.items == 1, "arbitered logreg: single binary target"
            ch.broadcast("logreg/setup", {"items": np.array([self.items], np.int64)},
                         targets=ch.members)
            self.w = np.zeros((self.x.shape[1], 1)) \
                if self.x is not None else None
        else:
            self.pools = [he.RandomnessPool(p) for p in self.pubs] \
                if cfg.he_packed else [None] * len(self.pubs)
            self.x = base._select(d.ids, self.order, d.x).astype(np.float64)
            ch.recv("master", "logreg/setup")
            self.w = np.zeros((self.x.shape[1], 1))
            # contiguous column shards, one per arbiter key: arbiter s
            # only ever decrypts (and sees) columns self._shards[s]
            self._shards = np.array_split(np.arange(self.x.shape[1]),
                                          len(self.arbiters))
            self._pending = False     # deferred grad apply outstanding

    def on_batch_master(self, rows, step) -> float:
        cfg, ch = self.cfg, self.ch
        zb = np.zeros((len(rows), 1))
        if self.x is not None:
            zb += self.x[rows] @ self.w
        for msg in ch.gather(ch.members, "logreg/z"):
            zb += msg.tensor("z")
        p = _sigmoid(zb)
        r = (p - self.y[rows]) / len(rows)            # (B, 1)
        r_int = he.encode_fixed(r[:, 0])
        rb = str(max(1, int(np.abs(r_int).max())))
        sharded = len(self.pubs) > 1
        for s, (pub, pool) in enumerate(zip(self.pubs, self.pools)):
            enc_r = [pub.encrypt_int(int(v), rn=pool.take())
                     for v in r_int]
            meta = {"width": str(pub.cipher_bytes), "rb": rb}
            if sharded:
                meta["shard"] = str(s)
            # async broadcast: the heavy member-side homomorphic matvec
            # for this round overlaps the master's next-round logit
            # gather and encryption instead of serializing behind the
            # wire write
            ch.broadcast("logreg/enc_resid",
                         {"r": codec.ints_to_u8(enc_r,
                                                pub.cipher_bytes)},
                         targets=ch.members, wait=False, meta=meta)
        if self.x is not None:
            self.w -= cfg.lr * (self.x[rows].T @ r + cfg.l2 * self.w)
        eps = 1e-9
        yb = self.y[rows]
        return float(-np.mean(yb * np.log(p + eps)
                              + (1 - yb) * np.log(1 - p + eps)))

    def member_stage_send(self, rows, step):
        self.ch.isend("master", "logreg/z", {"z": self.x[rows] @ self.w})
        return None

    def member_stage_recv(self, rows, step, ctx) -> None:
        self._send_enc_grads(rows)
        if int(self.cfg.pipeline_depth) >= 2:
            # deferred apply: consume round t-1's decrypted gradient
            # AFTER round t's ciphertexts are on their way, so the
            # arbiter decrypt of round t overlaps the next matvec
            # instead of stalling this member. One extra round of
            # bounded staleness; flushed by on_window_drain.
            if self._pending:
                self._apply_grads()
            self._pending = True
        else:
            self._pending = True
            self._apply_grads()

    def on_window_drain(self) -> None:
        if self.is_member and getattr(self, "_pending", False):
            self._apply_grads()

    def _send_enc_grads(self, rows) -> None:
        """One member round: per key shard, recv Enc(r), compute the
        homomorphic matvec over this shard's columns, ship Enc(g)."""
        cfg, ch = self.cfg, self.ch
        for s, arb in enumerate(self.arbiters):
            pub = self.pubs[s]
            width = pub.cipher_bytes
            cols = self._shards[s] if len(self.arbiters) > 1 else None
            msg = ch.recv("master", "logreg/enc_resid")
            enc_r = codec.u8_to_ints(msg.tensor("r"))
            xb = self.x[rows] if cols is None else self.x[rows][:, cols]
            packed = None
            if cfg.he_packed:
                x_int = he.encode_fixed(xb).reshape(len(rows), -1)
                rb = int(msg.meta.get("rb", 1 << he.SCALE_BITS))
                try:
                    packed = he.packed_matvec(pub, x_int, enc_r, rb,
                                              pool=self.pools[s])
                except ValueError:
                    # slot wider than the key's plaintext (tiny he_bits
                    # / huge values): degrade to the scalar reference
                    packed = None
            if packed is not None:
                cts, info = packed
                meta = {"packed": "1", "width": str(width),
                        **{k: str(v) for k, v in info.items()}}
            else:
                cts = list(he.matvec_cipher(pub, xb,
                                            np.array(enc_r, dtype=object)))
                meta = {"width": str(width)}
            parts = min(max(1, int(cfg.he_stream_chunks)), len(cts))
            if parts <= 1:
                ch.send(arb, "logreg/enc_grad",
                        {"g": codec.ints_to_u8(cts, width)}, meta=meta)
                continue
            # streamed ciphertext round (DESIGN.md §10.2): the first
            # chunk carries the full packing meta plus the stream
            # length; isend lets chunk k+1 encode while chunk k is on
            # the wire, and the arbiter decrypts chunk 0 on arrival
            for i, piece in enumerate(np.array_split(np.arange(len(cts)),
                                                     parts)):
                chunk = [cts[j] for j in piece]
                m = dict(meta, parts=str(parts)) if i == 0 \
                    else {"width": str(width)}
                ch.isend(arb, "logreg/enc_grad",
                         {"g": codec.ints_to_u8(chunk, width)}, meta=m)

    def _apply_grads(self) -> None:
        cfg, ch = self.cfg, self.ch
        if len(self.arbiters) == 1:
            g = ch.recv("arbiter", "logreg/grad").tensor("g")
        else:
            g = np.empty(self.x.shape[1])
            for s, arb in enumerate(self.arbiters):
                g[self._shards[s]] = ch.recv(arb,
                                             "logreg/grad").tensor("g")
        self.w -= cfg.lr * (g[:, None] + cfg.l2 * self.w)
        self._pending = False

    def arbiter_round(self, step) -> None:
        # one decryption round: every member streams an encrypted
        # gradient (possibly chunked); chunks feed the decrypt pool as
        # they arrive and plaintexts reassemble in chunk order
        ch = self.ch
        for m in ch.members:
            sess = self.dpool.session()
            first = None
            n_cts = 0
            for i, part in enumerate(ch.recv_parts(m,
                                                   "logreg/enc_grad")):
                if first is None:
                    first = part
                cts = codec.u8_to_ints(part.tensor("g"))
                n_cts += len(cts)
                sess.submit(i, cts)
            plains = sess.gather()
            if first.meta.get("packed") == "1":
                flat = he.unpack_matvec(plains,
                                        int(first.meta["slot_bits"]),
                                        int(first.meta["k"]),
                                        int(first.meta["off_bits"]),
                                        int(first.meta["count"]))
            else:
                flat = plains
            g = he.decode_fixed(flat, (len(flat),),
                                scale_bits=2 * he.SCALE_BITS)
            if self.cfg.noise_sigma > 0:
                # noising defense (docs/privacy.md): the decrypted
                # gradient is the label-bearing exchange here — the
                # member reconstructs residual signs from it — so the
                # key holder perturbs it before returning ownership
                g = g + base.defense_noise(self.cfg, g, step,
                                           f"{self.role}/{m}")
            ch.send(m, "logreg/grad", {"g": g})
            self.decrypted += n_cts
            self.values += len(flat)

    # -- predict/serve (plaintext logit aggregation; arbiter idle) ----------
    def predict_master(self, rows) -> np.ndarray:
        z = np.zeros((len(rows), 1))
        if self.x is not None:
            z += self.x[rows] @ self.w
        for msg in self.ch.gather(self.ch.members, "logreg/pred_z"):
            z += msg.tensor("z")
        return _sigmoid(z)

    def predict_member(self, rows) -> None:
        self.send_embed(self.predict_embed(rows), rows)

    def predict_embed(self, rows) -> np.ndarray:
        # the member "embedding" is its partial logit slice — row-wise
        # dot products, safely cacheable per row id
        return self.x[rows] @ self.w

    def send_embed(self, z, rows) -> None:
        self.ch.send("master", "logreg/pred_z", {"z": np.asarray(z)})

    def evaluate_master(self, scores, rows) -> Dict[str, float]:
        from repro_torch.train.evals import auc
        y = self.y[rows]
        eps = 1e-9
        logloss = float(-np.mean(y * np.log(scores + eps)
                                 + (1 - y) * np.log(1 - scores + eps)))
        return {"auc": auc(scores, y), "logloss": logloss}

    def finalize(self) -> Dict:
        if self.is_arbiter:
            return {"decrypted_values": self.decrypted,
                    "recovered_values": self.values,
                    "decrypt_pool": self.dpool.stats()}
        pools = [p for p in getattr(self, "pools", []) if p is not None]
        rand = {"hits": sum(p.hits for p in pools),
                "fallbacks": sum(p.fallbacks for p in pools),
                "generated": sum(p._generated for p in pools)}
        if self.is_master:
            return {"w_master": self.w, "rand_pool": rand}
        return {"w": self.w, "rand_pool": rand}

    def close(self) -> None:
        for pool in getattr(self, "pools", []):
            if pool is not None:
                pool.stop()
        dpool = getattr(self, "dpool", None)
        if dpool is not None:
            dpool.close()

    def state_dict(self) -> Dict:
        if self.is_arbiter:
            return {"decrypted": self.decrypted, "values": self.values}
        return {"w": None if self.w is None else self.w.copy()}

    def load_state_dict(self, state) -> None:
        if self.is_arbiter:
            self.decrypted = state["decrypted"]
            self.values = state["values"]
        else:
            self.w = None if state["w"] is None else state["w"].copy()
