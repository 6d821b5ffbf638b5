"""Typed message schema for the VFL wire protocol.

Replaces stringly-typed tags (``f"logreg/z/{step}"``) and ad-hoc
``meta`` string dicts with a declared registry: every message type names
its payload fields (dtype / rank / width constraints) once, and a
:class:`TypedChannel` stamps sequence numbers onto stepped tags
automatically — protocol code says ``ch.send("linreg/z", {...})`` and
never hand-threads a step counter again.

Validation runs on BOTH ends: the sender can't emit a payload that
doesn't match the declaration (catches producer bugs at the source) and
the receiver re-checks after decode (catches version/key-size skew
between parties — e.g. a peer framing Paillier ciphertexts with a
different key width is rejected before it decodes to garbage).

Stream awareness (DESIGN.md §7): a channel is the (peer, message-type)
pair. Receives are addressed by sequence number, and anything that
arrives early — a later frame racing a bare message, sub-messages of a
coalesced frame — is parked in a per-channel reorder buffer and
delivered in order. ``ch.frame(to)`` coalesces every send inside the
``with`` block into ONE wire message (one length prefix, one syscall,
one packet for small control rounds); the receiving channel unpacks it
transparently. Declaring a message with ``compress=True`` lets the
channel quantize its float payloads to int8 (+per-column scale) with
error feedback when the channel was built with ``compress=True`` —
protocols opt in per message type; HE ciphertext channels simply never
declare it.

Wire compatibility: a stepped message named ``linreg/z`` with sequence
number 7 rides the existing transports under the tag ``linreg/z/7`` —
the same tag the hand-rolled protocols produced, so per-tag byte
accounting and captured traces stay comparable across the redesign.
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm.base import (Message, PartyCommunicator, Payload,
                                   RecvFuture, SendFuture)


class SchemaError(ValueError):
    """A message violated its declared schema."""


@dataclass(frozen=True)
class Field:
    """Constraint on one payload tensor.

    ``dtype``: numpy dtype name ("float64", "uint8", ...), "bytes" for
    fixed-width byte strings (kind 'S'), or None for any.
    ``ndim``: required rank, or None.
    ``width_meta``: name of a metadata key that declares the trailing
    dim (big-int rows: ciphertexts, blinded PSI points); when the key is
    present the tensor's last axis must match it exactly.
    """

    dtype: Optional[str] = None
    ndim: Optional[int] = None
    width_meta: Optional[str] = None


@dataclass(frozen=True)
class MsgType:
    name: str
    fields: Optional[Mapping[str, Field]]   # None = free-form payload
    stepped: bool = False
    compress: bool = False
    doc: str = ""


MESSAGES: Dict[str, MsgType] = {}

# channel-internal meta keys (never user-set)
_COMP_META = "comp"            # json: [[field, orig_dtype], ...]
_FRAME_META = "frame"          # json: [[name, seq, fields, meta], ...]
_FRAME_TYPE = "frame"          # wire tag prefix for coalesced frames


def message(name: str, fields: Optional[Mapping[str, Field]] = None,
            stepped: bool = False, compress: bool = False,
            doc: str = "") -> MsgType:
    """Declare (or idempotently re-declare) a message type.

    ``fields`` maps payload tensor names to :class:`Field` constraints
    (None = free-form payload); ``stepped`` auto-threads a sequence
    number per (peer, type) channel; ``compress`` opts the type's float
    payloads into int8 error-feedback compression on compressing
    channels (HE ciphertext types simply never declare it).

    Example::

        schema.message("linreg/z", {"z": Field("float64", 2)},
                       stepped=True,
                       doc="member partial predictions, one per step")
        ch.send("master", "linreg/z", {"z": zb})   # no step threading
    """
    mt = MsgType(name, dict(fields) if fields is not None else None,
                 stepped, compress, doc)
    prev = MESSAGES.get(name)
    if prev is not None and \
            (prev.fields, prev.stepped, prev.compress) != \
            (mt.fields, mt.stepped, mt.compress):
        raise SchemaError(f"conflicting redeclaration of {name!r}")
    MESSAGES[name] = mt
    return mt


def _check(mt: MsgType, payload: Payload, meta: Mapping[str, str],
           end: str) -> None:
    if mt.fields is None:
        return
    missing = set(mt.fields) - set(payload)
    extra = set(payload) - set(mt.fields)
    if missing or extra:
        raise SchemaError(
            f"{mt.name} ({end}): payload fields {sorted(payload)} != "
            f"declared {sorted(mt.fields)}")
    for fname, f in mt.fields.items():
        arr = np.asarray(payload[fname])
        if f.dtype == "bytes":
            if arr.dtype.kind != "S":
                raise SchemaError(f"{mt.name}.{fname} ({end}): dtype "
                                  f"{arr.dtype} is not a byte string")
        elif f.dtype is not None and arr.dtype != np.dtype(f.dtype):
            raise SchemaError(f"{mt.name}.{fname} ({end}): dtype "
                              f"{arr.dtype} != declared {f.dtype}")
        if f.ndim is not None and arr.ndim != f.ndim:
            raise SchemaError(f"{mt.name}.{fname} ({end}): rank "
                              f"{arr.ndim} != declared {f.ndim}")
        if f.width_meta is not None and f.width_meta in meta:
            want = int(meta[f.width_meta])
            if arr.ndim == 0 or arr.shape[-1] != want:
                raise SchemaError(
                    f"{mt.name}.{fname} ({end}): width "
                    f"{arr.shape[-1] if arr.ndim else 0} != declared "
                    f"{want} (key-size mismatch between parties?)")


def lookup(name: str) -> MsgType:
    mt = MESSAGES.get(name)
    if mt is None:
        raise SchemaError(f"unregistered message type {name!r}")
    return mt


class _FrameBuffer:
    """Sends buffered inside a ``ch.frame(to)`` block."""

    __slots__ = ("to", "parts")

    def __init__(self, to: str):
        self.to = to
        self.parts: List[Tuple[str, int, Payload, Dict[str, str]]] = []


class TypedChannel:
    """Schema-enforcing facade over a :class:`PartyCommunicator`.

    Sequence numbers for stepped message types are kept per
    (peer, message-type) pair and advanced automatically on every
    send/recv, so both ends stay in lock-step without protocol code
    ever formatting a tag. Out-of-order arrivals (frames racing bare
    messages) are reordered per channel before delivery.

    Example::

        ch = TypedChannel(comm, compress=cfg.compress)
        with ch.frame("member0"):          # one wire message
            ch.send("member0", "ctrl/step", step_payload)
            ch.send("member0", "predict/rows", {"rows": rows})
        msg = ch.recv("member0", "splitnn/pred_u")
    """

    def __init__(self, comm: PartyCommunicator, compress: bool = False):
        self.comm = comm
        self.compress = compress
        self._send_seq: Dict[tuple, int] = defaultdict(int)
        self._recv_seq: Dict[tuple, int] = defaultdict(int)
        # (frm, name) -> {seq or None: [Message, ...]} delivered early;
        # inner keys are deleted once drained (a long fit would
        # otherwise leak one entry per step per channel)
        self._reorder: Dict[tuple, Dict[Optional[int], list]] = \
            defaultdict(dict)
        self._frame_send_seq: Dict[str, int] = defaultdict(int)
        self._frame_recv_seq: Dict[str, int] = defaultdict(int)
        self._framing: Optional[_FrameBuffer] = None
        self.error_feedback = None       # lazily built ErrorFeedback
        # elastic / straggler machinery — inert until the driver arms
        # it. ``elastic_roles``: peers whose crashes are recoverable
        # (their ConnectionErrors are converted into down-marks +
        # stale substitution instead of propagating). ``down``: peers
        # currently skipped — sends are dropped, gathers substitute the
        # last delivered message. ``round_deadline``: per-round gather
        # bound; a member that misses it is a straggler and its stale
        # contribution is used (bounded-staleness semantics).
        self.down: set = set()
        self.elastic_roles: set = set()
        self.round_deadline: Optional[float] = None
        self._last_msg: Dict[tuple, Message] = {}
        self._stale_futs: Dict[tuple, list] = {}
        # adversarial exchange capture (docs/privacy.md): the driver
        # installs an ExchangeCapture here when cfg.capture_exchanges
        # is on. None (the default) keeps every hot path at a single
        # is-None check — capture-off runs are bit-identical (tested).
        self.capture = None

    # mirror the communicator's identity surface so match/protocol code
    # can treat a TypedChannel as "the comm with types"
    @property
    def me(self) -> str:
        return self.comm.me

    @property
    def world(self) -> List[str]:
        return self.comm.world

    @property
    def members(self) -> List[str]:
        return self.comm.members

    @property
    def stats(self):
        return self.comm.stats

    def _wire_tag(self, mt: MsgType, seq: int) -> str:
        return f"{mt.name}/{seq}" if mt.stepped else mt.name

    # -- compression ---------------------------------------------------------
    def _compress_payload(self, mt: MsgType, payload: Payload,
                          meta: Dict[str, str], to: str
                          ) -> Tuple[Payload, Dict[str, str]]:
        from repro_torch.core import compression
        if self.error_feedback is None:
            self.error_feedback = compression.ErrorFeedback()
        out: Payload = {}
        comp: List[List[str]] = []
        for k, v in payload.items():
            arr = np.asarray(v)
            if arr.dtype.kind == "f" and arr.ndim >= 1 and arr.size:
                q, scale = self.error_feedback.compress(
                    f"{to}/{mt.name}/{k}", arr.astype(np.float32))
                out[f"{k}.q"] = q
                out[f"{k}.scale"] = scale
                comp.append([k, arr.dtype.name])
            else:
                out[k] = arr
        if comp:
            meta = dict(meta)
            meta[_COMP_META] = json.dumps(comp)
        return out, meta

    @staticmethod
    def _decompress(msg: Message) -> Message:
        from repro_torch.core import compression
        spec = msg.meta.pop(_COMP_META, None)
        if spec is None:
            return msg
        payload = dict(msg.payload)
        for k, dtype in json.loads(spec):
            q = payload.pop(f"{k}.q")
            scale = payload.pop(f"{k}.scale")
            payload[k] = compression.dequantize_int8(q, scale) \
                .astype(dtype)
        msg.payload = payload
        return msg

    # -- send side -----------------------------------------------------------
    def _prepare(self, to: str, name: str, payload: Payload,
                 meta: Optional[Dict[str, str]]
                 ) -> Tuple[MsgType, int, Payload, Dict[str, str]]:
        mt = lookup(name)
        payload = {k: np.asarray(v) for k, v in payload.items()}
        meta = dict(meta or {})
        _check(mt, payload, meta, "send")
        if self.compress and mt.compress:
            payload, meta = self._compress_payload(mt, payload, meta, to)
        seq = self._send_seq[(to, name)]
        if mt.stepped:
            self._send_seq[(to, name)] = seq + 1
        return mt, seq, payload, meta

    def send(self, to: str, name: str, payload: Payload,
             meta: Optional[Dict[str, str]] = None) -> None:
        if to in self.down:
            return          # dropped before seq/EF advance: the peer's
        #                     whole channel state resets at rejoin
        if self.capture is not None:
            # pre-_prepare: the plaintext this party emits, before
            # compression/masking bookkeeping mutates the payload
            self.capture.record("send", to, name, payload)
        try:
            mt, seq, payload, meta = self._prepare(to, name, payload,
                                                   meta)
            if self._framing is not None and self._framing.to == to:
                self._framing.parts.append((name, seq, payload, meta))
                return
            self.comm.send(to, self._wire_tag(mt, seq), payload,
                           meta=meta)
        except ConnectionError:
            if to not in self.elastic_roles:
                raise
            self.down.add(to)

    def isend(self, to: str, name: str, payload: Payload,
              meta: Optional[Dict[str, str]] = None
              ) -> Optional[SendFuture]:
        """Non-blocking typed send; returns the transport future (or
        None when buffered into an open frame)."""
        if to in self.down:
            return None
        if self.capture is not None:
            self.capture.record("send", to, name, payload)
        try:
            mt, seq, payload, meta = self._prepare(to, name, payload,
                                                   meta)
            if self._framing is not None and self._framing.to == to:
                self._framing.parts.append((name, seq, payload, meta))
                return None
            return self.comm.isend(to, self._wire_tag(mt, seq), payload,
                                   meta=meta)
        except ConnectionError:
            if to not in self.elastic_roles:
                raise
            self.down.add(to)
            return None

    def frame(self, to: str, wait: bool = True) -> "_FrameContext":
        """Coalesce every send to ``to`` inside the block into one wire
        message (single prefix+body buffer; one packet for small
        control rounds). Sends to other peers pass through unchanged."""
        return _FrameContext(self, to, wait)

    def _flush_frame(self, fb: _FrameBuffer, wait: bool) -> None:
        if not fb.parts:
            return
        if len(fb.parts) == 1:           # no coalescing win: send bare
            name, seq, payload, meta = fb.parts[0]
            tag = self._wire_tag(lookup(name), seq)
            if wait:
                self.comm.send(fb.to, tag, payload, meta=meta)
            else:
                self.comm.isend(fb.to, tag, payload, meta=meta)
            return
        merged: Payload = {}
        spec = []
        for i, (name, seq, payload, meta) in enumerate(fb.parts):
            for k, v in payload.items():
                merged[f"{i}.{k}"] = v
            spec.append([name, seq, sorted(payload), meta])
        fseq = self._frame_send_seq[fb.to]
        self._frame_send_seq[fb.to] = fseq + 1
        tag = f"{_FRAME_TYPE}/{fseq}"
        meta = {_FRAME_META: json.dumps(spec)}
        if wait:
            self.comm.send(fb.to, tag, merged, meta=meta)
        else:
            self.comm.isend(fb.to, tag, merged, meta=meta)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait until every queued async send hit the wire."""
        self.comm.flush_sends(timeout)

    # -- recv side -----------------------------------------------------------
    def _unpack_frame(self, frm: str, msg: Message) -> None:
        spec = json.loads(msg.meta[_FRAME_META])
        for i, (name, seq, fields, meta) in enumerate(spec):
            payload = {k: msg.payload[f"{i}.{k}"] for k in fields}
            sub = Message(frm, self.comm.me,
                          self._wire_tag(lookup(name), seq),
                          payload, dict(meta))
            mt = lookup(name)
            key = seq if mt.stepped else None
            self._reorder[(frm, name)].setdefault(key, []).append(sub)

    def _pull(self, frm: str, mt: MsgType, seq: int,
              timeout: Optional[float] = None) -> Message:
        """Deliver (frm, mt, seq): from the reorder buffer if it arrived
        early (inside a frame), else from the transport — unpacking any
        interleaved frames along the way."""
        key = seq if mt.stepped else None
        buf = self._reorder[(frm, mt.name)]
        while True:
            lst = buf.get(key)
            if lst:
                msg = lst.pop(0)
                if not lst:
                    del buf[key]
                return self._decompress(msg)
            tags = (self._wire_tag(mt, seq),
                    f"{_FRAME_TYPE}/{self._frame_recv_seq[frm]}")
            msg = self.comm.recv_any(frm, tags, timeout)
            if msg.tag == tags[1]:
                self._frame_recv_seq[frm] += 1
                self._unpack_frame(frm, msg)
                continue
            return self._decompress(msg)

    def recv(self, frm: str, name: str,
             timeout: Optional[float] = None) -> Message:
        mt = lookup(name)
        seq = self._recv_seq[(frm, name)]
        msg = self._pull(frm, mt, seq, timeout)
        # advance only after the transport delivered: a timed-out recv
        # must be retryable without skipping a sequence number
        if mt.stepped:
            self._recv_seq[(frm, name)] = seq + 1
        _check(mt, msg.payload, msg.meta, "recv")
        if self.capture is not None:
            # post-decompress/post-check: exactly the plaintext this
            # party observes (so e.g. int8 quantization error is part
            # of what a captured-exchange adversary sees)
            self.capture.record("recv", frm, name, msg.payload)
        return msg

    def irecv(self, frm: str, name: str) -> RecvFuture:
        """Deferred typed receive. The returned future owns this
        channel position (the sequence number advances now); resolve it
        from the agent's own thread."""
        mt = lookup(name)
        seq = self._recv_seq[(frm, name)]
        if mt.stepped:
            self._recv_seq[(frm, name)] = seq + 1

        def _resolve(timeout: Optional[float]) -> Message:
            msg = self._pull(frm, mt, seq, timeout)
            _check(mt, msg.payload, msg.meta, "recv")
            if self.capture is not None:
                self.capture.record("recv", frm, name, msg.payload)
            return msg

        def _peek() -> bool:
            key = seq if mt.stepped else None
            return bool(self._reorder[(frm, mt.name)].get(key)) or \
                self.comm._peek(frm, (self._wire_tag(mt, seq),))

        return RecvFuture(_resolve, _peek)

    def recv_parts(self, frm: str, name: str,
                   timeout: Optional[float] = None):
        """Receive one logically streamed payload sent as N consecutive
        chunk messages of the same stepped type (DESIGN.md §10.2): the
        first chunk's ``meta["parts"]`` declares the stream length
        (absent = a plain single message). Yields each chunk as it
        arrives — sequence numbering already orders the stream — so the
        consumer overlaps its per-chunk work (e.g. ciphertext
        decryption) with later chunks still on the wire."""
        first = self.recv(frm, name, timeout=timeout)
        yield first
        for _ in range(int(first.meta.get("parts", "1")) - 1):
            yield self.recv(frm, name, timeout=timeout)

    # -- collectives ---------------------------------------------------------
    def broadcast(self, name: str, payload: Payload,
                  targets: Optional[Sequence[str]] = None,
                  meta: Optional[Dict[str, str]] = None,
                  wait: bool = True) -> List[SendFuture]:
        futs = []
        for t in (targets if targets is not None else self.world):
            if t == self.me:
                continue
            if wait:
                self.send(t, name, payload, meta=meta)
            else:
                f = self.isend(t, name, payload, meta=meta)
                if f is not None:
                    futs.append(f)
        return futs

    def gather(self, frm: Sequence[str], name: str,
               timeout: Optional[float] = None,
               stale_ok: bool = False) -> List[Message]:
        """Collect one message per peer. Plain behavior (no deadline,
        no elastic roles armed) is the classic blocking gather.

        With ``self.round_deadline`` set (or an explicit ``timeout`` +
        ``stale_ok``), a peer that misses the deadline is recorded as a
        straggler and its LAST delivered message is substituted — the
        bounded-staleness contribution; its late message is drained
        opportunistically on a later gather. A peer whose connection
        dropped (and is in ``elastic_roles``) is marked down and
        likewise substituted until it rejoins."""
        if timeout is None and self.round_deadline is not None:
            timeout, stale_ok = self.round_deadline, True
        self._drain_stale()
        pairs = [(f, None if f in self.down else self.irecv(f, name))
                 for f in frm]
        out = []
        for f, fut in pairs:
            msg = None
            if fut is not None:
                try:
                    msg = fut.result(
                        self.comm._timeout if timeout is None
                        else timeout)
                except ConnectionError:
                    if f not in self.elastic_roles:
                        raise
                    self.down.add(f)
                    self._stale_futs.setdefault((f, name),
                                                []).append(fut)
                except TimeoutError:
                    if not stale_ok:
                        raise
                    if (f, name) in self._last_msg:
                        self.stats.record_straggle(f)
                        self._stale_futs.setdefault((f, name),
                                                    []).append(fut)
                    else:
                        # nothing cached yet (first round, process
                        # cold start): bounded staleness can only
                        # degrade to a contribution that exists, so
                        # wait out the full transport timeout instead
                        msg = fut.result(self.comm._timeout)
            if msg is None:
                msg = self._last_msg.get((f, name))
                if msg is None:
                    raise ConnectionError(
                        f"{self.me}: {f!r} is down with no stale "
                        f"{name!r} contribution cached to substitute")
            elif stale_ok or f in self.elastic_roles:
                self._last_msg[(f, name)] = msg
            out.append(msg)
        return out

    def _drain_stale(self) -> None:
        """Consume stragglers' late messages once they finally arrive
        (their futures own channel positions that must be drained, or
        the transport's pending store grows one entry per straggle)."""
        for key, futs in list(self._stale_futs.items()):
            left = []
            for fut in futs:
                if fut.done():
                    try:
                        self._last_msg[key] = fut.result(0.0)
                    except Exception:        # noqa: BLE001
                        pass
                else:
                    left.append(fut)
            if left:
                self._stale_futs[key] = left
            else:
                del self._stale_futs[key]

    def reset_peer(self, peer: str, keep: Sequence[str] = ()) -> None:
        """Zero all channel state for one peer so a restarted process
        (whose counters start at 0) can re-handshake: sequence numbers,
        reorder buffers, frame counters, stale caches, parked straggler
        futures, and compression error-feedback residuals — except
        message types listed in ``keep``."""
        for d in (self._send_seq, self._recv_seq):
            for key in list(d):
                if key[0] == peer and key[1] not in keep:
                    del d[key]
        for key in list(self._reorder):
            if key[0] == peer and key[1] not in keep:
                del self._reorder[key]
        for store in (self._last_msg, self._stale_futs):
            for key in list(store):
                if key[0] == peer:
                    del store[key]
        self._frame_send_seq.pop(peer, None)
        self._frame_recv_seq.pop(peer, None)
        if self.error_feedback is not None:
            for k in list(self.error_feedback.residuals):
                if k.startswith(f"{peer}/"):
                    del self.error_feedback.residuals[k]


class _FrameContext:
    def __init__(self, ch: TypedChannel, to: str, wait: bool = True):
        self.ch = ch
        self.to = to
        self.wait = wait

    def __enter__(self) -> TypedChannel:
        if self.ch._framing is not None:
            raise SchemaError("nested frame() blocks are not supported")
        self.ch._framing = _FrameBuffer(self.to)
        return self.ch

    def __exit__(self, exc_type, exc, tb) -> None:
        # flush even when the block raised: the buffered sends already
        # consumed their channel sequence numbers in _prepare, so
        # dropping them would desync the peer forever
        fb, self.ch._framing = self.ch._framing, None
        self.ch._flush_frame(fb, self.wait)
