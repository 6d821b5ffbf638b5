"""Communication layer: the MPI-like ``PartyCommunicator`` interface.

The paper's central abstraction (§2): agents exchange tensors through a
send/recv interface whose *implementation* (thread queue, process pipe,
TCP socket, TPU collective) is swapped without touching protocol code.
Every send is metered (payload bytes via the safetensors codec, wall
time) — the paper's "comprehensive logging of payload, exchange time".

Non-blocking engine (DESIGN.md §7): every communicator owns one
background sender thread draining a FIFO queue, so ``isend`` returns a
:class:`SendFuture` immediately. Encode (safetensors serialization)
runs on the *sender thread* by default (DESIGN.md §8.3): the caller
only snapshots the payload — arrays whose buffers are writeable are
copied on enqueue, read-only arrays (e.g. jax exports) ride as-is — so
protocols may update weights in place the moment ``isend`` returns
while the master's critical path no longer pays serialization.
``CommCfg(encode_offload=False)`` restores caller-side encode. The
blocking ``send`` is a thin wrapper (``isend`` + wait) with a fast path
that encodes and writes inline when nothing is queued, so the
synchronous protocols pay no thread handoff. ``irecv`` returns a
:class:`RecvFuture` that resolves lazily: message *arrival* already
progresses in the background on every transport (listener threads /
mailbox queues), so resolving is just the matching wait.
``CommStats`` splits queued-time (waiting behind earlier sends) from
wire-time (inside the transport write).

WAN emulation (DESIGN.md §8.2): ``CommCfg.link = LinkSpec(...)``
shapes every outbound message in the sender thread — bandwidth
serializes messages on a virtual link clock, latency (plus optional
jitter) delays delivery *in parallel* across in-flight messages, the
way real propagation delay does — so loopback benchmarks and tests can
reproduce the cross-silo regimes the VFL-in-practice literature warns
about without leaving one host.
"""
from __future__ import annotations

import abc
import queue as queue_mod
import random
import ssl
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm import codec

Payload = Dict[str, np.ndarray]


@dataclass(frozen=True)
class LinkSpec:
    """Emulated WAN link applied to every outbound message.

    ``latency_ms`` is one-way propagation delay (an RTT of 40 ms means
    ``latency_ms=20`` on both parties' links); ``bandwidth_mbps`` is
    the serialization rate in megabits/s (0 = unlimited);
    ``jitter_ms`` adds uniform-random extra delay in ``[0, jitter_ms]``
    per message (FIFO order is preserved — a jittered message never
    overtakes an earlier one). ``loss`` is a per-message drop
    probability in ``[0, 1]``: dropped messages resolve their send
    future normally (the sender believes the write succeeded, like a
    blackholed IP route) and are counted in ``CommStats.link_dropped``;
    ``loss=1.0`` blackholes the link entirely — the chaos ``partition``
    scenario. Deliveries that do survive keep FIFO order.

    Latency is modeled as *propagation*: two messages enqueued
    back-to-back both arrive ~``latency_ms`` later, not 2x. Bandwidth
    is modeled as *serialization*: each message occupies the link for
    ``nbytes * 8 / bandwidth`` seconds before the next may enter.

    Example::

        from repro_torch.comm.base import CommCfg, LinkSpec

        wan = CommCfg(link=LinkSpec(latency_ms=20, bandwidth_mbps=100))
        job = VFLJob(cfg, master, members, mode="grpc", comm_cfg=wan)
    """

    latency_ms: float = 0.0
    bandwidth_mbps: float = 0.0
    jitter_ms: float = 0.0
    loss: float = 0.0


@dataclass(frozen=True)
class TLSSpec:
    """Mutual-TLS material for the TCP transports (``sock``/``grpc``
    framings and their ``*_proc`` modes).

    ``cert``/``key`` are this agent's PEM certificate chain and private
    key; ``ca`` is the bundle used to verify *peers* (both directions —
    the server requires a client certificate signed by the same CA, so
    every connection is mutually authenticated, the deployment model
    cross-organization VFL needs). ``server_hostname`` overrides the
    name checked against the server certificate (default: the ``host``
    from the address map); ``check_hostname=False`` skips the name
    check while keeping chain verification.

    Paths may contain an ``{agent}`` placeholder, resolved to the
    communicator's own agent id — so one shared :class:`CommCfg` can
    hand every agent its own certificate::

        tls = TLSSpec(cert="certs/{agent}.crt", key="certs/{agent}.key",
                      ca="certs/ca.crt")
        job = VFLJob(cfg, master, members, mode="grpc_proc",
                     comm_cfg=CommCfg(tls=tls))

    Generate a repo-local test CA + per-agent certificates with
    ``python -m repro.launch.certs`` (see docs/deploy.md). TLS wraps
    the wire only — payload bytes are unchanged, so depth-1 runs over
    TLS stay bit-identical to plaintext runs.
    """

    cert: str
    key: str
    ca: str
    server_hostname: Optional[str] = None
    check_hostname: bool = True

    def resolve(self, agent: str) -> "TLSSpec":
        """Substitute the ``{agent}`` placeholder in the paths."""
        from dataclasses import replace
        return replace(self,
                       cert=self.cert.format(agent=agent),
                       key=self.key.format(agent=agent),
                       ca=self.ca.format(agent=agent))

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert, self.key)
        ctx.load_verify_locations(self.ca)
        ctx.verify_mode = ssl.CERT_REQUIRED      # mutual TLS
        return ctx

    def client_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(self.cert, self.key)
        ctx.load_verify_locations(self.ca)
        ctx.check_hostname = self.check_hostname
        return ctx


@dataclass(frozen=True)
class CommCfg:
    """Transport-independent communicator settings.

    ``timeout``: default bound for every blocking wait (connect, recv,
    blocking-send completion); per-call ``timeout=`` overrides it.
    ``None`` (the default) keeps each transport's own default (120 s;
    240 s for process mailboxes, sized for slow spawn imports) — so a
    CommCfg passed only for, say, link shaping never silently tightens
    a transport's deliberate timeout.
    ``nodelay``: disable Nagle on TCP transports (keep True; the flag
    exists so benchmarks can measure the before/after honestly).
    ``link``: optional :class:`LinkSpec` WAN emulation, applied in the
    sender thread of every transport.
    ``encode_offload``: serialize ``isend`` payloads on the sender
    thread instead of the caller (True, the default, shaves the
    caller's critical path; the payload is snapshotted on enqueue
    either way).
    ``tls``: optional :class:`TLSSpec` — wrap every TCP connection
    (``sock`` and ``grpc`` framings, thread and ``*_proc`` modes) in
    mutually-authenticated TLS. Ignored by the in-memory transports.
    ``strict_eof``: treat *any* EOF from an identified peer as a drop
    (mark the sender down), not just mid-frame closes. Off by default —
    the PR 5 attribution semantics, where a clean close between frames
    is a normal shutdown — and switched on by elastic clusters, where a
    SIGKILL'd agent's kernel-closed sockets often look like clean
    closes and must still be detected within milliseconds. Only
    meaningful when the master does no receives after its shutdown
    broadcast (our drivers' discipline).
    ``peer_overrides``: optional per-edge settings, keyed by peer agent
    id — the cluster spec's ``[comm.master.member0]`` tables resolve
    here (``ClusterSpec.comm_for``). Only the **edge-scoped** fields of
    an override are honored: ``link`` (each overridden peer gets its
    own emulated uplink with an independent bandwidth clock) and
    ``timeout`` (bounds blocking sends to and receives from that
    peer). Connection-level fields (``tls``, ``nodelay``,
    ``encode_offload``, ``strict_eof``) stay world-level — a socket is
    configured before the engine knows which VFL edge it serves — and
    the spec validator rejects them per-edge. Each field pins its edge
    only when the override actually sets it: a non-None ``link`` pins
    that edge's shaping (chaos-scripted
    :meth:`PartyCommunicator.set_link` does not touch it), while a
    timeout-only override (``link=None``) keeps riding the shared
    world link — the "*" bandwidth clock and runtime ``set_link``
    swaps — exactly like peers with no entry at all.

    Example::

        from repro_torch.comm.base import CommCfg, LinkSpec

        cfg = CommCfg(timeout=60.0,
                      link=LinkSpec(latency_ms=40, jitter_ms=5))
        job = VFLJob(vfl_cfg, master, members, mode="socket",
                     comm_cfg=cfg)
    """

    timeout: Optional[float] = None
    nodelay: bool = True
    link: Optional[LinkSpec] = None
    encode_offload: bool = True
    tls: Optional[TLSSpec] = None
    strict_eof: bool = False
    peer_overrides: Optional[Dict[str, "CommCfg"]] = None


@dataclass
class Message:
    sender: str
    recipient: str
    tag: str
    payload: Payload
    meta: Dict[str, str] = field(default_factory=dict)

    def tensor(self, name: str = "x") -> np.ndarray:
        return self.payload[name]


@dataclass
class CommStats:
    sent_messages: int = 0
    sent_bytes: int = 0
    recv_messages: int = 0
    recv_wait_s: float = 0.0
    send_s: float = 0.0
    # async-engine split: time a message sat behind earlier sends in the
    # outbound queue vs time inside the transport write itself. For the
    # blocking fast path queued_s is ~0 and wire_s ≈ send_s.
    queued_s: float = 0.0
    wire_s: float = 0.0
    async_sends: int = 0
    per_tag_bytes: Dict[str, int] = field(default_factory=dict)
    # lifecycle phase the agent is currently in ("match" / "fit" /
    # "predict" / ...); the driver updates it at phase transitions so
    # payload accounting splits by phase with zero protocol involvement
    phase: str = "init"
    per_phase_bytes: Dict[str, int] = field(default_factory=dict)
    # robustness accounting: rounds where the master proceeded with a
    # stale contribution because a member missed its per-round deadline
    # (keyed by the straggling peer), and messages the emulated link
    # dropped (LinkSpec.loss / chaos partition)
    straggles: Dict[str, int] = field(default_factory=dict)
    link_dropped: int = 0

    def record_send(self, tag: str, nbytes: int, dt: float,
                    phase: Optional[str] = None):
        # ``phase`` pins deferred-encode sends to the lifecycle phase
        # they were *enqueued* in (the sender thread may only get to
        # them after a phase transition)
        phase = self.phase if phase is None else phase
        self.sent_messages += 1
        self.sent_bytes += nbytes
        self.send_s += dt
        self.per_tag_bytes[tag] = self.per_tag_bytes.get(tag, 0) + nbytes
        self.per_phase_bytes[phase] = \
            self.per_phase_bytes.get(phase, 0) + nbytes

    def record_wire(self, queued: float, wire: float, was_async: bool):
        # called under the communicator's send lock (sender thread or
        # the inline fast path), so += updates never interleave
        self.queued_s += queued
        self.wire_s += wire
        if was_async:
            self.async_sends += 1

    def record_recv(self, wait: float):
        self.recv_messages += 1
        self.recv_wait_s += wait

    def record_straggle(self, peer: str):
        self.straggles[peer] = self.straggles.get(peer, 0) + 1

    def as_dict(self) -> Dict[str, Any]:
        return {
            "sent_messages": self.sent_messages,
            "sent_bytes": self.sent_bytes,
            "recv_messages": self.recv_messages,
            "recv_wait_s": round(self.recv_wait_s, 4),
            "send_s": round(self.send_s, 4),
            "queued_s": round(self.queued_s, 4),
            "wire_s": round(self.wire_s, 4),
            "async_sends": self.async_sends,
            "per_tag_bytes": dict(self.per_tag_bytes),
            "per_phase_bytes": dict(self.per_phase_bytes),
            "straggles": dict(self.straggles),
            "link_dropped": self.link_dropped,
        }


class SendFuture:
    """Completion handle for one outbound message.

    Resolves once the transport write finished (thread/process: queue
    put; socket: ``sendall`` returned). ``result`` re-raises the
    transport error, if any.
    """

    def __init__(self, msg: Message):
        self.msg = msg
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> None:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"send of {self.msg.tag!r} to {self.msg.recipient!r} "
                f"did not complete within {timeout}s")
        if self._exc is not None:
            raise self._exc

    # -- engine side ---------------------------------------------------------
    def _resolve(self, exc: Optional[BaseException] = None) -> None:
        self._exc = exc
        self._done.set()


class RecvFuture:
    """Deferred receive: arrival progresses in the background (listener
    threads / mailboxes); ``result`` performs the matching wait. ``done``
    peeks without blocking."""

    def __init__(self, resolve: Callable[[Optional[float]], Message],
                 peek: Callable[[], bool]):
        self._resolve = resolve
        self._peek = peek
        self._msg: Optional[Message] = None

    def done(self) -> bool:
        return self._msg is not None or self._peek()

    def result(self, timeout: Optional[float] = None) -> Message:
        if self._msg is None:
            self._msg = self._resolve(timeout)
        return self._msg


def _buffer_mutable(a: np.ndarray) -> bool:
    """Could this array's bytes still change under the caller's feet?
    A read-only *view* of a writeable array is mutable through its
    base, so the snapshot must walk the whole ndarray ancestry; a
    chain ending in None or a foreign buffer (jax exports) is only as
    mutable as its read-only flags say."""
    while isinstance(a, np.ndarray):
        if a.flags.writeable:
            return True
        a = a.base
    return False


class _SendItem:
    """One queued outbound message. ``raw`` is the encoded blob, or
    None when encode is offloaded to the sender thread (the message's
    payload is already a snapshot, so late encode sees frozen bytes)."""

    __slots__ = ("msg", "raw", "future", "t_enq", "phase")

    def __init__(self, msg: Message, raw: Optional[bytes],
                 future: SendFuture, phase: str):
        self.msg = msg
        self.raw = raw
        self.future = future
        self.t_enq = time.perf_counter()
        self.phase = phase

    def encode(self) -> bytes:
        if self.raw is None:
            m = self.msg
            self.raw = codec.encode(
                m.payload, {"sender": m.sender, "tag": m.tag, **m.meta})
        return self.raw


class PartyCommunicator(abc.ABC):
    """MPI-like send/recv among named agents.

    ``world`` lists every agent id ("master", "member0", ..., "arbiter").
    """

    def __init__(self, me: str, world: Sequence[str],
                 timeout: float = 120.0,
                 comm_cfg: Optional[CommCfg] = None):
        self.me = me
        self.world = list(world)
        self.stats = CommStats()
        self.cfg = comm_cfg if comm_cfg is not None \
            else CommCfg(timeout=timeout)
        # CommCfg.timeout=None defers to the transport's constructor
        # default (process mode deliberately runs 240 s, not 120 s)
        self._timeout = self.cfg.timeout \
            if self.cfg.timeout is not None else timeout
        self._link = self.cfg.link
        if self._link is not None and self._link == LinkSpec():
            self._link = None            # all-zero spec: no shaping
        # per-edge overrides (CommCfg.peer_overrides): link and timeout
        # register independently, each only when the override sets it —
        # a timeout-only override must NOT pin a private copy of the
        # world link (it would get its own bandwidth clock and be
        # exempt from runtime set_link chaos swaps). An explicit
        # all-zero link pins the edge as unshaped.
        self._peer_links: Dict[str, Optional[LinkSpec]] = {}
        self._peer_timeouts: Dict[str, float] = {}
        for peer, ov in (self.cfg.peer_overrides or {}).items():
            if ov.link is not None:
                self._peer_links[peer] = \
                    None if ov.link == LinkSpec() else ov.link
            if ov.timeout is not None:
                self._peer_timeouts[peer] = ov.timeout
        # link-shaping clocks (sender thread only), one per uplink:
        # time the last byte of the previous message entered the
        # emulated link, and the latest delivery stamp handed out
        # (enforces FIFO under jitter). Default-link peers share the
        # "*" clock (one uplink serializes them, the PR 4 semantics);
        # an overridden edge is its own physical link with its own
        # bandwidth clock.
        self._link_busy: Dict[str, float] = {}
        self._link_last: Dict[str, float] = {}
        # stable per-agent seed (hash() is salted per interpreter — a
        # spawned agent process would jitter differently every run)
        self._link_rng = random.Random(zlib.crc32(me.encode()))
        # async sender engine: FIFO queue + lazily started drain thread.
        # _submitted/_completed (guarded by _send_lock) let the blocking
        # fast path prove nothing is queued OR in flight before writing
        # inline, which preserves per-transport FIFO order.
        self._sendq: "queue_mod.Queue[Optional[_SendItem]]" = \
            queue_mod.Queue()
        self._send_lock = threading.Lock()
        self._send_done = threading.Condition(self._send_lock)
        self._submitted = 0
        self._completed = 0
        self._sender: Optional[threading.Thread] = None
        # wire errors are sticky PER PEER: after a partial write the
        # stream to *that* peer may be mid-frame (each peer is its own
        # connection/mailbox), so the engine never writes to it again —
        # but streams to other peers stay healthy, which is what lets
        # an elastic master keep serving survivors while one member is
        # down. _suspect names the last peer whose write failed (crash
        # attribution for the rejoin machinery).
        self._send_errs: Dict[str, BaseException] = {}
        self._suspect: Optional[str] = None

    # -- implementation hooks ------------------------------------------------
    @abc.abstractmethod
    def _send(self, msg: Message, raw: bytes) -> None:
        ...

    @abc.abstractmethod
    def _recv_any(self, frm: str, tags: Sequence[str],
                  timeout: Optional[float] = None) -> Message:
        """Block until a message from ``frm`` with any of ``tags``
        arrives; return it (earliest-arrived wins on ties)."""

    def _peek(self, frm: str, tags: Sequence[str]) -> bool:
        """Non-blocking: is a matching message already delivered?"""
        return False                     # pragma: no cover - overridden

    def _recv(self, frm: str, tag: str,
              timeout: Optional[float] = None) -> Message:
        return self._recv_any(frm, (tag,), timeout)

    # -- sender engine -------------------------------------------------------
    def _link_for(self, to: str) -> Optional[LinkSpec]:
        """The emulated link shaping sends to ``to``: the per-edge
        override when one exists, else the world-level link."""
        if to in self._peer_links:
            return self._peer_links[to]
        return self._link

    def _timeout_for(self, to: str) -> float:
        return self._peer_timeouts.get(to, self._timeout)

    def _shape_delay(self, t_enq: float, nbytes: int,
                     link: LinkSpec, ckey: str) -> None:
        """Sleep (sender thread, no locks held) until the emulated link
        would deliver this message. Bandwidth serializes on a virtual
        clock keyed to *enqueue* time, so latency overlaps across
        in-flight messages like real propagation delay; the delivery
        stamp is monotonic so jitter never reorders the FIFO. ``ckey``
        names the uplink clock: "*" for the shared default link, the
        peer id for a per-edge override (its own physical link)."""
        tx = nbytes * 8.0 / (link.bandwidth_mbps * 1e6) \
            if link.bandwidth_mbps else 0.0
        busy = max(self._link_busy.get(ckey, 0.0), t_enq) + tx
        self._link_busy[ckey] = busy
        extra = self._link_rng.uniform(0.0, link.jitter_ms) * 1e-3 \
            if link.jitter_ms else 0.0
        deliver = busy + link.latency_ms * 1e-3 + extra
        last = max(self._link_last.get(ckey, 0.0), deliver)
        self._link_last[ckey] = last
        dt = last - time.perf_counter()
        if dt > 0:
            time.sleep(dt)

    def _finish_item(self, item: _SendItem,
                     exc: Optional[BaseException]) -> None:
        # caller must hold _send_lock
        item.future._resolve(exc)
        self._completed += 1
        self._send_done.notify_all()

    def _sender_loop(self) -> None:
        while True:
            item = self._sendq.get()
            if item is None:
                return
            to = item.msg.recipient
            # fail fast (and skip encode) once the wire to this peer
            # errored: after a partial write that stream may be
            # mid-frame, so the engine never writes to it again
            with self._send_lock:
                err = self._send_errs.get(to)
                if err is not None:
                    self._finish_item(item, err)
                    continue
            try:
                deferred = item.raw is None
                raw = item.encode()
            except BaseException as e:          # noqa: BLE001
                # encode never touched the wire: the error is NOT
                # sticky — only this send fails
                with self._send_lock:
                    self._finish_item(item, e)
                continue
            link = self._link_for(to)
            if link is not None:
                if link.loss and self._link_rng.random() < link.loss:
                    # blackholed: the sender side believes the write
                    # succeeded (futures resolve), nothing hits the wire
                    with self._send_lock:
                        self.stats.link_dropped += 1
                        self._finish_item(item, None)
                    continue
                ckey = to if to in self._peer_links else "*"
                self._shape_delay(item.t_enq, len(raw), link, ckey)
            with self._send_lock:
                err = self._send_errs.get(to)
                if err is not None:
                    self._finish_item(item, err)
                    continue
                if deferred:       # caller didn't know the byte count
                    self.stats.record_send(item.msg.tag, len(raw), 0.0,
                                           phase=item.phase)
                t0 = time.perf_counter()
                try:
                    self._send(item.msg, raw)
                except BaseException as e:          # noqa: BLE001
                    self._send_errs[to] = e
                    self._suspect = to
                    item.future._resolve(e)
                else:
                    t1 = time.perf_counter()
                    self.stats.record_wire(t0 - item.t_enq, t1 - t0,
                                           was_async=True)
                    item.future._resolve()
                finally:
                    self._completed += 1
                    self._send_done.notify_all()

    def _ensure_sender(self) -> None:
        if self._sender is None:
            self._sender = threading.Thread(target=self._sender_loop,
                                            daemon=True,
                                            name=f"sender-{self.me}")
            self._sender.start()

    def _raise_pending_send_error(self, to: str) -> None:
        # sticky by design: after a wire error the stream to that peer
        # may be mid-frame, so the engine never writes to it again —
        # every further send to the same peer fails with the original
        # error (other peers' streams are unaffected)
        with self._send_lock:
            err = self._send_errs.get(to)
            if err is not None:
                raise err

    # -- public API ----------------------------------------------------------
    def _make(self, to: str, tag: str, payload: Payload,
              meta: Optional[Dict[str, str]],
              encode: bool = True) -> "Tuple[Message, Optional[bytes]]":
        """Build the Message (+ encoded blob unless deferred). With
        ``encode=False`` the payload is *snapshotted* instead: arrays
        whose buffers are writeable are copied (the caller may mutate
        them the moment isend returns — the snapshot contract),
        read-only arrays ride as-is (jax exports, received tensors)."""
        if encode:
            payload = {k: np.asarray(v) for k, v in payload.items()}
        else:
            snap = {}
            for k, v in payload.items():
                a = np.asarray(v)
                if _buffer_mutable(a):
                    a = a.copy()
                snap[k] = a
            payload = snap
        msg = Message(self.me, to, tag, payload, dict(meta or {}))
        if not encode:
            return msg, None
        raw = codec.encode(payload, {"sender": self.me, "tag": tag,
                                     **msg.meta})
        return msg, raw

    def _enqueue(self, msg: Message, raw: Optional[bytes],
                 t0: float) -> SendFuture:
        fut = SendFuture(msg)
        self._ensure_sender()
        with self._send_lock:
            self._submitted += 1
            if raw is not None:
                self.stats.record_send(msg.tag, len(raw),
                                       time.perf_counter() - t0)
        self._sendq.put(_SendItem(msg, raw, fut, self.stats.phase))
        return fut

    def isend(self, to: str, tag: str, payload: Payload,
              meta: Optional[Dict[str, str]] = None) -> SendFuture:
        """Non-blocking send: snapshot the payload now, encode + write
        on the background sender thread (or encode inline when
        ``CommCfg.encode_offload`` is off), FIFO with every other send.

        Example::

            fut = comm.isend("master", "splitnn/u", {"u": acts})
            ...                      # overlap compute with the write
            fut.result(timeout=30)   # re-raises transport errors
        """
        self._raise_pending_send_error(to)
        t0 = time.perf_counter()
        msg, raw = self._make(to, tag, payload, meta,
                              encode=not self.cfg.encode_offload)
        return self._enqueue(msg, raw, t0)

    def send(self, to: str, tag: str, payload: Payload,
             meta: Optional[Dict[str, str]] = None) -> None:
        """Blocking send. Fast path: when no async send is queued or in
        flight (and no link shaping is active), encode and write inline
        on the caller thread — no thread handoff."""
        self._raise_pending_send_error(to)
        t0 = time.perf_counter()
        if self._link_for(to) is None:
            msg, raw = self._make(to, tag, payload, meta)
            with self._send_lock:
                if self._submitted == self._completed:
                    t1 = time.perf_counter()
                    try:
                        self._send(msg, raw)
                    except BaseException:
                        self._suspect = to
                        raise
                    self.stats.record_wire(0.0, time.perf_counter() - t1,
                                           was_async=False)
                    self.stats.record_send(tag, len(raw),
                                           time.perf_counter() - t0)
                    return
        else:
            # shaped links route every send through the sender thread:
            # the link clock lives there, and the delivery sleep must
            # not run under the send lock
            msg, raw = self._make(to, tag, payload, meta)
        # async sends outstanding (or link shaping): join the FIFO
        fut = self._enqueue(msg, raw, t0)
        fut.result(self._timeout_for(to))

    def flush_sends(self, timeout: Optional[float] = None) -> None:
        """Block until every queued send hit the wire."""
        with self._send_done:
            ok = self._send_done.wait_for(
                lambda: self._submitted == self._completed, timeout)
            if not ok:
                raise TimeoutError("unflushed sends remain")
            if self._send_errs:
                raise next(iter(self._send_errs.values()))

    def set_link(self, link: Optional[LinkSpec]) -> None:
        """Swap WAN emulation at runtime — the chaos scenarios'
        mid-run toggle (``partition`` = ``LinkSpec(loss=1.0)``,
        ``slow`` = inflated latency). Subsequent sends route through
        the sender thread and see the new link; a message racing the
        swap may be shaped under either spec (benign). Swaps the
        *default* link only: edges whose ``CommCfg.peer_overrides``
        entry sets a link keep their pinned spec (timeout-only
        overrides ride the default link and follow the swap)."""
        if link is not None and link == LinkSpec():
            link = None                  # all-zero spec: no shaping
        self._link = link

    def suspects(self) -> set:
        """Peers this communicator has evidence are down: failed
        outbound writes here, plus transport-detected drops (TCP
        framings override to add their ``_down`` set)."""
        return {self._suspect} if self._suspect is not None else set()

    def reset_peer(self, peer: str,
                   keep_tags: Sequence[str] = ()) -> None:
        """Forget all state for one peer so a restarted process can
        re-handshake: clears its sticky send error and suspect mark,
        and drops its undelivered inbound messages except tags with a
        prefix in ``keep_tags`` (the control-plane tags a rejoiner's
        hello may already ride on). Transports extend this to also
        close cached connections and clear down-marks."""
        with self._send_lock:
            self._send_errs.pop(peer, None)
            if self._suspect == peer:
                self._suspect = None
        pending = getattr(self, "_pending", None)
        if pending is not None:
            for key in list(pending):
                if key[0] == peer and not any(
                        key[1].startswith(k) for k in keep_tags):
                    del pending[key]

    def recv(self, frm: str, tag: str,
             timeout: Optional[float] = None) -> Message:
        if timeout is None and frm in self._peer_timeouts:
            timeout = self._peer_timeouts[frm]
        t0 = time.perf_counter()
        msg = self._recv(frm, tag, timeout)
        self.stats.record_recv(time.perf_counter() - t0)
        return msg

    def recv_any(self, frm: str, tags: Sequence[str],
                 timeout: Optional[float] = None) -> Message:
        """Blocking wait for the first message from ``frm`` carrying any
        of ``tags`` (stream-aware receives: data or a coalesced frame)."""
        if timeout is None and frm in self._peer_timeouts:
            timeout = self._peer_timeouts[frm]
        t0 = time.perf_counter()
        msg = self._recv_any(frm, tuple(tags), timeout)
        self.stats.record_recv(time.perf_counter() - t0)
        return msg

    def irecv(self, frm: str, tag: str) -> RecvFuture:
        """Non-blocking receive handle for (frm, tag). Arrival already
        progresses in the background; ``result()`` is the matching wait
        and MUST be called from the agent's own thread (transports hold
        one mailbox per agent)."""
        def _resolve(timeout: Optional[float]) -> Message:
            return self.recv(frm, tag, timeout)
        return RecvFuture(_resolve, lambda: self._peek(frm, (tag,)))

    def broadcast(self, tag: str, payload: Payload,
                  targets: Optional[Sequence[str]] = None,
                  meta: Optional[Dict[str, str]] = None,
                  wait: bool = True) -> List[SendFuture]:
        """Send to every target; with ``wait=False`` the writes stay on
        the sender thread and the returned futures track completion."""
        futs = [self.isend(t, tag, payload, meta=meta)
                for t in (targets if targets is not None else self.world)
                if t != self.me]
        if wait:
            for f in futs:
                f.result(self._timeout)
        return futs

    def gather(self, frm: Sequence[str], tag: str) -> List[Message]:
        futs = [self.irecv(f, tag) for f in frm]
        return [f.result(self._timeout) for f in futs]

    def scatter(self, tag: str, payloads: Dict[str, Payload]) -> None:
        for to, payload in payloads.items():
            self.send(to, tag, payload)

    def close(self) -> None:
        """Stop the sender thread after draining queued writes."""
        if self._sender is not None:
            self._sendq.put(None)
            self._sender.join(timeout=10)
            self._sender = None

    @property
    def members(self) -> List[str]:
        return [w for w in self.world if w.startswith("member")]
