"""Distributed TCP communicator: length-prefixed safetensors frames.

Every agent runs a listener thread; messages are length-prefixed
safetensors blobs. Agents connect lazily and reuse sockets. Works across
hosts; in tests everything binds to 127.0.0.1. The gRPC-style framed
transport (``comm/grpc.py``) shares this module's server/connection
machinery (:class:`_TcpCommunicator`) and differs only in the wire
framing — see docs/transports.md for both wire formats. With
``CommCfg.tls = TLSSpec(...)`` every connection (both framings, thread
and ``*_proc`` modes) is wrapped in mutually-authenticated TLS; the
frame/payload contract above the wire is unchanged, so TLS'd depth-1
runs stay bit-identical to plaintext traces (docs/deploy.md covers
certificate generation and the cluster launcher).

Latency engineering (DESIGN.md §7): ``TCP_NODELAY`` is set on both the
connecting and the accepted side (small control messages used to sit in
Nagle's buffer waiting for the peer's delayed ACK), and small frames go
out as ONE ``sendall`` buffer (prefix + body) so a frame never straddles
a Nagle boundary; large bodies skip the concat copy. A connection that
drops mid-frame marks its sender as down and wakes every waiter —
``recv`` from a dead peer raises ``ConnectionError`` immediately instead
of hanging until the timeout.
"""
from __future__ import annotations

import random
import select
import socket
import ssl
import struct
import threading
import time
from typing import Dict, Optional, Sequence, Set, Tuple

from repro_torch.comm import codec
from repro_torch.comm.base import CommCfg, Message, PartyCommunicator

# below this, prefix+body are concatenated into one buffer (one packet
# under NODELAY); above it, the concat copy costs more than it saves
_INLINE_FRAME_BYTES = 1 << 16
# how long close() waits for each peer to read an outbound connection
# to its end (capped by the transport timeout)
_LINGER_S = 10.0


class _MidFrameClose(ConnectionError):
    """The peer closed with a partially-delivered read outstanding."""


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = conn.recv(n - got)
        if not chunk:
            if got:
                raise _MidFrameClose(
                    f"socket closed mid-frame ({got}/{n} bytes)")
            raise ConnectionError("socket closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _drop_conn(conn: socket.socket) -> None:
    """Close a connection that another thread may still be waiting on (a
    gRPC client's reader, a server's read loop): shutdown() first wakes
    the waiters with EOF. A bare close() frees the fd number while such a
    thread still holds the kernel socket, and with TLS OpenSSL keeps the
    bare number, so its next read or write would hit whatever socket
    reuses it."""
    try:
        conn.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass


def _shut_wr(conn: socket.socket) -> None:
    """Half-close ``conn``: a FIN after every byte already written. On a
    TLS socket this is the TCP socket's own shutdown, which leaves the
    TLS layer to the thread that may still be reading it."""
    try:
        socket.socket.shutdown(conn, socket.SHUT_WR)
    except OSError:
        pass


def _drain_to_eof(conn: socket.socket, deadline: float) -> None:
    """Read and discard ``conn``'s bytes until the peer closes it or
    ``deadline`` (``time.monotonic()``) passes."""
    poller = select.poll()
    poller.register(conn, select.POLLIN)
    try:
        while True:
            left = deadline - time.monotonic()
            if left <= 0 or not poller.poll(int(left * 1000) + 1):
                return
            if not socket.socket.recv(conn, 1 << 16):
                return
    except (OSError, ValueError):
        return


class _TcpCommunicator(PartyCommunicator):
    """Shared TCP server/connection machinery for framed transports.

    Owns the listener socket (bind retries transient EADDRINUSE — a
    pre-allocated port can be sniped before a spawned child binds it),
    the accept loop, lazy outbound connections with connect retries
    (independently booting agents link up in any order), the pending
    message store with mid-frame-drop attribution, and close().

    Subclasses provide the wire format:

    * ``_greet(conn)`` — write the connection opening (hello frame /
      HTTP/2 preface) right after connect.
    * ``_serve_conn(conn)`` — per-connection read loop; deliver parsed
      messages via ``_deliver`` and attribute drops via ``_mark_down``.
    * ``_send(msg, raw)`` — frame and write one message.
    """

    def __init__(self, me: str, addresses: Dict[str, Tuple[str, int]],
                 timeout: float = 120.0, nodelay: bool = True,
                 comm_cfg: Optional[CommCfg] = None):
        """``addresses``: agent id -> (host, port) for EVERY agent.

        ``timeout`` bounds every blocking wait (connect + recv);
        ``nodelay`` disables Nagle (keep True — the flag exists so the
        benchmark can measure the before/after honestly). Both are
        superseded by ``comm_cfg`` when one is passed.
        """
        super().__init__(me, list(addresses), timeout=timeout,
                         comm_cfg=comm_cfg)
        self._addr = dict(addresses)
        self._pending: Dict[Tuple[str, str], list] = {}
        self._cv = threading.Condition()
        self._out: Dict[str, socket.socket] = {}
        self._in: Set[socket.socket] = set()
        self._in_lock = threading.Lock()
        self._down: Set[str] = set()
        # elastic clusters: any EOF from an identified peer is a drop
        # (SIGKILL's kernel-closed sockets look like clean closes)
        self._strict_eof = self.cfg.strict_eof
        self._nodelay = self.cfg.nodelay if comm_cfg is not None \
            else nodelay
        # TLS (DESIGN.md §9): both framings (length-prefix and gRPC)
        # ride the same ssl.SSLContext wrapping — the wire bytes change,
        # the frame/payload contract above them does not
        self._tls = self.cfg.tls.resolve(me) \
            if self.cfg.tls is not None else None
        self._srv_ctx = self._tls.server_context() if self._tls else None
        self._cli_ctx = self._tls.client_context() if self._tls else None
        host, port = self._addr[me]
        deadline = time.monotonic() + min(self._timeout, 10.0)
        while True:
            try:
                self._server = socket.create_server((host, port),
                                                    backlog=16)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        self._alive = True
        self._listener = threading.Thread(target=self._listen, daemon=True)
        self._listener.start()

    # -- server side ---------------------------------------------------------
    def _listen(self):
        while self._alive:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            if self._nodelay:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_entry, args=(conn,),
                             daemon=True).start()

    def _serve_entry(self, conn: socket.socket) -> None:
        """Per-connection thread: TLS-wrap (when configured), then hand
        off to the framing's read loop. A failed handshake — plaintext
        client against a TLS server, or an untrusted certificate — only
        rejects THIS connection; the listener keeps serving."""
        if self._srv_ctx is not None:
            try:
                # bound the handshake so a silent client can't wedge
                # this thread forever; restore blocking mode after
                conn.settimeout(min(self._timeout, 30.0))
                conn = self._srv_ctx.wrap_socket(conn, server_side=True)
                conn.settimeout(None)
            except (OSError, ssl.SSLError):
                try:
                    conn.close()
                except OSError:
                    pass
                return
        # track the accepted socket so close() can tear it down: an
        # agent that exits (or restarts, freeing its port for the
        # respawn to rebind) must not leave inbound connections open
        with self._in_lock:
            self._in.add(conn)
        try:
            self._serve_conn(conn)
        finally:
            with self._in_lock:
                self._in.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_conn(self, conn: socket.socket) -> None:
        raise NotImplementedError

    def _deliver(self, msg: Message) -> None:
        with self._cv:
            self._pending.setdefault((msg.sender, msg.tag),
                                     []).append(msg)
            self._cv.notify_all()

    def _mark_down(self, sender: Optional[str]) -> None:
        """A connection from ``sender`` died with bytes outstanding:
        nothing further will be delivered — wake waiters so they error
        instead of hanging out the timeout."""
        if sender is not None and self._alive:
            with self._cv:
                self._down.add(sender)
                self._cv.notify_all()

    # -- client side ---------------------------------------------------------
    def _greet(self, conn: socket.socket) -> None:
        raise NotImplementedError

    def _conn_to(self, to: str) -> socket.socket:
        if to not in self._out:
            # peers boot independently (one process per agent): retry
            # refused connects until the peer's listener is up, bounded
            # by the configured timeout. Exponential backoff with
            # jitter, not a fixed busy-loop — a rejoin storm of agents
            # reconnecting to a peer that stays down for seconds must
            # not hammer it 20x/s each, and the jitter de-synchronizes
            # the herd.
            deadline = time.monotonic() + self._timeout
            delay, attempts = 0.05, 0
            while True:
                try:
                    conn = socket.create_connection(
                        self._addr[to], timeout=self._timeout)
                    break
                except ConnectionRefusedError as e:
                    attempts += 1
                    now = time.monotonic()
                    if now >= deadline:
                        raise ConnectionError(
                            f"{self.me}: could not connect to {to!r} at "
                            f"{self._addr[to]} within {self._timeout}s "
                            f"({attempts} attempts): {e}") from e
                    # full jitter in [delay/2, delay], capped to both
                    # the growth ceiling and the remaining deadline
                    time.sleep(min(delay * (0.5 + 0.5 * random.random()),
                                   max(deadline - now, 0.0)))
                    delay = min(delay * 2.0, 2.0)
            if self._nodelay:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._cli_ctx is not None:
                # handshake failures do NOT retry: a reachable peer that
                # rejects our certificate (or presents an untrusted one)
                # stays rejected — surface it immediately, attributed
                sni = self._tls.server_hostname or self._addr[to][0]
                try:
                    conn = self._cli_ctx.wrap_socket(
                        conn, server_hostname=sni)
                except (OSError, ssl.SSLError) as e:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    raise ConnectionError(
                        f"{self.me}: TLS handshake with {to!r} at "
                        f"{self._addr[to]} failed: {e}") from e
            self._greet(conn)
            self._out[to] = conn
        return self._out[to]

    def _write_frames(self, recipient: str, *bufs: bytes) -> None:
        """Write buffers to ``recipient``; on any error drop the
        connection so no later write can corrupt the peer's framing."""
        conn = self._conn_to(recipient)
        try:
            for b in bufs:
                conn.sendall(b)
        except BaseException:
            self._out.pop(recipient, None)
            _drop_conn(conn)
            raise

    # -- receive side --------------------------------------------------------
    def _recv_any(self, frm: str, tags: Sequence[str],
                  timeout: Optional[float] = None) -> Message:
        timeout = self._timeout if timeout is None else timeout
        keys = [(frm, t) for t in tags]

        def ready():
            return any(self._pending.get(k) for k in keys) \
                or frm in self._down

        with self._cv:
            ok = self._cv.wait_for(ready, timeout=timeout)
            for k in keys:
                lst = self._pending.get(k)
                if lst:
                    msg = lst.pop(0)
                    if not lst:     # delete drained stepped-tag entries
                        del self._pending[k]
                    return msg
            if frm in self._down:
                raise ConnectionError(
                    f"{self.me}: connection from {frm!r} dropped "
                    f"mid-frame with no message {list(tags)} pending")
            if not ok:
                raise TimeoutError(f"{self.me}: no message "
                                   f"{frm}/{list(tags)}")
            raise AssertionError("unreachable")   # pragma: no cover

    def _peek(self, frm: str, tags: Sequence[str]) -> bool:
        with self._cv:
            return any(self._pending.get((frm, t)) for t in tags)

    def suspects(self) -> Set[str]:
        with self._cv:
            down = set(self._down)
        return down | super().suspects()

    def reset_peer(self, peer: str,
                   keep_tags: Sequence[str] = ()) -> None:
        """Forget one peer entirely so its restarted process can
        re-handshake: clear the sticky send error and down-mark, close
        the cached outbound socket (the next send reconnects to the new
        listener), and drop undelivered inbound messages except
        control-plane tags (``keep_tags`` prefixes) a rejoiner's hello
        may already ride on."""
        with self._send_lock:
            self._send_errs.pop(peer, None)
            if self._suspect == peer:
                self._suspect = None
        out = self._out.pop(peer, None)
        if out is not None:
            _drop_conn(out)
        with self._cv:
            self._down.discard(peer)
            for key in list(self._pending):
                if key[0] == peer and not any(
                        key[1].startswith(k) for k in keep_tags):
                    del self._pending[key]

    def close(self) -> None:
        super().close()                  # drain + stop the sender thread
        self._alive = False
        try:
            # shutdown() before close(): the listener thread is blocked
            # in accept(), which (on Linux) pins the kernel socket — a
            # bare close() would leave the port in LISTEN until that
            # accept returned, so a restarted agent could never rebind
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._server.close()
        except OSError:
            pass
        self._listener.join(timeout=5)
        with self._in_lock:
            pending_in = list(self._in)
        for c in pending_in:
            _drop_conn(c)
        # outbound connections close gracefully: half-close, wait for
        # the peer's EOF (it has read every frame), then close. A close
        # with the peer's bytes unread in the receive queue makes the
        # kernel answer with a reset, which fails the peer's next write
        # (a gRPC server's SETTINGS ack) and can end its read loop with
        # our last frames unread.
        out = list(self._out.values())
        for c in out:
            _shut_wr(c)
        deadline = time.monotonic() + min(self._timeout, _LINGER_S)
        for c in out:
            self._await_eof(c, deadline)
            _drop_conn(c)

    def _await_eof(self, conn: socket.socket, deadline: float) -> None:
        """Wait until the peer has closed ``conn`` (after reading what
        we sent) or ``deadline`` passes."""
        _drain_to_eof(conn, deadline)


class SocketCommunicator(_TcpCommunicator):
    """Length-prefix framing: each message is an 8-byte little-endian
    length followed by the safetensors blob; a connection opens with a
    hello frame naming the connecting agent (so even a drop during the
    peer's FIRST data frame is attributable).

    Example::

        addrs = local_addresses(["master", "member0"])
        cm = SocketCommunicator("master", addrs)
        # ... on the other host/thread/process:
        c0 = SocketCommunicator("member0", addrs)
        c0.send("master", "hello", {"x": np.zeros(3)})
        msg = cm.recv("member0", "hello")
    """

    def _serve_conn(self, conn: socket.socket):
        sender: Optional[str] = None
        mid_frame = False
        try:
            # connection hello: the first frame is the peer's agent id
            (n,) = struct.unpack("<Q", _recv_exact(conn, 8))
            sender = _recv_exact(conn, n).decode()
            while True:
                mid_frame = False
                (n,) = struct.unpack("<Q", _recv_exact(conn, 8))
                mid_frame = True
                raw = _recv_exact(conn, n)
                payload, meta = codec.decode(raw)
                sender = meta.pop("sender", sender)
                tag = meta.pop("tag")
                self._deliver(Message(sender, self.me, tag, payload,
                                      meta))
        except (ConnectionError, OSError) as e:
            # a clean close lands exactly between frames; a drop with
            # bytes outstanding (inside the body — mid_frame — or even
            # inside the next length prefix, _MidFrameClose) means the
            # peer died with a message on the wire. strict_eof (elastic
            # clusters) treats even the clean close as a drop: a
            # SIGKILL'd peer's kernel closes its sockets tidily.
            if mid_frame or isinstance(e, _MidFrameClose) \
                    or (self._strict_eof and sender is not None):
                self._mark_down(sender)
            return

    def _greet(self, conn: socket.socket) -> None:
        me = self.me.encode()
        conn.sendall(struct.pack("<Q", len(me)) + me)   # hello

    def _send(self, msg: Message, raw: bytes) -> None:
        prefix = struct.pack("<Q", len(raw))
        if len(raw) <= _INLINE_FRAME_BYTES:
            self._write_frames(msg.recipient, prefix + raw)
        else:
            self._write_frames(msg.recipient, prefix, raw)


# the kernel's ephemeral range where /proc does not give it (Linux's
# default)
_EPHEMERAL_DEFAULT = (32768, 60999)
_LOWEST_PORT = 1024
# ports drawn from the OS's entropy: no state a fork would share
_PORTS = random.SystemRandom()


def ephemeral_range() -> Tuple[int, int]:
    """The kernel's ephemeral port range (lowest, highest): where a bind
    of port 0 and an outgoing connection take their local ports."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = (int(x) for x in f.read().split())
        return lo, hi
    except (OSError, ValueError):
        return _EPHEMERAL_DEFAULT


def _bindable(port: int) -> bool:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def local_addresses(world: Sequence[str], base_port: int = 0
                    ) -> Dict[str, Tuple[str, int]]:
    """Loopback addresses, a distinct free port each. With ``base_port``
    0 each port is drawn at random below the kernel's ephemeral range
    and checked by a bind: a port-0 bind or an outgoing connection of
    another process takes its port from that range, so between this
    check and the communicator's own bind no such port can take it
    (an OS-assigned port, released and bound again later, could be).
    Otherwise each address gets ``base_port``, bound and released
    first."""
    addrs: Dict[str, Tuple[str, int]] = {}
    if base_port:
        for w in world:
            s = socket.socket()
            s.bind(("127.0.0.1", base_port))
            addrs[w] = ("127.0.0.1", s.getsockname()[1])
            s.close()
        return addrs
    lo, _ = ephemeral_range()
    if lo - _LOWEST_PORT < 2 * len(world):
        raise RuntimeError(f"no room below the ephemeral ports ({lo}) "
                           f"for {len(world)} loopback addresses")
    taken: Set[int] = set()
    for w in world:
        while True:
            port = _PORTS.randrange(_LOWEST_PORT, lo)
            if port not in taken and _bindable(port):
                break
        taken.add(port)
        addrs[w] = ("127.0.0.1", port)
    return addrs
