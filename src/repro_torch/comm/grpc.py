"""gRPC-style framed transport: HTTP/2-like wire format, stdlib only.

The paper ships gRPC + Protobuf + Safetensors. This transport
reproduces the gRPC *wire shape* — an HTTP/2 connection preface, a
SETTINGS frame, HPACK-encoded HEADERS opening one stream per message,
and the payload chunked into DATA frames behind the 5-byte gRPC
message prefix — over plain TCP with no third-party dependency, while
speaking the exact same safetensors channel payloads as the socket
transport (``comm/sock.py``): the two are interchangeable under every
protocol, and the seed-trace bit-identity suite runs on both. When the
real ``grpcio`` package is available it can be slotted behind the same
interface, but nothing here imports it.

Scope (documented in docs/transports.md, internals in DESIGN.md §8):

* Each direction of each agent pair is its own client connection
  (mirroring the socket transport's lazy outbound links). The server
  answers with HTTP/2 flow control: it advertises
  ``SETTINGS_INITIAL_WINDOW_SIZE``, acks the client's SETTINGS, grows
  the connection window with an immediate WINDOW_UPDATE, and
  replenishes connection/stream windows as it consumes DATA. The
  client honors both windows — every DATA frame waits for credit
  (RFC 7540 §6.9), so a long-lived serving stream pushing a large
  response interops with real gRPC peers instead of relying on TCP
  backpressure alone. A send stalled on a closed window fails
  attributed after the transport timeout.
* HEADERS use HPACK *literal without indexing* representations only
  (no dynamic table, no Huffman) — valid HPACK, trivially decodable.
* Stream 1 is the connection hello (``:path /repro.Party/Hello`` +
  ``grpc-agent``), so a peer dying inside its very first data stream
  is still attributable and fails waiters fast.
* ``CommCfg.tls`` applies here exactly as on the socket framing — the
  shared ``_TcpCommunicator`` base wraps every connection in mutual
  TLS before any frame moves, so ``mode="grpc"``/``"grpc_proc"`` run
  encrypted with no change to the framing (docs/deploy.md). A client
  connection is read by its reader thread and written by the sender:
  the two take turns under the connection's lock, since an
  ``ssl.SSLSocket`` read in one thread while another writes it corrupts
  the TLS stream, and the reader waits for the server's bytes with no
  deadline, so an idle connection outlives the transport timeout.
* Messages ride one stream each (odd ids, ascending): HEADERS
  (END_HEADERS) then DATA frames of at most 16384 bytes, the last
  flagged END_STREAM. The DATA body is the gRPC length-prefixed
  message: 1 compressed-flag byte (always 0 — compression happens at
  the schema layer), a 4-byte big-endian length, then the safetensors
  blob whose ``__metadata__`` carries sender/tag exactly as on the
  socket transport.
"""
from __future__ import annotations

import select
import socket
import ssl
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.comm import codec
from repro_torch.comm.base import Message
from repro_torch.comm.sock import (_MidFrameClose, _TcpCommunicator,
                                   _drop_conn, _recv_exact,
                                   local_addresses)

__all__ = ["GrpcCommunicator", "local_addresses"]

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
MAX_FRAME = 16384                      # HTTP/2 default SETTINGS_MAX_FRAME_SIZE

# frame types
FT_DATA = 0x0
FT_HEADERS = 0x1
FT_SETTINGS = 0x4
FT_WINDOW_UPDATE = 0x8

# frame flags
FLAG_END_STREAM = 0x1
FLAG_END_HEADERS = 0x4
FLAG_ACK = 0x1                         # on SETTINGS frames

# flow control (RFC 7540 §6.9): both connection and stream windows
# start at the protocol default; our server immediately advertises a
# large initial stream window via SETTINGS and grows the connection
# window via WINDOW_UPDATE so bulk activations/ciphertexts stream
# without per-64KiB round trips, then replenishes as it consumes.
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
DEFAULT_WINDOW = 65535
RECV_WINDOW = 1 << 24                  # 16 MiB advertised by the server

_HELLO_PATH = "/repro.Party/Hello"
_SEND_PATH = "/repro.Party/Exchange"


def _hp_int(n: int, prefix_bits: int, first: int = 0) -> bytes:
    """HPACK integer encoding (RFC 7541 §5.1) with ``first`` carrying
    the representation's pattern bits above the prefix."""
    limit = (1 << prefix_bits) - 1
    if n < limit:
        return bytes([first | n])
    out = [first | limit]
    n -= limit
    while n >= 128:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _hp_read_int(buf: bytes, pos: int, prefix_bits: int
                 ) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    n = buf[pos] & limit
    pos += 1
    if n < limit:
        return n, pos
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def hpack_encode(headers: List[Tuple[str, str]]) -> bytes:
    """Literal-without-indexing representations only (pattern 0000)."""
    out = bytearray()
    for k, v in headers:
        kb, vb = k.encode(), v.encode()
        out += b"\x00"                       # literal, name not indexed
        out += _hp_int(len(kb), 7) + kb      # H bit 0: raw octets
        out += _hp_int(len(vb), 7) + vb
    return bytes(out)


def hpack_decode(block: bytes) -> Dict[str, str]:
    out: Dict[str, str] = {}
    pos = 0
    try:
        while pos < len(block):
            if block[pos] != 0x00:
                raise ValueError(
                    f"unsupported HPACK representation "
                    f"0x{block[pos]:02x} (this transport emits "
                    f"literal-without-indexing only)")
            pos += 1
            klen, pos = _hp_read_int(block, pos, 7)
            k = block[pos:pos + klen].decode()
            pos += klen
            vlen, pos = _hp_read_int(block, pos, 7)
            out[k] = block[pos:pos + vlen].decode()
            pos += vlen
    except (IndexError, UnicodeDecodeError) as e:
        # normalize so _serve_conn's except clause attributes the drop
        # instead of the listener thread dying unhandled
        raise ValueError(f"truncated/garbled HPACK block: {e}") from e
    return out


def _frame(ftype: int, flags: int, stream: int, body: bytes) -> bytes:
    return (len(body).to_bytes(3, "big") + bytes((ftype, flags))
            + (stream & 0x7FFFFFFF).to_bytes(4, "big") + body)


def _read_frame(conn: socket.socket) -> Tuple[int, int, int, bytes]:
    hdr = _recv_exact(conn, 9)
    length = int.from_bytes(hdr[:3], "big")
    ftype, flags = hdr[3], hdr[4]
    stream = int.from_bytes(hdr[5:9], "big") & 0x7FFFFFFF
    body = _recv_exact(conn, length) if length else b""
    return ftype, flags, stream, body


def _take_frame(buf: bytearray) -> Optional[Tuple[int, int, int, bytes]]:
    """The first whole frame in ``buf``, removed from it; None while
    ``buf`` holds less than a frame."""
    if len(buf) < 9:
        return None
    length = int.from_bytes(buf[:3], "big")
    if len(buf) < 9 + length:
        return None
    ftype, flags = buf[3], buf[4]
    stream = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
    body = bytes(buf[9:9 + length])
    del buf[:9 + length]
    return ftype, flags, stream, body


def _recv_ready(conn: socket.socket, lock: threading.Lock) -> bytes:
    """The bytes of ``conn`` that can be read now: wait until the socket
    is readable outside ``lock``, then read under it without blocking,
    so a writer holding ``lock`` never waits on a read. Returns b"" while
    a TLS record is still incomplete (the rest of it is on the socket,
    which shows readable again); raises once the peer has closed. Under
    the lock the TLS layer is drained, so no decrypted byte is left where
    the next wait on the socket cannot see it."""
    poller = select.poll()
    poller.register(conn, select.POLLIN)
    while not poller.poll(1000):
        if conn.fileno() < 0:
            raise ConnectionError("socket closed")
    with lock:
        timeout = conn.gettimeout()
        conn.settimeout(0.0)
        try:
            chunk = conn.recv(1 << 16)
        except (ssl.SSLWantReadError, BlockingIOError):
            return b""
        finally:
            conn.settimeout(timeout)
        if not chunk:
            raise ConnectionError("socket closed")
        while isinstance(conn, ssl.SSLSocket) and conn.pending():
            chunk += conn.recv(conn.pending())
    return chunk


def _settings_body(entries: Dict[int, int]) -> bytes:
    return b"".join(k.to_bytes(2, "big") + v.to_bytes(4, "big")
                    for k, v in entries.items())


def _parse_settings(body: bytes) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for i in range(0, len(body) - 5, 6):
        out[int.from_bytes(body[i:i + 2], "big")] = \
            int.from_bytes(body[i + 2:i + 6], "big")
    return out


def _window_update(stream: int, inc: int) -> bytes:
    return _frame(FT_WINDOW_UPDATE, 0, stream,
                  (inc & 0x7FFFFFFF).to_bytes(4, "big"))


class _FlowState:
    """Client-side send windows for one outbound connection: the
    connection window plus one window per open stream, replenished by
    the peer's SETTINGS / WINDOW_UPDATE frames (read by the per-
    connection reader thread). DATA writes block in :meth:`consume`
    until both windows have credit."""

    def __init__(self):
        self.cv = threading.Condition()
        self.conn_window = DEFAULT_WINDOW
        self.initial_window = DEFAULT_WINDOW
        self.streams: Dict[int, int] = {}
        self.closed = False

    def open_stream(self, stream: int) -> None:
        with self.cv:
            self.streams[stream] = self.initial_window

    def close_stream(self, stream: int) -> None:
        with self.cv:
            self.streams.pop(stream, None)

    def consume(self, stream: int, n: int, timeout: float,
                who: str) -> None:
        """Block until ``n`` bytes of credit exist on both the
        connection and ``stream`` windows, then take them."""
        deadline = time.monotonic() + timeout
        with self.cv:
            while not self.closed and (
                    self.conn_window < n
                    or self.streams.get(stream, 0) < n):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionError(
                        f"{who}: flow-control stall — peer advanced "
                        f"no window for {timeout}s (conn "
                        f"{self.conn_window}, stream {stream} "
                        f"{self.streams.get(stream, 0)}, need {n})")
                self.cv.wait(remaining)
            if self.closed:
                raise ConnectionError(
                    f"{who}: connection lost while awaiting "
                    f"flow-control window")
            self.conn_window -= n
            self.streams[stream] -= n

    def window_update(self, stream: int, inc: int) -> None:
        with self.cv:
            if stream == 0:
                self.conn_window += inc
            elif stream in self.streams:
                self.streams[stream] += inc
            self.cv.notify_all()

    def apply_settings(self, new_initial: int) -> None:
        # RFC 7540 §6.9.2: a changed SETTINGS_INITIAL_WINDOW_SIZE
        # adjusts every open stream window by the delta (possibly
        # driving it negative); the connection window is untouched
        with self.cv:
            delta = new_initial - self.initial_window
            self.initial_window = new_initial
            for s in self.streams:
                self.streams[s] += delta
            self.cv.notify_all()

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify_all()


class GrpcCommunicator(_TcpCommunicator):
    """gRPC-framed transport; a drop-in peer of ``SocketCommunicator``.

    Registers as ``mode="grpc"`` (agents as threads) and
    ``mode="grpc_proc"`` (one OS process per agent) in
    :class:`~repro_torch.core.party.VFLJob`.

    Example::

        from repro_torch.comm.grpc import GrpcCommunicator, local_addresses

        addrs = local_addresses(["master", "member0"])
        cm = GrpcCommunicator("master", addrs)
        c0 = GrpcCommunicator("member0", addrs)
        c0.send("master", "t", {"x": np.arange(4.0)})
        assert cm.recv("member0", "t").tensor("x")[1] == 1.0
    """

    def __init__(self, me, addresses, timeout: float = 120.0,
                 nodelay: bool = True, comm_cfg=None):
        super().__init__(me, addresses, timeout=timeout,
                         nodelay=nodelay, comm_cfg=comm_cfg)
        self._next_stream = 3              # stream 1 is the hello
        # per-outbound-connection flow control + write serialization
        # (the sender thread and the reader thread's SETTINGS ack both
        # write on the same socket)
        self._fc: Dict[socket.socket, _FlowState] = {}
        self._wl: Dict[socket.socket, threading.Lock] = {}
        self._readers: Dict[socket.socket, threading.Thread] = {}

    # -- client side ---------------------------------------------------------
    def _greet(self, conn: socket.socket) -> None:
        hello = hpack_encode([
            (":method", "POST"), (":scheme", "http"),
            (":path", _HELLO_PATH), (":authority", "party"),
            ("grpc-agent", self.me),
        ])
        conn.sendall(PREFACE + _frame(FT_SETTINGS, 0, 0, b"")
                     + _frame(FT_HEADERS,
                              FLAG_END_HEADERS | FLAG_END_STREAM, 1,
                              hello))
        fc = _FlowState()
        lock = threading.Lock()
        self._fc[conn] = fc
        self._wl[conn] = lock
        t = threading.Thread(target=self._client_reader,
                             args=(conn, fc, lock),
                             name=f"grpc-fc-{self.me}", daemon=True)
        self._readers[conn] = t
        t.start()

    def _client_reader(self, conn: socket.socket, fc: _FlowState,
                       lock: threading.Lock) -> None:
        """Consume the server's control frames on an outbound
        connection: SETTINGS (initial window size; acked), WINDOW_UPDATE
        (credit). Exits — releasing any window-blocked sender — when the
        connection dies. Reads take turns with the sender's writes under
        ``lock`` (:func:`_recv_ready`); a server that sends nothing for
        longer than the transport timeout is idle, not dead."""
        buf = bytearray()
        try:
            while True:
                frame = _take_frame(buf)
                if frame is None:
                    buf += _recv_ready(conn, lock)
                    continue
                ftype, flags, stream, body = frame
                if ftype == FT_SETTINGS:
                    if flags & FLAG_ACK:
                        continue
                    iw = _parse_settings(body).get(
                        SETTINGS_INITIAL_WINDOW_SIZE)
                    if iw is not None:
                        fc.apply_settings(iw)
                    with lock:
                        conn.sendall(_frame(FT_SETTINGS, FLAG_ACK, 0, b""))
                elif ftype == FT_WINDOW_UPDATE:
                    inc = int.from_bytes(body[:4], "big") & 0x7FFFFFFF
                    fc.window_update(stream, inc)
                # other server frames (trailers etc.) are ignored
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            fc.close()
            self._fc.pop(conn, None)
            self._wl.pop(conn, None)
            self._readers.pop(conn, None)

    def _await_eof(self, conn: socket.socket, deadline: float) -> None:
        """The connection's reader reads the server's last control
        frames and then its EOF; wait for it to end, then discard
        whatever it left unread (it ends early if an ack cannot be
        written after the half-close)."""
        reader = self._readers.get(conn)
        if reader is not None:
            reader.join(max(deadline - time.monotonic(), 0.0))
        super()._await_eof(conn, deadline)

    def _write_frames(self, recipient: str, *bufs: bytes) -> None:
        conn = self._conn_to(recipient)
        lock = self._wl.get(conn)
        if lock is None:
            super()._write_frames(recipient, *bufs)
        else:
            with lock:
                super()._write_frames(recipient, *bufs)

    def _send(self, msg: Message, raw: bytes) -> None:
        stream = self._next_stream         # sender-thread serialized
        self._next_stream += 2
        headers = hpack_encode([
            (":method", "POST"), (":scheme", "http"),
            (":path", _SEND_PATH), (":authority", msg.recipient),
            ("content-type", "application/grpc+safetensors"),
            ("grpc-agent", self.me),
        ])
        grpc_msg = b"\x00" + struct.pack(">I", len(raw)) + raw
        conn = self._conn_to(msg.recipient)
        fc = self._fc.get(conn)
        bufs = [_frame(FT_HEADERS, FLAG_END_HEADERS, stream, headers)]
        if fc is None:
            # reader already tore the state down — surface the drop via
            # the normal write path (which closes the cached conn)
            raise ConnectionError(
                f"{self.me}: connection to {msg.recipient!r} lost "
                f"before stream {stream} opened")
        fc.open_stream(stream)
        try:
            for lo in range(0, len(grpc_msg), MAX_FRAME):
                chunk = grpc_msg[lo:lo + MAX_FRAME]
                last = lo + MAX_FRAME >= len(grpc_msg)
                bufs.append(_frame(FT_DATA,
                                   FLAG_END_STREAM if last else 0,
                                   stream, chunk))
                try:
                    fc.consume(stream, len(chunk), self._timeout,
                               self.me)
                except ConnectionError:
                    # a stalled window is a dead link: drop the cached
                    # conn so no later write corrupts peer framing
                    self._out.pop(msg.recipient, None)
                    _drop_conn(conn)
                    raise
                # small messages coalesce HEADERS+DATA into one sendall
                # (one packet under NODELAY), mirroring the socket
                # transport's inline-frame path; larger ones flush as
                # window credit arrives
                if last and len(bufs) == 2:
                    self._write_frames(msg.recipient, b"".join(bufs))
                else:
                    self._write_frames(msg.recipient, *bufs)
                bufs = []
        finally:
            fc.close_stream(stream)

    # -- server side ---------------------------------------------------------
    def _serve_conn(self, conn: socket.socket) -> None:
        sender: Optional[str] = None
        streams: Dict[int, bytearray] = {}
        # receive-side flow-control ledger: how much consumed credit we
        # owe the peer, per connection and per open stream. Replenished
        # lazily at half-window so bulk streams cost O(size/8MiB)
        # WINDOW_UPDATE frames, not one per DATA frame.
        conn_owed = 0
        stream_owed: Dict[int, int] = {}
        try:
            if _recv_exact(conn, len(PREFACE)) != PREFACE:
                raise ConnectionError("bad HTTP/2 connection preface")
            # advertise our receive windows up front: SETTINGS grows
            # every (current and future) stream window, WINDOW_UPDATE
            # grows the connection window, which SETTINGS cannot touch
            conn.sendall(
                _frame(FT_SETTINGS, 0, 0, _settings_body(
                    {SETTINGS_INITIAL_WINDOW_SIZE: RECV_WINDOW}))
                + _window_update(0, RECV_WINDOW - DEFAULT_WINDOW))
            while True:
                ftype, flags, stream, body = _read_frame(conn)
                if ftype == FT_SETTINGS:
                    if not flags & FLAG_ACK:
                        conn.sendall(
                            _frame(FT_SETTINGS, FLAG_ACK, 0, b""))
                    continue
                if ftype == FT_HEADERS:
                    hdrs = hpack_decode(body)
                    agent = hdrs.get("grpc-agent")
                    if agent:
                        sender = agent
                    if hdrs.get(":path") == _HELLO_PATH:
                        continue
                    streams[stream] = bytearray()
                elif ftype == FT_DATA:
                    buf = streams.get(stream)
                    if buf is None:
                        raise ConnectionError(
                            f"DATA on unopened stream {stream}")
                    buf += body
                    conn_owed += len(body)
                    if flags & FLAG_END_STREAM:
                        # deliver BEFORE closing the stream ledger: a
                        # corrupt gRPC prefix raises with the stream
                        # still open, so the drop is attributed below
                        # instead of hanging waiters to the timeout
                        self._deliver_stream(sender, bytes(buf))
                        del streams[stream]
                        stream_owed.pop(stream, None)
                    else:
                        owed = stream_owed.get(stream, 0) + len(body)
                        if owed >= RECV_WINDOW // 2:
                            conn.sendall(_window_update(stream, owed))
                            owed = 0
                        stream_owed[stream] = owed
                    if conn_owed >= RECV_WINDOW // 2:
                        conn.sendall(_window_update(0, conn_owed))
                        conn_owed = 0
                # unknown frame types are ignored (HTTP/2 §4.1 says
                # implementations must discard frames they don't know)
        except (ConnectionError, OSError, ValueError) as e:
            # a clean close lands between frames with no stream open;
            # anything else (mid-frame partial read, an open stream,
            # bad preface/HPACK) means the peer died with a message on
            # the wire — attribute it and fail waiters fast. strict_eof
            # (elastic clusters) attributes even the clean close: a
            # SIGKILL'd peer's kernel closes its sockets tidily.
            if streams or isinstance(e, (_MidFrameClose, ValueError)) \
                    or (self._strict_eof and sender is not None):
                self._mark_down(sender)
            return

    def _deliver_stream(self, sender: Optional[str], buf: bytes) -> None:
        if len(buf) < 5:
            raise ConnectionError("short gRPC message prefix")
        (n,) = struct.unpack(">I", buf[1:5])
        if len(buf) - 5 != n:
            raise ConnectionError(
                f"gRPC length prefix {n} != body {len(buf) - 5}")
        payload, meta = codec.decode(buf[5:])
        sender = meta.pop("sender", sender)
        tag = meta.pop("tag")
        self._deliver(Message(sender, self.me, tag, payload, meta))
