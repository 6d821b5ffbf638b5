"""Persistent federated inference on top of :class:`VFLJob`.

The training driver's predict phase (PR 2) answers one caller at a
time: every query pays a ``ctrl/phase`` handshake and the caller owns
the master until its scores return. Serving millions of recsys users
needs the opposite shape — the federation stays parked in a long-lived
predict session (``serve_open``), concurrent queries are admitted into
a bounded queue, coalesced into one ``predict/rows`` round across the
members, and de-multiplexed back to their callers:

    callers ──submit──> admission queue ──coalesce──> one federated
    round (``serve_query``; duplicate rows cross the wire once) ──demux
    ──> per-caller scores

Three knobs shape the latency/throughput trade (docs/serving.md):

* ``max_batch`` — row budget per federated round; whole requests are
  packed until the budget is hit.
* ``max_wait_ms`` — how long the batcher holds an under-full round open
  for more arrivals. 0 favors latency, a few ms favors QPS.
* ``admission_limit`` — queued-row bound; beyond it ``submit`` fails
  fast with :class:`AdmissionError` instead of building an unbounded
  backlog (tail latency stays bounded under overload).

Every request carries a trace (admission -> coalesce -> exchange ->
dequeue timestamps) aggregated by :class:`ServeStats`, the serving
sibling of ``CommStats``. A thin length-prefixed-safetensors TCP
frontend (:class:`ServeFrontend` / :class:`ServeClient`) exposes the
engine on a port so ``repro.launch.cluster`` can deploy it from a
``[serve]`` spec section.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.comm import codec

__all__ = ["ServeCfg", "ServeStats", "AdmissionError", "FederatedServer",
           "ServeFrontend", "ServeClient"]


class AdmissionError(RuntimeError):
    """Raised by ``submit``/``query`` when the admission queue is full
    (queued rows would exceed ``ServeCfg.admission_limit``). Callers
    should back off and retry; the server sheds load instead of letting
    the backlog grow without bound."""


@dataclass
class ServeCfg:
    """Knobs for :class:`FederatedServer` (mirrored by the cluster
    spec's ``[serve]`` section)."""

    max_batch: int = 64           # row budget per federated round
    max_wait_ms: float = 2.0      # batcher hold time for an under-full round
    admission_limit: int = 4096   # queued-row bound before shedding
    cache_rows: int = 0           # member embed-cache capacity (0 = off)
    host: str = "127.0.0.1"       # TCP frontend bind address
    port: int = 0                 # frontend port (0 = engine only, no TCP)


@dataclass
class _Pending:
    """One admitted request travelling through the batcher."""

    rows: np.ndarray
    done: threading.Event = field(default_factory=threading.Event)
    scores: Optional[np.ndarray] = None
    err: Optional[BaseException] = None
    # trace stamps (time.perf_counter): admitted, picked into a round,
    # round sent to the federation, scores handed back
    t_admit: float = 0.0
    t_coalesce: float = 0.0
    t_exchange: float = 0.0
    t_done: float = 0.0

    def trace(self) -> Dict[str, float]:
        return {"queue_s": self.t_coalesce - self.t_admit,
                "exchange_s": self.t_done - self.t_exchange,
                "total_s": self.t_done - self.t_admit}


class ServeStats:
    """CommStats-style counters for the serving path. Latencies keep a
    bounded reservoir (most recent ``window`` requests) so percentile
    math stays O(window) regardless of uptime."""

    def __init__(self, window: int = 4096):
        self.requests = 0
        self.rejected = 0
        self.batches = 0
        self.rows_in = 0            # rows admitted
        self.rows_wire = 0          # rows actually sent (post-dedupe)
        self.queue_s = 0.0          # summed admission -> coalesce wait
        self.exchange_s = 0.0       # summed round exchange time
        self._lat = deque(maxlen=window)
        self._lock = threading.Lock()

    def record(self, p: "_Pending") -> None:
        with self._lock:
            self.requests += 1
            self.rows_in += len(p.rows)
            t = p.trace()
            self.queue_s += t["queue_s"]
            self.exchange_s += t["exchange_s"]
            self._lat.append(t["total_s"])

    def record_batch(self, n_rows_wire: int) -> None:
        with self._lock:
            self.batches += 1
            self.rows_wire += n_rows_wire

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def latency_s(self, q: float) -> float:
        """Latency quantile (0..1) over the recent-request window."""
        with self._lock:
            lat = sorted(self._lat)
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(q * len(lat)))]

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            avg_batch = self.rows_wire / max(self.batches, 1)
            d = {"requests": self.requests, "rejected": self.rejected,
                 "batches": self.batches, "rows_in": self.rows_in,
                 "rows_wire": self.rows_wire,
                 "avg_batch_rows": round(avg_batch, 2),
                 "queue_s": round(self.queue_s, 4),
                 "exchange_s": round(self.exchange_s, 4)}
        d["p50_ms"] = round(self.latency_s(0.50) * 1e3, 3)
        d["p99_ms"] = round(self.latency_s(0.99) * 1e3, 3)
        return d


class FederatedServer:
    """Admission + dynamic batching around an open serve session.

    ``engine`` is anything with the ``serve_open`` / ``serve_query`` /
    ``serve_close`` trio — a :class:`repro_torch.core.party.VFLJob` (agents
    in-process or spawned) or a bare ``PartyMaster`` whose peers run
    elsewhere. The server owns the session: :meth:`start` opens it,
    :meth:`stop` drains the queue and closes it.

    Thread-safe: any number of caller threads may :meth:`query`
    concurrently; one batcher thread serializes the federated rounds
    (the VFL round itself is single-flight — members answer EVAL rounds
    in announcement order)."""

    def __init__(self, engine: Any, cfg: Optional[ServeCfg] = None):
        self.engine = engine
        self.cfg = cfg or ServeCfg()
        self.stats = ServeStats()
        self._cv = threading.Condition()
        self._queue: "deque[_Pending]" = deque()
        self._queued_rows = 0
        self._stopping = False
        self._failed: Optional[BaseException] = None
        self._batcher: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FederatedServer":
        """Open the serve session and start the batcher thread."""
        self.engine.serve_open()
        self._batcher = threading.Thread(target=self._batch_loop,
                                         name="serve-batcher",
                                         daemon=True)
        self._batcher.start()
        return self

    def stop(self, timeout: float = 30.0) -> Dict[str, Any]:
        """Drain queued requests, close the serve session, and return
        the final :class:`ServeStats` snapshot."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._batcher is not None:
            self._batcher.join(timeout)
        if self._failed is None:
            self.engine.serve_close()
        return self.stats.as_dict()

    def __enter__(self) -> "FederatedServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- caller side ---------------------------------------------------------
    def submit(self, rows: Sequence[int]) -> _Pending:
        """Admit one query (non-blocking). Returns the pending handle;
        wait on ``handle.done`` and read ``handle.scores``. Raises
        :class:`AdmissionError` when the queue is over budget."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        p = _Pending(rows=rows)
        with self._cv:
            if self._failed is not None:
                raise RuntimeError("serving session failed"
                                   ) from self._failed
            if self._stopping:
                raise RuntimeError("server is stopping")
            if self._queued_rows + len(rows) > self.cfg.admission_limit:
                self.stats.record_reject()
                raise AdmissionError(
                    f"admission queue full ({self._queued_rows} rows "
                    f"queued, limit {self.cfg.admission_limit})")
            p.t_admit = time.perf_counter()
            self._queue.append(p)
            self._queued_rows += len(rows)
            self._cv.notify_all()
        return p

    def query(self, rows: Sequence[int],
              timeout: float = 60.0) -> np.ndarray:
        """Blocking federated inference for ``rows``: admit, ride a
        coalesced round, return this caller's score slice."""
        p = self.submit(rows)
        if not p.done.wait(timeout):
            raise TimeoutError(f"serve query not answered in {timeout}s")
        if p.err is not None:
            raise RuntimeError("federated round failed") from p.err
        return p.scores

    # -- batcher -------------------------------------------------------------
    def _take_batch(self) -> List[_Pending]:
        """Block for the first request, then hold the round open up to
        ``max_wait_ms`` packing whole requests until ``max_batch`` rows.
        Returns [] only when stopping with an empty queue."""
        cfg = self.cfg
        with self._cv:
            while not self._queue and not self._stopping:
                self._cv.wait(0.05)
            if not self._queue:
                return []
            batch = [self._queue.popleft()]
            nrows = len(batch[0].rows)
            deadline = time.perf_counter() + cfg.max_wait_ms * 1e-3
            while nrows < cfg.max_batch:
                if self._queue:
                    nxt = self._queue[0]
                    if nrows + len(nxt.rows) > cfg.max_batch:
                        break
                    batch.append(self._queue.popleft())
                    nrows += len(nxt.rows)
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._stopping:
                    break
                self._cv.wait(remaining)
            self._queued_rows -= nrows
        now = time.perf_counter()
        for p in batch:
            p.t_coalesce = now
        return batch

    def _batch_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            rows = np.concatenate([p.rows for p in batch])
            # duplicates across coalesced callers cross the wire once
            # (Driver.predict_now dedupes); count the post-dedupe rows
            # the members actually see
            self.stats.record_batch(len(np.unique(rows)))
            t_ex = time.perf_counter()
            for p in batch:
                p.t_exchange = t_ex
            try:
                scores = np.asarray(self.engine.serve_query(rows=rows))
            except BaseException as e:
                with self._cv:
                    self._failed = e
                    self._stopping = True
                for p in batch + list(self._queue):
                    p.err = e
                    p.done.set()
                self._queue.clear()
                return
            t_done = time.perf_counter()
            lo = 0
            for p in batch:
                p.scores = scores[lo:lo + len(p.rows)]
                lo += len(p.rows)
                p.t_done = t_done
                self.stats.record(p)
                p.done.set()


# ---------------------------------------------------------------------------
# TCP frontend: length-prefixed safetensors request/reply
# ---------------------------------------------------------------------------
# Frame = 8-byte LE length + codec.encode payload. Request metadata op:
#   "query" {"rows": int64[n]} -> {"scores": float[n, items]}
#   "stats" {}                 -> metadata {"stats": json}
# Errors return metadata {"error": str}. One in-flight request per
# connection; concurrent callers open concurrent connections (the
# engine coalesces them into shared rounds).

_MAX_REQ = 64 << 20


def _read_frame(conn: socket.socket) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 8:
        chunk = conn.recv(8 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack("<Q", hdr)
    if n > _MAX_REQ:
        raise ValueError(f"frame of {n} bytes exceeds {_MAX_REQ}")
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(1 << 16, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def _write_frame(conn: socket.socket, payload: bytes) -> None:
    conn.sendall(struct.pack("<Q", len(payload)) + payload)


class ServeFrontend:
    """TCP face of a :class:`FederatedServer` — what the cluster
    launcher's ``serve`` phase binds from the ``[serve]`` spec section.
    Thread-per-connection; each query blocks its connection while the
    engine coalesces it with concurrent callers' rows."""

    def __init__(self, server: FederatedServer,
                 host: Optional[str] = None, port: Optional[int] = None):
        cfg = server.cfg
        self.server = server
        self._sock = socket.create_server(
            (host or cfg.host, cfg.port if port is None else port))
        self._sock.listen(128)
        self.address = self._sock.getsockname()[:2]
        self._closing = False
        self._threads: List[threading.Thread] = []
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          name="serve-accept",
                                          daemon=True)
        self._acceptor.start()

    @property
    def port(self) -> int:
        return self.address[1]

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while True:
                    blob = _read_frame(conn)
                    if blob is None:
                        return
                    tensors, meta = codec.decode(blob)
                    _write_frame(conn, self._answer(tensors, meta))
        except (ConnectionError, OSError, ValueError):
            return

    def _answer(self, tensors: Dict[str, np.ndarray],
                meta: Dict[str, str]) -> bytes:
        op = meta.get("op", "query")
        try:
            if op == "query":
                scores = self.server.query(
                    tensors["rows"],
                    timeout=float(meta.get("timeout", 60.0)))
                return codec.encode(
                    {"scores": np.ascontiguousarray(scores)})
            if op == "stats":
                return codec.encode(
                    {}, {"stats": json.dumps(self.server.stats.as_dict())})
            return codec.encode({}, {"error": f"unknown op {op!r}"})
        except AdmissionError as e:
            return codec.encode({}, {"error": str(e),
                                     "rejected": "1"})
        except BaseException as e:
            return codec.encode({}, {"error": f"{type(e).__name__}: {e}"})

    def close(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._acceptor.join(5)


class ServeClient:
    """Minimal blocking client for :class:`ServeFrontend`. One
    connection, one in-flight request; load generators open one client
    per worker."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self._addr = (host, int(port))
        self._timeout = timeout
        self._conn: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        if self._conn is None:
            c = socket.create_connection(self._addr,
                                         timeout=self._timeout)
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conn = c
        return self._conn

    def _roundtrip(self, payload: bytes):
        conn = self._connect()
        try:
            _write_frame(conn, payload)
            blob = _read_frame(conn)
        except (ConnectionError, OSError):
            self.close()
            raise
        if blob is None:
            self.close()
            raise ConnectionError("serve frontend closed the connection")
        return codec.decode(blob)

    def query(self, rows: Sequence[int]) -> np.ndarray:
        """Score ``rows`` over the wire; blocks for the coalesced
        round. Raises :class:`AdmissionError` on shed load."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        tensors, meta = self._roundtrip(
            codec.encode({"rows": rows}, {"op": "query"}))
        if "error" in meta:
            if meta.get("rejected"):
                raise AdmissionError(meta["error"])
            raise RuntimeError(meta["error"])
        return tensors["scores"]

    def stats(self) -> Dict[str, Any]:
        """Fetch the server's live :class:`ServeStats` snapshot."""
        _, meta = self._roundtrip(codec.encode({}, {"op": "stats"}))
        if "error" in meta:
            raise RuntimeError(meta["error"])
        return json.loads(meta["stats"])

    def close(self) -> None:
        """Close the connection (idempotent)."""
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
