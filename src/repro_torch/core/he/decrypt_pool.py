"""Arbiter-side decrypt worker pool (DESIGN.md §10.1).

Paillier decryption is pure big-int ``pow``, which holds the GIL — a
thread pool buys nothing, so the pool runs ``workers`` spawned OS
processes, each holding a copy of the private key (a frozen dataclass
of plain ints, cheap to pickle) and CRT-decrypting whole ciphertext
chunks per task. The packed-matvec + CRT path is embarrassingly
parallel across ciphertexts: a chunk is independent of every other
chunk, so chunks stream into the pool as they arrive off the wire
(``TypedChannel.recv_parts``) and plaintexts reassemble in submission
*index* order regardless of completion order.

Failure semantics: a worker that dies mid-round (OOM kill, segfault in
a native big-int op, operator ``kill``) must not hang the arbiter on a
result that will never come. ``gather`` watches worker liveness while
it waits and raises :class:`DecryptWorkerError` naming the worker and
the outstanding chunks; a worker that *reports* an exception (bad
ciphertext bytes) raises the same attributed error without losing the
pool.

``workers=0`` is the inline mode: ``submit``/``gather`` run the exact
serial CRT loop on the caller's thread — the seed decrypt path, used
for bit-identity tests and as the ``decrypt_vector`` fallback.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.he.paillier import PrivateKey


class DecryptWorkerError(RuntimeError):
    """A decrypt worker died or reported a failure; the message names
    the worker (index/pid), the cause, and the chunks outstanding."""


def _worker_main(widx: int, priv: PrivateKey, task_q, res_q) -> None:
    """Worker loop: (session, idx, [ciphertexts]) -> decrypt -> result.
    Module-level for spawn picklability. A ``None`` task shuts down."""
    dec = priv.decrypt_int_crt if priv.p else priv.decrypt_int_plain
    while True:
        task = task_q.get()
        if task is None:
            return
        sess, idx, cts = task
        t0 = time.perf_counter()
        try:
            plains = [dec(c) for c in cts]
        except BaseException as e:      # report, keep the worker alive
            res_q.put((sess, idx, None, f"{type(e).__name__}: {e}",
                       widx, 0.0))
            continue
        res_q.put((sess, idx, plains, None, widx,
                   time.perf_counter() - t0))


class DecryptSession:
    """One decryption round: chunks submitted in any order, plaintexts
    gathered in index order. Obtained from :meth:`DecryptPool.session`;
    sessions are sequential (one open round per pool)."""

    def __init__(self, pool: "DecryptPool", sid: int):
        self._pool = pool
        self._sid = sid
        self._results: Dict[int, List[int]] = {}
        self._submitted = 0

    def submit(self, idx: int, cts: Sequence[int]) -> None:
        """Queue chunk ``idx`` (arrival order is irrelevant — results
        reassemble by ``idx``)."""
        self._pool._submit(self._sid, idx, [int(c) for c in cts])
        self._submitted += 1

    def gather(self, n: Optional[int] = None,
               timeout: Optional[float] = None) -> List[int]:
        """Block until all ``n`` chunks (default: every submitted one)
        are decrypted; return the concatenated plaintexts in chunk-index
        order. Raises :class:`DecryptWorkerError` on a dead or failing
        worker, ``TimeoutError`` when ``timeout`` (default: the pool's)
        elapses first."""
        n = self._submitted if n is None else n
        self._pool._collect(self._sid, self._results, n, timeout)
        out: List[int] = []
        for idx in sorted(self._results):
            out.extend(self._results[idx])
        return out


class DecryptPool:
    """Process pool decrypting ciphertext chunks with ``priv``.

    Stats (``stats()``): chunks/values decrypted, cumulative in-worker
    ``decrypt_s`` vs pool ``idle_s`` (worker-seconds not spent
    decrypting while rounds were open), and the busy high-water mark.
    """

    def __init__(self, priv: PrivateKey, workers: int = 0,
                 timeout_s: float = 60.0):
        self.priv = priv
        self.workers = max(0, int(workers))
        self.timeout_s = timeout_s
        self._sid = 0
        self._inflight = 0
        self._procs: List[mp.process.BaseProcess] = []
        self._task_q = None
        self._res_q = None
        # stats
        self.chunks = 0
        self.values = 0
        self.decrypt_s = 0.0
        self.idle_s = 0.0
        self.max_busy = 0
        self._open_s = 0.0            # wall time with chunks in flight
        self._t_first: Optional[float] = None
        if self.workers:
            ctx = mp.get_context("spawn")
            self._task_q = ctx.Queue()
            self._res_q = ctx.Queue()
            # process-mode VFL agents are themselves daemonic (an
            # abandoned VFLJob must not block interpreter exit), and
            # multiprocessing refuses children of daemons because they
            # would escape atexit joining. Our workers don't: they are
            # daemons too (die with the arbiter) and close() joins
            # them — so lift the flag just for the spawn.
            cfg = mp.current_process()._config
            was_daemon = cfg.get("daemon", False)
            if was_daemon:
                cfg["daemon"] = False
            try:
                for i in range(self.workers):
                    p = ctx.Process(target=_worker_main,
                                    args=(i, priv, self._task_q,
                                          self._res_q), daemon=True)
                    p.start()
                    self._procs.append(p)
            finally:
                if was_daemon:
                    cfg["daemon"] = True
        else:
            self._dec = priv.decrypt_int_crt if priv.p \
                else priv.decrypt_int_plain

    # -- rounds --------------------------------------------------------------
    def session(self) -> DecryptSession:
        self._sid += 1
        return DecryptSession(self, self._sid)

    def decrypt_many(self, cts: Sequence[int],
                     chunk: int = 64) -> List[int]:
        """Decrypt a flat ciphertext list, pool-parallel in ``chunk``-d
        pieces (inline serial at ``workers=0``)."""
        sess = self.session()
        cts = list(cts)
        for i, lo in enumerate(range(0, len(cts), max(1, chunk))):
            sess.submit(i, cts[lo:lo + max(1, chunk)])
        return sess.gather()

    # -- internals -----------------------------------------------------------
    def _submit(self, sid: int, idx: int, cts: List[int]) -> None:
        self.chunks += 1
        self.values += len(cts)
        if not self.workers:
            t0 = time.perf_counter()
            self._serial = getattr(self, "_serial", {})
            self._serial[(sid, idx)] = [self._dec(c) for c in cts]
            self.decrypt_s += time.perf_counter() - t0
            return
        if self._inflight == 0:
            self._t_first = time.perf_counter()
        self._inflight += 1
        self.max_busy = max(self.max_busy,
                            min(self._inflight, self.workers))
        self._task_q.put((sid, idx, cts))

    def _collect(self, sid: int, results: Dict[int, List[int]],
                 n: int, timeout: Optional[float]) -> None:
        if not self.workers:
            serial = getattr(self, "_serial", {})
            for (s, idx) in list(serial):
                if s == sid:
                    results[idx] = serial.pop((s, idx))
            if len(results) < n:
                raise DecryptWorkerError(
                    f"inline decrypt session {sid}: {n - len(results)} "
                    f"of {n} chunks were never submitted")
            return
        deadline = time.monotonic() + (self.timeout_s if timeout is None
                                       else timeout)
        while len(results) < n:
            try:
                rsid, idx, plains, err, widx, dt = \
                    self._res_q.get(timeout=0.05)
            except _queue.Empty:
                self._check_alive(sid, n - len(results))
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"decrypt pool: session {sid} still missing "
                        f"{n - len(results)} of {n} chunks after "
                        f"{self.timeout_s if timeout is None else timeout}s")
                continue
            self._inflight -= 1
            if err is not None:
                raise DecryptWorkerError(
                    f"decrypt worker #{widx} failed on chunk {idx} of "
                    f"session {rsid}: {err}")
            self.decrypt_s += dt
            if rsid == sid:
                results[idx] = plains
            # a stale-session result (caller abandoned a round after an
            # error) is drained and dropped
        if self._inflight == 0 and self._t_first is not None:
            self._open_s += time.perf_counter() - self._t_first
            self._t_first = None

    def _check_alive(self, sid: int, missing: int) -> None:
        for i, p in enumerate(self._procs):
            if not p.is_alive():
                raise DecryptWorkerError(
                    f"decrypt worker #{i} (pid {p.pid}) died with exit "
                    f"code {p.exitcode} while session {sid} had "
                    f"{missing} chunks outstanding")

    # -- lifecycle / stats ---------------------------------------------------
    def stats(self) -> Dict[str, float]:
        idle = max(0.0, self.workers * self._open_s - self.decrypt_s) \
            if self.workers else 0.0
        return {"workers": self.workers, "chunks": self.chunks,
                "values": self.values, "max_busy": self.max_busy,
                "decrypt_s": round(self.decrypt_s + 0.0, 4),
                "idle_s": round(self.idle_s + idle, 4)}

    def close(self) -> None:
        if not self.workers:
            return
        for _ in self._procs:
            try:
                self._task_q.put(None)
            except (ValueError, OSError):
                break
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._procs = []
        self.workers = 0
        self._dec = self.priv.decrypt_int_crt if self.priv.p \
            else self.priv.decrypt_int_plain

    def __enter__(self) -> "DecryptPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
