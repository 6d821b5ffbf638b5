"""The PyTorch port's transports and execution modes on the CPU: the
communicators (thread bus, TCP with length-prefix framing, HTTP/2-shaped
gRPC framing, multiprocessing queues) round-trip tensors and fail fast
on a peer dropped mid-frame, and split-NN ``run_vfl`` gives the same
losses in all six modes.

One JAX checkpoint cut (``resume_dir``) of a narrow transformer tower
(``embed`` -> ``attn_block`` -> ``quantize`` -> ``mlp``) starts every
run. At pipeline depth 1 each mode's loss history is bit-identical to
the port's thread mode, which is held to the JAX package's thread mode
at rtol 1e-5 (1e-4 from a round where a quantization took a code one
step apart, as ``tests/test_torch_train.py`` explains); at depth 2 the
port's ``socket_proc`` (every agent its own OS process over TCP) is held
to the port's thread mode bit for bit and through it to the JAX
package's depth 2. A spawned worker does not inherit
``torch.set_num_threads``, and another intra-op thread count changes
CPU reduction orders, so the process-mode jobs run with
``OMP_NUM_THREADS=1`` in their environment. Every mode but thread runs
its job in a fresh interpreter (``_port_fit_fresh``).
"""
import multiprocessing as mp
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.party import VFLJob as JaxJob  # noqa: E402
from repro.core.party import run_vfl as jax_run_vfl  # noqa: E402
from repro.core.protocols.base import VFLConfig as JaxConfig  # noqa: E402
from repro.core.protocols.driver import Checkpointer  # noqa: E402
from repro.data.vertical import vertical_partition  # noqa: E402
from repro_torch.comm import codec  # noqa: E402
from repro_torch.comm.grpc import (FLAG_END_HEADERS,  # noqa: E402
                                   FLAG_END_STREAM, FT_HEADERS, FT_SETTINGS,
                                   PREFACE, GrpcCommunicator, _frame,
                                   hpack_decode, hpack_encode)
from repro_torch.comm.local import ThreadBus  # noqa: E402
from repro_torch.comm.process import (ProcessBus,  # noqa: E402
                                      ProcessCommunicator)
from repro_torch.comm.sock import (SocketCommunicator,  # noqa: E402
                                   _recv_exact, local_addresses)
from repro_torch.core import party  # noqa: E402
from repro_torch.core.party import MODES, run_vfl  # noqa: E402
from repro_torch.core.protocols import base as tbase  # noqa: E402
from repro_torch.core.protocols.linreg import LinRegProtocol  # noqa: E402

NARROW = ("embed:tokens=4,dim=16", "attn_block:heads=2", "quantize",
          "mlp:hidden=16")
TOP = ("mlp:hidden=16,final_act=0",)


# ---------------------------------------------------------------------------
# communicators
# ---------------------------------------------------------------------------


def _pair(kind, **kw):
    """Two connected communicators "a" and "b" of one transport."""
    if kind == "thread":
        bus = ThreadBus(["a", "b"])
        return bus.communicator("a", **kw), bus.communicator("b", **kw)
    if kind == "process":
        bus = ProcessBus(["a", "b"], mp.get_context("spawn"))
        return (ProcessCommunicator("a", bus, **kw),
                ProcessCommunicator("b", bus, **kw))
    cls = SocketCommunicator if kind == "socket" else GrpcCommunicator
    addrs = local_addresses(["a", "b"])
    return cls("a", addrs, **kw), cls("b", addrs, **kw)


def _pingpong(comm_a, comm_b):
    out = {}

    def a():
        comm_a.send("b", "ping", {"x": np.arange(5, dtype=np.float32)})
        out["a"] = comm_a.recv("b", "pong").tensor("x")

    def b():
        m = comm_b.recv("a", "ping")
        comm_b.send("a", "pong", {"x": m.tensor("x") * 2})

    ta, tb = threading.Thread(target=a), threading.Thread(target=b)
    ta.start(); tb.start(); ta.join(30); tb.join(30)
    return out["a"]


TRANSPORTS = ["thread", "socket", "grpc", "process"]


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_communicator_roundtrip(kind):
    ca, cb = _pair(kind)
    try:
        got = _pingpong(ca, cb)
        np.testing.assert_array_equal(got,
                                      np.arange(5, dtype=np.float32) * 2)
        assert ca.stats.sent_messages == 1
        assert ca.stats.sent_bytes > 0
    finally:
        ca.close(); cb.close()


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_out_of_order_tags(kind):
    ca, cb = _pair(kind)
    try:
        ca.send("b", "t1", {"x": np.array([1.0])})
        ca.send("b", "t2", {"x": np.array([2.0])})
        assert cb.recv("a", "t2").tensor("x")[0] == 2.0  # later tag first
        assert cb.recv("a", "t1").tensor("x")[0] == 1.0
    finally:
        ca.close(); cb.close()


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_large_frame_roundtrips(kind):
    """512 KiB, above the socket's inline threshold (prefix + body, no
    concat copy) and across many 16 KiB gRPC DATA frames."""
    ca, cb = _pair(kind)
    try:
        big = np.random.default_rng(0).normal(size=(256, 256))
        ca.send("b", "big", {"x": big})
        np.testing.assert_array_equal(cb.recv("a", "big").tensor("x"), big)
    finally:
        ca.close(); cb.close()


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_timeout_configurable_and_honored(kind):
    ca, cb = _pair(kind, timeout=0.3)
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            cb.recv("a", "nothing")
        assert 0.2 <= time.monotonic() - t0 < 2.0
        # a per-call timeout beats the constructor's
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            cb.recv("a", "nothing", timeout=0.8)
        assert time.monotonic() - t0 >= 0.7
    finally:
        ca.close(); cb.close()


# ---------------------------------------------------------------------------
# socket framing: a frame is a u64 length prefix and a safetensors body;
# the first frame on a link names the peer
# ---------------------------------------------------------------------------


def _wire_blob(sender: str, tag: str, payload) -> bytes:
    raw = codec.encode({k: np.asarray(v) for k, v in payload.items()},
                       {"sender": sender, "tag": tag})
    return struct.pack("<Q", len(raw)) + raw


def _hello(sender: str) -> bytes:
    b = sender.encode()
    return struct.pack("<Q", len(b)) + b


def test_partial_reads_reassembled():
    """A frame dribbled in 7-byte chunks still decodes."""
    addrs = local_addresses(["a", "b"])
    cb = SocketCommunicator("b", addrs, timeout=10.0)
    try:
        blob = _hello("a") + _wire_blob("a", "slow", {"x": np.arange(64.0)})
        conn = socket.create_connection(addrs["b"])

        def dribble():
            for i in range(0, len(blob), 7):
                conn.sendall(blob[i:i + 7])
                time.sleep(0.001)
        t = threading.Thread(target=dribble)
        t.start()
        msg = cb.recv("a", "slow")
        t.join()
        conn.close()
        np.testing.assert_array_equal(msg.tensor("x"), np.arange(64.0))
    finally:
        cb.close()


def test_recv_exact_raises_on_midframe_close():
    srv = socket.create_server(("127.0.0.1", 0))
    out = socket.create_connection(srv.getsockname())
    conn, _ = srv.accept()
    out.sendall(b"abc")
    out.close()
    with pytest.raises(ConnectionError, match="mid-frame"):
        _recv_exact(conn, 10)
    conn.close()
    srv.close()


# what reaches the wire before the peer dies: after an established
# frame, half a frame; half of the very first frame (the hello names the
# peer); 3 of the 8 length-prefix bytes
DROPS = {
    "midframe": (True, struct.pack("<Q", 1 << 20) + b"only-the-start"),
    "first_frame": (False, struct.pack("<Q", 1 << 20) + b"partial-first"),
    "length_prefix": (True, b"\x03\x00\x00"),
}


@pytest.mark.parametrize("drop", sorted(DROPS))
def test_socket_drop_raises_not_hangs(drop):
    established, tail = DROPS[drop]
    addrs = local_addresses(["a", "b"])
    cb = SocketCommunicator("b", addrs, timeout=30.0)
    try:
        conn = socket.create_connection(addrs["b"])
        conn.sendall(_hello("a"))
        if established:
            conn.sendall(_wire_blob("a", "ok", {"x": np.zeros(2)}))
            assert cb.recv("a", "ok").tag == "ok"
        conn.sendall(tail)
        conn.close()
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="dropped"):
            cb.recv("a", "never")
        assert time.monotonic() - t0 < 5          # not the 30 s timeout
    finally:
        cb.close()


@pytest.mark.parametrize("kind", ["socket", "grpc"])
def test_clean_close_between_frames_is_not_an_error(kind):
    ca, cb = _pair(kind, timeout=5.0)
    try:
        ca.send("b", "t0", {"x": np.ones(3)})
        ca.send("b", "t1", {"x": np.ones(3) * 2})
        ca.close()                                # boundary close
        assert cb.recv("a", "t0").tensor("x")[0] == 1
        assert cb.recv("a", "t1").tensor("x")[0] == 2
    finally:
        cb.close()


@pytest.mark.parametrize("kind", ["socket", "grpc"])
def test_close_before_the_server_reads_is_not_an_error(kind, monkeypatch):
    """Fresh pairs whose receiving side picks its connection up only
    after the sender has closed: every frame still arrives. A close
    that left the server's gRPC SETTINGS unread reset the connection,
    the server's SETTINGS ack then failed, and its read loop ended with
    both frames unread (every pair lost them)."""
    cls = SocketCommunicator if kind == "socket" else GrpcCommunicator
    serve = cls._serve_conn

    def slow_serve(self, conn):
        time.sleep(0.05)
        return serve(self, conn)

    monkeypatch.setattr(cls, "_serve_conn", slow_serve)
    for _ in range(8):
        ca, cb = _pair(kind, timeout=5.0)
        try:
            ca.send("b", "t0", {"x": np.ones(3)})
            ca.send("b", "t1", {"x": np.ones(3) * 2})
            ca.close()
            assert cb.recv("a", "t0").tensor("x")[0] == 1
            assert cb.recv("a", "t1").tensor("x")[0] == 2
        finally:
            cb.close()


def test_tcp_nodelay_set_on_outbound():
    ca, cb = _pair("socket")
    try:
        ca.send("b", "t", {"x": np.zeros(1)})
        assert ca._out["b"].getsockopt(socket.IPPROTO_TCP,
                                       socket.TCP_NODELAY) == 1
        cb.recv("a", "t")
    finally:
        ca.close(); cb.close()


# ---------------------------------------------------------------------------
# gRPC framing
# ---------------------------------------------------------------------------


def test_hpack_roundtrip_including_long_values():
    hdrs = [(":path", "/repro.Party/Exchange"), ("grpc-agent", "m" * 300)]
    assert hpack_decode(hpack_encode(hdrs)) == dict(hdrs)


def test_grpc_wire_is_http2_shaped():
    """The connection preface, then a SETTINGS frame."""
    srv = socket.create_server(("127.0.0.1", 0))
    ca = GrpcCommunicator("a", {"a": local_addresses(["a"])["a"],
                                "b": srv.getsockname()})
    try:
        ca.send("b", "t", {"x": np.zeros(2)})
        conn, _ = srv.accept()
        conn.settimeout(5.0)
        buf = b""
        while len(buf) < len(PREFACE) + 9:
            buf += conn.recv(4096)
        assert buf.startswith(PREFACE)
        assert buf[len(PREFACE) + 3] == 0x4       # SETTINGS first
        conn.close()
    finally:
        ca.close()


def test_grpc_midstream_drop_attributed_and_raises():
    """A peer dying with an open stream fails waiters fast (the hello
    HEADERS on stream 1 named the connection)."""
    addrs = local_addresses(["a", "b"])
    cb = GrpcCommunicator("b", addrs, timeout=30.0)
    try:
        conn = socket.create_connection(addrs["b"])
        hello = hpack_encode([(":path", "/repro.Party/Hello"),
                              ("grpc-agent", "a")])
        conn.sendall(PREFACE + _frame(FT_SETTINGS, 0, 0, b"")
                     + _frame(FT_HEADERS,
                              FLAG_END_HEADERS | FLAG_END_STREAM, 1, hello))
        conn.sendall(_frame(FT_HEADERS, FLAG_END_HEADERS, 3, hpack_encode(
            [(":path", "/repro.Party/Exchange"), ("grpc-agent", "a")])))
        time.sleep(0.1)
        conn.close()
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="dropped"):
            cb.recv("a", "never")
        assert time.monotonic() - t0 < 5
    finally:
        cb.close()


# ---------------------------------------------------------------------------
# split-NN in every mode, from one JAX cut
# ---------------------------------------------------------------------------


def _case():
    rng = np.random.default_rng(0)
    n, d = 96, 12
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=(d, 3)) > 0).astype(np.float64)
    ids = [f"u{i:05d}" for i in range(n)]
    master, members = vertical_partition(ids, x, y, widths=[5], seed=3)
    kw = dict(protocol="split_nn", epochs=1, batch_size=32, lr=0.1, seed=0,
              use_psi=False, embedding_dim=8, hidden=(16,), tower=NARROW,
              top_tower=TOP)
    return kw, master, members


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """A JAX split-NN checkpoint after one epoch (3 rounds)."""
    kw, master, members = _case()
    d = tmp_path_factory.mktemp("cut_narrow")
    with JaxJob(JaxConfig(**kw), master, members,
                callbacks=[Checkpointer(d)]) as job:
        assert job.fit()["history"]
    return d


def _losses(res):
    return np.array([h["loss"] for h in res["master"]["history"]])


def _port_fit(cut, mode, depth):
    kw, master, members = _case()
    kw["epochs"] = 3                  # two more epochs from the cut
    return _losses(run_vfl(tbase.VFLConfig(**kw), master, members,
                           mode=mode, resume_dir=str(cut),
                           pipeline_depth=depth, device="cpu"))


def _port_fit_fresh(cut, mode, depth, tmp_path):
    """``_port_fit`` in a fresh interpreter, so that the job's pipes and
    sockets are its own. A TLS reader thread that an earlier test left
    in this process (the JAX package's gRPC client, ROADMAP Queue 3)
    keeps reading and writing the file descriptor number it held; once
    that number was reused, it landed a TLS alert in a process-mode
    job's queue, whose readers then waited for a frame of 0x17030300
    bytes. The child writes to files, so this process holds no pipe of
    the job."""
    out, log = tmp_path / f"{mode}_{depth}.npy", tmp_path / "fit.log"
    script = tmp_path / "fit.py"
    here = Path(__file__).resolve().parent
    script.write_text(
        "import sys\n"
        f"sys.path[:0] = [{str(here)!r}, {str(here.parent / 'src')!r}]\n"
        "import numpy as np\n"
        "import test_torch_modes as t\n"
        "if __name__ == '__main__':\n"
        f"    np.save({str(out)!r}, t._port_fit({str(cut)!r}, {mode!r}, "
        f"{depth}))\n")
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, str(script)],
                            stdin=subprocess.DEVNULL, stdout=f,
                            stderr=subprocess.STDOUT, timeout=300).returncode
    assert rc == 0, log.read_text()[-4000:]
    return np.load(out)


@pytest.fixture(scope="module")
def reference(cut):
    """The JAX package's thread mode and the port's, at depth 1 and 2,
    with the rounds where a quantization of the port took a code one
    step apart from the JAX package's."""
    from test_torch_train import _CodeFlips
    kw, master, members = _case()
    kw["epochs"] = 3
    out = {}
    with pytest.MonkeyPatch.context() as mpatch:
        for depth in (1, 2):
            flips = _CodeFlips(mpatch)
            want = _losses(jax_run_vfl(JaxConfig(**kw), master, members,
                                       mode="thread", resume_dir=str(cut),
                                       pipeline_depth=depth))
            got = _port_fit(cut, "thread", depth)
            out[depth] = (got, want, flips.rounds())
            mpatch.undo()
    return out


def _check_against_jax(got, want, flip_rounds):
    assert len(got) == len(want) == 9     # the cut's 3 rounds, then 6
    np.testing.assert_array_equal(got[:3], want[:3])
    first = min(flip_rounds, default=len(got))
    np.testing.assert_allclose(got[:first], want[:first], rtol=1e-5)
    np.testing.assert_allclose(got[first:], want[first:], rtol=1e-4)
    assert np.isfinite(got).all()


def test_thread_mode_matches_jax(reference):
    for depth in (1, 2):
        _check_against_jax(*reference[depth])


@pytest.mark.parametrize("mode", [m for m in MODES if m != "thread"])
def test_split_nn_mode_bit_identical_at_depth1(cut, reference, mode,
                                               monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = _port_fit_fresh(cut, mode, 1, tmp_path)
    thread, want, flips = reference[1]
    np.testing.assert_array_equal(got, thread)
    _check_against_jax(got, want, flips)


def test_socket_proc_depth2_matches_jax(cut, reference, monkeypatch,
                                       tmp_path):
    """Every agent its own OS process over TCP, at bounded staleness 1:
    the same losses as the port's thread mode at depth 2, held to the
    JAX package's depth 2."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = _port_fit_fresh(cut, "socket_proc", 2, tmp_path)
    thread, want, flips = reference[2]
    np.testing.assert_array_equal(got, thread)
    _check_against_jax(got, want, flips)


# ---------------------------------------------------------------------------
# agent failures reach the caller with their traceback, fast
# ---------------------------------------------------------------------------


@tbase.register
class FailingMemberProtocol(LinRegProtocol):
    name = "failing_member"

    def setup(self):
        if self.is_member:
            raise RuntimeError("deliberate member failure")
        super().setup()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_agent_failure_propagates_fast(mode, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(64, 6)), rng.normal(size=(64, 1))
    ids = [f"u{i:05d}" for i in range(64)]
    master, members = vertical_partition(ids, x, y, widths=[3], seed=1)
    cfg = tbase.VFLConfig(protocol="test_torch_modes:FailingMemberProtocol",
                          epochs=1, batch_size=16, use_psi=False)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        run_vfl(cfg, master, members, mode=mode, device="cpu")
    assert time.monotonic() - t0 < 120        # far below the 600 s hang
    assert "deliberate member failure" in str(ei.value.__cause__)


def test_unknown_mode_refused():
    kw, master, members = _case()
    with pytest.raises(ValueError, match="unknown mode"):
        party.VFLJob(tbase.VFLConfig(**kw), master, members, mode="mesh",
                     device="cpu")
