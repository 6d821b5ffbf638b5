"""Agent lifecycle runtime of the PyTorch port: role objects, the
:class:`VFLJob` entry point and the execution-mode plumbing.

The counterpart of the JAX package's ``repro/core/party.py``. Every
agent runs one :class:`~repro_torch.core.protocols.driver.VFLProtocol`
instance under the shared :class:`~repro_torch.core.protocols.driver.
Driver`; a protocol is resolved by ``cfg.protocol`` name::

    job = VFLJob(cfg, master_data, member_datas, device="cuda")
    job.fit()                    # training phase (callbacks, checkpoints)
    scores = job.predict()       # joint inference — no retraining
    metrics = job.evaluate()     # predict + protocol metrics (e.g. AUC)
    results = job.shutdown()     # per-role result dicts

``device`` says where every agent keeps its tensors. It defaults to
``"cuda"``, and a CUDA device on a machine without one raises: the job
never carries on on the CPU unasked. Tests pass ``device="cpu"``.

Every agent runs in one of six execution modes, with identical
protocol code: "thread" (in-process queues), "socket" and "grpc" (each
agent a thread over localhost TCP, with length-prefix or HTTP/2-like
gRPC framing), and "process", "socket_proc" and "grpc_proc" (each agent
its own OS process, over multiprocessing queues or TCP). A process-mode
agent is started with the *spawn* method, so it builds its own CUDA
context on the card; its data, results and errors cross the process
boundary as numpy arrays and plain Python, never as CUDA tensors.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.comm.base import CommCfg, PartyCommunicator
from repro_torch.comm.grpc import GrpcCommunicator
from repro_torch.comm.local import ThreadBus
from repro_torch.comm.schema import TypedChannel
from repro_torch.comm.sock import SocketCommunicator, local_addresses
from repro_torch.core.protocols import PROTOCOLS, VFLConfig  # noqa: F401
from repro_torch.core.protocols.base import (MasterData, MemberData,
                                             resolve_protocol)
from repro_torch.core.protocols.driver import (Callback, Driver,
                                               ElasticCfg, load_checkpoint)
from repro_torch.models.params import resolve_device

# ensure built-in protocols register
from repro_torch.core.protocols import linreg as _linreg  # noqa: F401
from repro_torch.core.protocols import logreg as _logreg  # noqa: F401
from repro_torch.core.protocols import split_nn as _split_nn  # noqa: F401
from repro_torch.core.protocols import secure_agg as _sec_agg  # noqa: F401

MODES = ("thread", "socket", "grpc", "process", "socket_proc", "grpc_proc")


def world_for(cfg: VFLConfig, n_members: int) -> List[str]:
    world = ["master"] + [f"member{i}" for i in range(n_members)]
    if resolve_protocol(cfg.protocol).needs_arbiter:
        n_arb = max(1, int(getattr(cfg, "n_arbiters", 1)))
        world += ["arbiter" if i == 0 else f"arbiter{i}"
                  for i in range(n_arb)]
    return world


def _force_comm_timeout(cfg: CommCfg, timeout: float) -> CommCfg:
    """``cfg`` with every per-message wait set to ``timeout`` — the
    world-level default AND any ``peer_overrides`` entry."""
    import dataclasses
    over = cfg.peer_overrides
    if over:
        over = {p: dataclasses.replace(o, timeout=timeout)
                for p, o in over.items()}
    return dataclasses.replace(cfg, timeout=timeout,
                               peer_overrides=over)


def _wrap_exc(e: BaseException) -> RuntimeError:
    """Picklable stand-in carrying the agent's traceback text."""
    tb = "".join(traceback.format_exception(type(e), e, e.__traceback__))
    return RuntimeError(f"{type(e).__name__}: {e}\n"
                        f"--- remote traceback ---\n{tb}")


# ---------------------------------------------------------------------------
# explicit role objects — for deployments where each agent is its own
# process/host and you hand it a communicator yourself
# ---------------------------------------------------------------------------


class VFLAgent:
    """One agent: protocol instance + driver over a communicator."""

    role: str = "?"

    def __init__(self, comm: PartyCommunicator, cfg: VFLConfig,
                 callbacks: Sequence[Callback] = (),
                 resume_dir: Optional[str] = None,
                 elastic: Optional[ElasticCfg] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.comm = comm
        self.cfg = cfg
        proto_cls = resolve_protocol(cfg.protocol)
        proto = proto_cls(cfg, TypedChannel(comm, compress=cfg.compress),
                          comm.me, device=resolve_device(device))
        resume = load_checkpoint(resume_dir, comm.me) if resume_dir \
            else None
        self.driver = Driver(proto, callbacks=callbacks,
                             resume_state=resume, elastic=elastic)


class PartyMaster(VFLAgent):
    """Drives the federation: call ``fit`` / ``predict`` / ``evaluate``
    in any order, then ``shutdown`` to release the other agents."""

    role = "master"

    def fit(self, data: MasterData, **kw) -> Dict[str, Any]:
        if self.driver.proto.data is None:
            self.driver.prepare(data)
        return self.driver.fit(**kw)

    def predict(self, rows=None, **kw):
        return self.driver.predict(rows, **kw)

    def evaluate(self, rows=None) -> Dict[str, Any]:
        return self.driver.evaluate(rows)

    # persistent serving session (docs/serving.md): open once, answer
    # many query rounds, close before the next fit/shutdown
    def serve_open(self) -> None:
        self.driver.serve_open()

    def serve_query(self, rows, **kw):
        return self.driver.serve_query(rows, **kw)

    def serve_close(self) -> None:
        self.driver.serve_close()

    def shutdown(self) -> Dict[str, Any]:
        self.driver.shutdown_world()
        self.driver.proto.close()
        return self.driver.result()


class PartyMember(VFLAgent):
    """Reactive agent: serves the master's phase announcements until
    shutdown, then returns its result dict."""

    role = "member"

    def serve(self, data: MemberData,
              rejoin: bool = False) -> Dict[str, Any]:
        """``rejoin=True`` is the restarted-agent entry: state was
        restored from ``resume_dir`` (the checkpoint carries the
        matched order, so ``prepare`` does no matching comm) and the
        member enters the master's paused fit via the ``ctrl/rejoin``
        handshake instead of waiting for a phase announcement."""
        try:
            self.driver.prepare(data)
            if rejoin:
                return self.driver.rejoin_follow()
            return self.driver.follow()
        finally:
            self.driver.proto.close()


class Arbiter(VFLAgent):
    role = "arbiter"

    def serve(self) -> Dict[str, Any]:
        try:
            self.driver.prepare(None)
            return self.driver.follow()
        finally:
            self.driver.proto.close()


# ---------------------------------------------------------------------------
# agent entry points
# ---------------------------------------------------------------------------


def _drive_master(driver: Driver, cmd_q, res_q) -> Dict[str, Any]:
    """Command loop for the master agent: the owning VFLJob feeds
    (phase, kwargs) pairs; each reply is ("ok", payload) or
    ("error", wrapped-exception)."""
    while True:
        cmd, kw = cmd_q.get()
        if cmd == "shutdown":
            driver.shutdown_world()
            res_q.put(("ok", None))
            break
        try:
            if cmd == "fit":
                r: Any = driver.fit(**kw)
            elif cmd == "predict":
                r = driver.predict(**kw)
            elif cmd == "evaluate":
                r = driver.evaluate(**kw)
            elif cmd == "serve_open":
                r = driver.serve_open()
            elif cmd == "serve_query":
                r = driver.serve_query(**kw)
            elif cmd == "serve_close":
                r = driver.serve_close()
            else:
                raise ValueError(f"unknown job command {cmd!r}")
        except BaseException as e:
            res_q.put(("error", _wrap_exc(e)))
            raise
        res_q.put(("ok", r))
    return driver.result()


def _agent_entry(role: str, comm: PartyCommunicator, cfg: VFLConfig,
                 data, out: Dict[str, Any], device: torch.device,
                 callbacks=None, resume_dir=None, cmd_q=None,
                 res_q=None) -> None:
    proto_cls = resolve_protocol(cfg.protocol)
    proto = proto_cls(cfg, TypedChannel(comm, compress=cfg.compress),
                      role, device=device)
    resume = load_checkpoint(resume_dir, role) if resume_dir else None
    driver = Driver(proto, callbacks=callbacks or (), resume_state=resume)
    try:
        driver.prepare(data)
        if role == "master":
            out[role] = _drive_master(driver, cmd_q, res_q)
        else:
            out[role] = driver.follow()
    except BaseException as e:   # propagate to the runner
        out[role] = {"error": e}
        if role == "master" and res_q is not None:
            res_q.put(("error", _wrap_exc(e)))
        raise
    finally:
        try:
            proto.close()
        finally:
            comm.close()


def _mp_entry(role, transport, world, cfg, data, q, device: str,
              callbacks=None, resume_dir=None, cmd_q=None, res_q=None,
              comm_cfg=None):
    # module-level for picklability (spawn). ``transport`` selects the
    # wire: ("bus", mp queue boxes), ("sock", address map) or
    # ("grpc", address map) — the address-map kinds run every agent as
    # its own OS process talking TCP, the paper's distributed
    # deployment (and the shape where pipelined rounds overlap with
    # real parallelism, GIL-free). ``device`` arrives as a string and is
    # resolved here, so a worker without the card raises as a thread
    # agent does; each worker makes its own CUDA context.
    kind, arg = transport
    tkw = {} if comm_cfg is None else {"comm_cfg": comm_cfg}
    if kind == "bus":
        from repro_torch.comm.process import ProcessBus, ProcessCommunicator
        bus = ProcessBus.__new__(ProcessBus)
        bus.world = world
        bus.boxes = arg
        comm = ProcessCommunicator(role, bus, **tkw)
    elif kind == "sock":
        comm = SocketCommunicator(role, arg, **tkw)
    elif kind == "grpc":
        comm = GrpcCommunicator(role, arg, **tkw)
    else:
        raise ValueError(f"unknown transport {kind!r}")
    out: Dict[str, Any] = {}
    try:
        _agent_entry(role, comm, cfg, data, out, resolve_device(device),
                     callbacks, resume_dir, cmd_q, res_q)
    except BaseException as e:
        # the error must reach the parent's queue BEFORE this process
        # dies — otherwise run_vfl blocks its full timeout and reports
        # queue.Empty instead of the real traceback
        q.put((role, {"error": _wrap_exc(e)}))
        raise
    q.put((role, out[role]))


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------


class VFLJob:
    """A live VFL federation with a phase API.

    Starts every agent for ``cfg.protocol`` in the requested execution
    mode (:data:`MODES`) and keeps them alive between calls, so inference
    reuses the loaded state. ``callbacks`` run on every role; in the
    process modes they are pickled into the workers, so their in-memory
    state does not flow back. ``resume_dir``
    restores a :class:`~repro_torch.core.protocols.driver.Checkpointer`
    cut — one written by this package or by the JAX package, whose
    checkpoints hold the same numpy trees.

    Example::

        cfg = VFLConfig(protocol="split_nn", tower=(...), top_tower=(...))
        with VFLJob(cfg, master, members, resume_dir="ckpt",
                    device="cuda") as job:
            scores = job.predict()       # joint inference on the card
        # __exit__ ran job.shutdown() and released every agent
    """

    def __init__(self, cfg: VFLConfig, master_data: MasterData,
                 member_datas: List[MemberData], mode: str = "thread",
                 callbacks: Sequence[Callback] = (),
                 resume_dir: Optional[str] = None,
                 pipeline_depth: Optional[int] = None,
                 comm_timeout: Optional[float] = None,
                 comm_cfg: Optional[CommCfg] = None,
                 comm_cfgs: Optional[Dict[str, CommCfg]] = None,
                 device: Union[str, torch.device] = "cuda"):
        """``pipeline_depth`` overrides ``cfg.pipeline_depth``;
        ``comm_timeout`` overrides each transport's per-message wait
        (including any edge-pinned ``[comm.a.b]`` timeouts);
        ``comm_cfg`` configures the transports in full. ``comm_cfgs``
        overrides ``comm_cfg`` per role (keyed by agent id):
        ``ClusterSpec.comm_for(role)`` resolves a spec's ``[comm.a.b]``
        tables into per-role cfgs, and :meth:`from_spec` passes them
        here; roles without an entry fall back to ``comm_cfg``.
        ``device`` is where every agent keeps its tensors (see
        :func:`resolve_device`)."""
        import dataclasses
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} (one of {MODES})")
        dev = resolve_device(device)
        if pipeline_depth is not None:
            cfg = dataclasses.replace(cfg, pipeline_depth=pipeline_depth)
        if comm_timeout is not None:
            comm_cfg = _force_comm_timeout(comm_cfg or CommCfg(),
                                           comm_timeout)
            if comm_cfgs is not None:
                comm_cfgs = {w: _force_comm_timeout(c, comm_timeout)
                             for w, c in comm_cfgs.items()}

        def _cfg_for(w: str) -> Optional[CommCfg]:
            if comm_cfgs is not None and w in comm_cfgs:
                return comm_cfgs[w]
            return comm_cfg

        def _ckw(w: str) -> Dict[str, Any]:
            c = _cfg_for(w)
            return {} if c is None else {"comm_cfg": c}

        self.cfg = cfg
        self.mode = mode
        self.device = dev
        self.world = world_for(cfg, len(member_datas))
        datas: Dict[str, Any] = {"master": master_data}
        for i, md in enumerate(member_datas):
            datas[f"member{i}"] = md
        for w in self.world:
            if w.startswith("arbiter"):
                datas[w] = None

        self._results: Dict[str, Any] = {}
        self._failed: Optional[BaseException] = None
        self._closed = False
        self._threads: List[threading.Thread] = []
        self._procs: Dict[str, mp.process.BaseProcess] = {}
        self._q = None                      # process-mode exit results

        if mode in ("thread", "socket", "grpc"):
            self._cmd_q: Any = queue.Queue()
            self._res_q: Any = queue.Queue()
            if mode == "thread":
                bus = ThreadBus(self.world)
                comms = {w: bus.communicator(w, **_ckw(w))
                         for w in self.world}
            else:
                tcls = SocketCommunicator if mode == "socket" \
                    else GrpcCommunicator
                addrs = local_addresses(self.world)
                comms = {w: tcls(w, addrs, **_ckw(w)) for w in self.world}
            for w in self.world:
                is_m = w == "master"
                t = threading.Thread(
                    target=_agent_entry,
                    args=(w, comms[w], cfg, datas[w], self._results, dev,
                          list(callbacks), resume_dir,
                          self._cmd_q if is_m else None,
                          self._res_q if is_m else None),
                    daemon=True)
                self._threads.append(t)
                t.start()
        else:
            # spawn, never fork: a forked child of a parent that has used
            # CUDA cannot use it, and each worker builds its own context
            ctx = mp.get_context("spawn")
            if mode == "process":
                from repro_torch.comm.process import ProcessBus
                # the bus must outlive __init__: Process.start() drops
                # its args reference, and a GC'd mp.Queue unlinks its
                # named semaphores before slow-importing children
                # rebuild them
                self._bus = bus = ProcessBus(self.world, ctx)
                transport = ("bus", bus.boxes)
            else:
                # one OS process per agent over real TCP — the paper's
                # distributed deployment on one host; control replies
                # still ride mp queues
                kind = "sock" if mode == "socket_proc" else "grpc"
                transport = (kind, local_addresses(self.world))
            self._q = ctx.Queue()
            self._cmd_q = ctx.Queue()
            self._res_q = ctx.Queue()
            for w in self.world:
                is_m = w == "master"
                p = ctx.Process(
                    target=_mp_entry,
                    args=(w, transport, self.world, cfg, datas[w],
                          self._q, str(dev), list(callbacks), resume_dir,
                          self._cmd_q if is_m else None,
                          self._res_q if is_m else None, _cfg_for(w)))
                # daemonized: an abandoned job (no shutdown) must not
                # block interpreter exit on multiprocessing's atexit join
                p.daemon = True
                self._procs[w] = p
                p.start()

    @classmethod
    def from_spec(cls, spec, mode: Optional[str] = None,
                  **kw) -> "VFLJob":
        """Run a whole cluster spec in-process — every agent from the
        spec's world, the spec's protocol/transport settings (TLS, link
        shaping, timeouts), data built by the spec's provider — so a
        deployment spec can be validated end-to-end on one machine
        before ``python -m repro_torch.launch.cluster`` distributes it.

        The spec's ``[agents]``/``[hosts]`` address maps are ignored
        here (local ports are auto-assigned); ``mode`` overrides the
        execution mode (default: the spec's framing as threads,
        ``"socket"``/``"grpc"``; pass e.g. ``"grpc_proc"`` for one OS
        process per agent). Other keywords go to the constructor, the
        port's ``device`` among them.

        Example (the spec's ``[comm.tls]`` certificates must exist —
        mint them once with the command in the spec's header, or drop
        the table for a plaintext run)::

            # python -m repro_torch.launch.certs \\
            #     --dir examples/cluster/certs \\
            #     --agents master member0 alpha beta
            job = VFLJob.from_spec("examples/cluster/"
                                   "quickstart_cluster.toml")
            job.fit(); print(job.evaluate()["auc"]); job.shutdown()
        """
        from repro_torch.launch.cluster import load_spec
        spec = load_spec(spec)
        spec.validate()
        datas = {r: spec.build_data(r) for r in spec.world()}
        members = [datas[f"member{i}"] for i in range(spec.n_members)]
        if mode is None:
            mode = "socket" if spec.framing == "sock" else "grpc"
        kw.setdefault("comm_cfg", spec.comm)
        if spec.comm_edges:
            # per-link [comm.a.b] overrides: each role's transport gets
            # its own resolved cfg (peer_overrides on the named edges)
            kw.setdefault("comm_cfgs",
                          {r: spec.comm_for(r) for r in spec.world()})
        return cls(spec.cfg, datas["master"], members, mode=mode, **kw)

    # -- phase API -----------------------------------------------------------
    # ``timeout`` bounds how long the job waits for the master's reply;
    # pass float("inf") for unbounded runs.
    def fit(self, timeout: float = 3600.0, **kw) -> Dict[str, Any]:
        """Run the training phase; returns the master's fit summary."""
        return self._call("fit", timeout=timeout, **kw)

    def predict(self, rows=None, timeout: float = 3600.0, **kw):
        """Joint inference over the matched samples (or a row subset):
        members answer feature-slice queries, the master assembles and
        returns the score matrix."""
        return self._call("predict", timeout=timeout, rows=rows, **kw)

    def evaluate(self, rows=None,
                 timeout: float = 3600.0) -> Dict[str, Any]:
        """Predict + the protocol's metrics vs the master's labels."""
        return self._call("evaluate", timeout=timeout, rows=rows)

    # -- persistent serving session (docs/serving.md) ------------------------
    def serve_open(self, timeout: float = 600.0) -> None:
        """Open a long-lived predict phase: members park in their round
        loop and every subsequent :meth:`serve_query` costs exactly one
        federated round. Pair with :meth:`serve_close`;
        :class:`repro_torch.serve.federated.FederatedServer` drives this
        API with admission control and dynamic batching."""
        self._call("serve_open", timeout=timeout)

    def serve_query(self, rows, timeout: float = 3600.0, **kw):
        """One inference round inside an open serve session; returns
        scores in ``rows`` order (duplicates cross the wire once)."""
        return self._call("serve_query", timeout=timeout, rows=rows,
                          **kw)

    def serve_close(self, timeout: float = 600.0) -> None:
        """End the serve session opened by :meth:`serve_open`."""
        self._call("serve_close", timeout=timeout)

    def shutdown(self, timeout: float = 600.0) -> Dict[str, Any]:
        """End the federation and return per-role result dicts."""
        if self._closed:
            return self._finish(timeout)
        self._cmd_q.put(("shutdown", {}))
        self._wait_reply(timeout)
        self._closed = True
        return self._finish(timeout)

    def __enter__(self) -> "VFLJob":
        return self

    def __exit__(self, *exc) -> None:
        if self._failed is None and not self._closed:
            self.shutdown()

    # -- plumbing ------------------------------------------------------------
    def _call(self, cmd: str, timeout: float = 3600.0, **kw):
        if self._failed is not None:
            raise RuntimeError("job already failed") from self._failed
        if self._closed:
            raise RuntimeError(f"job already shut down; cannot {cmd}")
        self._cmd_q.put((cmd, kw))
        status, payload = self._wait_reply(timeout)
        if status == "error":
            self._fail("master", payload)
        return payload

    def _wait_reply(self, timeout: float = 600.0):
        """Wait for the master's reply while watching every agent for
        failure — a crashed member surfaces its real traceback here
        instead of stalling the job until the comm timeout."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self._res_q.get(timeout=0.2)
            except queue.Empty:
                err = self._peek_agent_error()
                if err is not None:
                    self._fail(*err)
                if time.monotonic() > deadline:
                    self._abort()
                    raise TimeoutError("master agent did not reply")

    def _peek_agent_error(self):
        if self._q is not None:           # process mode: drain exits
            while True:
                try:
                    role, res = self._q.get_nowait()
                except queue.Empty:
                    break
                self._results[role] = res
        for role, res in list(self._results.items()):
            if isinstance(res, dict) and isinstance(res.get("error"),
                                                    BaseException):
                return role, res["error"]
        # a worker that died before it could even post (e.g. killed, or
        # crashed during interpreter spawn) would otherwise stall the
        # job until the comm timeout
        for role, p in self._procs.items():
            if role not in self._results and p.exitcode not in (None, 0):
                return role, RuntimeError(
                    f"agent process died with exit code {p.exitcode} "
                    f"before reporting a result")
        return None

    def _fail(self, role: str, err: BaseException):
        self._failed = err
        self._abort()
        raise RuntimeError(f"agent {role} failed") from err

    def _abort(self) -> None:
        self._closed = True
        for p in self._procs.values():
            if p.is_alive():
                p.terminate()
        for p in self._procs.values():
            p.join(timeout=10)

    def _finish(self, timeout: float) -> Dict[str, Any]:
        if self._procs:
            deadline = time.monotonic() + timeout
            while len(self._results) < len(self.world) \
                    and time.monotonic() < deadline:
                try:
                    role, res = self._q.get(timeout=1.0)
                    self._results[role] = res
                except queue.Empty:
                    if not any(p.is_alive()
                               for p in self._procs.values()):
                        break
            for p in self._procs.values():
                p.join(timeout=60)
        else:
            for t in self._threads:
                t.join(timeout=timeout)
        for role, res in self._results.items():
            if isinstance(res, dict) and isinstance(res.get("error"),
                                                    BaseException):
                raise RuntimeError(f"agent {role} failed") \
                    from res["error"]
        missing = [w for w in self.world if w not in self._results]
        if missing:
            raise RuntimeError(f"agents did not finish: {missing}")
        return dict(self._results)


def run_vfl(cfg: VFLConfig, master_data: MasterData,
            member_datas: List[MemberData], mode: str = "thread",
            callbacks: Sequence[Callback] = (),
            resume_dir: Optional[str] = None,
            pipeline_depth: Optional[int] = None,
            comm_cfg: Optional[CommCfg] = None,
            device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """One-shot job (matching + training + teardown) in the given mode.

    Compatibility wrapper over :class:`VFLJob`."""
    job = VFLJob(cfg, master_data, member_datas, mode=mode,
                 callbacks=callbacks, resume_dir=resume_dir,
                 pipeline_depth=pipeline_depth, comm_cfg=comm_cfg,
                 device=device)
    job.fit()
    return job.shutdown()
