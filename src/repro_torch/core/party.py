"""Agent lifecycle runtime of the PyTorch port: role objects, the
:class:`VFLJob` entry point and the thread execution mode.

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

This slice ports the ``"thread"`` mode (in-process queues) and the
split-NN protocol's serving path; the socket, grpc and process modes and
the other protocols come with later slices.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.comm.base import CommCfg, PartyCommunicator
from repro_torch.comm.local import ThreadBus
from repro_torch.comm.schema import TypedChannel
from repro_torch.core.protocols import PROTOCOLS, VFLConfig  # noqa: F401
from repro_torch.core.protocols.base import (MasterData, MemberData,
                                             resolve_protocol)
from repro_torch.core.protocols.driver import (Callback, Driver,
                                               load_checkpoint)
from repro_torch.models.params import resolve_device

# ensure the ported protocols register
from repro_torch.core.protocols import split_nn as _split_nn  # noqa: F401

MODES = ("thread",)


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
    """Stand-in carrying the agent's traceback text."""
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
                 device: Union[str, torch.device] = "cuda"):
        self.comm = comm
        self.cfg = cfg
        proto_cls = resolve_protocol(cfg.protocol)
        proto = proto_cls(cfg, TypedChannel(comm, compress=cfg.compress),
                          comm.me, device=resolve_device(device))
        resume = load_checkpoint(resume_dir, comm.me) if resume_dir \
            else None
        self.driver = Driver(proto, callbacks=callbacks,
                             resume_state=resume)


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

    def serve(self, data: MemberData) -> Dict[str, Any]:
        try:
            self.driver.prepare(data)
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


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------


class VFLJob:
    """A live VFL federation with a phase API.

    Starts every agent for ``cfg.protocol`` in the requested execution
    mode and keeps them alive between calls, so inference reuses the
    loaded state. ``callbacks`` run on every role. ``resume_dir``
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
                 device: Union[str, torch.device] = "cuda"):
        """``pipeline_depth`` overrides ``cfg.pipeline_depth``;
        ``comm_timeout`` overrides each transport's per-message wait;
        ``comm_cfg`` configures the transports in full. ``device`` is
        where every agent keeps its tensors (see
        :func:`resolve_device`)."""
        import dataclasses
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not ported yet "
                             f"(repro_torch runs {MODES})")
        dev = resolve_device(device)
        if pipeline_depth is not None:
            cfg = dataclasses.replace(cfg, pipeline_depth=pipeline_depth)
        if comm_timeout is not None:
            comm_cfg = _force_comm_timeout(comm_cfg or CommCfg(),
                                           comm_timeout)
        ckw = {} if comm_cfg is None else {"comm_cfg": comm_cfg}

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
        self._cmd_q: Any = queue.Queue()
        self._res_q: Any = queue.Queue()
        bus = ThreadBus(self.world)
        comms = {w: bus.communicator(w, **ckw) for w in self.world}
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
                    self._closed = True
                    raise TimeoutError("master agent did not reply")

    def _peek_agent_error(self):
        for role, res in list(self._results.items()):
            if isinstance(res, dict) and isinstance(res.get("error"),
                                                    BaseException):
                return role, res["error"]
        return None

    def _fail(self, role: str, err: BaseException):
        self._failed = err
        self._closed = True
        raise RuntimeError(f"agent {role} failed") from err

    def _finish(self, timeout: float) -> Dict[str, Any]:
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
