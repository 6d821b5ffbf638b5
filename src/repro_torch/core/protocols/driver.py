"""Lifecycle protocol API + the shared training driver.

The seed shipped protocols as monolithic ``(master_fn, member_fn,
arbiter_fn)`` triples that each hand-rolled matching, the epoch/batch
loop, history recording, and the shutdown handshake — ~150 lines of
scaffolding per protocol, with no way to run inference, eval
mid-training, or checkpoint. This module splits the two layers the
VFL-survey literature says belong apart:

* **algorithm layer** — :class:`VFLProtocol`: a protocol subclasses it
  and fills in role hooks (``setup``, ``on_batch_master`` /
  ``on_batch_member`` / ``arbiter_round``, ``predict_master`` /
  ``predict_member``, ``finalize``). A new protocol is ~40 lines of
  math, not ~180 of loop plumbing.

* **coordination layer** — :class:`Driver`: ONE copy of the epoch/batch
  loop, deterministic batching, per-round callbacks (eval, checkpoint,
  early-stop, metrics streaming), per-phase wall timings
  (CommStats-style), the predict/serve phase, and the done/shutdown
  handshake. The master's driver announces each round over typed
  ``ctrl/*`` messages; member and arbiter drivers are reactive, so the
  master can stop early, interleave eval rounds, or resume mid-epoch
  without any protocol-level agreement on loop bounds.

Phase machine (one ``ctrl/phase`` per transition, master-announced)::

    match ──> setup ──> [ FIT rounds ]* ──> [ PREDICT rounds ]* ──> shutdown
                          ctrl/step RUN        ctrl/step EVAL
                          (epoch, lo, hi)      + predict/rows

``ctrl/step`` carries (op, epoch, lo, hi); every party reconstructs the
batch rows from the shared deterministic permutation, so the wire never
moves sample indices during training — only during predict, where the
query rows are explicit.
"""
from __future__ import annotations

import os
import pickle
import queue
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm import schema
from repro_torch.comm.schema import Field, TypedChannel
from repro_torch.core.protocols.base import (VFLConfig, batch_bounds,
                                             batch_order, master_match,
                                             member_match)
from repro_torch.models.params import resolve_device

# ctrl/phase ops
PHASE_SHUTDOWN = 0
PHASE_FIT = 1
PHASE_PREDICT = 2

# ctrl/step ops
OP_END = 0
OP_RUN = 1
OP_EVAL = 2

schema.message("ctrl/phase", {"op": Field("int64", 1)}, stepped=True,
               doc="master announces the next lifecycle phase")
schema.message("ctrl/step",
               {"op": Field("int64", 1), "epoch": Field("int64", 1),
                "lo": Field("int64", 1), "hi": Field("int64", 1)},
               stepped=True,
               doc="one driver round: train batch / eval chunk / end")
schema.message("predict/rows", {"rows": Field("int64", 1)}, stepped=True,
               doc="explicit query rows (indices into the matched order)")
schema.message("ctrl/rejoin", {"step": Field("int64", 1)}, stepped=True,
               doc="rejoin handshake: restarted member hello (its "
                   "restored step) / master ack (its global step)")


class ExchangeCapture:
    """Driver-level exchange-capture hook (docs/privacy.md).

    When ``cfg.capture_exchanges`` is on, the driver installs one of
    these on its typed channel; the channel then calls :meth:`record`
    for every message whose type is in ``names`` — on the send side
    *before* compression/masking bookkeeping (``_prepare``) and on the
    receive side *after* decompression and schema checks, i.e. exactly
    the plaintext a wire adversary at that party observes. Off by
    default: the tap is a ``capture is None`` check and capture-off
    runs are trace-bit-identical to the seed fixtures (tested in
    tests/test_capture_hook.py).

    The captured rounds are exported through ``Driver.result()
    ["capture"]`` as plain dicts (picklable across every VFLJob mode)
    and consumed offline by :mod:`repro.attacks` — the label-inference
    attacks never touch a live channel.
    """

    #: label-bearing exchanges plus the round announcements needed to
    #: reconstruct batch rows offline (rows never cross the wire during
    #: fit — they are re-derived from ``batch_order`` + (epoch, lo, hi))
    DEFAULT_NAMES = ("ctrl/step", "splitnn/u", "splitnn/du",
                     "logreg/grad")

    def __init__(self, names: Optional[Sequence[str]] = None):
        self.names = frozenset(names if names is not None
                               else self.DEFAULT_NAMES)
        self.records: List[Dict[str, Any]] = []

    def record(self, direction: str, peer: str, name: str,
               payload: Dict[str, np.ndarray]) -> None:
        if name not in self.names:
            return
        self.records.append({
            "dir": direction, "peer": peer, "name": name,
            "payload": {k: np.array(v, copy=True)
                        for k, v in payload.items()}})

    def entries(self, name: Optional[str] = None,
                peer: Optional[str] = None,
                direction: Optional[str] = None) -> List[Dict[str, Any]]:
        """Captured records filtered by message type / peer / direction,
        in arrival order (the order attacks align rounds by)."""
        return [r for r in self.records
                if (name is None or r["name"] == name)
                and (peer is None or r["peer"] == peer)
                and (direction is None or r["dir"] == direction)]

    def as_dict(self) -> Dict[str, Any]:
        return {"names": sorted(self.names),
                "records": list(self.records)}


@dataclass
class ElasticCfg:
    """Master-side elastic policy: which peers may crash and rejoin
    mid-fit (the launcher derives this from the spec's ``[restart]``
    section), and how long the master waits for a restarted peer's
    ``ctrl/rejoin`` hello before giving up and failing the run."""
    roles: frozenset = frozenset()
    wait_s: float = 60.0


class VFLProtocol:
    """Base class for VFL protocols: algorithm hooks only.

    One instance exists per agent; ``self.role`` says which hooks the
    driver will call. State set up in ``setup`` (weight slices, selected
    feature matrices) lives on ``self`` and is what ``state_dict`` /
    ``load_state_dict`` checkpoint. The hook lifecycle diagram lives in
    docs/protocols.md.

    Example (a minimal pipeline-capable protocol)::

        @register
        class MyProto(VFLProtocol):
            name = "my_proto"
            supports_pipeline = True

            def setup(self):
                self.w = np.zeros(...)            # role-local state

            def on_batch_master(self, rows, step):
                z = self.ch.recv("member0", "my/z").tensor("z")
                self.ch.isend("member0", "my/r", {"r": z - y})
                return float(loss)

            def member_stage_send(self, rows, step):
                self.ch.isend("master", "my/z", {"z": fwd(rows)})
                return rows                       # ctx for recv stage

            def member_stage_recv(self, rows, step, ctx):
                r = self.ch.recv("master", "my/r").tensor("r")
                self.apply(ctx, r)
    """

    name: str = "?"
    needs_arbiter: bool = False
    # protocols that split the member round into a send stage (compute
    # outbound from current — possibly stale — state) and a recv stage
    # (consume the master's reply, apply the update) can run pipelined
    # at cfg.pipeline_depth >= 2; see member_stage_send/_recv below.
    supports_pipeline: bool = False

    def __init__(self, cfg: VFLConfig, ch: TypedChannel, role: str,
                 device: Any = "cuda"):
        self.cfg = cfg
        self.ch = ch
        self.role = role
        # where this agent keeps its tensors: the card unless the caller
        # asks for the CPU; a CUDA device this machine lacks raises here,
        # as it does in VFLJob
        self.device = resolve_device(device)
        self.data: Any = None          # MasterData / MemberData / None
        self.order: Optional[List[str]] = None
        # True while running under a checkpoint restore: setup() hooks
        # must skip comm-based exchanges whose counterpart ran (or is
        # mid-fit) in another epoch of the federation — e.g. a rejoining
        # member recovers setup-time scalars from the checkpoint instead
        self.resuming: bool = False

    @property
    def is_master(self) -> bool:
        return self.role == "master"

    @property
    def is_member(self) -> bool:
        return self.role.startswith("member")

    @property
    def is_arbiter(self) -> bool:
        # key-sharded decryption (cfg.n_arbiters >= 2) names its agents
        # "arbiter", "arbiter1", ... — all of them are arbiter-role
        return self.role.startswith("arbiter")

    # -- lifecycle hooks (override what the protocol needs) ------------------
    def match(self) -> Optional[List[str]]:
        """ID matching; default is the shared PSI / salted-hash phase."""
        if self.is_master:
            return master_match(self.ch, self.data, self.cfg)
        if self.is_member:
            return member_match(self.ch, self.data, self.cfg)
        return None

    def setup(self) -> None:
        """Post-match initialization (select rows, init weights, exchange
        dimensions / keys). Runs again on resume — training state that
        must survive belongs in ``state_dict``."""

    def on_batch_master(self, rows: np.ndarray, step: int) -> float:
        """One training round on the master; returns the batch loss."""
        raise NotImplementedError

    def on_batch_member(self, rows: np.ndarray, step: int) -> None:
        """One synchronous member round. Pipeline-capable protocols get
        this for free as stage_send immediately followed by stage_recv —
        which is exactly what guarantees ``pipeline_depth=1`` stays
        bit-identical to the pipelined hooks."""
        if not self.supports_pipeline:
            raise NotImplementedError
        ctx = self.member_stage_send(rows, step)
        self.member_stage_recv(rows, step, ctx)

    # -- pipelined member stages (supports_pipeline protocols) ---------------
    def member_stage_send(self, rows: np.ndarray, step: int) -> Any:
        """Compute this step's outbound tensors from the member's
        *current* state and isend them. Returns an opaque ctx handed
        back to :meth:`member_stage_recv` (e.g. the cached batch
        slice). With ``pipeline_depth=D`` the driver runs this up to
        D-1 steps ahead of the matching recv stage."""
        raise NotImplementedError

    def member_stage_recv(self, rows: np.ndarray, step: int,
                          ctx: Any) -> None:
        """Consume the master's reply for ``step`` and apply the local
        update."""
        raise NotImplementedError

    def arbiter_round(self, step: int) -> None:
        """One arbiter service round (e.g. decrypt-and-return)."""

    def on_window_drain(self) -> None:
        """Called on members when the driver drains its pipeline window
        (phase end): protocols that defer part of a round past its recv
        stage — e.g. the HE gradient apply at ``pipeline_depth >= 2``
        (DESIGN.md §10.2) — flush the remainder here so the next phase
        (predict/eval) sees fully applied state."""

    def predict_master(self, rows: np.ndarray) -> np.ndarray:
        """Assemble joint scores for ``rows`` of the matched order."""
        raise NotImplementedError

    def predict_member(self, rows: np.ndarray) -> None:
        """Answer one feature-slice query during predict/eval."""
        raise NotImplementedError

    # -- serving cache hooks (optional; docs/serving.md) ---------------------
    def predict_embed(self, rows: np.ndarray) -> Optional[np.ndarray]:
        """Pure per-row embedding compute for ``rows`` — no comm, no
        per-query masking — or ``None`` when the protocol cannot split
        its predict path (the driver then bypasses the embedding cache
        and calls :meth:`predict_member` directly). Row ``i`` of the
        result must depend only on row ``i`` of the input, so cached
        and freshly computed rows can be mixed within one query."""
        return None

    def send_embed(self, u: np.ndarray, rows: np.ndarray) -> None:
        """Ship precomputed embeddings ``u`` for ``rows`` to the master,
        applying any per-query transform (e.g. pairwise secure-agg
        masks) that must NOT be cached. Protocols overriding
        :meth:`predict_embed` must override this too."""
        raise NotImplementedError

    def evaluate_master(self, scores: np.ndarray,
                        rows: np.ndarray) -> Dict[str, float]:
        """Metrics for predicted ``scores`` vs the master's labels."""
        return {}

    def finalize(self) -> Dict[str, Any]:
        """Role-specific result payload (weights, counters)."""
        return {}

    def close(self) -> None:
        """Release protocol resources (threads, pools). Always called."""

    # -- checkpoint hooks ----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        pass

    # -- roofline hook -------------------------------------------------------
    def roofline_profile(self) -> Optional[Dict[str, float]]:
        """Analytic per-step cost of this role's model, or ``None``
        when the protocol doesn't account itself. Keys (all optional):
        ``flops_per_step`` (training FLOPs for one round),
        ``bytes_per_step`` (wire bytes this role exchanges per round),
        ``params_bytes``. Merged into ``Driver.result()["roofline"]``
        next to the measured compute/wire split (launch/roofline.py)."""
        return None


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------


class Callback:
    """Per-round hooks invoked by the driver (all roles). Master-side
    callbacks may call ``driver.request_stop()`` / ``driver.predict_now``
    / ``driver.save_checkpoint()``; member/arbiter drivers invoke the
    same hooks so e.g. checkpoints stay role-consistent."""

    def on_fit_start(self, driver: "Driver") -> None: ...
    def on_epoch_start(self, driver: "Driver", epoch: int) -> None: ...
    def on_batch_end(self, driver: "Driver", step: int, epoch: int,
                     loss: Optional[float]) -> None: ...
    def on_epoch_end(self, driver: "Driver", epoch: int) -> None: ...
    def on_fit_end(self, driver: "Driver") -> None: ...


class MetricsStream(Callback):
    """Streams per-round rows into ``self.rows`` (CommStats-style: step,
    epoch, loss, cumulative sent bytes, wall time since fit start)."""

    def __init__(self):
        self.rows: List[Dict[str, Any]] = []
        self._t0 = 0.0

    def on_fit_start(self, driver):
        self._t0 = time.perf_counter()

    def on_batch_end(self, driver, step, epoch, loss):
        if driver.role != "master":
            return
        self.rows.append({
            "step": step, "epoch": epoch, "loss": loss,
            "sent_bytes": driver.ch.stats.sent_bytes,
            "wall_s": round(time.perf_counter() - self._t0, 4),
        })


class EarlyStopping(Callback):
    """Stop when the master's batch loss hasn't improved by
    ``min_delta`` for ``patience`` consecutive rounds."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.bad = 0

    def on_batch_end(self, driver, step, epoch, loss):
        if driver.role != "master" or loss is None:
            return
        if loss < self.best - self.min_delta:
            self.best, self.bad = loss, 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                driver.request_stop(f"early-stop at step {step} "
                                    f"(best loss {self.best:.6f})")


class StopAtStep(Callback):
    """Deterministically end fit after ``n`` global steps (testing /
    budgeted runs)."""

    def __init__(self, n: int):
        self.n = n

    def on_batch_end(self, driver, step, epoch, loss):
        if driver.role == "master" and step + 1 >= self.n:
            driver.request_stop(f"step budget {self.n} reached")


class Checkpointer(Callback):
    """Writes ``<dir>/<role>.pkl`` every ``every_steps`` rounds; every
    role checkpoints at the same global step, so a directory is a
    consistent cut of the whole federation. Resume via
    ``VFLJob(..., resume_dir=...)``."""

    def __init__(self, directory, every_steps: int = 1,
                 save_on_start: bool = False):
        self.directory = str(directory)
        self.every_steps = every_steps
        # elastic clusters set this so a checkpoint exists from step 0:
        # a member crashing before its first on_batch_end still has
        # state (and the matched order) to rejoin from
        self.save_on_start = save_on_start

    def on_fit_start(self, driver):
        if self.save_on_start:
            driver.save_checkpoint(self.directory)

    def on_batch_end(self, driver, step, epoch, loss):
        if (step + 1) % self.every_steps == 0:
            driver.save_checkpoint(self.directory)


class EvalEveryEpoch(Callback):
    """Master-side mid-training evaluation: runs a federated predict
    pass over the matched set at each epoch end (members answer inside
    their fit loop via EVAL rounds) and appends the protocol's metrics
    to ``driver.eval_history``."""

    def __init__(self, every: int = 1, max_rows: Optional[int] = None):
        self.every = every
        self.max_rows = max_rows

    def on_epoch_end(self, driver, epoch):
        if driver.role != "master" or (epoch + 1) % self.every:
            return
        n = driver.n if self.max_rows is None else min(driver.n,
                                                       self.max_rows)
        rows = np.arange(n)
        scores = driver.predict_now(rows)
        metrics = driver.proto.evaluate_master(scores, rows)
        driver.eval_history.append({"epoch": epoch, **metrics})


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


class EmbedCache:
    """Bounded LRU of per-row member embeddings for the serve path
    (``cfg.serve_cache_rows``; docs/serving.md). Keys are matched-order
    row ids (int), values the member's *unmasked* embedding row —
    per-query transforms (secure-agg masks) are applied after lookup by
    :meth:`VFLProtocol.send_embed`. Cleared whenever a fit phase starts."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._d)

    def lookup(self, rows: np.ndarray
               ) -> Tuple[Dict[int, np.ndarray], np.ndarray]:
        """Split ``rows`` into (found, missing). ``found`` maps row id ->
        cached embedding; ``missing`` keeps query order, deduplicated."""
        found: Dict[int, np.ndarray] = {}
        missing: List[int] = []
        seen_missing = set()
        for r in rows:
            r = int(r)
            if r in found or r in seen_missing:
                continue
            v = self._d.get(r)
            if v is not None:
                self._d.move_to_end(r)
                found[r] = v
                self.hits += 1
            else:
                seen_missing.add(r)
                missing.append(r)
                self.misses += 1
        return found, np.asarray(missing, dtype=rows.dtype)

    def insert(self, rows: np.ndarray, u: np.ndarray) -> None:
        for i, r in enumerate(rows):
            self._d[int(r)] = u[i]
            self._d.move_to_end(int(r))
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def invalidate(self) -> None:
        if self._d:
            self.invalidations += 1
        self._d.clear()

    def as_dict(self) -> Dict[str, int]:
        return {"rows": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations}


def _step_payload(op: int, epoch: int, lo: int, hi: int):
    # explicit dtype: bare np.array([int]) is int32 on some platforms,
    # which would fail the declared-int64 schema check
    return {"op": np.array([op], np.int64),
            "epoch": np.array([epoch], np.int64),
            "lo": np.array([lo], np.int64),
            "hi": np.array([hi], np.int64)}


class Driver:
    """Shared coordination layer: owns the loop, the protocol owns the
    math. One driver per agent; the master's is command-driven (via
    :class:`~repro_torch.core.party.VFLJob`), member/arbiter drivers follow
    the master's ``ctrl/*`` announcements."""

    def __init__(self, proto: VFLProtocol,
                 callbacks: Sequence[Callback] = (),
                 resume_state: Optional[Dict[str, Any]] = None,
                 elastic: Optional[ElasticCfg] = None):
        self.proto = proto
        self.cfg = proto.cfg
        self.ch = proto.ch
        self.role = proto.role
        self.callbacks = list(callbacks)
        self.history: List[Dict[str, Any]] = []
        self.eval_history: List[Dict[str, Any]] = []
        self.phase_s: Dict[str, float] = {}
        self.global_step = 0
        self.n: int = 0
        self.stopped: Optional[str] = None
        self._stop: Optional[str] = None
        self._resume = resume_state
        self._pos = (0, 0)            # (epoch, next batch index)
        self.elastic = elastic        # master-side; None = fail-fast
        # one dict per recovered peer: role, master step at rejoin, the
        # peer's restored step, and how long the rejoin handshake took
        self.recoveries: List[Dict[str, Any]] = []
        # member-side serve cache (cfg.serve_cache_rows); lazily built on
        # the first EVAL round a cache-capable protocol answers
        self._embed_cache: Optional[EmbedCache] = None
        # per-step roofline accounting (launch/roofline.py): fit phases
        # accumulate wall/steps plus CommStats counter deltas here, and
        # result() resolves them into the compute-vs-wire split
        self._fit_acc: Dict[str, float] = {"wall_s": 0.0, "steps": 0}
        # adversarial exchange capture (docs/privacy.md): installed on
        # the channel only when asked for — every other run keeps the
        # channel's ``capture`` at None and pays one is-None check
        if self.cfg.capture_exchanges:
            self.ch.capture = ExchangeCapture()

    _ROOF_COUNTERS = ("recv_wait_s", "send_s", "queued_s", "wire_s",
                      "sent_bytes")

    def _roof_snap(self) -> Dict[str, float]:
        s = self.ch.stats
        return {k: float(getattr(s, k)) for k in self._ROOF_COUNTERS}

    def _roof_record(self, t0: float, snap: Dict[str, float],
                     step0: int) -> None:
        """Fold one fit phase's wall/steps/comm deltas into the
        roofline accumulator (phases add up across refits)."""
        acc = self._fit_acc
        acc["wall_s"] += time.perf_counter() - t0
        acc["steps"] += self.global_step - step0
        now = self._roof_snap()
        for k in self._ROOF_COUNTERS:
            acc[k] = acc.get(k, 0.0) + now[k] - snap[k]

    # -- helpers -------------------------------------------------------------
    @property
    def _others(self) -> List[str]:
        return self.ch.members + self._arbiters

    @property
    def _arbiters(self) -> List[str]:
        return [w for w in self.ch.world if w.startswith("arbiter")]

    def _invoke(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def _timed(self, phase: str, t0: float) -> None:
        self.phase_s[phase] = round(
            self.phase_s.get(phase, 0.0) + time.perf_counter() - t0, 4)

    def request_stop(self, reason: str = "requested") -> None:
        self._stop = reason

    def save_checkpoint(self, directory) -> None:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        state = {"global_step": self.global_step, "pos": self._pos,
                 "history": list(self.history),
                 # the agreed sample order: lets a restarted agent skip
                 # the comm-driven match phase entirely on resume
                 "order": list(self.proto.order)
                 if self.proto.order is not None else None,
                 "proto": self.proto.state_dict()}
        # atomic tmp+rename: a SIGKILL mid-write must never leave a
        # truncated pickle for the restarted process to trip over
        tmp = d / f".{self.role}.pkl.tmp"
        tmp.write_bytes(pickle.dumps(state))
        os.replace(tmp, d / f"{self.role}.pkl")

    # -- lifecycle entry -----------------------------------------------------
    def prepare(self, data) -> None:
        """match + setup (+ checkpoint restore). Runs once per agent."""
        self.proto.data = data
        self.proto.resuming = self._resume is not None
        t0 = time.perf_counter()
        self.ch.stats.phase = "match"
        if self._resume is not None and \
                self._resume.get("order") is not None:
            # the checkpoint carries the agreed order — a restarted
            # agent must NOT rerun the comm-based match phase (its
            # peers are mid-fit, not waiting in match)
            self.proto.order = list(self._resume["order"])
        else:
            self.proto.order = self.proto.match()
        self._timed("match", t0)
        self.n = len(self.proto.order) if self.proto.order is not None \
            else 0
        t0 = time.perf_counter()
        self.ch.stats.phase = "setup"
        self.proto.setup()          # keygen etc. — timed on its own
        self._timed("setup", t0)
        if self._resume is not None:
            self.proto.load_state_dict(self._resume["proto"])
            self.global_step = self._resume["global_step"]
            self._pos = tuple(self._resume["pos"])
            self.history = list(self._resume["history"])

    def result(self) -> Dict[str, Any]:
        out = {**self.proto.finalize(), "comm": self.ch.stats.as_dict(),
               "phase_s": dict(self.phase_s)}
        if self._embed_cache is not None:
            out["embed_cache"] = self._embed_cache.as_dict()
        if getattr(self.ch, "capture", None) is not None:
            out["capture"] = self.ch.capture.as_dict()
        if self._fit_acc["steps"] > 0:
            from repro_torch.launch.roofline import step_account
            out["roofline"] = step_account(
                self._fit_acc["wall_s"], int(self._fit_acc["steps"]),
                self._fit_acc, self.proto.roofline_profile())
        if self.role == "master":
            out["history"] = list(self.history)
            out["n_common"] = self.n
            if self.stopped:
                out["stopped"] = self.stopped
            if self.eval_history:
                out["eval_history"] = list(self.eval_history)
            if self.recoveries:
                out["recoveries"] = list(self.recoveries)
        return out

    # -- master side ---------------------------------------------------------
    def fit(self, epochs: Optional[int] = None) -> Dict[str, Any]:
        """Run the training phase (master only): announce FIT, drive the
        epoch/batch loop, broadcast RUN rounds, handle callbacks /
        early stop, then close the phase with END.

        The master keeps a sliding window of up to ``cfg.pipeline_depth``
        announced-but-not-yet-computed rounds. At depth 1 (default) the
        announce/compute interleaving is exactly the synchronous
        lock-step loop. At depth D >= 2 members see future rounds early
        and run their send stage ahead (bounded staleness); every
        announced round IS computed — a stop request only stops new
        announcements, so stops take effect within D-1 rounds and no
        follower is ever left waiting on a round that never happens.
        """
        assert self.role == "master"
        t0 = time.perf_counter()
        roof_snap, roof_step0 = self._roof_snap(), self.global_step
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        # protocols without stage hooks run their members synchronously;
        # announcing ahead of them would deadlock a mid-fit eval (the
        # member sits inside on_batch_member for an announced round the
        # master hasn't computed), so the window collapses to 1
        depth = max(1, int(cfg.pipeline_depth)) \
            if self.proto.supports_pipeline else 1
        self.ch.stats.phase = "fit"
        # arm the channel's elastic / straggler machinery for the fit
        # phase only: crashes outside fit (match, predict) stay
        # fail-fast, and the per-round deadline is meaningful only when
        # the pipeline gives members slack to be stale in
        if self.elastic is not None:
            self.ch.elastic_roles = set(self.elastic.roles)
        if depth > 1 and cfg.round_deadline_s > 0:
            self.ch.round_deadline = float(cfg.round_deadline_s)
        self.ch.broadcast("ctrl/phase", {"op": np.array([PHASE_FIT], np.int64)},
                          targets=self._others)
        self._stop = None
        self._invoke("on_fit_start")
        start_epoch, start_batch = self._pos
        bounds = batch_bounds(self.n, cfg)
        last_b = len(bounds) - 1

        def _schedule():
            for epoch in range(start_epoch, epochs):
                first = start_batch if epoch == start_epoch else 0
                for b in range(first, len(bounds)):
                    yield epoch, b, bounds[b]

        sched = _schedule()
        announced: "deque" = deque()
        exhausted = False
        cached_epoch, perm = None, None
        while True:
            # a down peer pauses NEW announcements; the already-announced
            # window still completes below (stale substitution keeps the
            # survivors' streams in lock-step), then the rejoin handshake
            # runs with no round in flight
            while not self._stop and not exhausted and not self.ch.down \
                    and len(announced) < depth:
                try:
                    epoch, b, (lo, hi) = next(sched)
                except StopIteration:
                    exhausted = True
                    break
                # epoch-start callbacks run BEFORE the epoch's first
                # round is announced (so a callback may run comm rounds,
                # e.g. an eval pass, with no member mid-round). At
                # depth 1 this is the legacy ordering exactly; at
                # depth >= 2 on_epoch_start(e) can fire while the tail
                # of epoch e-1 is still computing.
                if b == 0:
                    self._invoke("on_epoch_start", epoch)
                self.ch.broadcast("ctrl/step",
                                  _step_payload(OP_RUN, epoch, lo, hi),
                                  targets=self._others,
                                  wait=(depth == 1))
                announced.append((epoch, b, lo, hi))
            if not announced:
                if self.ch.down and self.elastic is not None:
                    self._elastic_rejoin()
                    continue
                break
            epoch, b, lo, hi = announced.popleft()
            if epoch != cached_epoch:
                perm = batch_order(self.n, cfg, epoch)
                cached_epoch = epoch
            loss = self.proto.on_batch_master(perm[lo:hi],
                                              self.global_step)
            if self.global_step % cfg.record_every == 0:
                # wall_s (since fit start) lets offline analysis split
                # steady-state step time from jit/pipeline warmup
                self.history.append({"step": self.global_step,
                                     "epoch": epoch, "loss": loss,
                                     "wall_s": round(
                                         time.perf_counter() - t0, 6)})
            self.global_step += 1
            self._pos = (epoch, b + 1)
            self._invoke("on_batch_end", self.global_step - 1, epoch,
                         loss)
            if b == last_b and not self._stop:
                self._pos = (epoch + 1, 0)
                self._invoke("on_epoch_end", epoch)
        self.ch.round_deadline = None     # disarm: predict waits fully
        self.ch._drain_stale()            # consume late straggler msgs
        self.ch.broadcast("ctrl/step", _step_payload(OP_END, -1, 0, 0),
                          targets=self._others)
        self.stopped = self._stop
        self._invoke("on_fit_end")
        self._roof_record(t0, roof_snap, roof_step0)
        self._timed("fit", t0)
        out = {"history": list(self.history), "n_common": self.n,
               "stopped": self.stopped,
               "eval_history": list(self.eval_history)}
        if self.recoveries:
            out["recoveries"] = list(self.recoveries)
        return out

    def _elastic_rejoin(self) -> None:
        """The in-flight window is drained and at least one elastic peer
        is down: for each, reset every per-peer comm/channel counter
        (the restarted process counts from zero on both planes), wait
        for its ``ctrl/rejoin`` hello, ack with the master's global
        step, and resume announcing. Survivors never notice — their
        streams were kept in lock-step by stale substitution, so no
        counter of theirs is touched."""
        assert self.role == "master" and self.elastic is not None
        for dead in sorted(self.ch.down):
            t0 = time.perf_counter()
            # full reset BEFORE listening: sequence numbers, reorder
            # buffers, EF residuals, the cached connection and the
            # sticky send error all return to zero so both ends of the
            # new connection agree on a fresh stream. The hello may
            # already be pending — keep control-plane tags.
            self.ch.reset_peer(dead)
            self.ch.comm.reset_peer(dead, keep_tags=("ctrl/",))
            try:
                hello = self.ch.recv(dead, "ctrl/rejoin",
                                     timeout=self.elastic.wait_s)
            except (TimeoutError, ConnectionError) as e:
                raise ConnectionError(
                    f"master: peer {dead!r} dropped mid-fit and sent "
                    f"no rejoin hello within {self.elastic.wait_s}s"
                ) from e
            peer_step = int(hello.tensor("step")[0])
            self.ch.down.discard(dead)
            self.ch.send(dead, "ctrl/rejoin",
                         {"step": np.array([self.global_step],
                                           np.int64)})
            self.recoveries.append({
                "role": dead, "step": self.global_step,
                "peer_step": peer_step,
                "wait_s": round(time.perf_counter() - t0, 4)})

    def predict(self, rows: Optional[np.ndarray] = None,
                batch_size: Optional[int] = None) -> np.ndarray:
        """Joint inference phase (master only): members answer
        feature-slice queries, the master assembles scores. No training
        state changes."""
        assert self.role == "master"
        t0 = time.perf_counter()
        self.ch.stats.phase = "predict"
        self.ch.broadcast("ctrl/phase", {"op": np.array([PHASE_PREDICT], np.int64)},
                          targets=self._others)
        out = self.predict_now(rows, batch_size)
        self.ch.broadcast("ctrl/step", _step_payload(OP_END, -1, 0, 0),
                          targets=self._others)
        self._timed("predict", t0)
        return out

    def predict_now(self, rows: Optional[np.ndarray] = None,
                    batch_size: Optional[int] = None) -> np.ndarray:
        """Run EVAL rounds inside the *current* phase (used by the
        standalone predict phase and by mid-fit eval callbacks alike —
        members handle EVAL steps from within their fit loop)."""
        rows = np.arange(self.n) if rows is None else \
            np.asarray(rows, dtype=np.int64)
        bs = batch_size or self.cfg.batch_size
        parts = []
        for lo in range(0, len(rows), bs):
            sub = rows[lo:lo + bs]
            # duplicate row ids inside one batch (coalesced serving
            # queries hit the same hot users) are computed and shipped
            # once and re-expanded on return; already-unique batches
            # take the original path untouched, so training-time traces
            # stay bit-identical
            uniq, inv = np.unique(sub, return_inverse=True)
            wire = uniq if len(uniq) < len(sub) else sub
            step = _step_payload(OP_EVAL, -1, lo, lo + len(wire))
            # one coalesced frame per member: the EVAL announcement and
            # its query rows ride a single wire message (DESIGN.md §7)
            for m in self.ch.members:
                with self.ch.frame(m):
                    self.ch.send(m, "ctrl/step", step)
                    self.ch.send(m, "predict/rows", {"rows": wire})
            for arb in self._arbiters:
                self.ch.send(arb, "ctrl/step", step)
            scores = np.asarray(self.proto.predict_master(wire))
            if wire is uniq:
                scores = scores[inv]
            parts.append(scores)
        return np.concatenate(parts, axis=0) if parts else \
            np.zeros((0, 1))

    # -- persistent serving session (docs/serving.md) ------------------------
    def serve_open(self) -> None:
        """Open a long-lived predict phase: one ``ctrl/phase`` broadcast
        parks every member in its EVAL round loop, after which
        :meth:`serve_query` answers each coalesced query batch with a
        single round — no per-query phase handshake. Close with
        :meth:`serve_close` before fitting or shutting down."""
        assert self.role == "master"
        self.ch.stats.phase = "serve"
        self.ch.broadcast("ctrl/phase",
                          {"op": np.array([PHASE_PREDICT], np.int64)},
                          targets=self._others)

    def serve_query(self, rows: np.ndarray,
                    batch_size: Optional[int] = None) -> np.ndarray:
        """One federated inference round inside an open serve session.
        Scores come back in ``rows`` order; duplicates within the batch
        cross the wire once (see :meth:`predict_now`)."""
        assert self.role == "master"
        return self.predict_now(rows, batch_size or len(rows) or None)

    def serve_close(self) -> None:
        """End the serve session: members drain back to their phase
        wait loop."""
        assert self.role == "master"
        self.ch.broadcast("ctrl/step", _step_payload(OP_END, -1, 0, 0),
                          targets=self._others)

    def evaluate(self, rows: Optional[np.ndarray] = None) -> Dict[str, Any]:
        assert self.role == "master"
        rows = np.arange(self.n) if rows is None else \
            np.asarray(rows, dtype=np.int64)
        scores = self.predict(rows)
        return self.proto.evaluate_master(scores, rows)

    def shutdown_world(self) -> None:
        assert self.role == "master"
        self.ch.broadcast("ctrl/phase", {"op": np.array([PHASE_SHUTDOWN], np.int64)},
                          targets=self._others)

    # -- member / arbiter side ----------------------------------------------
    def follow(self, idle_timeout: float = 3600.0) -> Dict[str, Any]:
        """Reactive phase loop for members and the arbiter: wait for the
        master's phase announcements until shutdown. The wait between
        phases is patient (a live job may sit idle between fit and
        predict far longer than the transports' per-message timeouts);
        within a phase, round timeouts stay strict."""
        while True:
            deadline = time.monotonic() + idle_timeout
            while True:
                try:
                    op = int(self.ch.recv("master",
                                          "ctrl/phase").tensor("op")[0])
                    break
                except (queue.Empty, TimeoutError):
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{self.role}: no phase announcement within "
                            f"{idle_timeout}s")
            if op == PHASE_SHUTDOWN:
                break
            t0 = time.perf_counter()
            if op == PHASE_FIT:
                self.ch.stats.phase = "fit"
                if self._embed_cache is not None:
                    # refit invalidates every cached embedding — the
                    # bottom model is about to change
                    self._embed_cache.invalidate()
                self._invoke("on_fit_start")
                roof_snap, roof_step0 = self._roof_snap(), \
                    self.global_step
                self._follow_steps()
                self._roof_record(t0, roof_snap, roof_step0)
                self._invoke("on_fit_end")
                self._timed("fit", t0)
            elif op == PHASE_PREDICT:
                self.ch.stats.phase = "predict"
                # a predict phase may be a long-lived serving session
                # with idle gaps between queries far beyond the
                # transport timeout — wait for rounds as patiently as
                # for phase announcements
                self._follow_steps(idle_timeout=idle_timeout)
                self._timed("predict", t0)
            else:
                raise ValueError(f"{self.role}: unknown phase op {op}")
        return self.result()

    def rejoin_follow(self, idle_timeout: float = 3600.0
                      ) -> Dict[str, Any]:
        """Member entry point after a restart: state is already restored
        from the checkpoint (``prepare`` skipped match via the stored
        order), the master is paused mid-fit waiting for us. Send the
        rejoin hello, take the master's global step from the ack, and
        drop straight into the fit round loop — there is no pending
        ``ctrl/phase`` announcement to wait for. After fit ends, hand
        over to the normal :meth:`follow` loop for predict/shutdown."""
        assert self.role != "master"
        hello = {"step": np.array([self.global_step], np.int64)}
        self.ch.send("master", "ctrl/rejoin", hello)
        ack = self.ch.recv("master", "ctrl/rejoin",
                           timeout=self.ch.comm._timeout)
        self.global_step = max(self.global_step,
                               int(ack.tensor("step")[0]))
        t0 = time.perf_counter()
        self.ch.stats.phase = "fit"
        self._invoke("on_fit_start")
        roof_snap, roof_step0 = self._roof_snap(), self.global_step
        self._follow_steps()
        self._roof_record(t0, roof_snap, roof_step0)
        self._invoke("on_fit_end")
        self._timed("fit", t0)
        return self.follow(idle_timeout)

    def _follow_steps(self, idle_timeout: Optional[float] = None) -> None:
        """Reactive round loop. Synchronous members execute each RUN
        round in place; with ``pipeline_depth=D >= 2`` a
        pipeline-capable member keeps up to D rounds in flight — the
        send stage runs as soon as a round is announced, the recv stage
        (gradient apply) is deferred until the window is full or the
        phase ends. The master computes every round it announced, so
        draining the window at END never blocks on a missing reply.
        EVAL rounds are answered immediately with the current (possibly
        bounded-stale) parameters. ``idle_timeout`` (serving sessions)
        makes the wait for the *next* round patient — transport
        timeouts between queries are retried until the budget runs
        out; within a round, timeouts stay strict."""
        cfg = self.cfg
        depth = max(1, int(cfg.pipeline_depth))
        arbiter = self.role.startswith("arbiter")
        pipelined = (depth > 1 and not arbiter
                     and self.proto.supports_pipeline)
        inflight: "deque" = deque()       # (rows, step, epoch, ctx)
        cached_epoch, perm = None, None

        def _complete_one() -> None:
            rows0, step0, epoch0, ctx0 = inflight.popleft()
            self.proto.member_stage_recv(rows0, step0, ctx0)
            self._invoke("on_batch_end", step0, epoch0, None)

        def _next_step():
            if idle_timeout is None:
                return self.ch.recv("master", "ctrl/step")
            deadline = time.monotonic() + idle_timeout
            while True:
                try:
                    return self.ch.recv("master", "ctrl/step")
                except (queue.Empty, TimeoutError):
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{self.role}: no serve round within "
                            f"{idle_timeout}s")

        while True:
            msg = _next_step()
            op = int(msg.tensor("op")[0])
            if op == OP_END:
                while inflight:
                    _complete_one()
                if not arbiter:
                    self.proto.on_window_drain()
                return
            epoch = int(msg.tensor("epoch")[0])
            lo, hi = int(msg.tensor("lo")[0]), int(msg.tensor("hi")[0])
            if op == OP_RUN:
                if epoch != cached_epoch:
                    perm = batch_order(self.n, self.cfg, epoch)
                    cached_epoch = epoch
                rows = perm[lo:hi]
                if arbiter:
                    self.proto.arbiter_round(self.global_step)
                    self.global_step += 1
                    self._pos = (epoch, -1)
                    self._invoke("on_batch_end", self.global_step - 1,
                                 epoch, None)
                elif not pipelined:
                    self.proto.on_batch_member(rows, self.global_step)
                    self.global_step += 1
                    self._pos = (epoch, -1)   # members don't track batch
                    self._invoke("on_batch_end", self.global_step - 1,
                                 epoch, None)
                else:
                    while len(inflight) >= depth:
                        _complete_one()
                    ctx = self.proto.member_stage_send(rows,
                                                       self.global_step)
                    inflight.append((rows, self.global_step, epoch, ctx))
                    self.global_step += 1
                    self._pos = (epoch, -1)
            elif op == OP_EVAL:
                if not arbiter:
                    rows = self.ch.recv("master",
                                        "predict/rows").tensor("rows")
                    self._answer_eval(np.asarray(rows))
            else:
                raise ValueError(f"{self.role}: unknown step op {op}")

    def _answer_eval(self, rows: np.ndarray) -> None:
        """Answer one EVAL query, through the embedding cache when the
        protocol supports the split predict path and
        ``cfg.serve_cache_rows > 0``."""
        if self.cfg.serve_cache_rows <= 0:
            self.proto.predict_member(rows)
            return
        if self._embed_cache is None:
            self._embed_cache = EmbedCache(self.cfg.serve_cache_rows)
        cache = self._embed_cache
        found, missing = cache.lookup(rows)
        if len(missing):
            fresh = self.proto.predict_embed(missing)
            if fresh is None:
                # protocol can't split compute from comm — fall back
                # (undo the speculative stat counts for this query)
                cache.misses -= len(missing)
                cache.hits -= len(found)
                self.proto.predict_member(rows)
                return
            fresh = np.asarray(fresh)
            cache.insert(missing, fresh)
            found.update(
                {int(r): fresh[i] for i, r in enumerate(missing)})
        u = np.stack([found[int(r)] for r in rows], axis=0)
        self.proto.send_embed(u, rows)


def load_checkpoint(directory, role: str) -> Optional[Dict[str, Any]]:
    p = Path(directory) / f"{role}.pkl"
    if not p.exists():
        return None
    return pickle.loads(p.read_bytes())
