"""Multi-host cluster launcher of the PyTorch port: one spec file, one
command per host. The counterpart of the JAX package's
``repro/launch/cluster.py``; one TOML spec drives either package.

The paper pitches "easily deploy learning in a distributed environment";
this module is the piece that makes the ``*_proc`` transport modes span
real machines. A single TOML/JSON *cluster spec* names every agent's
``host:port``, the transport (framing, timeouts, TLS, WAN shaping), the
protocol configuration and the data provider; each participating host
then runs::

    python -m repro_torch.launch.cluster spec.toml --host alpha

and the launcher spawns/supervises that host's agents. Each agent is
its own OS process from the *spawn* context, so it builds its own CUDA
context; it gets the launcher's ``device`` as a string (``"cuda"``
unless the caller asks for ``"cpu"``) and resolves it itself, so an
agent without the card raises instead of training on the CPU. Only
numpy arrays and plain Python cross the status queue.

* **Rendezvous** — agents bind their listeners first, then launchers
  exchange readiness over a control channel (riding the transports'
  connect-retry, so independently booting hosts link up in any order).
* **Supervision** — a crashed agent's real traceback reaches the local
  launcher within its 0.2 s poll tick and is fanned out to every peer
  launcher over the control channel, so ALL launchers exit non-zero
  within seconds instead of hanging until a transport timeout (the
  cross-machine extension of the in-process dead-process watchdog).
* **Shutdown** — SIGTERM to a launcher fans out SIGTERM to its agents
  and notifies peers; per-agent stdout/stderr is captured under
  ``--log-dir`` (``<role>.log``, plus ``pids.json`` and, on success,
  ``summary.json``).

Exit codes: 0 success · 1 agent failure (local or remote) · 2 spec or
usage error · 3 rendezvous timeout · 143 terminated by signal.

See docs/deploy.md for the spec schema and a two-machine walkthrough;
``python -m repro_torch.launch.certs`` mints the TLS material. For
testing a spec without any launcher, ``VFLJob.from_spec(spec)`` runs
the whole federation in-process over the spec's transport settings.

A ``[data] provider`` names a ``module:function``. The committed specs
name the JAX package's built-in providers (``repro.launch.cluster:
quickstart_data``); this package reads a module under ``repro.`` as its
counterpart under ``repro_torch.`` and never imports the JAX package.
"""
from __future__ import annotations

import argparse
import importlib
import json
import multiprocessing as mp
import os
import pathlib
import queue
import signal
import sys
import time
import traceback
from dataclasses import dataclass, field, fields
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.comm.base import CommCfg, LinkSpec, TLSSpec
from repro_torch.comm.grpc import GrpcCommunicator
from repro_torch.comm.sock import SocketCommunicator
from repro_torch.core.protocols.driver import (Callback, Checkpointer,
                                               ElasticCfg)
from repro_torch.models.params import resolve_device

# ---------------------------------------------------------------------------
# minimal TOML (Python 3.10 has no tomllib; the subset below covers
# cluster specs: [table.sub] headers, strings, numbers, bools, arrays)
# ---------------------------------------------------------------------------


def _toml_scalar(s: str) -> Any:
    s = s.strip()
    if s.startswith('"') and s.endswith('"') and len(s) >= 2:
        return s[1:-1]
    if s.startswith("'") and s.endswith("'") and len(s) >= 2:
        return s[1:-1]
    if s == "true":
        return True
    if s == "false":
        return False
    if s.startswith("[") and s.endswith("]"):
        body = s[1:-1].strip()
        if not body:
            return []
        parts, depth, cur = [], 0, ""
        for ch in body:
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
                continue
            if ch == "[":
                depth += 1
            elif ch == "]":
                depth -= 1
            cur += ch
        parts.append(cur)
        # TOML allows a trailing comma in arrays
        if parts and not parts[-1].strip():
            parts.pop()
        return [_toml_scalar(p) for p in parts]
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    raise ValueError(f"unsupported TOML value: {s!r}")


def parse_toml(text: str) -> Dict[str, Any]:
    """Parse the cluster-spec TOML subset (uses :mod:`tomllib` when the
    interpreter has it, Python >= 3.11)."""
    try:
        import tomllib
        return tomllib.loads(text)
    except ModuleNotFoundError:
        pass
    def _strip_comment(val: str) -> str:
        out, quote = "", None
        for ch in val:
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "\"'":
                quote = ch
            elif ch == "#":
                break
            out += ch
        return out

    root: Dict[str, Any] = {}
    table = root
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        ln, line = i + 1, lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            table = root
            for part in line[1:-1].strip().split("."):
                table = table.setdefault(part.strip(), {})
            continue
        if "=" not in line:
            raise ValueError(f"TOML line {ln}: expected key = value, "
                             f"got {line!r} (parser supports the "
                             f"cluster-spec subset; see docs/deploy.md)")
        key, _, val = line.partition("=")
        val = _strip_comment(val)
        # multi-line arrays: keep consuming lines until brackets close
        while val.count("[") > val.count("]"):
            if i >= len(lines):
                raise ValueError(f"TOML line {ln}: unterminated array "
                                 f"for key {key.strip()!r}")
            val += " " + _strip_comment(lines[i].strip())
            i += 1
        table[key.strip()] = _toml_scalar(val)
    return root


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------


def _addr(s: Union[str, Sequence[Any]]) -> Tuple[str, int]:
    if isinstance(s, str):
        host, _, port = s.rpartition(":")
        return host, int(port)
    host, port = s
    return str(host), int(port)


@dataclass
class HostSpec:
    """One launcher invocation: its control endpoint + owned agents."""
    control: Tuple[str, int]
    agents: List[str]


@dataclass
class RestartPolicy:
    """Per-role supervision policy from the spec's ``[restart]`` table.

    ``policy="never"`` (default) keeps the launcher fail-fast: any crash
    aborts every launcher. ``policy="on_failure"`` makes the owning
    launcher respawn the agent up to ``max_restarts`` times with
    exponential backoff (``backoff_s * 2^attempt``, capped at
    ``backoff_max_s``); the restarted agent resumes from its local
    checkpoint (written every ``checkpoint_every`` rounds) and rejoins
    the paused master, which waits up to ``wait_s`` for the rejoin
    hello. Only members may be restartable — crashes of the master or
    arbiter, and any crash before rendezvous or outside the fit phase,
    stay fail-fast. See docs/deploy.md.
    """

    policy: str = "never"              # "never" | "on_failure"
    max_restarts: int = 3
    backoff_s: float = 0.5
    backoff_max_s: float = 10.0
    wait_s: float = 60.0               # master-side rejoin wait
    checkpoint_every: int = 1


@dataclass
class ChaosSpec:
    """Fault injection from the spec's ``[chaos]`` table: at global
    step ``step`` on agent ``role`` (a name or a list of names — a
    list injects the same fault on every named agent in the same
    round, the *correlated* failure case), run ``scenario`` —

    * ``"crash"`` — raise inside the driver loop (the process dies;
      pair with ``[restart]`` to exercise the rejoin path),
    * ``"partition"`` — blackhole the agent's outbound link
      (``LinkSpec(loss=loss)``, default drop-everything),
    * ``"slow"`` — inflate the agent's outbound latency to
      ``latency_ms`` mid-run (the straggler scenario; pair with
      ``round_deadline_s`` at depth >= 2 to see stale substitution).

    ``repeat=true`` re-arms the fault on every supervisor respawn —
    the restarted agent resumes from a checkpoint at/past the chaos
    step and crashes again immediately, the crash-loop that must end
    in an attributed restart-budget exhaustion, not a hang.
    """

    role: Union[str, List[str]]
    step: int
    scenario: str = "crash"            # "crash" | "partition" | "slow"
    latency_ms: float = 250.0          # "slow" link latency
    loss: float = 1.0                  # "partition" drop probability
    repeat: bool = False               # re-arm on supervisor respawn

    @property
    def roles(self) -> List[str]:
        """The fault's victims, normalized to a list."""
        return [self.role] if isinstance(self.role, str) \
            else list(self.role)


@dataclass
class ServeSpec:
    """The spec's ``[serve]`` table: deploy a persistent federated
    inference service (docs/serving.md) when ``"serve"`` appears in
    ``[run] phases``. The master hosts a
    :class:`~repro_torch.serve.federated.FederatedServer` behind a TCP
    frontend; members stay parked in the serve session answering
    coalesced query rounds."""

    port: int = 18080                 # frontend port on the master's host
    host: str = "0.0.0.0"             # frontend bind address
    max_batch: int = 64               # rows per federated round
    max_wait_ms: float = 2.0          # batcher hold for an under-full round
    admission_limit: int = 4096       # queued-row bound before shedding
    cache_rows: int = 0               # member embed-cache capacity (rows)
    duration_s: float = 0.0           # serve window; 0 = until stop_file
    stop_file: str = ""               # path whose appearance ends serving


@dataclass
class ClusterSpec:
    """Parsed cluster spec — everything a launcher (or
    :meth:`~repro_torch.core.party.VFLJob.from_spec`) needs to run the
    federation.

    Built from a TOML/JSON file via :func:`load_spec`; see
    docs/deploy.md for the on-disk schema. All fields are plain
    dataclasses, so a spec pickles into spawned agent processes as-is.

    Example (``make_communicator`` needs the spec's TLS certificates
    on disk — see ``python -m repro_torch.launch.certs``)::

        spec = load_spec("examples/cluster/quickstart_cluster.toml")
        spec.validate()                            # no files touched
        comm = spec.make_communicator("member0")   # TLS'd, full map
        data = spec.build_data("member0")
    """

    cfg: Any                                  # VFLConfig
    agents: Dict[str, Tuple[str, int]]
    hosts: Dict[str, HostSpec]
    comm: CommCfg = CommCfg()
    framing: str = "grpc"                     # "sock" | "grpc"
    run_phases: List[str] = field(default_factory=lambda: ["fit"])
    # the JAX package's spelling, as the committed specs write it;
    # build_data reads it through provider_module
    data_provider: str = "repro.launch.cluster:quickstart_data"
    data_kwargs: Dict[str, Any] = field(default_factory=dict)
    barrier_timeout: float = 60.0
    control_tls: bool = True
    chaos: Optional[ChaosSpec] = None
    # per-role restart policies; "*" is the member-wide default set by
    # flat [restart] keys, explicit [restart.<role>] entries override
    restart: Dict[str, RestartPolicy] = field(default_factory=dict)
    serve: Optional[ServeSpec] = None
    # per-link overrides: [comm.<a>.<b>] tables, keyed by the (a, b)
    # role pair. Edges are symmetric (shape both directions) and each
    # pair appears once; values hold only edge-scoped keys (timeout,
    # latency_ms, bandwidth_mbps, jitter_ms, loss) — resolved against
    # the flat [comm] defaults by :meth:`comm_for`
    comm_edges: Dict[Tuple[str, str], Dict[str, Any]] = \
        field(default_factory=dict)

    # -- structure -----------------------------------------------------------
    @property
    def n_members(self) -> int:
        return sum(1 for a in self.agents if a.startswith("member"))

    def world(self) -> List[str]:
        from repro_torch.core.party import world_for
        return world_for(self.cfg, self.n_members)

    def agents_of(self, host: str) -> List[str]:
        if host not in self.hosts:
            raise KeyError(f"host {host!r} not in spec "
                           f"(hosts: {sorted(self.hosts)})")
        return list(self.hosts[host].agents)

    def restart_of(self, role: str) -> RestartPolicy:
        """Effective restart policy for ``role``: its explicit
        ``[restart.<role>]`` entry, else the member-wide flat
        ``[restart]`` default (members only), else fail-fast."""
        rp = self.restart.get(role)
        if rp is None and role.startswith("member"):
            rp = self.restart.get("*")
        return rp if rp is not None else RestartPolicy()

    def restartable_roles(self) -> List[str]:
        return [r for r in sorted(self.agents)
                if self.restart_of(r).policy == "on_failure"]

    def validate(self) -> None:
        expected = set(self.world())
        have = set(self.agents)
        if have != expected:
            raise ValueError(
                f"[agents] must name exactly the protocol's world "
                f"{sorted(expected)}; got {sorted(have)}")
        if self.framing not in ("sock", "grpc"):
            raise ValueError(f"[comm] framing must be 'sock' or "
                             f"'grpc', got {self.framing!r}")
        assigned: List[str] = []
        for hs in self.hosts.values():
            assigned += hs.agents
        if sorted(assigned) != sorted(have):
            dup = {a for a in assigned if assigned.count(a) > 1}
            missing = have - set(assigned)
            unknown = set(assigned) - have
            raise ValueError(
                f"[hosts] must assign every agent to exactly one "
                f"host (duplicates: {sorted(dup)}, unassigned: "
                f"{sorted(missing)}, unknown: {sorted(unknown)})")
        for phase in self.run_phases:
            if phase not in ("fit", "evaluate", "predict", "serve"):
                raise ValueError(f"[run] unknown phase {phase!r}")
        if "serve" in self.run_phases:
            ss = self.serve or ServeSpec()
            if ss.duration_s <= 0 and not ss.stop_file:
                raise ValueError(
                    "[serve] needs a bounded lifetime: set duration_s "
                    "> 0 and/or stop_file (the service ends when the "
                    "window closes or the file appears)")
        if self.chaos is not None:
            if not self.chaos.roles:
                raise ValueError("[chaos] role must name at least one "
                                 "agent")
            for cr in self.chaos.roles:
                if cr not in have:
                    raise ValueError(f"[chaos] role {cr!r} is not an "
                                     f"agent")
            if self.chaos.scenario not in ("crash", "partition", "slow"):
                raise ValueError(
                    f"[chaos] unknown scenario {self.chaos.scenario!r} "
                    f"(valid: crash, partition, slow)")
        for key, rp in self.restart.items():
            if rp.policy not in ("never", "on_failure"):
                raise ValueError(f"[restart] unknown policy "
                                 f"{rp.policy!r} for {key!r} "
                                 f"(valid: never, on_failure)")
            if key != "*" and key not in have:
                raise ValueError(f"[restart] role {key!r} is not an "
                                 f"agent")
        restartable = self.restartable_roles()
        bad = [r for r in restartable if not r.startswith("member")]
        if bad:
            raise ValueError(
                f"[restart] only members may use policy='on_failure' "
                f"(got {bad}); the master coordinates the rejoin and "
                f"cannot itself be elastic")
        if restartable and (self.cfg.secure_agg
                            or self.cfg.protocol == "secure_agg"):
            raise ValueError(
                "[restart] elastic members are unsupported with secure "
                "aggregation: a restarted member's pairwise masks "
                "desync from the survivors'")
        for (a, b) in self.comm_edges:
            for r in (a, b):
                if r not in have:
                    raise ValueError(
                        f"[comm.{a}.{b}] {r!r} is not an agent "
                        f"(agents: {sorted(have)})")
            if a == b:
                raise ValueError(f"[comm.{a}.{b}] is a self-edge")
            if (b, a) in self.comm_edges:
                raise ValueError(
                    f"[comm.{a}.{b}] duplicates [comm.{b}.{a}] — "
                    f"edges are symmetric, name each pair once")
        # composable towers (repro_torch.models.tower): block structure
        # is checkable now; concrete widths resolve at setup time from
        # the data provider's feature slices
        from repro_torch.models.tower import check_blocks
        for attr in ("tower", "top_tower"):
            blocks = getattr(self.cfg, attr, ())
            if blocks:
                try:
                    check_blocks(blocks)
                except ValueError as e:
                    raise ValueError(
                        f"[protocol] {attr}: {e}") from None
        if getattr(self.cfg, "tower_shard", 1) < 1:
            raise ValueError("[protocol] tower_shard must be >= 1")

    # -- construction --------------------------------------------------------
    _EDGE_LINK_KEYS = ("latency_ms", "bandwidth_mbps", "jitter_ms",
                       "loss")

    def comm_for(self, role: str) -> CommCfg:
        """``role``'s effective :class:`CommCfg`: the flat ``[comm]``
        defaults, plus ``peer_overrides`` for every ``[comm.a.b]``
        edge touching ``role`` (edges are symmetric — both endpoints
        shape the same link). An override carries only the fields its
        edge table actually sets: a timeout-only edge keeps
        ``link=None`` so the transport leaves it on the shared world
        link (and runtime ``set_link`` swaps still reach it) instead
        of pinning a private copy. Identical to ``self.comm`` when
        the spec has no edge tables."""
        from dataclasses import replace
        over: Dict[str, CommCfg] = {}
        for (a, b), ed in self.comm_edges.items():
            peer = b if a == role else a if b == role else None
            if peer is None:
                continue
            lk = {k: float(ed[k]) for k in self._EDGE_LINK_KEYS
                  if k in ed}
            over[peer] = replace(
                self.comm,
                link=replace(self.comm.link or LinkSpec(), **lk)
                if lk else None,
                timeout=float(ed["timeout"]) if "timeout" in ed
                else None,
                peer_overrides=None)
        if not over:
            return self.comm
        return replace(self.comm, peer_overrides=over)

    def make_communicator(self, role: str):
        """Build ``role``'s transport communicator with the full
        address map and the spec's :class:`CommCfg` (TLS and per-link
        ``[comm.a.b]`` overrides included)."""
        cls = SocketCommunicator if self.framing == "sock" \
            else GrpcCommunicator
        comm = self.comm_for(role)
        if self.restartable_roles():
            # elastic clusters need drop attribution even for clean
            # EOFs: a SIGKILL'd agent's kernel closes its sockets
            # tidily, and the master must notice within milliseconds
            from dataclasses import replace
            comm = replace(comm, strict_eof=True)
        return cls(role, dict(self.agents), comm_cfg=comm)

    def control_comm(self, host: str) -> SocketCommunicator:
        """The launcher↔launcher control channel: a tiny sock-framed
        world of the host names, TLS'd like the data plane (unless
        ``control_tls=false``)."""
        addrs = {h: hs.control for h, hs in self.hosts.items()}
        cfg = CommCfg(timeout=self.barrier_timeout,
                      tls=self.comm.tls if self.control_tls else None)
        return SocketCommunicator(host, addrs, comm_cfg=cfg)

    def build_data(self, role: str):
        """Call the spec's data provider for ``role`` (each host builds
        its own agents' data locally — nothing raw crosses the wire)."""
        modname, _, fname = self.data_provider.partition(":")
        if not fname:
            raise ValueError("[data] provider must be 'module:function'"
                             f", got {self.data_provider!r}")
        fn: Callable = getattr(
            importlib.import_module(provider_module(modname)), fname)
        return fn(role, **self.data_kwargs)


def provider_module(modname: str) -> str:
    """The module this package imports for a provider's ``modname``: a
    module of the JAX package (``repro`` or ``repro.<...>``) is read as
    its counterpart in this one, so a spec written for either package
    runs here without importing the JAX package; any other name as
    written."""
    if modname == "repro" or modname.startswith("repro."):
        return "repro_torch" + modname[len("repro"):]
    return modname


def load_spec(spec: Union[str, pathlib.Path, Dict[str, Any],
                          ClusterSpec]) -> ClusterSpec:
    """Load a cluster spec from a ``.toml``/``.json`` path, an
    already-parsed dict, or pass a :class:`ClusterSpec` through.

    Relative TLS certificate paths are resolved against the spec
    file's directory (an ``{agent}`` placeholder survives resolution
    and is substituted per agent by the transport).

    Example::

        spec = load_spec("examples/cluster/quickstart_cluster.toml")
        print(spec.world(), spec.framing)
    """
    if isinstance(spec, ClusterSpec):
        return spec
    base = pathlib.Path(".")
    if isinstance(spec, (str, pathlib.Path)):
        path = pathlib.Path(spec)
        base = path.parent
        text = path.read_text()
        raw = json.loads(text) if path.suffix == ".json" \
            else parse_toml(text)
    else:
        raw = dict(spec)
    return _spec_from_dict(raw, base)


def _spec_from_dict(raw: Dict[str, Any],
                    base: pathlib.Path) -> ClusterSpec:
    from repro_torch.core.protocols.base import VFLConfig
    proto = dict(raw.get("protocol") or {})
    name = proto.pop("name", None)
    if name:
        proto["protocol"] = name
    valid = {f.name for f in fields(VFLConfig)}
    unknown = set(proto) - valid
    if unknown:
        raise ValueError(f"[protocol] unknown VFLConfig fields "
                         f"{sorted(unknown)} (valid: {sorted(valid)})")
    proto = {k: tuple(v) if isinstance(v, list) else v
             for k, v in proto.items()}
    cfg = VFLConfig(**proto)

    comm_raw = dict(raw.get("comm") or {})
    framing = comm_raw.pop("framing", "grpc")
    link = comm_raw.pop("link", None)
    tls = comm_raw.pop("tls", None)
    ckw: Dict[str, Any] = {}
    for k in ("timeout", "nodelay", "encode_offload"):
        if k in comm_raw:
            ckw[k] = comm_raw.pop(k)
    barrier = comm_raw.pop("barrier_timeout", 60.0)
    control_tls = comm_raw.pop("control_tls", True)
    # per-link overrides: [comm.a.b] tables scope edge settings to the
    # a<->b link; flat [comm] keys stay the every-edge default
    edge_keys = ("timeout", "latency_ms", "bandwidth_mbps",
                 "jitter_ms", "loss")
    edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for a in [k for k, v in comm_raw.items() if isinstance(v, dict)]:
        sub = comm_raw.pop(a)
        for b, ed in sub.items():
            if not isinstance(ed, dict):
                raise ValueError(
                    f"[comm.{a}] expected per-peer tables "
                    f"([comm.{a}.<role>]), got key {b!r}")
            unknown = set(ed) - set(edge_keys)
            if unknown:
                raise ValueError(
                    f"[comm.{a}.{b}] unknown keys {sorted(unknown)} "
                    f"(valid: {sorted(edge_keys)}; connection-level "
                    f"settings like tls/nodelay stay in flat [comm])")
            edges[(a, b)] = dict(ed)
    if comm_raw:
        raise ValueError(f"[comm] unknown keys {sorted(comm_raw)}")
    if link is not None:
        ckw["link"] = LinkSpec(**link)
    if tls is not None:
        def _p(p: str) -> str:
            return p if os.path.isabs(p) else str(base / p)
        ckw["tls"] = TLSSpec(
            cert=_p(tls["cert"]), key=_p(tls["key"]), ca=_p(tls["ca"]),
            server_hostname=tls.get("server_hostname"),
            check_hostname=tls.get("check_hostname", True))

    agents = {a: _addr(v) for a, v in (raw.get("agents") or {}).items()}
    hosts = {h: HostSpec(control=_addr(hv["control"]),
                         agents=list(hv.get("agents", [])))
             for h, hv in (raw.get("hosts") or {}).items()}

    run = dict(raw.get("run") or {})
    data = dict(raw.get("data") or {})
    provider = data.pop("provider",
                        "repro.launch.cluster:quickstart_data")
    chaos_raw = raw.get("chaos")
    chaos = None
    if chaos_raw:
        ckeys = {f.name for f in fields(ChaosSpec)}
        unknown = set(chaos_raw) - ckeys
        if unknown:
            raise ValueError(f"[chaos] unknown keys {sorted(unknown)} "
                             f"(valid: {sorted(ckeys)})")
        chaos = ChaosSpec(**{**chaos_raw, "step": int(chaos_raw["step"])})

    serve_raw = raw.get("serve")
    serve = None
    if serve_raw:
        skeys = {f.name for f in fields(ServeSpec)}
        unknown = set(serve_raw) - skeys
        if unknown:
            raise ValueError(f"[serve] unknown keys {sorted(unknown)} "
                             f"(valid: {sorted(skeys)})")
        serve = ServeSpec(**serve_raw)
        if serve.cache_rows:
            # the member-side embed cache is a protocol knob — every
            # agent's VFLConfig must agree on it
            cfg.serve_cache_rows = int(serve.cache_rows)

    restart_raw = dict(raw.get("restart") or {})
    rkeys = {f.name for f in fields(RestartPolicy)}

    def _policy(d: Dict[str, Any], where: str) -> RestartPolicy:
        unknown = set(d) - rkeys
        if unknown:
            raise ValueError(f"[restart{where}] unknown keys "
                             f"{sorted(unknown)} (valid: "
                             f"{sorted(rkeys)})")
        return RestartPolicy(**d)

    per_role = {k: v for k, v in restart_raw.items()
                if isinstance(v, dict)}
    flat = {k: v for k, v in restart_raw.items()
            if not isinstance(v, dict)}
    restart: Dict[str, RestartPolicy] = {}
    if flat:
        restart["*"] = _policy(flat, "")
    for role, d in per_role.items():
        restart[role] = _policy({**flat, **d}, f".{role}")

    return ClusterSpec(
        cfg=cfg, agents=agents, hosts=hosts, comm=CommCfg(**ckw),
        framing=framing,
        run_phases=list(run.get("phases", ["fit"])),
        data_provider=provider, data_kwargs=data,
        barrier_timeout=float(barrier), control_tls=bool(control_tls),
        chaos=chaos, restart=restart, serve=serve, comm_edges=edges)


# ---------------------------------------------------------------------------
# built-in data providers (each host rebuilds its slice locally from
# the shared seed — deterministic, nothing raw crosses the wire)
# ---------------------------------------------------------------------------


def quickstart_data(role: str, seed: int = 0, **_: Any):
    """The quickstart's SBOL-like two-silo recommendation dataset,
    sliced for ``role`` (the cluster-spec default provider)."""
    from repro_torch.configs.vfl_recsys import VFLRecsysConfig
    from repro_torch.core.protocols.base import MasterData, MemberData
    from repro_torch.data.synthetic import make_recsys_silos
    data = make_recsys_silos(VFLRecsysConfig().reduced(), seed=seed)
    if role == "master":
        return MasterData(data.ids, data.labels.astype(np.float64),
                          data.features)
    if role.startswith("member"):
        i = int(role[len("member"):])
        return MemberData(data.member_ids[i], data.member_features[i])
    return None


def linreg_demo_data(role: str, n: int = 192, d: int = 12,
                     items: int = 2, widths: Sequence[int] = (4, 3),
                     seed: int = 0, **_: Any):
    """Tiny synthetic vertically-partitioned regression set — the
    cheapest cluster smoke workload (numpy only, no tensors)."""
    from repro_torch.data.vertical import vertical_partition
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    w = rng.normal(size=(d, items))
    y = x @ w * 0.4 + rng.normal(scale=0.05, size=(n, items))
    ids = [f"u{i:05d}" for i in range(n)]
    master, members = vertical_partition(ids, x, y,
                                         widths=list(widths),
                                         overlap=1.0, seed=1)
    if role == "master":
        return master
    if role.startswith("member"):
        return members[int(role[len("member"):])]
    return None


def logreg_he_demo_data(role: str, n: int = 192, d: int = 12,
                        widths: Sequence[int] = (5, 5),
                        seed: int = 0, **_: Any):
    """Synthetic vertically-partitioned binary-classification set for
    ``logreg_he`` cluster smokes (master keeps the remainder columns
    plus the labels; arbiter roles — however many the spec's
    ``n_arbiters`` asks for — get no data at all)."""
    from repro_torch.data.vertical import vertical_partition
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    w = rng.normal(size=(d, 1))
    y = (1.0 / (1.0 + np.exp(-(x @ w))) > 0.5).astype(np.float64)
    ids = [f"u{i:05d}" for i in range(n)]
    master, members = vertical_partition(ids, x, y,
                                         widths=list(widths),
                                         overlap=1.0, seed=1)
    if role == "master":
        return master
    if role.startswith("member"):
        return members[int(role[len("member"):])]
    return None


# ---------------------------------------------------------------------------
# agent child process
# ---------------------------------------------------------------------------


def _json_safe(obj: Any, _depth: int = 0) -> Any:
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    if isinstance(obj, dict) and _depth < 4:
        out = {}
        for k, v in obj.items():
            v = _json_safe(v, _depth + 1)
            if v is not ...:
                out[str(k)] = v
        return out
    if isinstance(obj, (list, tuple)) and _depth < 4 and len(obj) <= 64:
        vals = [_json_safe(v, _depth + 1) for v in obj]
        return [v for v in vals if v is not ...]
    return ...                                 # dropped (arrays, objects)


class _ChaosCrash(Callback):
    """Driver callback that crashes its agent at a given step — the
    knob the chaos CI job (and any user validating their supervision
    story) flips via the spec's ``[chaos]`` table."""

    def __init__(self, step: int):
        self.step = step

    def on_batch_end(self, driver, step, epoch, loss) -> None:
        if step >= self.step:
            raise RuntimeError(
                f"chaos: injected crash at step {step}")


class _ChaosLink(Callback):
    """Driver callback that swaps the agent's outbound link spec once
    at a given step — the ``partition`` (blackhole) and ``slow``
    (latency-inflation) chaos scenarios."""

    def __init__(self, step: int, link: LinkSpec):
        self.step = step
        self.link = link
        self._fired = False

    def on_batch_end(self, driver, step, epoch, loss) -> None:
        if not self._fired and step >= self.step:
            self._fired = True
            print(f"chaos: link -> {self.link} at step {step}",
                  flush=True)
            driver.ch.comm.set_link(self.link)


def _chaos_callbacks(spec: ClusterSpec, role: str) -> List[Callback]:
    ch = spec.chaos
    if ch is None or role not in ch.roles:
        return []
    if ch.scenario == "crash":
        return [_ChaosCrash(ch.step)]
    if ch.scenario == "partition":
        return [_ChaosLink(ch.step, LinkSpec(loss=ch.loss))]
    if ch.scenario == "slow":
        return [_ChaosLink(ch.step, LinkSpec(latency_ms=ch.latency_ms))]
    raise ValueError(f"unknown chaos scenario {ch.scenario!r}")


def _serve_phase(spec: ClusterSpec, agent) -> Dict[str, Any]:
    """Master-side ``serve`` phase: host the federated inference
    service behind its TCP frontend until the spec's lifetime ends
    (``duration_s`` elapsed and/or ``stop_file`` appeared), then return
    the final ServeStats snapshot for the summary."""
    from repro_torch.serve.federated import (FederatedServer, ServeCfg,
                                             ServeFrontend)
    ss = spec.serve or ServeSpec()
    scfg = ServeCfg(max_batch=ss.max_batch, max_wait_ms=ss.max_wait_ms,
                    admission_limit=ss.admission_limit,
                    cache_rows=ss.cache_rows)
    srv = FederatedServer(agent, scfg).start()
    fe = ServeFrontend(srv, host=ss.host, port=ss.port)
    try:
        print(f"[master] serving on {ss.host}:{fe.port} "
              f"(max_batch={ss.max_batch} "
              f"max_wait_ms={ss.max_wait_ms})", flush=True)
        deadline = time.monotonic() + ss.duration_s \
            if ss.duration_s > 0 else None
        stop = pathlib.Path(ss.stop_file) if ss.stop_file else None
        while True:
            time.sleep(0.25)
            if deadline is not None and time.monotonic() > deadline:
                break
            if stop is not None and stop.exists():
                break
    finally:
        fe.close()
    return srv.stop()


def _cluster_agent_main(spec: ClusterSpec, role: str, log_path: str,
                        status_q, rejoin: bool = False,
                        device: str = "cuda") -> None:
    """Entry point of one spawned agent process (module-level for
    spawn picklability). Reports ("ready"|"ok"|"error", role, info) on
    ``status_q``; stdout/stderr land in ``log_path``. ``rejoin=True``
    marks a supervisor respawn: the agent restores state from its
    checkpoint directory and enters the master's paused fit via the
    rejoin handshake. ``device`` arrives as a string and the agent's
    role object resolves it, so each agent process makes its own CUDA
    context (or raises without one)."""
    lf = open(log_path, "ab", buffering=0)
    os.dup2(lf.fileno(), 1)
    os.dup2(lf.fileno(), 2)
    sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
    sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
    comm = None
    try:
        from repro_torch.core.party import (Arbiter, PartyMaster,
                                            PartyMember)
        comm = spec.make_communicator(role)
        status_q.put(("ready", role, os.getpid()))
        data = spec.build_data(role)
        # a chaos fault is injected ONCE by default — the supervisor's
        # respawn of the victim must not re-arm it (it would crash
        # again instantly and burn the whole restart budget on one
        # scripted fault). [chaos] repeat=true opts into exactly that
        # burn: the crash-loop scenario that must end in an attributed
        # restart-budget exhaustion rather than a hang.
        rearm = spec.chaos is not None and spec.chaos.repeat
        callbacks = _chaos_callbacks(spec, role) \
            if (not rejoin or rearm) else []
        restartable = spec.restartable_roles()
        elastic = None
        resume_dir = None
        if restartable and role == "master":
            elastic = ElasticCfg(
                roles=frozenset(restartable),
                wait_s=max(spec.restart_of(r).wait_s
                           for r in restartable))
        elif role in restartable:
            # the agent's checkpoint directory sits beside its log;
            # save_on_start guarantees a rejoinable cut exists from
            # step 0. Only a supervisor respawn resumes from it — a
            # fresh run ignores (and then overwrites) leftovers.
            rp = spec.restart_of(role)
            ckpt = str(pathlib.Path(log_path).parent / "ckpt")
            callbacks.append(Checkpointer(
                ckpt, every_steps=rp.checkpoint_every,
                save_on_start=True))
            if rejoin:
                resume_dir = ckpt
        if role == "master":
            agent = PartyMaster(comm, spec.cfg, callbacks=callbacks,
                                elastic=elastic, device=device)
            summary: Dict[str, Any] = {}
            for phase in spec.run_phases:
                print(f"[{role}] phase {phase}", flush=True)
                if phase == "fit":
                    r = agent.fit(data)
                    h = r["history"]
                    summary["fit"] = {
                        "n_common": r["n_common"], "steps": len(h),
                        "first_loss": h[0]["loss"] if h else None,
                        "final_loss": h[-1]["loss"] if h else None,
                        "wall_s": h[-1]["wall_s"] if h else None}
                    if r.get("recoveries"):
                        summary["recoveries"] = _json_safe(
                            r["recoveries"])
                elif phase == "evaluate":
                    summary["evaluate"] = _json_safe(agent.evaluate())
                elif phase == "predict":
                    scores = agent.predict()
                    summary["predict"] = {"rows": int(scores.shape[0])}
                elif phase == "serve":
                    summary["serve"] = _serve_phase(spec, agent)
            res = agent.shutdown()
            summary["comm"] = _json_safe(res.get("comm"))
            if res.get("roofline"):
                # per-step compute-vs-wire split (launch/roofline.py)
                summary["roofline"] = _json_safe(res["roofline"])
            status_q.put(("ok", role, summary))
        else:
            agent = PartyMember(comm, spec.cfg, callbacks=callbacks,
                                resume_dir=resume_dir, device=device) \
                if role.startswith("member") \
                else Arbiter(comm, spec.cfg, callbacks=callbacks,
                             device=device)
            res = agent.serve(data, rejoin=rejoin) \
                if role.startswith("member") else agent.serve()
            out = {"comm": _json_safe(res.get("comm"))}
            if res.get("roofline"):
                out["roofline"] = _json_safe(res["roofline"])
            status_q.put(("ok", role, out))
    except BaseException:
        tb = traceback.format_exc()
        print(tb, file=sys.stderr, flush=True)
        # the traceback must reach the supervisor BEFORE this process
        # dies — the launcher turns it into its own exit diagnostics
        status_q.put(("error", role, tb))
        raise
    finally:
        if comm is not None:
            comm.close()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


class _ClusterFailed(Exception):
    def __init__(self, code: int):
        self.code = code


class ClusterLauncher:
    """Spawn + supervise one host's agents from a :class:`ClusterSpec`.

    ``run()`` blocks until every local agent finished (exit 0), any
    agent — local or on a peer launcher — failed (exit 1), rendezvous
    timed out (exit 3), or :meth:`request_stop` was called (exit 143).
    The CLI (``python -m repro_torch.launch.cluster``) is a thin wrapper
    that adds SIGTERM/SIGINT handling. ``device`` is where every agent of
    this host keeps its tensors, a respawned one included; a CUDA device
    this machine lacks raises here.

    Example::

        spec = load_spec("spec.toml")
        rc = ClusterLauncher(spec, host="alpha", log_dir="runs/alpha",
                             device="cuda").run()
    """

    POLL_S = 0.2

    def __init__(self, spec: ClusterSpec, host: str,
                 log_dir: Union[str, pathlib.Path] = "runs/cluster",
                 device: str = "cuda"):
        spec.validate()
        self.device = str(resolve_device(device))
        self.spec = spec
        self.host = host
        self.roles = spec.agents_of(host)
        self.log_dir = pathlib.Path(log_dir)
        self.peers = [h for h in spec.hosts if h != host]
        self._stop = False
        self._procs: Dict[str, mp.process.BaseProcess] = {}
        self._ok: Dict[str, Any] = {}
        self._exit_seen: Dict[str, float] = {}
        self._ctl: Optional[SocketCommunicator] = None
        self._fail_futs: Dict[str, Any] = {}
        # elastic supervision: restart attempts per role and scheduled
        # respawn times (monotonic)
        self._restarts: Dict[str, int] = {}
        self._pending_restart: Dict[str, float] = {}
        self._pids: Dict[str, int] = {}
        self._ctx = None

    def request_stop(self) -> None:
        """Ask ``run()`` to terminate local agents and exit 143 (wired
        to SIGTERM/SIGINT by the CLI)."""
        self._stop = True

    # -- internals -----------------------------------------------------------
    def _log(self, msg: str) -> None:
        print(f"[launcher {self.host}] {msg}", flush=True)

    def _terminate_local(self) -> None:
        for p in self._procs.values():
            if p.is_alive():
                p.terminate()                 # SIGTERM fan-out
        deadline = time.monotonic() + 5.0
        for p in self._procs.values():
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        for p in self._procs.values():
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)

    def _broadcast_fail(self, role: str, tb: str) -> None:
        if self._ctl is None:
            return
        try:
            futs = self._ctl.broadcast(
                "ctl/fail", {"ok": np.zeros(1)},
                meta={"role": role, "traceback": tb[-16000:]},
                wait=False)
            for f in futs:
                try:
                    f.result(5.0)
                except (TimeoutError, OSError):
                    pass                       # peer already gone
        except (OSError, RuntimeError):
            pass

    def _fail(self, role: str, tb: str, remote: bool = False) -> None:
        origin = "peer launcher reported" if remote else "local"
        self._log(f"agent {role} FAILED ({origin}); terminating "
                  f"{len(self._procs)} local agent(s)")
        sys.stderr.write(f"\n--- agent {role} failure ---\n{tb}\n")
        sys.stderr.flush()
        if not remote:
            self._broadcast_fail(role, tb)
        self._terminate_local()
        raise _ClusterFailed(1)

    def _check_peers(self) -> None:
        for peer, fut in self._fail_futs.items():
            if fut.done():
                msg = fut.result(1.0)
                self._fail(msg.meta.get("role", f"<{peer}>"),
                           msg.meta.get("traceback", "(no traceback)"),
                           remote=True)

    def _maybe_restart(self, role: str, why: str) -> bool:
        """Death/error handling for a restartable role: schedule a
        backed-off respawn and return True, or return False when the
        policy (or the remaining budget, or the phase) says fail-fast."""
        if role in self._pending_restart:
            return True                   # already scheduled (a death
        #                                   and its error msg both land)
        rp = self.spec.restart_of(role)
        # the policy only arms once the agent has reported ready (its
        # listener bound, data plane up): crashes before that are
        # deploy problems — bad spec, bad certs, import errors — that a
        # respawn would only repeat. The agent's own fit may begin (and
        # a chaos fault may fire) before the LAUNCHERS' control barrier
        # completes, so readiness, not the cross-host barrier, is the
        # arming point.
        if rp.policy != "on_failure" or role not in self._pids:
            return False
        n = self._restarts.get(role, 0)
        if n >= rp.max_restarts:
            self._log(f"agent {role} exhausted its restart budget "
                      f"({rp.max_restarts})")
            return False
        self._restarts[role] = n + 1
        backoff = min(rp.backoff_s * (2 ** n), rp.backoff_max_s)
        self._log(f"agent {role} died ({why}); restart "
                  f"{n + 1}/{rp.max_restarts} in {backoff:.1f}s")
        self._pending_restart[role] = time.monotonic() + backoff
        if self._ctl is not None:
            # informational only — peer supervision loops ignore it,
            # but it lands in their logs for cross-host debugging
            try:
                self._ctl.broadcast("ctl/rejoin", {"ok": np.ones(1)},
                                    meta={"role": role}, wait=False)
            except (OSError, RuntimeError):
                pass
        return True

    def _forget_proc(self, role: str) -> None:
        p = self._procs.pop(role, None)
        if p is not None and p.is_alive():
            p.join(timeout=5.0)
        self._exit_seen.pop(role, None)

    def _spawn(self, role: str, rejoin: bool = False) -> None:
        p = self._ctx.Process(
            target=_cluster_agent_main,
            args=(self.spec, role, str(self.log_dir / f"{role}.log"),
                  self._status_q, rejoin, self.device))
        p.daemon = True
        self._procs[role] = p
        p.start()

    def _respawn_due(self) -> None:
        now = time.monotonic()
        for role, due in list(self._pending_restart.items()):
            if now >= due:
                del self._pending_restart[role]
                self._log(f"respawning agent {role} (rejoin)")
                self._spawn(role, rejoin=True)

    def _drain_status(self, ready: Optional[set] = None) -> None:
        while True:
            try:
                kind, role, info = self._status_q.get_nowait()
            except queue.Empty:
                return
            if kind == "ready":
                self._pids[role] = info
                if ready is not None:
                    ready.add(role)
                else:
                    # a respawned agent re-bound its listener: refresh
                    # pids.json so tooling kills the right process
                    (self.log_dir / "pids.json").write_text(
                        json.dumps(self._pids))
            elif kind == "ok":
                self._ok[role] = info
                self._log(f"agent {role} finished ok")
            elif kind == "error":
                if self._maybe_restart(role, "reported an error"):
                    self._forget_proc(role)
                else:
                    self._fail(role, info)

    def _check_deaths(self) -> None:
        for role, p in list(self._procs.items()):
            if role in self._ok or p.exitcode is None:
                continue
            code = p.exitcode
            # a dead agent's last "ok"/"error" message can still be in
            # flight through the status queue's feeder thread — give
            # it a grace window before calling the silence a failure,
            # so a crash reports its REAL traceback, not this generic
            # one. Clean exits get longer (the ok message may trail a
            # big result); crashes flush their traceback pre-mortem,
            # so a short window suffices and SIGKILL detection (which
            # has nothing queued) stays fast.
            grace = 5.0 if code == 0 else 1.5
            first = self._exit_seen.setdefault(role, time.monotonic())
            if time.monotonic() - first < grace:
                continue
            try:
                why = f"signal {signal.Signals(-code).name}" \
                    if code < 0 else f"exit code {code}"
            except ValueError:
                why = f"exit code {code}"
            if self._maybe_restart(role, why):
                self._forget_proc(role)
                continue
            self._fail(role, f"agent process {role!r} died with "
                             f"{why} before reporting a result "
                             f"(no traceback available)")

    def _tick(self, ready: Optional[set] = None) -> None:
        if self._stop:
            self._log("stop requested; terminating local agents")
            self._broadcast_fail(
                f"<{self.host}>", f"launcher on {self.host} was "
                f"terminated by signal; cluster cannot continue")
            self._terminate_local()
            raise _ClusterFailed(143)
        self._drain_status(ready)
        self._check_deaths()
        self._check_peers()
        self._respawn_due()
        time.sleep(self.POLL_S)

    # -- main ----------------------------------------------------------------
    def run(self) -> int:
        try:
            return self._run()
        except _ClusterFailed as e:
            return e.code
        finally:
            if self._ctl is not None:
                try:
                    self._ctl.close()
                except OSError:
                    pass

    def _run(self) -> int:
        spec = self.spec
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._pids: Dict[str, int] = {}
        ctx = mp.get_context("spawn")
        self._ctx = ctx
        self._status_q = ctx.Queue()

        # control channel first, so peers can rendezvous with us while
        # our agents are still importing
        if self.peers:
            self._ctl = spec.control_comm(self.host)
            self._fail_futs = {p: self._ctl.irecv(p, "ctl/fail")
                               for p in self.peers}
            ready_futs = {p: self._ctl.irecv(p, "ctl/ready")
                          for p in self.peers}

        self._log(f"spawning {self.roles} (logs in {self.log_dir})")
        for role in self.roles:
            self._spawn(role)

        # local readiness: every agent constructed its communicator
        # (listener bound) — then join the cross-host barrier
        ready: set = set()
        deadline = time.monotonic() + spec.barrier_timeout
        while len(ready) < len(self.roles):
            self._tick(ready)
            if time.monotonic() > deadline:
                self._log("local agents not ready before "
                          f"barrier_timeout={spec.barrier_timeout}s")
                self._terminate_local()
                return 3
        (self.log_dir / "pids.json").write_text(json.dumps(self._pids))

        if self.peers:
            # non-blocking: a blocking broadcast could wedge for the
            # full comm timeout retrying a peer that just died, while
            # that peer's ctl/fail sits completed in _fail_futs — the
            # supervision loop below must keep polling it so crash
            # propagation preempts a stuck rendezvous send
            try:
                ready_sends = list(self._ctl.broadcast(
                    "ctl/ready", {"ok": np.ones(1)},
                    meta={"host": self.host}, wait=False))
            except (OSError, RuntimeError) as e:
                self._log(f"rendezvous failed: {e}")
                self._terminate_local()
                return 3
            waiting = set(self.peers)
            while waiting:
                self._tick()
                for f in list(ready_sends):
                    if not f.done():
                        continue
                    try:
                        f.result(0)
                    except (OSError, TimeoutError) as e:
                        self._log(f"rendezvous failed: {e}")
                        self._terminate_local()
                        return 3
                    ready_sends.remove(f)
                waiting = {p for p in waiting
                           if not ready_futs[p].done()}
                if time.monotonic() > deadline:
                    self._log(f"peers {sorted(waiting)} not ready "
                              f"before barrier_timeout="
                              f"{spec.barrier_timeout}s")
                    self._terminate_local()
                    return 3
            self._log(f"rendezvous complete: "
                      f"{sorted(spec.hosts)} all ready")

        # supervise until every local agent reported ok
        while len(self._ok) < len(self.roles):
            self._tick()

        summary = {"host": self.host, "agents": self._ok}
        (self.log_dir / "summary.json").write_text(
            json.dumps(summary, indent=1))
        if "master" in self._ok:
            print("CLUSTER-RESULT " + json.dumps(summary), flush=True)
        if self._ctl is not None:
            try:
                self._ctl.broadcast("ctl/done", {"ok": np.ones(1)},
                                    wait=False)
                self._ctl.flush_sends(2.0)
            except (OSError, TimeoutError, RuntimeError):
                pass
        self._log("all local agents finished ok")
        return 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.cluster",
        description="Launch and supervise this host's share of a VFL "
                    "cluster from a shared spec file "
                    "(docs/deploy.md).")
    ap.add_argument("spec", help="path to the cluster spec "
                                 "(.toml or .json)")
    ap.add_argument("--host", help="which [hosts.<name>] entry this "
                                   "invocation runs (optional when "
                                   "the spec has exactly one host)")
    ap.add_argument("--log-dir", default=None,
                    help="per-agent log directory "
                         "(default: runs/cluster/<host>)")
    ap.add_argument("--check", action="store_true",
                    help="validate the spec, print the launch plan, "
                         "and exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the agents keep their tensors "
                         "(default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    try:
        spec = load_spec(args.spec)
        spec.validate()
    except (OSError, ValueError, KeyError) as e:
        print(f"spec error: {e}", file=sys.stderr)
        return 2
    if args.check:
        print(f"protocol: {spec.cfg.protocol}  framing: {spec.framing}"
              f"  tls: {'on' if spec.comm.tls else 'off'}")
        for h, hs in spec.hosts.items():
            print(f"host {h}: control {hs.control[0]}:{hs.control[1]}"
                  f"  agents {hs.agents}")
        for a, (ah, ap_) in spec.agents.items():
            print(f"agent {a}: {ah}:{ap_}")
        print("spec OK")
        return 0
    host = args.host
    if host is None:
        if len(spec.hosts) != 1:
            print(f"--host required (spec has hosts "
                  f"{sorted(spec.hosts)})", file=sys.stderr)
            return 2
        host = next(iter(spec.hosts))
    if host not in spec.hosts:
        print(f"unknown host {host!r} (spec has {sorted(spec.hosts)})",
              file=sys.stderr)
        return 2
    try:
        launcher = ClusterLauncher(
            spec, host,
            log_dir=args.log_dir or f"runs/cluster/{host}",
            device=args.device)
    except RuntimeError as e:              # a CUDA device this host lacks
        print(f"device error: {e}", file=sys.stderr)
        return 2
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: launcher.request_stop())
    return launcher.run()


if __name__ == "__main__":
    raise SystemExit(main())
