"""The PyTorch port's cluster launch subsystem on the CPU, held to the
live JAX package: spec parsing and validation field by field,
``VFLJob.from_spec`` (linreg at rtol 0; split-NN from one JAX checkpoint
cut at rtol 1e-5, 1e-4 after a quantization tie), two launchers over
TLS, crash fan-out across launchers (a member crash, a correlated crash
of two members, a SIGKILLed member) and the elastic restart of a member.

It also holds the port's TCP transports under TLS to what the JAX
package's grpc+TLS tests need and do not always get: fresh gRPC
connections that send at once in both directions, one after another in
one process (the reader thread of a gRPC client connection and its
sender used the ``ssl.SSLSocket`` at the same time, and a closed
connection's waiting thread could act on the reused fd number), and an
idle gRPC connection that outlives the transport timeout.

Spawned agents do not inherit ``torch.set_num_threads``, so the launcher
tests run them with ``OMP_NUM_THREADS=1`` in their environment.
"""
import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.party import VFLJob as JaxJob  # noqa: E402
from repro.core.protocols.driver import (  # noqa: E402
    Checkpointer as JaxCheckpointer)
from repro.launch import cluster as jcluster  # noqa: E402
from repro_torch.comm.base import CommCfg  # noqa: E402
from repro_torch.comm.grpc import GrpcCommunicator  # noqa: E402
from repro_torch.comm.sock import (SocketCommunicator,  # noqa: E402
                                   local_addresses)
from repro_torch.core.party import VFLJob  # noqa: E402
from repro_torch.launch import cluster  # noqa: E402
from repro_torch.launch.certs import TestCA, have_openssl  # noqa: E402
from repro_torch.launch.cluster import (ClusterLauncher,  # noqa: E402
                                        load_spec, parse_toml)

REPO = pathlib.Path(__file__).resolve().parents[1]
SPECS = REPO / "examples" / "cluster"
COMMITTED = ["quickstart_cluster.toml", "logreg_he_sharded.toml"]

NARROW = ("embed:tokens=4,dim=16", "attn_block:heads=2", "quantize",
          "mlp:hidden=16")
TOP = ("mlp:hidden=16,final_act=0",)


def _free_ports(n):
    return [port for _, port in
            local_addresses([f"p{i}" for i in range(n)]).values()]


def _linreg_spec(ports, tls_dir=None, framing="sock", epochs=3,
                 **extra):
    """The JAX package's test spec (``tests/test_cluster.py``)."""
    spec = {
        "protocol": {"name": "linreg", "epochs": epochs,
                     "batch_size": 48, "lr": 0.1, "seed": 0,
                     "use_psi": False},
        "run": {"phases": ["fit"]},
        "data": {"provider": "repro.launch.cluster:linreg_demo_data",
                 "seed": 0},
        "comm": {"framing": framing, "timeout": 30.0,
                 "barrier_timeout": 60.0},
        "agents": {"master": f"127.0.0.1:{ports[0]}",
                   "member0": f"127.0.0.1:{ports[1]}",
                   "member1": f"127.0.0.1:{ports[2]}"},
        "hosts": {"alpha": {"control": f"127.0.0.1:{ports[3]}",
                            "agents": ["master", "member0"]},
                  "beta": {"control": f"127.0.0.1:{ports[4]}",
                           "agents": ["member1"]}},
    }
    if tls_dir is not None:
        spec["comm"]["tls"] = {"cert": f"{tls_dir}/{{agent}}.crt",
                               "key": f"{tls_dir}/{{agent}}.key",
                               "ca": f"{tls_dir}/ca.crt"}
    spec.update(extra)
    return spec


@pytest.fixture(scope="session")
def port_certs(tmp_path_factory):
    if not have_openssl():
        pytest.skip("openssl CLI required")
    ca = TestCA(tmp_path_factory.mktemp("torch_clcerts"))
    for n in ("master", "member0", "member1", "alpha", "beta", "a", "b"):
        ca.issue(n)
    return ca


def _run_pair(spec, log_root, hosts=("alpha", "beta")):
    codes = {}

    def _one(host):
        codes[host] = ClusterLauncher(
            spec, host, log_dir=pathlib.Path(log_root) / host,
            device="cpu").run()
    ts = [threading.Thread(target=_one, args=(h,)) for h in hosts]
    for t in ts:
        t.start()
    for t in ts:
        t.join(150)
    assert not any(t.is_alive() for t in ts), "launcher wedged"
    return codes


@pytest.fixture
def one_thread_agents(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# ---------------------------------------------------------------------------
# spec parsing + validation, field by field against the JAX package
# ---------------------------------------------------------------------------


def _fields(spec):
    """A ClusterSpec of either package as plain Python: every dataclass
    (VFLConfig, CommCfg, HostSpec, ...) by its fields."""
    def plain(v):
        if dataclasses.is_dataclass(v):
            return {f.name: plain(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(plain(x) for x in v)
        return v
    return plain(spec)


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_specs_load_as_in_jax(name):
    path = SPECS / name
    text = path.read_text()
    assert parse_toml(text) == jcluster.parse_toml(text)
    got, want = load_spec(path), jcluster.load_spec(path)
    got.validate()
    assert _fields(got) == _fields(want)
    assert got.world() == want.world()
    assert got.restartable_roles() == want.restartable_roles()


def test_rich_spec_loads_as_in_jax():
    """Every optional table: [chaos] with a role list, [restart] flat and
    per role, [serve], [comm.link], [comm.a.b] edges, a tower."""
    raw = _linreg_spec(
        _free_ports(5),
        chaos={"role": ["member0", "member1"], "step": 3,
               "scenario": "slow", "repeat": True},
        restart={"policy": "on_failure", "backoff_s": 0.1,
                 "member1": {"max_restarts": 7}},
        serve={"port": 0, "host": "127.0.0.1", "stop_file": "stop",
               "cache_rows": 8},
        run={"phases": ["fit", "evaluate", "serve"]})
    raw["comm"]["link"] = {"latency_ms": 2.0}
    raw["comm"]["master"] = {"member1": {"timeout": 5.0,
                                         "latency_ms": 9.0}}
    got, want = load_spec(raw), jcluster.load_spec(raw)
    got.validate()
    assert _fields(got) == _fields(want)
    for role in got.world():
        assert _fields(got.comm_for(role)) == _fields(want.comm_for(role))
    assert got.restart_of("member1").max_restarts == 7
    assert got.cfg.serve_cache_rows == 8


def _mutate(attr, value):
    def run(spec):
        setattr(spec, attr, value)
    return run


def _set_cfg(**kw):
    def run(spec):
        for k, v in kw.items():
            setattr(spec.cfg, k, v)
    return run


def _unassign(spec):
    spec.hosts["beta"].agents = []


def _extra_arbiter(spec):
    spec.agents["arbiter"] = ("127.0.0.1", 1)


# (the dict's extra tables, a change to the loaded spec) -> the same
# validate() message in both packages
BAD_SPECS = {
    "unassigned": ({}, _unassign),
    "world": ({}, _extra_arbiter),
    "framing": ({}, _mutate("framing", "http")),
    "phase": ({"run": {"phases": ["fit", "train"]}}, None),
    "serve_unbounded": ({"run": {"phases": ["serve"]}}, None),
    "chaos_ghost": ({"chaos": {"role": ["member0", "ghost"], "step": 3}},
                    None),
    "chaos_scenario": ({"chaos": {"role": "member0", "step": 3,
                                  "scenario": "meteor"}}, None),
    "restart_master": ({"restart": {"master": {"policy": "on_failure"}}},
                       None),
    "restart_policy": ({"restart": {"policy": "always"}}, None),
    "restart_ghost": ({"restart": {"member9": {"policy": "on_failure"}}},
                      None),
    "restart_secure_agg": ({"restart": {"policy": "on_failure"}},
                           _set_cfg(secure_agg=True)),
    "edge_ghost": ({"comm": {"framing": "sock",
                             "master": {"ghost": {"timeout": 1.0}}}},
                   None),
    "edge_self": ({"comm": {"framing": "sock",
                            "master": {"master": {"timeout": 1.0}}}},
                  None),
    "edge_twice": ({"comm": {"framing": "sock",
                             "master": {"member0": {"timeout": 1.0}},
                             "member0": {"master": {"timeout": 2.0}}}},
                   None),
    "tower": ({}, _set_cfg(tower=("mlp:hidden=8", "attn_block:heads=2"))),
    "tower_key": ({}, _set_cfg(top_tower=("mlp:width=8",))),
    "tower_shard": ({}, _set_cfg(tower_shard=0)),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_validation_errors_match_jax(case):
    extra, change = BAD_SPECS[case]
    raw = _linreg_spec(_free_ports(5), **extra)
    msgs = []
    for mod in (cluster, jcluster):
        spec = mod.load_spec(raw)
        if change is not None:
            change(spec)
        with pytest.raises(ValueError) as ei:
            spec.validate()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# load_spec's own refusals: unknown keys in each table
BAD_TABLES = {
    "protocol": {"protocol": {"name": "linreg", "nope": 1}},
    "chaos": {"chaos": {"role": "member0", "step": 1, "nope": True}},
    "restart": {"restart": {"retries": 3}},
    "restart_role": {"restart": {"member0": {"retries": 3}}},
    "serve": {"serve": {"stop_file": "x", "nope": 1}},
    "comm": {"comm": {"framing": "sock", "nope": 1}},
    "edge": {"comm": {"framing": "sock",
                      "master": {"member0": {"tls": "x"}}}},
    "edge_flat": {"comm": {"framing": "sock", "master": {"member0": 1}}},
}


@pytest.mark.parametrize("case", sorted(BAD_TABLES))
def test_load_errors_match_jax(case):
    raw = _linreg_spec(_free_ports(5), **BAD_TABLES[case])
    msgs = []
    for mod in (cluster, jcluster):
        with pytest.raises(ValueError) as ei:
            mod.load_spec(raw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_restart_spec_validation():
    spec = load_spec(_linreg_spec(
        _free_ports(5),
        restart={"policy": "on_failure", "backoff_s": 0.1,
                 "member1": {"max_restarts": 7}}))
    spec.validate()
    assert spec.restartable_roles() == ["member0", "member1"]
    assert spec.restart_of("member0").max_restarts == 3
    assert spec.restart_of("member1").max_restarts == 7
    assert spec.restart_of("member1").backoff_s == 0.1
    assert spec.restart_of("master").policy == "never"


def test_restart_never_is_the_default():
    spec = load_spec(_linreg_spec(_free_ports(5)))
    assert spec.restartable_roles() == []
    assert spec.restart_of("member0").policy == "never"
    comm = spec.make_communicator("member0")
    try:
        assert comm.cfg.strict_eof is False
    finally:
        comm.close()


def test_chaos_callbacks_as_in_jax():
    raw = _linreg_spec(_free_ports(5),
                       chaos={"role": ["member0", "member1"], "step": 3,
                              "scenario": "crash", "repeat": True})
    spec = load_spec(raw)
    for role in ("master", "member0", "member1"):
        got = cluster._chaos_callbacks(spec, role)
        want = jcluster._chaos_callbacks(jcluster.load_spec(raw), role)
        assert [type(c).__name__ for c in got] \
            == [type(c).__name__ for c in want]
        assert [c.step for c in got] == [c.step for c in want]


_PROVIDERS = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import json
from repro_torch.launch.cluster import load_spec
out = {}
for path in sys.argv[1:]:
    spec = load_spec(path)
    for role in spec.world():
        d = spec.build_data(role)
        out[f"{path}:{role}"] = None if d is None else [
            type(d).__module__, len(d.ids), list(d.x.shape)]
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[k] is not None)
assert not leaked, leaked
print(json.dumps(out))
"""


def test_jax_provider_names_resolve_to_the_port():
    """The committed specs name ``repro.launch.cluster:...`` providers;
    with ``jax`` and ``repro`` blocked, the port builds every role's
    data from its own counterparts. The data equal the JAX package's."""
    paths = [str(SPECS / n) for n in COMMITTED]
    out = subprocess.run(
        [sys.executable, "-c", _PROVIDERS, *paths], capture_output=True,
        text=True, timeout=300, cwd=str(REPO / "src"),
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    built = json.loads(out.stdout.splitlines()[-1])
    assert {k: v for k, v in built.items() if v is not None}
    for key, got in built.items():
        if got is not None:
            assert got[0].startswith("repro_torch."), key
    assert cluster.provider_module("repro.launch.cluster") \
        == "repro_torch.launch.cluster"
    assert cluster.provider_module("repro") == "repro_torch"
    assert cluster.provider_module("my_lab.data") == "my_lab.data"
    assert cluster.provider_module("reproducible.x") == "reproducible.x"
    for name in COMMITTED:
        spec, jspec = load_spec(SPECS / name), jcluster.load_spec(SPECS / name)
        for role in spec.world():
            got, want = spec.build_data(role), jspec.build_data(role)
            if want is None:
                assert got is None
                continue
            assert list(got.ids) == list(want.ids)
            np.testing.assert_array_equal(got.x, want.x)
            if hasattr(want, "y"):
                np.testing.assert_array_equal(got.y, want.y)


# ---------------------------------------------------------------------------
# VFLJob.from_spec against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("framing", ["sock", "grpc"])
def test_from_spec_linreg_equals_jax(framing, port_certs):
    """linreg is numpy in both packages: losses and member weights equal
    at rtol 0. The port runs over TLS (the gRPC framing's fixed client
    path included); the JAX package in thread mode, which every one of
    its modes equals, so that its transports' TLS faults (ROADMAP Queue
    3) stay out of the port's tests."""
    ports = _free_ports(5)
    jax_fit, jax_res = _from_spec(JaxJob, _linreg_spec(ports),
                                  mode="thread")
    got_fit, got_res = _from_spec(
        VFLJob, _linreg_spec(ports, tls_dir=port_certs.dir,
                             framing=framing), device="cpu")
    np.testing.assert_allclose(_losses(got_fit), _losses(jax_fit),
                               rtol=0, atol=0)
    for j in range(2):
        np.testing.assert_allclose(got_res[f"member{j}"]["w"],
                                   jax_res[f"member{j}"]["w"],
                                   rtol=0, atol=0)


def test_from_spec_per_edge_comm_equals_jax():
    """A ``[comm.a.b]`` edge reaches only its two agents' transports
    (``VFLJob(comm_cfgs=)``): the master's link to member1 shaped, the
    rest not; the run still equals the JAX package's at rtol 0."""
    raw = _linreg_spec(_free_ports(5))
    raw["comm"]["master"] = {"member1": {"latency_ms": 5.0,
                                         "timeout": 20.0}}
    spec = load_spec(raw)
    assert spec.comm_for("member0") is spec.comm
    assert spec.comm_for("master").peer_overrides["member1"].timeout \
        == 20.0
    jax_fit, jax_res = _from_spec(JaxJob, raw, mode="thread")
    got_fit, got_res = _from_spec(VFLJob, raw, device="cpu")
    np.testing.assert_allclose(_losses(got_fit), _losses(jax_fit),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got_res["member1"]["w"],
                               jax_res["member1"]["w"], rtol=0, atol=0)
    assert got_res["master"]["comm"]["sent_bytes"] \
        == jax_res["master"]["comm"]["sent_bytes"]


def _from_spec(job_cls, raw, **kw):
    job = job_cls.from_spec(raw, pipeline_depth=1, **kw)
    fit = job.fit()
    return fit, job.shutdown()


def _losses(fit):
    return np.array([h["loss"] for h in fit["history"]])


def _splitnn_spec(epochs):
    raw = _linreg_spec(_free_ports(5), epochs=epochs)
    raw["protocol"] = {"name": "split_nn", "epochs": epochs,
                       "batch_size": 64, "lr": 0.1, "seed": 0,
                       "use_psi": False, "embedding_dim": 8,
                       "hidden": [16], "tower": list(NARROW),
                       "top_tower": list(TOP)}
    raw["data"] = {"provider": "repro.launch.cluster:quickstart_data",
                   "seed": 0}
    raw["agents"] = {k: v for k, v in raw["agents"].items()
                     if k != "member1"}
    raw["hosts"]["alpha"]["agents"] = ["master"]
    raw["hosts"]["beta"]["agents"] = ["member0"]
    return raw


@pytest.fixture(scope="module")
def splitnn_cut(tmp_path_factory):
    """A JAX split-NN checkpoint after one epoch (5 rounds) of the
    quickstart spec's data through a narrow transformer tower. Both
    packages run the spec in thread mode here: the transports are held
    elsewhere, and the JAX package's own can fail under load (ROADMAP
    Queue 3)."""
    d = tmp_path_factory.mktemp("cluster_cut")
    job = JaxJob.from_spec(_splitnn_spec(1), mode="thread",
                           callbacks=[JaxCheckpointer(d)])
    assert job.fit()["history"]
    job.shutdown()
    return d


def test_from_spec_split_nn_matches_jax(splitnn_cut, monkeypatch):
    from test_torch_train import _CodeFlips
    flips = _CodeFlips(monkeypatch)
    raw = _splitnn_spec(3)
    jjob = JaxJob.from_spec(raw, mode="thread", resume_dir=str(splitnn_cut))
    want = _losses(jjob.fit())
    jjob.shutdown()
    job = VFLJob.from_spec(raw, mode="thread", resume_dir=str(splitnn_cut),
                           device="cpu")
    got = _losses(job.fit())
    job.shutdown()
    assert len(got) == len(want) == 15      # the cut's 5 rounds, then 10
    np.testing.assert_array_equal(got[:5], want[:5])
    first = min(flips.rounds(), default=len(got))
    np.testing.assert_allclose(got[:first], want[:first], rtol=1e-5)
    np.testing.assert_allclose(got[first:], want[first:], rtol=1e-4)
    assert np.isfinite(got).all()


# ---------------------------------------------------------------------------
# two launchers on localhost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("framing", ["sock", "grpc"])
def test_two_launchers_tls_converge(tmp_path, port_certs, framing,
                                    one_thread_agents):
    raw = _linreg_spec(_free_ports(5), tls_dir=port_certs.dir,
                       framing=framing)
    codes = _run_pair(load_spec(raw), tmp_path)
    assert codes == {"alpha": 0, "beta": 0}
    summary = json.loads((tmp_path / "alpha" / "summary.json").read_text())
    fit = summary["agents"]["master"]["fit"]
    assert fit["final_loss"] < fit["first_loss"]
    assert fit["steps"] == 12
    assert summary["agents"]["master"]["comm"]["sent_bytes"] > 0
    for host, role in (("alpha", "master"), ("alpha", "member0"),
                       ("beta", "member1")):
        assert (tmp_path / host / f"{role}.log").exists()
    assert json.loads((tmp_path / "beta" / "pids.json").read_text())
    # the same spec in-process: the same last loss, bit for bit
    job = VFLJob.from_spec(raw, device="cpu")
    last = job.fit()["history"][-1]["loss"]
    job.shutdown()
    assert fit["final_loss"] == last


def test_member_crash_fails_both_launchers_with_traceback(
        tmp_path, capfd, one_thread_agents):
    spec = load_spec(_linreg_spec(_free_ports(5), epochs=100,
                                  chaos={"role": "member1", "step": 5}))
    t0 = time.monotonic()
    codes = _run_pair(spec, tmp_path)
    assert codes == {"alpha": 1, "beta": 1}
    assert time.monotonic() - t0 < 60.0
    err = capfd.readouterr().err
    assert "chaos: injected crash at step 5" in err
    assert "member1" in err
    assert not (tmp_path / "alpha" / "summary.json").exists()


def test_correlated_member_crashes_fail_both_launchers(
        tmp_path, capfd, one_thread_agents):
    spec = load_spec(_linreg_spec(
        _free_ports(5), epochs=100,
        chaos={"role": ["member0", "member1"], "step": 5}))
    t0 = time.monotonic()
    codes = _run_pair(spec, tmp_path)
    assert codes == {"alpha": 1, "beta": 1}
    assert time.monotonic() - t0 < 60.0
    assert "chaos: injected crash at step 5" in capfd.readouterr().err
    assert not (tmp_path / "alpha" / "summary.json").exists()


def test_sigkilled_member_detected_within_seconds(tmp_path,
                                                  one_thread_agents):
    spec = load_spec(_linreg_spec(
        _free_ports(5), epochs=500,
        comm={"framing": "sock", "timeout": 120.0,
              "barrier_timeout": 60.0, "link": {"latency_ms": 25.0}}))
    codes = {}

    def _one(host):
        codes[host] = ClusterLauncher(spec, host, log_dir=tmp_path / host,
                                      device="cpu").run()
    ts = [threading.Thread(target=_one, args=(h,))
          for h in ("alpha", "beta")]
    for t in ts:
        t.start()
    pids = tmp_path / "beta" / "pids.json"
    deadline = time.monotonic() + 60
    while not pids.exists() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert pids.exists(), "beta never reached readiness"
    time.sleep(3.0)                          # let training get going
    t0 = time.monotonic()
    os.kill(json.loads(pids.read_text())["member1"], signal.SIGKILL)
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts), "launchers hung after SIGKILL"
    assert time.monotonic() - t0 < 30.0
    assert codes == {"alpha": 1, "beta": 1}


def test_restart_policy_rejoins_and_completes(tmp_path, one_thread_agents):
    """The chaos crash kills member1 mid-fit; its launcher respawns it (a
    new process, resuming from its checkpoint), the master pauses for the
    rejoin and every announced round completes."""
    spec = load_spec(_linreg_spec(
        _free_ports(5), epochs=6,
        chaos={"role": "member1", "step": 5},
        restart={"member1": {"policy": "on_failure",
                             "backoff_s": 0.2, "backoff_max_s": 1.0}}))
    t0 = time.monotonic()
    codes = _run_pair(spec, tmp_path)
    assert codes == {"alpha": 0, "beta": 0}
    master = json.loads((tmp_path / "alpha" / "summary.json")
                        .read_text())["agents"]["master"]
    assert master["fit"]["steps"] == 24          # 6 epochs x 4 batches
    assert master["fit"]["final_loss"] < master["fit"]["first_loss"]
    rec = master["recoveries"]
    assert [r["role"] for r in rec] == ["member1"]
    assert rec[0]["wait_s"] < 15.0
    assert time.monotonic() - t0 < 120.0
    assert (tmp_path / "beta" / "pids.json").exists()


def test_cuda_launcher_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    spec = load_spec(_linreg_spec(_free_ports(5)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterLauncher(spec, "alpha", log_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VFLJob.from_spec(_linreg_spec(_free_ports(5)))


# ---------------------------------------------------------------------------
# the TCP transports under TLS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", [SocketCommunicator, GrpcCommunicator])
def test_tls_fresh_connections_send_at_once(cls, port_certs):
    """Forty pairs, one after another in one process, each sending 20
    messages both ways as its connections open: every message arrives.
    Before the gRPC client's reads and writes took turns, about half of
    such pairs lost their TLS stream (a bad record MAC, a timed-out
    receive); before a closed connection was shut down first, a few in a
    hundred met a thread of an earlier pair acting on a reused fd."""
    cfg = CommCfg(timeout=10.0, tls=port_certs.templated_spec())
    for it in range(40):
        addrs = local_addresses(["a", "b"])
        a, b = cls("a", addrs, comm_cfg=cfg), cls("b", addrs, comm_cfg=cfg)
        errs = []

        def run(me, peer, mine, theirs):
            try:
                for i in range(20):
                    me.send(peer, f"{mine}{i}",
                            {"x": np.full(64, i, np.float32)})
                for i in range(20):
                    assert me.recv(peer, f"{theirs}{i}").tensor("x")[0] == i
            except Exception as e:              # noqa: BLE001
                errs.append(repr(e))
        ts = [threading.Thread(target=run, args=(a, "b", "x", "y")),
              threading.Thread(target=run, args=(b, "a", "y", "x"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        a.close()
        b.close()
        assert not errs, (it, errs)


@pytest.mark.parametrize("tls", [False, True])
def test_grpc_idle_connection_outlives_the_timeout(tls, port_certs):
    """The transport timeout bounds waits for a message, not the silence
    of a server on a client connection: a gRPC client connection idle for
    longer than it still carries the next message."""
    cfg = CommCfg(timeout=0.5,
                  tls=port_certs.templated_spec() if tls else None)
    addrs = local_addresses(["a", "b"])
    a = GrpcCommunicator("a", addrs, comm_cfg=cfg)
    b = GrpcCommunicator("b", addrs, comm_cfg=cfg)
    try:
        a.send("b", "t0", {"x": np.zeros(2)})
        assert b.recv("a", "t0").tag == "t0"
        time.sleep(1.5)
        a.send("b", "t1", {"x": np.ones(2)})
        assert b.recv("a", "t1").tensor("x")[0] == 1.0
    finally:
        a.close()
        b.close()
