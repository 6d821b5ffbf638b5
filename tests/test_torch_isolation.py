"""The PyTorch port stands alone: every module of ``repro_torch`` imports
and its tower (also sharded over a model axis of 2) and a mesh-mode VFL
step run on the CPU with ``jax`` and the JAX package blocked,
so do the agents a process-mode job spawns, and no source of the port
(nor ``chip_smoke.py``) imports either."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import importlib, pathlib
import torch
torch.set_num_threads(1)
root = pathlib.Path(sys.argv[1])
mods = sorted(
    ".".join(p.relative_to(root).with_suffix("").parts).replace(
        ".__init__", "")
    for p in (root / "repro_torch").rglob("*.py"))
for m in mods:
    importlib.import_module(m)
from repro_torch.models import tower
spec = tower.resolve(("embed:tokens=4,dim=16", "attn_block:heads=2",
                      "quantize", "mlp:hidden=16"), 13, 8)
params = tower.init(spec, torch.Generator().manual_seed(0), "cpu")
x = torch.randn(3, 13)
with torch.no_grad():
    y = tower.apply(spec, params, x)
assert y.shape == (3, 8) and torch.isfinite(y).all()
# the sharded paths: the tower over a model axis of 2, a mesh-mode VFL
# step of 2 masked parties (the CPU device repeated)
from repro_torch.core import vfl_step
from repro_torch.launch.mesh import make_mesh
rules = tower.make_tower_rules(2, devices=["cpu"] * 2)
with torch.no_grad():
    ys = tower.apply(spec, tower.shard_tower(params, spec, rules), x, rules)
assert ys.shape == (3, 8) and torch.isfinite(ys).all()
mesh = make_mesh((2,), ("pod",), ["cpu"] * 2)
b = vfl_step.place_party_params(
    vfl_step.init_party_params(0, 2, 6, (8,), 4), mesh)
t = vfl_step.mlp_init(torch.Generator().manual_seed(1), (4, 8, 2))
_, _, loss = vfl_step.make_mesh_vfl_step(mesh, 2)(
    b, t, torch.randn(2, 16, 6), torch.ones(16, 2), 0)
assert torch.isfinite(loss)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[k] is not None)
assert not leaked, leaked
print("ok", len(mods))
"""


def test_port_imports_and_runs_with_jax_and_repro_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT / "src")],
        capture_output=True, text=True, timeout=300,
        cwd=str(ROOT / "src"))
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.split()[-1])
    assert n == len(list(PORT.rglob("*.py")))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_BLOCKED_WORKERS = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import json, pathlib
import numpy as np
from repro_torch.core.party import VFLJob
from repro_torch.core.protocols.base import MasterData, MemberData, VFLConfig
from repro_torch.core.protocols.driver import Callback


class Imports(Callback):
    # runs in each agent's own process: records what the worker imported
    def __init__(self, out):
        self.out = out

    def on_fit_end(self, driver):
        top = sorted({k.split(".")[0] for k, m in sys.modules.items()
                      if m is not None})
        pathlib.Path(self.out, driver.role).write_text(json.dumps(top))


if __name__ == "__main__":
    out = sys.argv[1]
    rng = np.random.default_rng(0)
    ids = [f"u{i}" for i in range(48)]
    master = MasterData(ids, rng.normal(size=(48, 1)),
                        rng.normal(size=(48, 3)))
    members = [MemberData(ids, rng.normal(size=(48, 2)))]
    cfg = VFLConfig(protocol="linreg", epochs=1, batch_size=16,
                    use_psi=False)
    with VFLJob(cfg, master, members, mode="process", device="cpu",
                callbacks=[Imports(out)]) as job:
        assert len(job.fit()["history"]) == 3
    print("ok")
"""


def test_process_mode_workers_import_no_jax(tmp_path):
    """A process-mode job's spawned agents import the port alone: the
    script blocks ``jax`` and ``repro`` in the parent and, run again as
    each spawned worker's main module, in every worker, and each worker
    reports the top-level modules it holds at the end of its fit."""
    script = tmp_path / "blocked_workers.py"
    script.write_text(_BLOCKED_WORKERS)
    out = subprocess.run(
        [sys.executable, str(script), str(tmp_path)], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT / "src"),
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    for role in ("master", "member0"):
        mods = json.loads((tmp_path / role).read_text())
        assert "repro_torch" in mods and "torch" in mods
        assert not {"jax", "jaxlib", "repro"} & set(mods), mods


_BLOCKED_CLUSTER = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import atexit, json, os, pathlib, threading


def data(role, out, **kw):
    # the spec's data provider: runs in each agent's own process, the
    # respawned member's included, and records what that process holds
    # now and when it exits
    from repro_torch.launch.cluster import linreg_demo_data

    def record(when):
        top = sorted({k.split(".")[0] for k, m in sys.modules.items()
                      if m is not None})
        pathlib.Path(out, f"{role}-{os.getpid()}-{when}").write_text(
            json.dumps(top))
    record("data")
    atexit.register(record, "exit")
    return linreg_demo_data(role, **kw)


if __name__ == "__main__":
    from repro_torch.comm.sock import local_addresses
    from repro_torch.launch.cluster import ClusterLauncher, load_spec
    out = sys.argv[1]
    ports = [p for _, p in local_addresses(
        [f"p{i}" for i in range(4)]).values()]
    spec = load_spec({
        "protocol": {"name": "linreg", "epochs": 2, "batch_size": 48,
                     "lr": 0.1, "seed": 0, "use_psi": False},
        "data": {"provider": "blocked_cluster:data", "out": out},
        "comm": {"framing": "grpc", "timeout": 30.0},
        "agents": {"master": f"127.0.0.1:{ports[0]}",
                   "member0": f"127.0.0.1:{ports[1]}"},
        "hosts": {"alpha": {"control": f"127.0.0.1:{ports[2]}",
                            "agents": ["master"]},
                  "beta": {"control": f"127.0.0.1:{ports[3]}",
                           "agents": ["member0"]}},
        "chaos": {"role": "member0", "step": 3},
        "restart": {"member0": {"policy": "on_failure",
                                "backoff_s": 0.2}}})
    codes = {}

    def run(host):
        codes[host] = ClusterLauncher(
            spec, host, log_dir=pathlib.Path(out, "logs", host),
            device="cpu").run()
    ts = [threading.Thread(target=run, args=(h,)) for h in ("alpha", "beta")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(150)
    assert codes == {"alpha": 0, "beta": 0}, codes
    summary = json.loads(pathlib.Path(out, "logs", "alpha",
                                      "summary.json").read_text())
    assert [r["role"] for r in
            summary["agents"]["master"]["recoveries"]] == ["member0"]
    print("ok")
"""


def test_cluster_agents_import_no_jax(tmp_path):
    """A two-launcher run on the CPU whose member crashes and is
    respawned: every agent process, the respawned member's included,
    imports the port alone. The script blocks ``jax`` and ``repro`` in the
    launchers' process and, as the spec's data provider's module, in
    every agent; the provider records each agent's top-level modules when
    it builds the data and when the process exits."""
    script = tmp_path / "blocked_cluster.py"
    script.write_text(_BLOCKED_CLUSTER)
    out = subprocess.run(
        [sys.executable, str(script), str(tmp_path)], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT / "src"),
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    records = sorted(p.name for p in tmp_path.iterdir()
                     if p.name.startswith(("master-", "member0-")))
    members = {r.split("-")[1] for r in records
               if r.startswith("member0-")}
    assert len(members) == 2, records            # the first and the respawn
    assert any(r.startswith("master-") and r.endswith("-exit")
               for r in records), records
    for r in records:
        mods = json.loads((tmp_path / r).read_text())
        assert "repro_torch" in mods and "torch" in mods, r
        assert not {"jax", "jaxlib", "repro"} & set(mods), (r, mods)
