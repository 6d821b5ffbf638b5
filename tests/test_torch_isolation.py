"""The PyTorch port stands alone: every module of ``repro_torch`` imports
and its tower runs on the CPU with ``jax`` and the JAX package blocked,
and no source of the port (nor ``chip_smoke.py``) imports either."""
import ast
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
with torch.no_grad():
    y = tower.apply(spec, params, torch.randn(3, 13))
assert y.shape == (3, 8) and torch.isfinite(y).all()
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
