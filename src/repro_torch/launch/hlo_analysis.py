"""What an eager step moves and holds, the counterpart of the JAX
package's ``repro/launch/hlo_analysis.py`` (kept under its name so that
a reader finds it).

The port has no HLO: a step runs eagerly, one op at a time, and its
collectives are written out (``launch/mesh.py``). So the facts the JAX
package reads from a compiled module come here from a run of the step
itself on a mesh of fake devices (:func:`fake_devices`): under
``FakeTensorMode`` a tensor on ``meta:i`` keeps its index, nothing is
allocated, and an op that mixes two positions without a collective
raises. :class:`StepTracker`, a
``TorchDispatchMode`` entered inside the fake mode, records while the
step runs:

* **memory**: each position's live bytes by storage lifetime (a
  storage counted once, whatever views it has, and freed when its last
  tensor goes), from the tensors :meth:`StepTracker.hold` names at the
  start (params, optimizer slots, the batch), and each position's peak;
* **transfers**: every copy between two positions (``aten._to_copy``,
  ``copy_`` across devices) as the bytes its destination receives,
  filed under the ``launch/mesh.py`` collective that made it
  (``mesh.current_collective``), or, in the backward, under the
  collective that tagged the copy's autograd node, with ``_bwd``
  appended; a copy under no collective is filed as ``unlabelled``,
  never dropped;
* **kernel calls**: the hand kernels' trace-route calls
  (``kernels/ops.py`` ``TRACE_COUNTERS``).

Byte convention: what each position actually receives. The port's
collectives gather to one device and copy out (``mesh.psum`` sends
n - 1 parts to one position, ``mesh.spread`` a whole to each target),
and the inventory shows that as it is; it is not the JAX package's ring
convention (all-reduce as twice the result a device). ``mult`` is 1:
an eager step runs every call, there is no loop body counted once, and
so ``loop_trip_counts`` has no counterpart.
"""
from __future__ import annotations

import collections
import os
import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels._build import TRACE_TYPES
from repro_torch.kernels.ops import TRACE_COUNTERS
from repro_torch.launch import mesh as M
from repro_torch.sharding.rules import Parts

aten = torch.ops.aten
UNLABELLED = "unlabelled"
_HERE = (os.path.abspath(M.__file__), os.path.abspath(__file__))
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class CollectiveRecord:
    op: str            # the collective's name, "<name>_bwd", or UNLABELLED
    bytes: int         # what the destination position receives
    mult: int          # 1: an eager step runs every call
    computation: str   # the port's function that made the copy
    src: int = 0       # the sending position
    dst: int = 0       # the receiving position

    @property
    def total(self) -> int:
        return self.bytes * self.mult


@dataclass
class HloReport:
    collectives: List[CollectiveRecord] = field(default_factory=list)

    def received(self) -> Dict[int, int]:
        """Bytes received, by position."""
        out: Dict[int, int] = collections.defaultdict(int)
        for c in self.collectives:
            out[c.dst] += c.total
        return dict(out)

    def busiest(self) -> Optional[int]:
        """The position that receives the most (the lowest such)."""
        got = self.received()
        return min(got, key=lambda p: (-got[p], p)) if got else None

    @property
    def collective_bytes(self) -> int:
        """The bytes the busiest position receives: a step's collective
        bytes a device, as the JAX package's are."""
        got = self.received()
        return max(got.values()) if got else 0

    def by_op(self, position: Optional[int] = None) -> Dict[str, int]:
        """Bytes by collective that ``position`` (the busiest by
        default) receives."""
        pos = self.busiest() if position is None else position
        out: Dict[str, int] = collections.defaultdict(int)
        for c in self.collectives:
            if c.dst == pos:
                out[c.op] += c.total
        return dict(out)

    def unlabelled(self) -> Dict[str, int]:
        """Bytes no collective moved, by the function that copied them,
        over every position."""
        out: Dict[str, int] = collections.defaultdict(int)
        for c in self.collectives:
            if c.op == UNLABELLED:
                out[c.computation] += c.total
        return dict(out)


def fake_devices(n: int) -> List[str]:
    """The fake devices of a trace's ``n`` mesh positions: ``meta:p``
    for p < 256, then ``lazy:p - 256`` (``_build.TRACE_TYPES``). A
    device index is a signed byte: ``meta:200`` is ``meta:-56`` and
    ``meta:255`` plain ``meta``, each a device of its own."""
    if n > 256 * len(TRACE_TYPES):
        raise ValueError(f"a trace takes at most {256 * len(TRACE_TYPES)} "
                         f"positions, {n} asked for")
    return [f"{TRACE_TYPES[p // 256]}:{p % 256}" for p in range(n)]


def position(device: torch.device) -> Optional[int]:
    """A fake device's mesh position (:func:`fake_devices`' inverse);
    None for the host (an index tensor made on the CPU is no position's
    memory, and its copy to a position no collective)."""
    if device.type not in TRACE_TYPES:
        return None
    i = 255 if device.index is None else device.index % 256
    return 256 * TRACE_TYPES.index(device.type) + i


def _caller() -> str:
    """The innermost function of the port outside this module and
    ``launch/mesh.py``, as ``path/in/port.py:function``."""
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PORT) and path not in _HERE:
            return f"{os.path.relpath(path, _PORT)}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class StepTracker(TorchDispatchMode):
    """Memory, transfers and kernel calls of what runs inside it (see
    the module's doc). Enter it inside ``FakeTensorMode``; name the
    tensors live at the start with :meth:`hold` first."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = collections.defaultdict(int)
        self.peak: Dict[int, int] = collections.defaultdict(int)
        self.start: Dict[int, int] = {}
        self.report = HloReport()
        self.kernel_calls: Dict[str, int] = {}
        self.ops = 0
        self._storages = WeakIdKeyDictionary()
        self._calls0: Dict[str, int] = {}

    # -- memory ------------------------------------------------------------
    def hold(self, *trees) -> None:
        """Count every tensor of ``trees`` (nested dicts, lists, tuples,
        ``Parts``) as live."""
        for tree in trees:
            for t in tensors(tree):
                self._alloc(t)

    def _alloc(self, t: torch.Tensor) -> None:
        pos = position(t.device)
        if pos is None:
            return
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = pos
        self.live[pos] += n
        self.peak[pos] = max(self.peak[pos], self.live[pos])
        weakref.finalize(st, self._free, pos, n)

    def _free(self, pos: int, n: int) -> None:
        self.live[pos] -= n

    def memory(self) -> Dict[int, Dict[str, int]]:
        """By position: bytes live at the start, at the peak and now."""
        return {p: {"start": self.start.get(p, 0), "peak": self.peak[p],
                    "now": self.live[p]}
                for p in sorted(set(self.peak) | set(self.start))}

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        self.start = dict(self.live)
        self.peak = collections.defaultdict(int, self.start)
        self._calls0 = {k: c.count for k, c in TRACE_COUNTERS.items()}
        return super().__enter__()

    def __exit__(self, *exc):
        self.kernel_calls = {k: c.count - self._calls0[k]
                             for k, c in TRACE_COUNTERS.items()}
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func is aten._to_copy.default:
            self._copy(args[0], out, out)
        elif func is aten.copy_.default:
            self._copy(args[1], args[0], args[1])
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._alloc(t)
        return out

    def _copy(self, src: torch.Tensor, dst: torch.Tensor,
              moved: torch.Tensor) -> None:
        a, b = position(src.device), position(dst.device)
        if a == b or a is None or b is None:
            return
        op = M.current_collective()
        if op is None:
            node = torch._C._current_autograd_node()
            name = None if node is None else node.metadata.get(M.NODE_KEY)
            op = UNLABELLED if name is None else f"{name}_bwd"
        self.report.collectives.append(CollectiveRecord(
            op, moved.numel() * moved.element_size(), 1, _caller(), a, b))


def tensors(tree):
    """The tensors of ``tree`` (nested dicts, lists, tuples,
    ``Parts``)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Parts):
        yield from tree.parts
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


def summarize(report: HloReport) -> str:
    lines = [f"collective bytes/device: {report.collective_bytes:,}"]
    for op, b in sorted(report.by_op().items(), key=lambda kv: -kv[1]):
        lines.append(f"  {op:>22s}: {b:,}")
    for where, b in sorted(report.unlabelled().items(),
                           key=lambda kv: -kv[1]):
        lines.append(f"  unlabelled from {where}: {b:,}")
    return "\n".join(lines)
