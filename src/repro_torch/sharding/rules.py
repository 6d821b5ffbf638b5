"""Logical-axis sharding rules of the port, the counterpart of the JAX
package's ``repro/sharding/rules.py``: rules resolve logical names ->
mesh axes with divisibility fallback.

Params and activations carry *logical* axis names ("embed", "heads",
"mlp", ...). A :class:`MeshRules` binds them to mesh axes ("pod", "data",
"model"). Resolution drops a mesh axis when the dimension size is not
divisible by it (e.g. glm4's 2 KV heads on a 16-way model axis fall back
to replication) — every fallback is recorded, in the JAX package's words
and order.

The tables are the JAX package's, copied. What differs is what a spec
drives: the JAX package hands specs to XLA, which partitions the
program; in the port the modules that shard read the resolved specs and
place each mesh position's share on its device themselves
(``models/tower.py``, ``models/decode_sharded.py``,
``core/vfl_step.py``, and the zoo's train and prefill steps through
:class:`Parts`, which :func:`place` makes of a whole tensor and its
spec: params, optimizer slots and the batch by its batch dim). The JAX
package's ``constrain``, a layout hint to XLA whose values never depend
on it, is read once: where the residual stream's ``("batch", "seq",
"embed")`` spec gives the sequence the ``model`` axis (the dry-run's
``seqshard`` lever, ``launch/dryrun.py``), a step's :class:`Layout`
keeps each row between layers as sequence cells over ``model``
(Megatron-style sequence parallelism); inside a layer the port picks
its own layout. :func:`place` sends each part to its position under
``launch/mesh.py``'s ``scatter`` name, so a trace of a step files the
batch's placement with the collectives. Its
``shard_map`` wrapper has no counterpart: the port writes its
collectives out (``launch/mesh.py``). Nor has
``reduce_dtype``: it asks a promoting ``jnp.einsum`` for a bf16 result,
and a product of bf16 tensors in torch is bf16 already (the port's
weights and activations share a dtype, ``models/layers.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch import mesh as M


class PartitionSpec(tuple):
    """One entry a dim: None (replicated), a mesh axis name, or a tuple
    of names (a joint axis). A tuple, so it compares equal to the JAX
    package's ``PartitionSpec`` of the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

# logical axis -> preferred mesh axes (tried in order, tuple = joint)
PARAM_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "embed": ("data",),          # FSDP shard of weight matrices
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert_mlp": None,          # experts already shard over model
    "experts": ("model",),
    "experts_dp": None,          # data-parallel experts
    "vocab": ("model",),
    "kv_lora": None,
    "q_lora": None,
    "head_dim": None,
    "layers": None,
    "state": None,
    "conv": None,
    # dt_rank stays replicated: sharding it makes the dt_proj contraction
    # all-reduce the full d_inner activation of every mamba layer
    "dt_rank": None,
    "d_inner": ("model",),
    "frames": None,
}

TRAIN_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "experts_dp": None,
    "expert_mlp": None,
    "vocab": ("model",),
    "head_dim": None,
    "kv_lora": None,
    "q_lora": None,
    "state": None,
    "d_inner": ("model",),
    "cache_seq": ("model",),
    "frames": None,
}

# decode: batch over data only (pod reserved for parties / spare DP),
# KV-cache sequence over model (partial-softmax combine).
DECODE_RULES = dict(TRAIN_RULES)
DECODE_RULES["batch"] = ("data",)


@dataclass
class MeshRules:
    mesh: object
    param_rules: Dict[str, Optional[Tuple[str, ...]]] = field(
        default_factory=lambda: dict(PARAM_RULES))
    act_rules: Dict[str, Optional[Tuple[str, ...]]] = field(
        default_factory=lambda: dict(TRAIN_RULES))
    fallbacks: List[str] = field(default_factory=list)

    def _axis_size(self, names: Sequence[str]) -> int:
        size = 1
        for n in names:
            size *= self.mesh.shape[n]
        return size

    def spec(self, logical: Sequence[Optional[str]], shape: Sequence[int],
             rules: Dict[str, Optional[Tuple[str, ...]]],
             what: str = "") -> PartitionSpec:
        used: set = set()
        parts = []
        for name, dim in zip(logical, shape):
            target = rules.get(name) if name else None
            if target is None:
                parts.append(None)
                continue
            target = tuple(a for a in target
                           if a in self.mesh.shape and a not in used)
            if not target or dim % self._axis_size(target) != 0:
                if target:
                    self.fallbacks.append(
                        f"{what}: dim {name}={dim} not divisible by "
                        f"{target} (size {self._axis_size(target)}) -> replicated")
                parts.append(None)
                continue
            used.update(target)
            parts.append(target if len(target) > 1 else target[0])
        return PartitionSpec(*parts)

    def param_spec(self, logical, shape) -> PartitionSpec:
        """The JAX package's ``param_sharding``: in the port a sharding
        is its spec."""
        return self.spec(logical, shape, self.param_rules, "param")

    def act_spec(self, logical, shape) -> PartitionSpec:
        return self.spec(logical, shape, self.act_rules, "act")


_current: contextvars.ContextVar[Optional[MeshRules]] = \
    contextvars.ContextVar("mesh_rules", default=None)


def current_rules() -> Optional[MeshRules]:
    return _current.get()


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    tok = _current.set(rules)
    try:
        yield rules
    finally:
        _current.reset(tok)


def is_axes(x) -> bool:
    """Is ``x`` one leaf of an axes tree: a tuple of names or None?"""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_in_tree_order(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of the
    trees in ``rest``, called in the JAX package's tree order (dict keys
    sorted), so the fallbacks a resolution records come in its order;
    the result keeps ``tree``'s structure. ``is_leaf`` marks leaves that
    are tuples (an axes tree's)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        got = {k: map_in_tree_order(fn, tree[k], *(r[k] for r in rest),
                                    is_leaf=is_leaf) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_in_tree_order(fn, v, *(r[i] for r in rest),
                                            is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def param_shardings(rules: MeshRules, axes_tree, abstract_params):
    """Resolve a whole axes tree to specs: a tree like
    ``abstract_params`` (anything with a ``shape``) whose leaves are
    :class:`PartitionSpec`."""
    return map_in_tree_order(
        lambda ax, ab: rules.param_spec(ax, tuple(ab.shape)),
        axes_tree, abstract_params, is_leaf=is_axes)


# ---------------------------------------------------------------------------
# placement: a whole tensor as its parts over a mesh, by its spec
# ---------------------------------------------------------------------------


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: () for None, a name's 1-tuple,
    a joint entry's names in its order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def positions(mesh, axes: Sequence[str]) -> List[Dict[str, int]]:
    """Every position over ``axes`` (name -> index), row-major in the
    order given: the order a joint spec entry numbers its chunks."""
    sizes = [mesh.shape[a] for a in axes]
    return [dict(zip(axes, idx))
            for idx in itertools.product(*(range(n) for n in sizes))]


def _joint_index(axes: Sequence[str], pos: Dict[str, int], mesh) -> int:
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + pos[a]
    return i


class Parts:
    """A whole tensor of ``shape`` split by ``spec`` over ``mesh``: one
    part for each position over the mesh axes the spec uses (``axes``,
    in mesh order), ``parts[i]`` the chunk of position ``keys[i]``, on
    that position's device (index 0 on the axes the spec does not use).
    A tensor the spec replicates is one part, on the mesh's first
    device. The tree walks of ``models/params.py`` treat each part as a
    leaf, so autograd and the elementwise optimizers see the parts."""

    def __init__(self, spec: PartitionSpec, shape: Sequence[int], mesh,
                 parts: Optional[Sequence[torch.Tensor]] = None):
        self.spec, self.shape, self.mesh = spec, tuple(shape), mesh
        used = {a for e in spec for a in entry_axes(e)}
        self.axes = tuple(a for a in mesh.axis_names if a in used)
        self.keys = positions(mesh, self.axes)
        if parts is not None and len(parts) != len(self.keys):
            raise ValueError(f"{len(parts)} parts for {len(self.keys)} "
                             f"positions of {spec}")
        self.parts = None if parts is None else list(parts)

    def with_parts(self, parts: Sequence) -> "Parts":
        return Parts(self.spec, self.shape, self.mesh, parts)

    def slices(self, pos: Dict[str, int], skip: Sequence[str] = ()
               ) -> Tuple[slice, ...]:
        """The part at ``pos`` as slices of the whole; a dim split over
        an axis in ``skip`` is left whole (its slices are those of the
        tensor the other axes' parts assemble)."""
        out = []
        for entry, n in zip(self.spec, self.shape):
            axes = entry_axes(entry)
            if not axes or set(axes) & set(skip):
                out.append(slice(None))
                continue
            size = 1
            for a in axes:
                size *= self.mesh.shape[a]
            c = n // size
            i = _joint_index(axes, pos, self.mesh)
            out.append(slice(i * c, (i + 1) * c))
        return tuple(out) + (slice(None),) * (len(self.shape)
                                              - len(self.spec))

    def part_shape(self, pos: Dict[str, int]) -> Tuple[int, ...]:
        """The shape of the part at ``pos``."""
        return tuple(len(range(n)[sl])
                     for sl, n in zip(self.slices(pos), self.shape))

    def part(self, **pos: int) -> torch.Tensor:
        """The part of the position ``pos`` (axes the spec does not use
        are ignored)."""
        return self.parts[self.keys.index(
            {a: pos.get(a, 0) for a in self.axes})]

    def whole(self, device=None) -> torch.Tensor:
        """The parts assembled on ``device`` (the first part's when
        None), a fresh tensor."""
        first = self.parts[0]
        out = torch.empty(self.shape, dtype=first.dtype,
                          device=device or first.device)
        for key, p in zip(self.keys, self.parts):
            out[self.slices(key)] = p.detach().to(out.device)
        return out


def place(t: torch.Tensor, spec: PartitionSpec, mesh) -> Parts:
    """``t`` split by ``spec`` over ``mesh``, each part a contiguous
    copy on its position's device; ``Parts.whole`` is the inverse."""
    spec = PartitionSpec(*(tuple(spec) + (None,) * (t.dim() - len(spec))))
    for entry, n in zip(spec, t.shape):
        size = 1
        for a in entry_axes(entry):
            size *= mesh.shape[a]
        if n % size:
            raise ValueError(f"dim {n} of {tuple(t.shape)} does not split "
                             f"over {entry} ({size})")
    out = Parts(spec, t.shape, mesh)
    src = t.detach()
    out.parts = []
    with M.collective("scatter"):
        for key in out.keys:
            chunk = src[out.slices(key)]
            out.parts.append(torch.empty(
                chunk.shape, dtype=chunk.dtype,
                device=mesh.device(**key)).copy_(chunk))
    return out


def zeros(spec: PartitionSpec, shape: Sequence[int], mesh,
          dtype: torch.dtype = torch.float32) -> Parts:
    """A whole tensor of zeros split by ``spec`` over ``mesh``, made
    part by part on each position's device (an optimizer slot of a
    placed param)."""
    out = Parts(spec, shape, mesh)
    out.parts = [torch.zeros(out.part_shape(key), dtype=dtype,
                             device=mesh.device(**key)) for key in out.keys]
    return out


class Layout:
    """Where a sharded train or prefill step runs: its rows, the batch's
    positions over the mesh axes the batch's spec splits (row-major in
    the spec's order, so row r holds the r-th chunk of the batch), and
    each row's positions over the ``model`` axis.

    Between layers row r's activations are its cells. Where the
    sequence is not split (``n_cells`` 1) the row is one tensor at its
    home, its model position 0. Where it is (``seq``: the activations'
    ``("batch", "seq", "embed")`` spec gives the sequence the ``model``
    axis) the row is a list of ``n_model`` cells, cell j the sequence
    chunk ``[j s / n, (j + 1) s / n)`` on position (r, j), and norms
    and residual adds run cell by cell (:meth:`each`). A layer that
    splits its work over ``model`` takes its input through
    :meth:`enter` and gives its partial outputs to :meth:`leave`; a
    layer that needs a row whole in one place takes it through
    :meth:`whole`."""

    def __init__(self, mesh, batch_entry=None, seq: bool = False):
        self.mesh = mesh
        self.rows = positions(mesh, entry_axes(batch_entry))
        self.n_model = mesh.shape.get("model", 1)
        self.n_cells = self.n_model if seq else 1

    def rows_whole(self) -> "Layout":
        """This layout with every row whole at its home (the encoder's
        frames, whose spec splits no sequence)."""
        out = copy.copy(self)
        out.n_cells = 1
        return out

    def cells(self, x) -> List[torch.Tensor]:
        """Row ``x``'s cells in sequence order."""
        return list(x) if self.n_cells > 1 else [x]

    def _row(self, cells: Sequence[torch.Tensor]):
        return list(cells) if self.n_cells > 1 else cells[0]

    def each(self, fn, xs, *others) -> list:
        """``fn(r, j, x, *o)`` of cell j of each row r of ``xs`` and the
        same cells of ``others`` (lists of rows like ``xs``): new rows."""
        return [self._row([fn(r, j, *c) for j, c in enumerate(zip(
            self.cells(x), *(self.cells(o[r]) for o in others)))])
            for r, x in enumerate(xs)]

    def enter(self, r: int, x, n: int) -> Tuple[torch.Tensor, ...]:
        """Row r whole on each of its first ``n`` model positions: the
        row copied from its home (``launch/mesh.py`` ``fan_out``, whose
        gradient is the positions' summed in order), or its cells
        gathered in order along the sequence (``spread``, whose gradient
        is the ordered reduce-scatter back to the cells)."""
        devs = [self.dev(r, j) for j in range(n)]
        if self.n_cells == 1:
            return M.fan_out(x, devs)
        lo = list(itertools.accumulate([0] + [c.shape[1] for c in x]))
        return M.spread(list(x), [(slice(None), slice(a, b))
                                  for a, b in zip(lo, lo[1:])], devs)

    def whole(self, r: int, x) -> torch.Tensor:
        """Row r whole at its home: ``x`` itself where the sequence is
        not split, else its cells gathered there (:meth:`enter`)."""
        return x if self.n_cells == 1 else self.enter(r, x, 1)[0]

    def leave(self, r: int, parts: Sequence[torch.Tensor]):
        """The sum of ``parts`` (whole rows, added in order: ``psum``)
        as row r: at its home, or each cell's chunk of the sequence
        summed on that cell's device (a reduce-scatter along the
        sequence; the gradient of every part is every cell's). One part
        is the row cut into its cells."""
        if self.n_cells == 1:
            return M.psum(parts, self.home(r))
        s = parts[0].shape[1]
        if s % self.n_cells:
            raise ValueError(f"a sequence of {s} does not split into "
                             f"{self.n_cells} cells")
        c = s // self.n_cells
        return [M.psum([p[:, j * c:(j + 1) * c] for p in parts],
                       self.dev(r, j)).contiguous()
                for j in range(self.n_cells)]

    def dev(self, r: int, j: int = 0) -> torch.device:
        pos = dict(self.rows[r])
        if "model" in self.mesh.shape:
            pos["model"] = j
        return self.mesh.device(**pos)

    def home(self, r: int) -> torch.device:
        return self.dev(r, 0)

    def homes(self) -> List[torch.device]:
        return [self.home(r) for r in range(len(self.rows))]

    def n_tp(self, w: Parts) -> int:
        """How many model positions share ``w``'s work: the model
        axis's size where ``w`` is split over it, else 1."""
        return self.n_model if "model" in w.axes else 1

    def model_dim(self, w: Parts) -> Optional[int]:
        """The dim of ``w`` split over ``model`` (None if none)."""
        for i, e in enumerate(w.spec):
            axes = entry_axes(e)
            if "model" in axes:
                if len(axes) > 1:
                    raise ValueError(f"a joint entry {e} with the model "
                                     f"axis is not taken here")
                return i
        return None

    def weights(self, w: Parts, n: int,
                rows: Optional[Sequence[int]] = None
                ) -> List[List[torch.Tensor]]:
        """``[j][r]``: what position (r, j) holds of ``w``, for the
        first ``n`` model positions and each r in ``rows`` (every row by
        default): its part of the model axis (all of it where ``w`` is
        not split there), gathered whole over every other axis on that
        position's device. One ``launch/mesh.py`` ``spread`` serves
        every position that holds the same parts, so a gradient is
        summed over them in mesh order and reduce-scattered back to the
        parts, never left to autograd's accumulation. A whole part
        asked for by one position, on its own device, is the part
        itself."""
        rows = list(range(len(self.rows)) if rows is None else rows)
        md = self.model_dim(w)
        if md is None:
            targets = [(r, j) for r in rows for j in range(n)]
            got = self._spread(w, w.keys, w.parts, targets)
            return [[got[i * n + j] for i in range(len(rows))]
                    for j in range(n)]
        if n != self.n_model:
            raise ValueError(f"{w.spec} splits over all {self.n_model} "
                             f"model positions, {n} asked for")
        out = []
        for j in range(n):
            keys = [(k, p) for k, p in zip(w.keys, w.parts)
                    if k["model"] == j]
            out.append(self._spread(w, [k for k, _ in keys],
                                    [p for _, p in keys],
                                    [(r, j) for r in rows]))
        return out

    def columns(self, w: Parts, cols: Sequence[Sequence[Tuple[int, int]]]
                ) -> List[List[torch.Tensor]]:
        """``[j][r]``: for model position j of each row, the ranges
        ``cols[j]`` ((lo, hi) of the whole of ``w``'s dim split over
        ``model``) cut from the model parts and concatenated in order,
        on that position's device, each part first gathered over the
        other axes (``weights``). A column map for a weight whose model
        parts are not the columns a position computes with (Mamba's
        ``w_in``, whose u and z halves each split over ``model``). The
        pieces a part gives are disjoint, so their gradients add into it
        exactly, in any order, before the gather's ordered
        reduce-scatter."""
        md = self.model_dim(w)
        parts = self.weights(w, self.n_model)
        c = w.shape[md] // self.n_model
        out = []
        for j, ranges in enumerate(cols):
            at_j = []
            for r in range(len(self.rows)):
                pieces = []
                for lo, hi in ranges:
                    for p in range(lo // c, (hi - 1) // c + 1):
                        a, b = max(lo, p * c), min(hi, (p + 1) * c)
                        pieces.append(parts[p][r].narrow(md, a - p * c,
                                                         b - a))
                pieces = M.scatter(pieces, [self.dev(r, j)] * len(pieces))
                at_j.append(torch.cat(pieces, md))
            out.append(at_j)
        return out

    def _spread(self, w: Parts, keys, parts, targets) -> List[torch.Tensor]:
        devs = [self.dev(r, j) for r, j in targets]
        if len(parts) == 1 and len(devs) == 1 and parts[0].device == devs[0]:
            return [parts[0]]
        return list(M.spread(parts, [w.slices(k, skip=("model",))
                                     for k in keys], devs))
