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
``core/vfl_step.py``). So the JAX package's ``constrain``, a layout
hint to XLA whose values never depend on it, has no counterpart, and
neither has its ``shard_map`` wrapper: the port writes its collectives
out (``launch/mesh.py``). Nor has ``reduce_dtype``: it asks a promoting
``jnp.einsum`` for a bf16 result, and a product of bf16 tensors in torch
is bf16 already (the port's weights and activations share a dtype,
``models/layers.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

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
