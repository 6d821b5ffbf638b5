"""Spec-based parameters of the PyTorch port's model zoo, the counterpart
of the JAX package's ``repro/models/params.py``.

Each layer module defines a *spec tree*: nested dicts whose leaves are
:class:`Spec` (shape + logical axes + initializer). ``init_tree`` turns
it into tensors; ``stack(spec, n)`` prepends a layer dimension, so a
stack of layers is stored stacked and walked by index.

``init_tree`` draws from an explicit ``torch.Generator`` on the target
device (the JAX package's per-path ``jax.random`` stream cannot be
reproduced), with the same distributions. ``from_numpy`` / ``to_numpy``
carry a JAX-made tree (nested dicts of stacked leaves, through
``np.asarray``) across unchanged, so one set of weights drives either
package. ``abstract_tree`` gives the shapes and dtypes as tensors on
PyTorch's ``meta`` device (nothing is allocated: a 398-billion-parameter
spec is described, never built), ``axes_tree`` the logical axes, both
equal to the JAX package's. ``tree_map`` and ``tree_items`` walk a
param tree (nested dicts, and lists for the split-NN towers) in the JAX
package's flattening order: dict keys sorted, list entries in order.

On a mesh of more than one device a param tree is *placed*:
``place_tree`` turns each leaf and its ``PartitionSpec`` (from
``launch.steps.resolve_param_shardings``) into a ``sharding.rules.Parts``
of per-position parts, and ``whole_tree`` is its inverse. ``tree_map``,
``tree_items`` and ``tree_leaves`` walk into a ``Parts``: each part is a
leaf, so autograd and the elementwise optimizers treat the parts as
they treat whole leaves.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.sharding.rules import PartitionSpec, Parts, place

PyTree = Any
Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device that this machine
    does not have raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch sees no CUDA device; pass "
            f"device='cpu' to run on the CPU")
    return dev


@dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev multiplier (normal) or value
    dtype: Any = None             # override param dtype (e.g. fp32 norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec rank mismatch: {self.shape} vs "
                             f"{self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def _map_specs(fn: Callable[[Tuple[str, ...], Spec], Any], tree: PyTree,
               path: Tuple[str, ...] = ()) -> PyTree:
    if is_spec(tree):
        return fn(path, tree)
    return {k: _map_specs(fn, v, path + (k,)) for k, v in tree.items()}


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree
             ) -> PyTree:
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of the
    trees in ``rest``, which share its structure (a leaf of ``tree`` may
    face a subtree in ``rest``, as an optimizer slot does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if isinstance(tree, Parts):
        return tree.with_parts([fn(p, *(r.parts[i] for r in rest))
                                for i, p in enumerate(tree.parts)])
    return fn(tree, *rest)


def tree_items(tree: PyTree, path: Tuple[str, ...] = ()
               ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in the JAX package's flattening order: dict
    keys sorted, list entries by index (the path holds ``str(index)``)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_items(v, path + (str(i),))]
    if isinstance(tree, Parts):
        return [(path + (str(i),), p) for i, p in enumerate(tree.parts)]
    return [(path, tree)]


def tree_leaves(tree: PyTree) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_items`'s order."""
    return [leaf for _, leaf in tree_items(tree)]


def init_tree(spec: PyTree, generator: torch.Generator,
              param_dtype: torch.dtype = torch.float32,
              device: Device = "cuda") -> PyTree:
    """Concrete params for ``spec`` on ``device``, drawn from
    ``generator`` (which must live on that device): normal with std
    ``scale / sqrt(fan_in)`` where ``fan_in`` is the product of all but
    the last dim (a stacked leaf's layer dim included, as in the JAX
    package), ``zeros``, or ``ones`` times ``scale``. Draws happen on
    the device: an 8-billion-parameter model is never built on the
    host."""
    dev = resolve_device(device)

    def leaf(_, s: Spec):
        dtype = s.dtype or param_dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        if s.init == "ones":
            return torch.full(s.shape, s.scale, dtype=dtype, device=dev)
        fan_in = s.shape[0] if len(s.shape) == 1 else int(
            np.prod(s.shape[:-1]))
        std = s.scale / max(1.0, fan_in) ** 0.5
        # drawn in f32 (in place, no temporary) and cast, as JAX does
        x = torch.empty(s.shape, dtype=torch.float32, device=dev)
        x.normal_(0.0, std, generator=generator)
        return x if dtype == torch.float32 else x.to(dtype)
    return _map_specs(leaf, spec)


def abstract_tree(spec: PyTree, param_dtype: torch.dtype = torch.float32
                  ) -> PyTree:
    """The params' shapes and dtypes, as tensors on the ``meta`` device:
    nothing is allocated."""
    def leaf(_, s: Spec):
        return torch.empty(s.shape, dtype=s.dtype or param_dtype,
                           device="meta")
    return _map_specs(leaf, spec)


def axes_tree(spec: PyTree) -> PyTree:
    """Each param's logical axes (the names the JAX package's sharding
    rules resolve)."""
    return _map_specs(lambda _, s: s.axes, spec)


def stack(spec: PyTree, n: int, axis_name: str = "layers") -> PyTree:
    """Prepend a layer dimension of size ``n`` to every leaf."""
    def leaf(_, s: Spec):
        return replace(s, shape=(n,) + s.shape, axes=(axis_name,) + s.axes)
    return _map_specs(leaf, spec)


def param_bytes(spec: PyTree, bytes_per_el: int = 2) -> int:
    total = 0

    def leaf(_, s: Spec):
        nonlocal total
        total += int(np.prod(s.shape)) * bytes_per_el
    _map_specs(leaf, spec)
    return total


def tree_slice(tree: PyTree, i) -> PyTree:
    """Index the leading (layer) dim of every leaf."""
    return tree_map(lambda x: x[i], tree)


def unstack(tree: PyTree, n: int) -> List[PyTree]:
    """The ``n`` slices of every leaf's leading (layer) dim as ``n``
    trees, through one ``unbind`` a leaf: under autograd its backward
    writes the stacked gradient once, where a slice a layer would add a
    zero-filled stacked gradient per layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, Parts):
        if tree.spec[0] is not None:
            raise ValueError(f"a stacked leaf's layer dim is split: "
                             f"{tree.spec}")
        per = [p.unbind(0) for p in tree.parts]
        spec = PartitionSpec(*tree.spec[1:])
        return [Parts(spec, tree.shape[1:], tree.mesh, [u[i] for u in per])
                for i in range(n)]
    return list(tree.unbind(0))


def from_numpy(tree: PyTree, device: Device = "cuda") -> PyTree:
    """A param tree of numpy arrays (a JAX-made tree through
    ``np.asarray``) as tensors on ``device``, in the same layout and
    dtypes. Values are copied, never reinterpreted."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.as_tensor(np.array(a, copy=True)).to(dev), tree)


def to_numpy(tree: PyTree) -> PyTree:
    """The inverse of :func:`from_numpy`: the tree as numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def place_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """``tree`` with each leaf of one dim or more split by its spec
    (a tree like it of ``PartitionSpec``) over ``mesh`` as a ``Parts``;
    a scalar (an optimizer's ``count``) goes whole to the mesh's first
    device."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if tree.dim() == 0:
        return tree.to(mesh.devices.reshape(-1)[0])
    return place(tree, specs, mesh)


def whole_tree(tree: PyTree, device: Optional[Device] = None) -> PyTree:
    """The inverse of :func:`place_tree`: each ``Parts`` assembled whole
    (on ``device``, else its first part's); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: whole_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(whole_tree(v, device) for v in tree)
    if isinstance(tree, Parts):
        return tree.whole(device)
    return tree
