"""Device meshes of the port, the counterpart of the JAX package's
``repro/launch/mesh.py``.

The JAX package is single-controller: one process, ``jax.devices()`` and
a ``Mesh`` of named axes run every sharded path. The port keeps that
shape. A :class:`Mesh` is an n-d array of ``torch.device``s with axis
names; the modules that shard (``models/tower.py``'s tensor parallelism,
``core/vfl_step.py``, ``models/decode_sharded.py``, the zoo's train and
prefill steps through ``sharding/rules.py``'s ``Layout``) place each mesh
position's share of a tensor on that position's device themselves and
combine the shares with the explicit collectives below, all from one
process: no ``torch.distributed``, no spawned process.

By default a mesh takes the distinct local CUDA devices and raises when
there are too few. A caller may name the devices, and may repeat one:
the CPU tests pass the CPU device repeated, and a one-card run passes
``cuda:0`` repeated, so every split, partial product and combine runs on
one device. A mesh never reuses a device the caller did not name.

Each collective names itself while it runs (:func:`collective`), and
tags the autograd node of each copy it makes, so that a trace of a step
(``launch/hlo_analysis.py``) files every byte a position receives
under the collective that moved it, forward or backward. The name
changes no value.

No hardware constant lives here: where the port needs a rate it takes
the card's own (``chip_smoke.py``), and the dry-run's datasheet
estimate keeps its own (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """An n-d array of ``torch.device``s with one name per axis.

    ``shape`` maps each axis name to its size, in axis order, as a JAX
    mesh's does; ``devices`` is the object array itself."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} dims needs as many "
                             f"axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, **position: int) -> torch.device:
        """The device at ``position`` (axis name -> index); an axis not
        named is taken at index 0."""
        idx = tuple(position.get(a, 0) for a in self.axis_names)
        return self.devices[idx]

    def axis_devices(self, axis: str, **position: int
                     ) -> Tuple[torch.device, ...]:
        """The devices along ``axis``, the other axes at ``position``
        (index 0 where not named)."""
        return tuple(self.device(**{**position, axis: i})
                     for i in range(self.shape[axis]))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def _cuda_devices() -> Tuple[torch.device, ...]:
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``devices`` in row-major
    order: the first ``prod(shape)`` distinct local CUDA devices when
    None (a ``ValueError`` naming the count when there are fewer), else
    exactly the devices given, which may repeat one (``["cuda:0"] * 4``
    runs a four-position mesh on one card)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    if devices is None:
        have = _cuda_devices()
        if len(have) < n:
            raise ValueError(
                f"a mesh of shape {shape} needs {n} CUDA device(s), but "
                f"only {len(have)} are visible; pass devices= to place "
                f"several mesh positions on one device")
        devs = list(have[:n])
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                             f"{len(devs)} given")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence[DeviceLike]) -> Mesh:
    """The JAX package's production shapes, (16, 16) ``data x model`` or
    (2, 16, 16) ``pod x data x model``, over an explicit device list."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_local_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A ``data x model`` mesh over local devices (see :func:`make_mesh`)."""
    return make_mesh((data, model), ("data", "model"), devices)


def mesh_chips(mesh) -> int:
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n


# ---------------------------------------------------------------------------
# collectives over one mesh axis, written out: a list of per-position
# tensors combined on a target device in the axis order, so two runs
# give the same bits. None writes a position's tensor in place (on a
# repeated device, ``.to(device)`` between two positions is the same
# tensor): the combine of two parts or more is a fresh tensor.
# ---------------------------------------------------------------------------

_collective: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("collective", default=None)
# the key of an autograd node's ``metadata`` that names the collective
# whose copy made the node
NODE_KEY = "collective"


@contextlib.contextmanager
def collective(name: str) -> Iterator[None]:
    """Name the copies made inside as the collective ``name`` (an outer
    name holds: a ``psum`` inside a ``reduce_scatter`` is the
    latter's). Values do not depend on it."""
    tok = _collective.set(_collective.get() or name)
    try:
        yield
    finally:
        _collective.reset(tok)


def current_collective() -> Optional[str]:
    """The collective running now, else None."""
    return _collective.get()


def _to(x: torch.Tensor, device: DeviceLike) -> torch.Tensor:
    """``x.to(device)``, a copy's autograd node tagged with the running
    collective (its backward is that collective's)."""
    y = x.to(device)
    if y is not x and y.grad_fn is not None:
        y.grad_fn.metadata[NODE_KEY] = _collective.get()
    return y


def psum(parts: Sequence[torch.Tensor], device: DeviceLike) -> torch.Tensor:
    """The sum of ``parts`` on ``device``, added in order."""
    with collective("psum"):
        return functools.reduce(torch.add, [_to(p, device) for p in parts])


def pmax(parts: Sequence[torch.Tensor], device: DeviceLike) -> torch.Tensor:
    """The elementwise maximum of ``parts`` on ``device``."""
    with collective("pmax"):
        return functools.reduce(torch.maximum,
                                [_to(p, device) for p in parts])


def all_gather(parts: Sequence[torch.Tensor], dim: int,
               device: DeviceLike) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``device``."""
    with collective("all_gather"):
        return torch.cat([_to(p, device) for p in parts], dim=dim)


def broadcast(x: torch.Tensor, devices: Sequence[DeviceLike]
              ) -> Tuple[torch.Tensor, ...]:
    """``x`` on each of ``devices`` (the same tensor where it is there
    already: read it, do not write it)."""
    with collective("broadcast"):
        return tuple(_to(x, d) for d in devices)


def scatter(pieces: Sequence[torch.Tensor], devices: Sequence[DeviceLike]
            ) -> List[torch.Tensor]:
    """``pieces[i]`` (pieces of one whole) on ``devices[i]`` (the piece
    itself where it is there already)."""
    with collective("scatter"):
        return [_to(p, d) for p, d in zip(pieces, devices)]


def gather(parts: Sequence[torch.Tensor], device: DeviceLike
           ) -> List[torch.Tensor]:
    """Each of ``parts`` on ``device``, uncombined (the part itself where
    it is there already)."""
    with collective("gather"):
        return [_to(p, device) for p in parts]


def reduce_scatter(parts: Sequence[torch.Tensor],
                   devices: Sequence[DeviceLike],
                   slices: Sequence[Tuple[slice, ...]]
                   ) -> List[torch.Tensor]:
    """The sum of ``parts`` (added in order), and of it ``slices[i]`` on
    ``devices[i]``, a contiguous tensor each (an FSDP gradient's
    reduce-scatter: each position keeps its own chunk of the sum)."""
    with collective("reduce_scatter"):
        total = psum(parts, devices[0])
        return [_to(total[sl], d).contiguous()
                for sl, d in zip(slices, devices)]


def exclusive_prefix(parts: Sequence[torch.Tensor],
                     devices: Sequence[DeviceLike]) -> List[torch.Tensor]:
    """Position i gets the sum of ``parts[:i]`` (zeros at 0), added in
    order, on ``devices[i]``: an exclusive prefix sum over an axis."""
    with collective("exclusive_prefix"):
        acc = torch.zeros_like(parts[0])
        out = []
        for p, d in zip(parts, devices):
            out.append(_to(acc, d))
            acc = acc + _to(p, acc.device)
        return out


def _cat_dim(slices: Sequence[Tuple[slice, ...]]) -> int:
    """The dim along which ``slices`` cut a whole into consecutive
    chunks, in order."""
    dims = {d for sl in slices for d, s in enumerate(sl)
            if s != slice(None)}
    starts = [sl[min(dims)].start for sl in slices] if dims else []
    if len(dims) != 1 or starts != sorted(starts):
        raise ValueError("spread takes parts split along one dim")
    return dims.pop()


class _Spread(torch.autograd.Function):
    """Parts assembled into one whole on each target device (fresh
    tensors: a copy of a lone part, else one ``cat``); the backward sums
    the targets' gradients in target order and gives each part its
    slice of the sum (``reduce_scatter``), so no gradient is left to
    autograd's accumulation across positions."""

    @staticmethod
    def forward(ctx, slices, targets, *parts):
        ctx.set_materialize_grads(False)
        ctx.slices, ctx.devices = slices, [p.device for p in parts]
        ctx.name = _collective.get() or "spread"
        with collective(ctx.name):
            if len(parts) == 1:
                return tuple(parts[0].to(d, copy=True) for d in targets)
            dim = _cat_dim(slices)
            return tuple(torch.cat([p.to(d) for p in parts], dim)
                         for d in targets)

    @staticmethod
    def backward(ctx, *grads):
        got = [g for g in grads if g is not None]
        none = (None, None)
        if not got:
            return none + (None,) * len(ctx.devices)
        with collective(f"{ctx.name}_bwd"):
            return none + tuple(reduce_scatter(got, ctx.devices,
                                               ctx.slices))


def spread(parts: Sequence[torch.Tensor], slices: Sequence[Tuple[slice, ...]],
           targets: Sequence[DeviceLike]) -> Tuple[torch.Tensor, ...]:
    """``parts`` (part i at ``slices[i]`` of the whole, split along one
    dim) assembled on each of ``targets``: an all-gather under autograd
    whose backward is the ordered reduce-scatter."""
    return _Spread.apply(tuple(slices),
                         tuple(torch.device(d) for d in targets), *parts)


def fan_out(x: torch.Tensor, targets: Sequence[DeviceLike]
            ) -> Tuple[torch.Tensor, ...]:
    """``x`` copied onto each of ``targets``; its gradient the targets'
    gradients added in order."""
    with collective("fan_out"):
        return spread([x], [(slice(None),) * x.dim()], targets)
