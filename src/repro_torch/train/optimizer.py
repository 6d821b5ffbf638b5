"""Optimizers over param trees, the counterpart of the JAX package's
``repro/train/optimizer.py``.

Each optimizer provides ``init(params) -> state`` and
``update(grads, state, params, lr) -> (params, state)``, plus
``state_axes(axes_tree) -> axes for state`` (Adafactor's factored slots
drop a dim, so their axes come from the param axes). The state trees
have the JAX package's layout and dtypes (``count`` an int32 scalar), so
one checkpoint holds either package's optimizer state.

The arithmetic is the JAX package's, op for op in f32. ``update``
writes the new params and state into the tensors it is given and
returns them: a full-size model's params, grads and two Adam moments
must fit one card, where a second copy of each would not. SGD-momentum
and AdamW, elementwise, update a large leaf in slices of ``CHUNK``
elements, so their temporaries stay small; Adafactor's slots and its
update clip need a whole leaf. Call ``update`` under ``torch.no_grad``.

Placed trees (``models/params.py``'s ``place_tree``: a leaf as per-position
parts on a mesh of more than one device) go through SGD-momentum and
AdamW part by part, as whole leaves do. Adafactor's slots of a placed
leaf are placed by the specs their axes resolve to (``state_axes``: the
param's spec without the dropped dim), each stored once, so a slot
replicated over an axis is one tensor for every position there. Each
mean of its update over a dim split over some axes (the row and column
statistics, the row statistic's mean, the RMS clip's over the whole
leaf) is the sum of the parts' sums over those axes, added in mesh
order, over the whole length.

AdamW for <=20B archs; Adafactor (factored second moment, no first
moment) for jamba-398B / internvl-76B, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Tuple

import torch

from repro_torch.launch import mesh as M
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding.rules import (Parts, PartitionSpec, entry_axes,
                                        zeros)

PyTree = Any
# elements of a leaf updated at once by the elementwise optimizers
CHUNK = 1 << 24


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], Tuple[PyTree, PyTree]]
    state_axes: Callable[[PyTree], PyTree]


def _pieces(*tensors: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """The tensors (of one shape) as matching flat slices of at most
    CHUNK elements: views, so writing a piece writes the tensor."""
    n = tensors[0].numel()
    if n <= CHUNK or not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for i in range(0, n, CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


def _count(state) -> torch.Tensor:
    """The step count after this update, as f32 (``count`` is bumped in
    place)."""
    state["count"].add_(1)
    return state["count"].float()


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mom": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        def upd(p, g, mom):
            # JAX casts a Python scalar to the array's dtype (a weak
            # type): 0.9 is 0.8984375 against a bfloat16 momentum
            mu, wd = (torch.tensor(x, dtype=mom.dtype, device=mom.device)
                      for x in (momentum, weight_decay))
            for pp, gp, mp in _pieces(p, g.contiguous(), mom):
                mp.mul_(mu).add_(gp.to(mp.dtype))
                step = mp + wd * pp.to(mp.dtype)
                pp.copy_(pp.float() - lr * step.float())
        tree_map(upd, params, grads, state["mom"])
        return params, state

    def state_axes(axes):
        return {"mom": axes}

    return Optimizer("sgdm", init, update, state_axes)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(params):
        leaf = tree_leaves(params)[0]
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def update(grads, state, params, lr):
        c = _count(state)
        # 0-dim tensors on ``count``'s device, copied once to each
        # device a part lives on (a CUDA tensor mixes with no other
        # card's); a Python float would divide by its reciprocal on the
        # card, other bits
        bcs = {c.device: (1 - torch.pow(b1, c), 1 - torch.pow(b2, c))}

        def upd(p, g, m, v):
            if p.device not in bcs:
                bcs[p.device] = tuple(_on(x, p.device) for x in bcs[c.device])
            bc1, bc2 = bcs[p.device]
            for pp, gp, mp, vp in _pieces(p, g.contiguous(), m, v):
                g32 = gp.float()
                mp.mul_(b1).add_((1 - b1) * g32)
                vp.mul_(b2).add_((1 - b2) * g32.square())
                p32 = pp.float()
                denom = (vp / bc2).sqrt_().add_(eps)
                step = (mp / bc1).div_(denom).add_(weight_decay * p32)
                pp.copy_(p32 - lr * step)
        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    def state_axes(axes):
        return {"m": axes, "v": axes, "count": ()}

    return Optimizer("adamw", init, update, state_axes)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, beta1=0)
# ---------------------------------------------------------------------------


def _leafwise(fn, tree, *rest):
    """``fn`` over the leaves of a param tree (a ``Parts`` is one leaf)
    and, leaf for leaf, the subtrees of ``rest`` facing them."""
    if isinstance(tree, dict):
        return {k: _leafwise(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leafwise(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _summed(parts: Parts, values, axes):
    """For each part of ``parts``, the sum of ``values`` (one a part)
    over the parts that differ from it only on the mesh ``axes``, added
    in mesh order, on that part's device: the same bits for each of
    them."""
    keep = [a for a in parts.axes if a not in axes]
    return [M.psum([v for k, v in zip(parts.keys, values)
                    if all(k[a] == key[a] for a in keep)], p.device)
            for key, p in zip(parts.keys, parts.parts)]


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8) -> Optimizer:
    def _factored(p) -> bool:
        return len(p.shape) >= 2

    def _slot_specs(p: Parts):
        spec = tuple(p.spec)
        if _factored(p):
            return {"v_row": (spec[:-1], p.shape[:-1]),
                    "v_col": (spec[:-2] + spec[-1:],
                              p.shape[:-2] + p.shape[-1:])}
        return {"v": (spec, p.shape)}

    def init(params):
        def slot(p):
            if isinstance(p, Parts):
                return {k: zeros(PartitionSpec(*sp), shape, p.mesh)
                        for k, (sp, shape) in _slot_specs(p).items()}
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"v_row": torch.zeros(p.shape[:-1], **f32),
                        "v_col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        leaf = tree_leaves(params)[0]
        return {"slots": _leafwise(slot, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def clip(u, norm):
        return u / torch.clamp(norm / clip_threshold, min=1.0)

    def upd(p, g, slot, beta2, lr):
        g = g.float()
        g2 = g.square() + eps
        if _factored(p):
            v_row = beta2 * slot["v_row"] + (1 - beta2) * g2.mean(-1)
            v_col = beta2 * slot["v_col"] + (1 - beta2) * g2.mean(-2)
            row_mean = v_row.mean(-1, keepdim=True)
            r = (v_row / torch.clamp(row_mean, min=eps))[..., None]
            u = g * torch.rsqrt(torch.clamp(r, min=eps)) \
                * torch.rsqrt(torch.clamp(v_col, min=eps))[..., None, :]
            slot["v_row"].copy_(v_row)
            slot["v_col"].copy_(v_col)
        else:
            v = beta2 * slot["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=eps))
            slot["v"].copy_(v)
        u = clip(u, torch.sqrt(torch.mean(torch.square(u))))
        p.copy_(p.float() - lr * u)

    def upd_placed(p: Parts, g: Parts, slot, beta2, lr):
        """``upd`` of a placed leaf: its means as sums over the parts
        (see the module's doc)."""
        spec = tuple(p.spec)
        gs = [t.float() for t in g.parts]
        if _factored(p):
            g2 = [t.square() + eps for t in gs]
            sums = {"v_row": _summed(p, [t.sum(-1) for t in g2],
                                     entry_axes(spec[-1])),
                    "v_col": _summed(p, [t.sum(-2) for t in g2],
                                     entry_axes(spec[-2]))}
            length = {"v_row": p.shape[-1], "v_col": p.shape[-2]}
            new = {}
            for name in ("v_row", "v_col"):
                sl = slot[name]
                # a slot part's statistic from the first param part
                # at its position (the others' are the same bits)
                src = [next(i for i, k in enumerate(p.keys)
                            if _only(k, sl.axes) == key) for key in sl.keys]
                new[name] = [_ema(beta2, old, _on(sums[name][i], old.device)
                                  / length[name])
                             for old, i in zip(sl.parts, src)]
            vr, vc = slot["v_row"], slot["v_col"]
            means = _summed(vr, [t.sum(-1, keepdim=True)
                                 for t in new["v_row"]], entry_axes(spec[-2]))
            r = [t / torch.clamp(m / p.shape[-2], min=eps)
                 for t, m in zip(new["v_row"], means)]
            us = []
            for key, gp in zip(p.keys, gs):
                rp = _on(r[vr.keys.index(_only(key, vr.axes))], gp.device)
                cp = new["v_col"][vc.keys.index(_only(key, vc.axes))]
                us.append(gp * torch.rsqrt(torch.clamp(rp, min=eps))[..., None]
                          * torch.rsqrt(torch.clamp(_on(cp, gp.device),
                                                    min=eps))[..., None, :])
        else:
            new = {"v": [_ema(beta2, old, gp.square() + eps)
                         for old, gp in zip(slot["v"].parts, gs)]}
            us = [gp * torch.rsqrt(torch.clamp(v, min=eps))
                  for gp, v in zip(gs, new["v"])]
        for name, vals in new.items():
            for old, v in zip(slot[name].parts, vals):
                old.copy_(v)
        squares = _summed(p, [u.square().sum() for u in us], p.axes)
        n = math.prod(p.shape)
        for pp, u, sq in zip(p.parts, us, squares):
            pp.copy_(pp.float() - lr * clip(u, torch.sqrt(sq / n)))

    def update(grads, state, params, lr):
        beta2 = 1.0 - _count(state) ** (-decay)

        def leaf(p, g, slot):
            if isinstance(p, Parts):
                upd_placed(p, g, slot, beta2, lr)
            else:
                upd(p, g, slot, beta2, lr)
        _leafwise(leaf, params, grads, state["slots"])
        return params, state

    def state_axes(axes):
        def slot_axes(ax):
            if len(ax) >= 2:
                return {"v_row": ax[:-1], "v_col": ax[:-2] + ax[-1:]}
            return {"v": ax}
        return {"slots": _map_axes(slot_axes, axes), "count": ()}

    return Optimizer("adafactor", init, update, state_axes)


def _only(key, axes):
    """``key`` (a position) on ``axes`` alone."""
    return {a: key[a] for a in axes}


def _on(x, device):
    """``x`` on ``device``: a copy from another position is a
    ``broadcast`` (``launch/mesh.py``)."""
    return M.broadcast(x, [device])[0]


def _ema(beta2, old, x):
    b = _on(beta2, old.device)
    return b * old + (1 - b) * x


def _map_axes(fn, axes):
    """``fn`` over an axes tree, whose leaves are tuples."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, v) for k, v in axes.items()}
    return fn(axes)


def make_optimizer(name: str) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name]()


def warmup_cosine(base_lr: float, warmup: int, total: int
                  ) -> Callable[[Any], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0 at ``total``; the value an f32 scalar tensor, as the JAX
    package's."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
