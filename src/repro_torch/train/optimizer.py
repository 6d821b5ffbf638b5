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
AdamW part by part, as whole leaves do. Adafactor's row and column
statistics and its RMS clip need whole leaves: on a placed tree it
raises.

AdamW for <=20B archs; Adafactor (factored second moment, no first
moment) for jamba-398B / internvl-76B, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Tuple

import torch

from repro_torch.models.params import is_placed, tree_leaves, tree_map
from repro_torch.sharding.rules import SHARDED_STEPS

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
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)

        def upd(p, g, m, v):
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


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8) -> Optimizer:
    def _factored(p) -> bool:
        return p.dim() >= 2

    def whole_leaves(params):
        if is_placed(params):
            raise NotImplementedError(
                f"Adafactor's factored statistics and update clip need "
                f"whole leaves, not a tree placed on a mesh: "
                f"{SHARDED_STEPS}")

    def init(params):
        whole_leaves(params)

        def slot(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"v_row": torch.zeros(p.shape[:-1], **f32),
                        "v_col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        leaf = tree_leaves(params)[0]
        return {"slots": tree_map(slot, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def update(grads, state, params, lr):
        whole_leaves(params)
        beta2 = 1.0 - _count(state) ** (-decay)

        def upd(p, g, slot):
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
            norm = torch.sqrt(torch.mean(torch.square(u)))
            u = u / torch.clamp(norm / clip_threshold, min=1.0)
            p.copy_(p.float() - lr * u)
        tree_map(upd, params, grads, state["slots"])
        return params, state

    def state_axes(axes):
        def slot_axes(ax):
            if len(ax) >= 2:
                return {"v_row": ax[:-1], "v_col": ax[:-2] + ax[-1:]}
            return {"v": ax}
        return {"slots": _map_axes(slot_axes, axes), "count": ()}

    return Optimizer("adafactor", init, update, state_axes)


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
