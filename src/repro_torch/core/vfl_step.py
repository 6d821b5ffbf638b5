"""Mesh-mode VFL: the paper's exchange schedule on a mesh of devices, the
counterpart of the JAX package's ``repro/core/vfl_step.py``.

Parties map to the ``pod`` mesh axis. Party p's bottom MLP runs on the
device at pod position p (the first device of the other axes there) on
its own feature slice; each bottom output gets the pairwise masks of
``core/secure_agg`` (which cancel in the sum), and the masked outputs
are summed onto the aggregate's device, pod position 0: the ``psum``
over ``pod``, so no party's raw embedding leaves it unmasked. The top
model and the multi-label BCE loss run once on the aggregate (the JAX
package replicates them on every pod, with the same values), and the
update is plain SGD.

One process drives every position (``launch/mesh.py``). The gradient of
each bottom is the plain, unsharded one: the sum is of tensors moved to
one device, whose backward hands each party the aggregate's cotangent
once, as ``jax.grad`` through the JAX package's ``psum`` does. (An
all-reduce whose backward sums the cotangents of a replicated top over
n positions would hand each party n times its gradient.)

The same exchange drives the VFL-LLM example
(``repro_torch.examples.vfl_llm``), where the parties hold feature
front-ends and the aggregate feeds a transformer backbone.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import secure_agg
from repro_torch.core.protocols.split_nn import _bce, init_generator
from repro_torch.launch.mesh import Mesh, psum
from repro_torch.models import tower as twr

Tree = List[Dict[str, torch.Tensor]]


def mlp_init(generator: torch.Generator, dims: Sequence[int]) -> Tree:
    """The legacy MLP's layers ``{'w': (a, b) / sqrt(a), 'b': zeros}``,
    drawn on the CPU from ``generator``."""
    return [{"w": torch.randn((a, b), generator=generator,
                              dtype=torch.float32) / np.sqrt(a),
             "b": torch.zeros(b, dtype=torch.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(params: Tree, x: torch.Tensor, final_act: bool = False
              ) -> torch.Tensor:
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def init_party_params(seed: int, n_parties: int, d_in: int, hidden,
                      e: int) -> Tree:
    """Party-stacked bottom params (the JAX package's layout: every leaf
    has a leading dim of ``n_parties``) on the CPU, party i drawn from
    the split-NN init stream ``i + 2`` of ``seed``. A JAX-made stack
    (numpy) places the same way (:func:`place_party_params`)."""
    dims = (d_in,) + tuple(hidden) + (e,)
    per = [mlp_init(init_generator(seed, i + 2), dims)
           for i in range(n_parties)]
    return [{k: torch.stack([p[li][k] for p in per]) for k in ("w", "b")}
            for li in range(len(dims) - 1)]


def pod_devices(mesh: Mesh) -> Tuple[torch.device, ...]:
    """Each party's device: pod position p, index 0 of the other axes."""
    return mesh.axis_devices("pod")


def place_party_params(stacked, mesh: Mesh) -> List[Tree]:
    """A party-stacked tree (tensors or numpy) as one tree a party, each
    on its pod position's device."""
    def part(a, i, dev):
        if isinstance(a, torch.Tensor):
            return a[i].detach().clone().to(dev)
        return torch.as_tensor(np.array(a[i], copy=True)).to(dev)
    return [[{k: part(lyr[k], i, dev) for k in ("w", "b")}
             for lyr in stacked]
            for i, dev in enumerate(pod_devices(mesh))]


def stack_party_params(bottoms: Sequence[Tree]) -> Tree:
    """The inverse of :func:`place_party_params`, on the CPU."""
    return [{k: torch.stack([b[li][k].detach().cpu() for b in bottoms])
             for k in ("w", "b")} for li in range(len(bottoms[0]))]


def make_mesh_vfl_step(mesh: Mesh, n_parties: int, lr: float = 0.05,
                       use_masks: bool = True):
    """Returns a step ``(bottoms, top, x, y, key) -> (bottoms, top,
    loss)``.

    ``bottoms``: one tree a party on its pod device
    (:func:`place_party_params`); ``top``: the top MLP on pod position
    0's device; ``x``: (n_parties, batch, d_in), the party feature
    slices padded to a common width, as one tensor or one tensor a
    party; ``y``: (batch, items) labels; ``key``: this step's integer
    mask seed (``secure_agg.fold_in(base, step)``). The returned trees
    are new tensors; the loss is a 0-d tensor on the aggregate's
    device."""
    devs = pod_devices(mesh)
    if len(devs) != n_parties:
        raise ValueError(f"the mesh's pod axis has {len(devs)} positions "
                         f"for {n_parties} parties")
    if use_masks and len({d.type for d in devs}) > 1:
        raise ValueError(f"pairwise masks cancel only when drawn on one "
                         f"device type; the pods are on {devs}")
    agg_dev = devs[0]
    lr = float(np.float32(lr))

    def step(bottoms: Sequence[Tree], top: Tree, x, y, key: int):
        b_leaves = [[t.detach().requires_grad_() for t in twr.leaves(b)]
                    for b in bottoms]
        t_leaves = [t.detach().requires_grad_() for t in twr.leaves(top)]
        with torch.enable_grad():
            us = []
            for p, dev in enumerate(devs):
                u = mlp_apply(twr.with_leaves(bottoms[p], b_leaves[p]),
                              x[p].to(dev), final_act=True)
                if use_masks:
                    u = u + secure_agg.pairwise_mask(key, p, n_parties,
                                                     u.shape, u.dtype, dev)
                us.append(u)
            agg = psum(us, agg_dev)
            loss = _bce(mlp_apply(twr.with_leaves(top, t_leaves), agg),
                        y.to(agg_dev))
            flat = [t for ls in b_leaves for t in ls] + t_leaves
            grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            new = [p - lr * g for p, g in zip(flat, grads)]
        out, i = [], 0
        for b, ls in zip(bottoms, b_leaves):
            out.append(twr.with_leaves(b, new[i:i + len(ls)]))
            i += len(ls)
        return out, twr.with_leaves(top, new[i:]), loss.detach()

    return step
