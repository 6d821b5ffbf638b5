"""Step builders: train_step / prefill_step / decode_step factories, the
counterpart of the JAX package's ``repro/launch/steps.py``, used by the
trainer and the training CLI.

PyTorch runs eagerly: a step is a plain function, and its gradients come
from autograd through the model, whose attention and expert matmuls are
``torch.autograd.Function``s with hand-written backward kernels on the
card (``kernels/ops.py``).

Mesh rules (``rules``, a ``MeshRules``) are accepted as in the JAX
package: every step runs under ``use_rules(rules)``, and
``resolve_param_shardings`` / ``opt_state_specs`` resolve each param and
optimizer slot to its ``PartitionSpec``. A decode step takes any mesh:
under rules, ``cfg.decode_partial_softmax`` splits the KV cache's
sequence over the mesh's ``model`` axis (``models/decode_sharded.py``).
A train or prefill step on a mesh of more than one device needs tensor-
and data-parallel layers for every family, which the port does not have
yet: it raises, naming the ROADMAP item. On a one-device mesh it gives
the values of no mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import mesh_chips
from repro_torch.models import params as PRM
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding.rules import (MeshRules, map_in_tree_order,
                                        param_shardings, use_rules)
from repro_torch.train import optimizer as O

# the ROADMAP Queue 1 item that ports train and prefill steps on a mesh
# of more than one device
_SHARDED_STEPS = ("ROADMAP Queue 1 item 10b (zoo train and prefill steps "
                  "on a mesh of more than one device)")


def check_rules(rules: Optional[MeshRules], what: str = "this step"
                ) -> None:
    """Raise unless ``rules`` is None or its mesh is one device."""
    if rules is not None and mesh_chips(rules.mesh) > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {dict(rules.mesh.shape)} needs tensor- "
            f"and data-parallel layers, not ported to repro_torch yet: "
            f"{_SHARDED_STEPS}")


def resolve_param_shardings(cfg: ModelConfig, rules: Optional[MeshRules],
                            param_dtype: torch.dtype = torch.bfloat16):
    """(abstract params on ``meta``, their logical axes, their specs):
    the specs a tree of ``PartitionSpec`` like the params, None without
    rules."""
    spec = T.model_spec(cfg)
    abstract = PRM.abstract_tree(spec, param_dtype)
    axes = PRM.axes_tree(spec)
    if rules is None:
        return abstract, axes, None
    return abstract, axes, param_shardings(rules, axes, abstract)


def opt_state_specs(opt: O.Optimizer, abstract_params, axes,
                    rules: Optional[MeshRules]):
    """The optimizer state of ``abstract_params`` on ``meta``; with
    rules, a pair (that, a tree like it of each slot's spec)."""
    abstract_state = opt.init(abstract_params)
    if rules is None:
        return abstract_state
    return abstract_state, map_in_tree_order(
        lambda sds, ax: rules.spec(tuple(ax), sds.shape, rules.param_rules,
                                   "opt"),
        abstract_state, opt.state_axes(axes))


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(total loss, metrics, grads) of ``T.loss_fn`` at ``params``: grads
    a tree like ``params``, None at a param that does not reach the loss.
    ``params`` is not changed; the values are detached."""
    leaf = {id(t): t.detach().requires_grad_()
            for t in tree_leaves(params) if t.is_floating_point()}
    tracked = tree_map(lambda t: leaf.get(id(t), t), params)
    with torch.enable_grad():
        loss, metrics = T.loss_fn(cfg, tracked, batch, compute_dtype)
        wrt = [t for t in tree_leaves(tracked) if t.requires_grad]
        got = torch.autograd.grad(loss, wrt, allow_unused=True)
    by_leaf = {id(t): g for t, g in zip(wrt, got)}
    grads = tree_map(lambda t: by_leaf.get(id(t)), tracked)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    for i in range(n):
        yield {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
               for k, x in batch.items()}


def make_train_step(cfg: ModelConfig, opt: O.Optimizer, lr: float = 3e-4,
                    rules=None, compute_dtype: torch.dtype = torch.bfloat16,
                    accum_steps: int = 1):
    """The batch holds ``tokens`` and ``labels`` (b, s), and for a
    vision-prefix model ``patches`` (b, num_tokens, d), which
    ``loss_fn`` prepends and masks out of the loss.

    accum_steps > 1: microbatch gradient accumulation — the global
    batch is split along the batch dim and grads are averaged in fp32
    over the microbatches, in order, as the JAX package's ``lax.scan``
    does. The optimizer update runs under ``torch.no_grad`` and writes
    the params and state it is given (``train/optimizer.py``); the step
    returns them with the metrics."""
    check_rules(rules, "a train step")

    def train_step(params, opt_state, batch
                   ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        with use_rules(rules):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if accum_steps == 1:
            _, metrics, grads = loss_and_grads(cfg, params, batch,
                                               compute_dtype)
            grads = tree_map(lambda g, p: torch.zeros_like(p)
                             if g is None else g, grads, params)
        else:
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            per_micro = []
            for mb in _microbatches(batch, accum_steps):
                _, metrics, grads = loss_and_grads(cfg, params, mb,
                                                   compute_dtype)
                tree_map(lambda a, g: None if g is None
                         else a.add_(g.float() / accum_steps), acc, grads)
                per_micro.append(metrics)
                del grads
            grads = tree_map(lambda a, p: a.to(p.dtype), acc, params)
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                       for k in per_micro[0]}
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, rules=None,
                      compute_dtype: torch.dtype = torch.bfloat16):
    """A step of ``batch["tokens"]`` (b, s), and for an encoder-decoder
    model ``batch["frames"]`` (b, n_frames, d), which the step encodes
    before the decoder attends to them, or for a vision-prefix model
    ``batch["patches"]`` (b, num_tokens, d), prepended to the tokens;
    returns the last position's logits (b, vocab)."""
    check_rules(rules, "a prefill step")

    def prefill_step(params, batch) -> torch.Tensor:
        with torch.no_grad(), use_rules(rules):
            logits, _ = T.forward(cfg, params, batch, compute_dtype)
        # serving returns only the last-position logits
        return logits[:, -1, :]
    return prefill_step


def make_decode_step(cfg: ModelConfig, rules=None,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     with_memory: bool = False):
    """A decode step; ``with_memory`` gives it a ``memory`` argument,
    the encoder's output that an encoder-decoder model's cross-attention
    reads. Any mesh: under ``rules`` with ``cfg.decode_partial_softmax``
    a full-attention model's KV cache is split over ``model``."""

    def decode_step(params, token, cache, index,
                    memory: Optional[torch.Tensor] = None):
        with torch.no_grad(), use_rules(rules):
            return T.decode_step(cfg, params, token, cache, index, memory,
                                 compute_dtype)
    if not with_memory:
        return lambda params, token, cache, index: \
            decode_step(params, token, cache, index)
    return decode_step
