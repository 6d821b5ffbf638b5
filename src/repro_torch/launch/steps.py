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

A train or prefill step on a mesh of more than one device runs every
family sharded (GQA attention, MLA, RWKV-6, Mamba and the hybrid, dense
and MoE; the encoder-decoder and the vision prefix, whose frames or
patches are split with the tokens' rows): ``place_params`` splits the
params by their
resolved specs (``sharding.rules.Parts``; the optimizer's ``init`` of
placed params places its slots alike, Adafactor's factored statistics
by the specs their axes resolve to), the step splits the whole batch
it is given over ``pod x data`` (``specs.place_batch``), and
``models/transformer.py``'s ``loss_fn_sharded`` / ``last_logits_sharded``
combine the positions' shares with ``launch/mesh.py``'s collectives in
axis order. With a sequence split (``act_rules["seq"] = ("model",)``,
the dry-run's ``seqshard`` lever, ``launch/dryrun.py``) each row's
residual stream lives between
layers as sequence cells over ``model`` (``sharding.rules.Layout``):
a layer gathers its row's cells, and reduce-scatters its partial
outputs back to them, where it would copy the row out of its home and
sum the partials there. Its values are those of the unsharded step,
with the split or without. On a one-device mesh a step gives the
values of no mesh. On a mesh of fake devices (``meta:i`` under
``FakeTensorMode``) a step is traced, not run: ``launch/dryrun.py``
reads what it holds, moves and calls.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import mesh_chips
from repro_torch.models import params as PRM
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding.rules import (Layout, MeshRules, P,
                                        map_in_tree_order, param_shardings,
                                        use_rules)
from repro_torch.train import optimizer as O


def sharded(rules: Optional[MeshRules]) -> bool:
    """Does a step under ``rules`` run on more than one mesh position?"""
    return rules is not None and mesh_chips(rules.mesh) > 1


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


def place_params(cfg: ModelConfig, params, rules: MeshRules):
    """Whole params split over ``rules.mesh`` by their resolved specs
    (``PRM.whole_tree`` is the inverse)."""
    _, _, specs = resolve_param_shardings(cfg, rules)
    return PRM.place_tree(params, specs, rules.mesh)


class _Rows:
    """A sharded step's batch placement, resolved once a batch shape
    (so ``MeshRules.fallbacks`` records it once, as a trace would): each
    key split by its spec's batch entry alone, so that a row holds all
    of its tokens, labels and patches whatever the spec makes of the
    sequence; and the residual stream's split, decided on its own at
    ``(b, s_total, d)``, the sequence after a vision prefix's patches
    are prepended, as the JAX package constrains it there. Where
    ``s_total`` does not divide over ``model`` the spec falls back to
    replication (recorded) and each row stays whole at its home."""

    def __init__(self, cfg: ModelConfig, rules: MeshRules):
        self.cfg, self.rules, self.specs = cfg, rules, {}

    def __call__(self, batch: Dict[str, Any]):
        """(the ``Layout`` of the batch's rows, each key's rows)."""
        key = tuple((k, tuple(v.shape)) for k, v in batch.items())
        if key not in self.specs:
            specs = {k: self.rules.act_spec(S.BATCH_AXES[k], tuple(v.shape))
                     for k, v in batch.items()}
            b, s = batch["tokens"].shape
            if T.has_vision_prefix(self.cfg):
                s += self.cfg.frontend.num_tokens
            act = self.rules.act_spec(("batch", "seq", "embed"),
                                      (b, s, self.cfg.d_model))
            self.specs[key] = specs, act[1] == "model"
        specs, seq = self.specs[key]
        parts = S.place_batch(batch, self.rules,
                              {k: P(sp[0]) for k, sp in specs.items()})
        lay = Layout(self.rules.mesh, specs["tokens"][0], seq)
        return lay, {k: [p.part(**row) for row in lay.rows]
                     for k, p in parts.items()}


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   compute_dtype: torch.dtype = torch.bfloat16, rows=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(total loss, metrics, grads) of ``T.loss_fn`` at ``params``: grads
    a tree like ``params``, None at a param that does not reach the loss.
    ``params`` is not changed; the values are detached. With ``rows``
    (a sharded step's batch placement) ``params`` are placed and the
    loss is ``T.loss_fn_sharded``'s."""
    leaf = {id(t): t.detach().requires_grad_()
            for t in tree_leaves(params) if t.is_floating_point()}
    tracked = tree_map(lambda t: leaf.get(id(t), t), params)
    with torch.enable_grad():
        if rows is None:
            loss, metrics = T.loss_fn(cfg, tracked, batch, compute_dtype)
        else:
            lay, by_row = rows(batch)
            loss, metrics = T.loss_fn_sharded(cfg, lay, tracked, by_row,
                                              compute_dtype)
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
    returns them with the metrics.

    On a mesh of more than one device ``params`` and ``opt_state`` are
    placed (``place_params``; ``opt.init`` of placed params: SGD,
    AdamW or Adafactor) and ``batch`` is whole: each microbatch is the
    unsharded step's, split over the rows (frames and patches with
    their tokens), so accumulation gives the unsharded step's values,
    with or without a sequence split (``_Rows``)."""
    rows = _Rows(cfg, rules) if sharded(rules) else None

    def train_step(params, opt_state, batch
                   ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        with use_rules(rules):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if accum_steps == 1:
            _, metrics, grads = loss_and_grads(cfg, params, batch,
                                               compute_dtype, rows)
            grads = tree_map(lambda g, p: torch.zeros_like(p)
                             if g is None else g, grads, params)
        else:
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            per_micro = []
            for mb in _microbatches(batch, accum_steps):
                _, metrics, grads = loss_and_grads(cfg, params, mb,
                                                   compute_dtype, rows)
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
    returns the last position's logits (b, vocab). On a mesh of more
    than one device ``params`` are placed, the whole batch (frames and
    patches with their tokens) is split over the rows, and the logits
    come back whole."""
    rows = _Rows(cfg, rules) if sharded(rules) else None

    def prefill_step(params, batch) -> torch.Tensor:
        with torch.no_grad(), use_rules(rules):
            if rows is not None:
                lay, by_row = rows(batch)
                return T.last_logits_sharded(cfg, lay, params, by_row,
                                             compute_dtype)
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
