"""Shape-and-dtype stand-ins for every model input, the counterpart of
the JAX package's ``repro/launch/specs.py``: tensors on the ``meta``
device, PyTorch's ``ShapeDtypeStruct``, which carry a shape and a dtype
and allocate nothing.

- train:    ``batch_specs(..., with_labels=True)``: tokens, labels and,
  for a model with a frontend, patches or frames;
- prefill:  ``batch_specs(..., with_labels=False)``;
- decode:   ``cache_specs``, the per-layer decode state that
  ``transformer.init_cache`` builds, built on ``meta``.

``cache_axes`` names each cache dim as the JAX package does. With mesh
rules (``rules``) the stand-ins come beside a tree like theirs of the
``PartitionSpec``s their logical axes resolve to, as the JAX package's
carry a sharding; ``place_batch`` splits a real batch by those specs
(``tokens``, ``labels``, a ``loss_mask``, ``patches`` and ``frames``
over ``pod x data``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.sharding.rules import Parts, map_in_tree_order, place

META = torch.device("meta")


def text_len(cfg: ModelConfig, shape: InputShape) -> int:
    """Text-token length such that the whole sequence is
    ``shape.seq_len`` (a vision prefix takes ``num_tokens`` of it)."""
    if transformer.has_vision_prefix(cfg):
        return shape.seq_len - cfg.frontend.num_tokens
    return shape.seq_len


def batch_specs(cfg: ModelConfig, shape: InputShape, rules=None,
                with_labels: bool = True,
                dtype: torch.dtype = torch.bfloat16):
    """The step's batch as ``meta`` tensors: tokens (and labels) (b,
    s_text) int32, patches (b, num_tokens, d) or frames (b, n_frames, d)
    of ``dtype``; under ``rules`` a pair (those, their specs by key)."""
    b = shape.global_batch
    s = text_len(cfg, shape)
    items = {"tokens": ((b, s), torch.int32, ("batch", "seq"))}
    if with_labels:
        items["labels"] = ((b, s), torch.int32, ("batch", "seq"))
    if transformer.has_vision_prefix(cfg):
        items["patches"] = ((b, cfg.frontend.num_tokens, cfg.d_model),
                            dtype, ("batch", "seq", "embed"))
    elif cfg.frontend is not None or cfg.encoder is not None:
        items["frames"] = ((b, cfg.encoder.n_frames, cfg.d_model), dtype,
                           ("batch", "frames", "embed"))
    batch = {k: torch.empty(sh, dtype=dt, device=META)
             for k, (sh, dt, _) in items.items()}
    if rules is None:
        return batch
    return batch, {k: rules.act_spec(ax, sh)
                   for k, (sh, _, ax) in items.items()}


# the logical axes of each batch key a sharded step splits, as
# ``batch_specs`` gives them
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "loss_mask": ("batch", "seq"),
              "patches": ("batch", "seq", "embed"),
              "frames": ("batch", "frames", "embed")}


def place_batch(batch: Dict[str, Any], rules, specs=None
                ) -> Dict[str, Parts]:
    """A real batch (tensors or arrays by key, ``BATCH_AXES``'s keys:
    the text, and a vision prefix's patches or an encoder's frames)
    split over ``rules.mesh`` by ``specs`` (by key), else by the specs
    its logical axes resolve to: the batch dim over ``pod x data`` where
    it divides, so each row's patches or frames sit with its tokens."""
    batch = {k: torch.as_tensor(x) for k, x in batch.items()}
    if specs is None:
        specs = {k: rules.act_spec(BATCH_AXES[k], tuple(t.shape))
                 for k, t in batch.items()}
    return {k: place(t, specs[k], rules.mesh) for k, t in batch.items()}


# ---------------------------------------------------------------------------
# cache axes (mirror transformer.init_cache's structure)
# ---------------------------------------------------------------------------


def _block_cache_axes(cfg: ModelConfig, mixer: str):
    if mixer == "attn":
        if cfg.attention == "mla":
            return {"ckv": ("batch", "cache_seq", "kv_lora"),
                    "k_rope": ("batch", "cache_seq", "head_dim")}
        kv = ("batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": kv, "v": kv}
    if mixer == "mamba":
        return {"h": ("batch", "d_inner", "state"),
                "conv": ("batch", "conv", "d_inner")}
    if mixer == "rwkv":
        return {"x_prev": ("batch", "embed"),
                "s": ("batch", "heads", "head_dim", None)}
    raise ValueError(mixer)


def cache_axes(cfg: ModelConfig):
    """The logical axis names of every cache leaf, as a tree like
    ``init_cache``'s; stacked blocks get a leading ``layers`` axis."""
    axes: Dict[str, Any] = {}
    for i, (mixer, _) in enumerate(cfg.prefix_pattern):
        axes[f"prefix{i}"] = _block_cache_axes(cfg, mixer)
    axes["blocks"] = {
        f"pos{i}": {k: ("layers",) + ax
                    for k, ax in _block_cache_axes(cfg, mixer).items()}
        for i, (mixer, _) in enumerate(cfg.block_pattern)}
    return axes


def cache_specs(cfg: ModelConfig, shape: InputShape, rules=None,
                dtype: torch.dtype = torch.bfloat16):
    """``transformer.init_cache`` for ``shape``'s batch and sequence
    length, on ``meta``: the decode state's shapes and dtypes with
    nothing allocated; under ``rules`` a pair (that, a tree like it of
    the leaves' specs)."""
    abstract = transformer.init_cache(cfg, shape.global_batch,
                                      shape.seq_len, dtype, META)
    if rules is None:
        return abstract
    return abstract, map_in_tree_order(
        lambda t, ax: rules.act_spec(ax, tuple(t.shape)), abstract,
        cache_axes(cfg))
