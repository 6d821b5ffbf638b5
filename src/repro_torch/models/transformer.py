"""Model assembly of the port's model zoo: block -> stack -> LM /
enc-dec. The counterpart of the JAX package's
``repro/models/transformer.py``.

This slice runs the decoder-only families whose blocks are GQA attention
(full, sliding-window, qk-norm; RoPE or none), multi-head latent
attention (MLA), an RWKV-6 time-mix or a Mamba (S6) mixer, followed by
a gated MLP or a mixture of experts (with shared experts and a dense
prefix layer), under rmsnorm: ``rwkv6-7b``, ``granite-moe-3b-a800m``,
``glm4-9b``, ``qwen3-14b``, ``h2o-danube-1.8b``, the hybrid
``jamba-1.5-large-398b``, and the MLA models ``deepseek-v2-lite-16b``
and ``minicpm3-4b``; and the encoder-decoder ``whisper-large-v3``: an
encoder of bidirectional attention over precomputed frame embeddings
(the audio frontend is a stub in both packages), sinusoidal positions,
a decoder whose blocks add cross-attention to the encoder's output
(``memory``), layernorm and the non-gated biased MLP throughout; and
the vision-language ``internvl2-76b``, whose precomputed patch
embeddings (the vision encoder is a stub in both packages) are prepended
to the token embeddings and carry no next-token loss.

Layer stacks keep the JAX package's *stacked* layout (every leaf of
``params["blocks"]["pos<i>"]`` and ``params["encoder"]["blocks"]`` has a
leading layer dim), so one numpy tree drives either package; where the
JAX package runs ``lax.scan`` over that dim, the port walks it with a
Python loop.
Under grad, ``cfg.remat_policy`` wraps each repeat as the JAX package's
``_maybe_remat`` does: ``full`` in ``torch.utils.checkpoint`` (nothing
kept but the repeat's input; the backward recomputes it), ``minimal`` in
selective checkpointing that keeps the outputs of the matmuls without
batch dims (``aten.mm`` / ``addmm``, the counterpart of
``dots_with_no_batch_dims_saveable``) and recomputes the rest, the
kernels included; ``none`` keeps everything. Values do not change, only
memory; under ``torch.no_grad`` or ``inference_mode`` (serving) nothing
is wrapped. The encoder's blocks are not wrapped, as the JAX package's
``encode`` wraps none. The JAX package's sharding constraints are
layout hints whose values do not depend on them, and are dropped; its
``decode_partial_softmax`` branch is kept: a decode
step under mesh rules with that flag and full attention splits the KV
cache's sequence over the ``model`` axis
(``models/decode_sharded.py``).

On a mesh of more than one device, ``loss_fn_sharded`` and
``last_logits_sharded`` run every family (GQA attention, MLA, RWKV-6
and Mamba mixers, the gated MLP and MoE, under rmsnorm; the
encoder-decoder's layernorm, biased MLP, encoder and cross-attention;
the vision prefix) with placed params (``sharding.rules.Parts``) and
the batch split into rows (``sharding.rules.Layout``;
``models/layers.py``'s ``*_sharded`` conventions), with the values of
``loss_fn`` and ``forward``. Each row's frames or patches travel with
its tokens: ``encode_sharded`` turns the rows' frames into the rows'
memory, and a row's patches are prepended to its embedded tokens and
masked out of its labels. Under a sequence split a row's residual
stream between layers is its sequence cells over ``model``
(``Layout``), cut after the embedding, the prefix and the positions
are in place; each layer gathers the row's cells and the head and loss
take each row whole, so labels and masks are never cut. A repeat's
FSDP gathers run inside the unit ``_maybe_remat`` wraps, so under
remat the gathered weights are recomputed in the backward and are not
kept across the step. The
loss's mask denominator, its metrics and the router losses are sums
over every row.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.models import attention, layers, mamba, mla, moe
from repro_torch.models import params as P, rwkv
from repro_torch.models.decode_sharded import sharded_decode_attention
from repro_torch.sharding.rules import current_rules

_AUX = ("load_balance", "router_z")


def has_vision_prefix(cfg: ModelConfig) -> bool:
    """internvl2: ``batch["patches"]`` are prepended to the tokens."""
    return cfg.frontend is not None and cfg.frontend.kind == "vision"


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


_MIXER_SPECS = {"attn": attention.attention_spec,
                "mamba": mamba.mamba_spec,
                "rwkv": rwkv.rwkv_spec}


def _mla(cfg: ModelConfig, mixer: str) -> bool:
    return mixer == "attn" and cfg.attention == "mla"


def _is_ln(cfg: ModelConfig) -> bool:
    """The whisper family: layernorm and the biased, non-gated MLP."""
    return cfg.encoder is not None


def _norm_spec(cfg: ModelConfig):
    return layers.layernorm_spec(cfg.d_model) if _is_ln(cfg) \
        else layers.rmsnorm_spec(cfg.d_model)


def _norm(cfg: ModelConfig, p, x):
    fn = layers.layernorm if _is_ln(cfg) else layers.rmsnorm
    return fn(p, x, cfg.norm_eps)


def block_spec(cfg: ModelConfig, mixer: str, ffn: str, cross: bool = False):
    spec: Dict[str, Any] = {
        "norm1": _norm_spec(cfg),
        "mixer": (mla.mla_spec(cfg) if _mla(cfg, mixer)
                  else _MIXER_SPECS[mixer](cfg))}
    if cross:
        spec["norm_x"] = _norm_spec(cfg)
        spec["cross"] = attention.attention_spec(cfg, cross=True)
    spec["norm2"] = _norm_spec(cfg)
    spec["ffn"] = (moe.moe_spec(cfg) if ffn == "moe"
                   else layers.mlp_spec(cfg.d_model, cfg.d_ff) if _is_ln(cfg)
                   else layers.gated_mlp_spec(cfg.d_model, cfg.d_ff))
    return spec


def model_spec(cfg: ModelConfig):
    cross = cfg.encoder is not None
    spec: Dict[str, Any] = {
        "embed": layers.embedding_spec(cfg.vocab, cfg.d_model),
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = layers.unembed_spec(cfg.vocab, cfg.d_model)
    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        spec[f"prefix{i}"] = block_spec(cfg, mixer, ffn, cross)
    spec["blocks"] = {
        f"pos{i}": P.stack(block_spec(cfg, mixer, ffn, cross), cfg.n_repeats)
        for i, (mixer, ffn) in enumerate(cfg.block_pattern)}
    if cfg.encoder is not None:
        enc_block = {"norm1": _norm_spec(cfg),
                     "mixer": attention.attention_spec(cfg),
                     "norm2": _norm_spec(cfg),
                     "ffn": layers.mlp_spec(cfg.d_model, cfg.d_ff)}
        spec["encoder"] = {
            "blocks": P.stack(enc_block, cfg.encoder.n_layers),
            "final_norm": _norm_spec(cfg)}
    return spec


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _cross(cfg: ModelConfig, p, x, memory) -> torch.Tensor:
    """The decoder block's cross-attention residual, where it has one."""
    if memory is None or "cross" not in p:
        return x
    return x + attention.cross_attention(
        cfg, p["cross"], _norm(cfg, p["norm_x"], x), memory)


def _ffn(cfg: ModelConfig, ffn: str, p, x
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = _norm(cfg, p["norm2"], x)
    if ffn == "moe":
        return moe.moe_ffn(cfg, p["ffn"], h, cfg.act)
    if _is_ln(cfg):
        return layers.mlp(p["ffn"], h, cfg.act), {}
    return layers.gated_mlp(p["ffn"], h, cfg.act), {}


def _apply_block(cfg: ModelConfig, mixer: str, ffn: str, p, x,
                 positions, memory=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = _norm(cfg, p["norm1"], x)
    if _mla(cfg, mixer):
        h = mla.mla_self_attention(cfg, p["mixer"], h, positions=positions)
    elif mixer == "attn":
        h = attention.self_attention(cfg, p["mixer"], h,
                                     positions=positions)
    elif mixer == "mamba":
        h = mamba.mamba_mixer(cfg, p["mixer"], h)
    else:
        h = rwkv.rwkv_mixer(cfg, p["mixer"], h)
    x = _cross(cfg, p, x + h, memory)
    h, aux = _ffn(cfg, ffn, p, x)
    return x + h, aux


# the matmuls without batch dims, whose outputs ``minimal`` keeps
_MATMULS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` (one repeat of the pattern) under ``cfg.remat_policy``."""
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat_policy == "minimal":
        contexts = functools.partial(create_selective_checkpoint_contexts,
                                     _MATMULS)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=contexts)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _stack(cfg: ModelConfig, params, x, block, device):
    """Prefix blocks, then the pattern blocks, repeat by repeat, each
    through ``block(mixer, ffn, p, x) -> (x, aux)``; one repeat is the
    unit ``_maybe_remat`` wraps. The router losses (on ``device``) are
    summed over the MoE layers and averaged."""
    aux_losses = {k: torch.zeros((), dtype=torch.float32, device=device)
                  for k in _AUX}

    def add(aux):
        for k in aux:
            aux_losses[k] = aux_losses[k] + aux[k]

    def unit(x, unit_params) -> Tuple[Any, List[Dict]]:
        auxes = []
        for i, (mixer, ffn) in enumerate(cfg.block_pattern):
            x, aux = block(mixer, ffn, unit_params[f"pos{i}"], x)
            auxes.append(aux)
        return x, auxes

    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        x, aux = block(mixer, ffn, params[f"prefix{i}"], x)
        add(aux)
    unit = _maybe_remat(cfg, unit)
    per_layer = {pos: P.unstack(p, cfg.n_repeats)
                 for pos, p in params["blocks"].items()}
    for layer in range(cfg.n_repeats):
        x, auxes = unit(x, {pos: ps[layer] for pos, ps in per_layer.items()})
        for aux in auxes:
            add(aux)
    n_moe = sum(f == "moe" for _, f in
                cfg.prefix_pattern + cfg.block_pattern * cfg.n_repeats)
    if n_moe:
        aux_losses = {k: v / n_moe for k, v in aux_losses.items()}
    return x, aux_losses


def _stack_forward(cfg: ModelConfig, params, x, positions, memory=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`_stack` of ``x``, each block attending to the encoder's
    ``memory`` where it is given."""
    return _stack(cfg, params, x, lambda mixer, ffn, p, x: _apply_block(
        cfg, mixer, ffn, p, x, positions, memory), x.device)


def _with_router_losses(cfg: ModelConfig, loss, metrics, aux):
    """``loss`` plus, for an MoE model, the weighted router losses, as
    the JAX package's ``loss_fn`` adds them; ``metrics`` gains the
    total (and the load balance)."""
    total = loss
    if cfg.moe is not None:
        total = (total
                 + cfg.moe.router_aux_weight * aux["load_balance"]
                 + cfg.moe.router_z_weight * aux["router_z"])
        metrics["load_balance"] = aux["load_balance"]
    metrics["total_loss"] = total
    return total, metrics


def _head(cfg: ModelConfig, params, x) -> torch.Tensor:
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return layers.unembed(params["lm_head"], x)


# ---------------------------------------------------------------------------
# on a mesh of more than one device (a list a row; see the module's doc)
# ---------------------------------------------------------------------------


def _norm_sharded(cfg: ModelConfig, lay, p, xs) -> List[torch.Tensor]:
    fn = layers.layernorm_sharded if _is_ln(cfg) else layers.rmsnorm_sharded
    return fn(lay, p, xs, cfg.norm_eps)


def _cross_sharded(cfg: ModelConfig, lay, p, xs, memory
                   ) -> List[torch.Tensor]:
    """:func:`_cross` of the rows: the cross-attention residual, where
    the block has one."""
    if memory is None or "cross" not in p:
        return xs
    hs = attention.cross_attention_sharded(
        cfg, lay, p["cross"], _norm_sharded(cfg, lay, p["norm_x"], xs),
        memory)
    return _add(lay, xs, hs)


def _add(lay, xs, hs) -> List:
    """The residual add of rows ``xs`` and ``hs``, cell by cell."""
    return lay.each(lambda r, j, x, h: x + h, xs, hs)


def _apply_block_sharded(cfg: ModelConfig, lay, mixer: str, ffn: str, p, xs,
                         positions, memory=None
                         ) -> Tuple[List[torch.Tensor], Dict]:
    hs = _norm_sharded(cfg, lay, p["norm1"], xs)
    if _mla(cfg, mixer):
        hs = mla.mla_self_attention_sharded(cfg, lay, p["mixer"], hs,
                                            positions)
    elif mixer == "attn":
        hs = attention.self_attention_sharded(cfg, lay, p["mixer"], hs,
                                              positions)
    elif mixer == "mamba":
        hs = mamba.mamba_mixer_sharded(cfg, lay, p["mixer"], hs)
    else:
        hs = rwkv.rwkv_mixer_sharded(cfg, lay, p["mixer"], hs)
    xs = _cross_sharded(cfg, lay, p, _add(lay, xs, hs), memory)
    hs = _norm_sharded(cfg, lay, p["norm2"], xs)
    if ffn == "moe":
        hs, aux = moe.moe_ffn_sharded(cfg, lay, p["ffn"], hs, cfg.act)
    elif _is_ln(cfg):
        hs, aux = layers.mlp_sharded(lay, p["ffn"], hs, cfg.act), {}
    else:
        hs, aux = layers.gated_mlp_sharded(lay, p["ffn"], hs, cfg.act), {}
    return _add(lay, xs, hs), aux


def _stack_forward_sharded(cfg: ModelConfig, lay, params, xs, positions,
                           memory=None) -> Tuple[List[torch.Tensor], Dict]:
    """:func:`_stack` of the rows ``xs``: every row goes through a
    repeat together (the MoE dispatch spans the rows); each block
    attends to the rows' ``memory`` where it is given."""
    return _stack(cfg, params, xs, lambda mixer, ffn, p, xs:
                  _apply_block_sharded(cfg, lay, mixer, ffn, p, xs,
                                       positions, memory), lay.home(0))


def _hidden_sharded(cfg: ModelConfig, lay, params,
                    batch: Dict[str, List[torch.Tensor]], dtype):
    """:func:`forward` up to the head on the rows of ``batch``: the
    rows' final-normed hidden states (in ``lay``'s form) and the router
    losses. Each row is embedded whole at its home, behind its patches
    and with whisper's positions, before a sequence split cuts it into
    cells, so positions are whole rows' (RoPE's too: a layer attends on
    its row whole)."""
    xs = layers.embed_sharded(lay, params["embed"], batch["tokens"], dtype)
    if has_vision_prefix(cfg):
        xs = [torch.cat([pt.to(x.device, dtype), x], dim=1)
              for pt, x in zip(batch["patches"], xs)]
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]
    if _is_ln(cfg):       # whisper's decoder: sinusoidal positions
        xs = [x + _sinusoidal(x.shape[1], cfg.d_model,
                              x.device).to(dtype)[None] for x in xs]
    memory = None
    if cfg.encoder is not None:
        memory = encode_sharded(cfg, lay.rows_whole(), params,
                                [f.to(dtype) for f in batch["frames"]])
    xs = [lay.leave(r, [x]) for r, x in enumerate(xs)]
    xs, aux = _stack_forward_sharded(cfg, lay, params, xs, positions,
                                     memory)
    return _norm_sharded(cfg, lay, params["final_norm"], xs), aux


def _head_sharded(cfg: ModelConfig, lay, params, xs):
    if cfg.tie_embeddings:
        return layers.head_sharded(lay, params["embed"]["table"], xs, True)
    return layers.head_sharded(lay, params["lm_head"]["w"], xs, False)


def _prefix_labels(cfg: ModelConfig, labels, mask):
    """``labels`` (b, s_text) and the loss mask (None for none) of a
    batch, or of a row, as the loss takes them: a vision prefix's
    ``num_tokens`` positions padded in front and masked out, as the JAX
    package's ``loss_fn`` pads and masks them."""
    if not has_vision_prefix(cfg):
        return labels, mask
    n = cfg.frontend.num_tokens
    labels = F.pad(labels, (n, 0))
    pm = (torch.arange(labels.shape[1], device=labels.device) >= n
          ).float().expand(labels.shape)
    return labels, pm if mask is None else mask * pm


def loss_fn_sharded(cfg: ModelConfig, lay, params,
                    batch: Dict[str, List[torch.Tensor]],
                    dtype: torch.dtype = torch.bfloat16
                    ) -> Tuple[torch.Tensor, Dict]:
    """:func:`loss_fn` on a mesh: ``batch`` maps each key to its rows
    (``tokens``, ``labels``, an optional ``loss_mask``, and ``frames``
    or ``patches`` where the model takes them)."""
    xs, aux = _hidden_sharded(cfg, lay, params, batch, dtype)
    # the head's vocab split on each row whole, rather than the whole
    # head on every cell
    xs = [lay.whole(r, x) for r, x in enumerate(xs)]
    masks = batch.get("loss_mask") or [None] * len(xs)
    labels, masks = zip(*(_prefix_labels(cfg, lab, m) for lab, m in
                          zip(batch["labels"], masks)))
    loss, metrics = layers.softmax_xent_sharded(
        lay, _head_sharded(cfg, lay, params, xs), labels,
        None if masks[0] is None else masks)
    return _with_router_losses(cfg, loss, metrics, aux)


def last_logits_sharded(cfg: ModelConfig, lay, params,
                        batch: Dict[str, List[torch.Tensor]],
                        dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """The last position's logits (b, vocab) of :func:`forward` on a
    mesh, whole on the first row's home: each row's vocab parts
    gathered, the rows concatenated in order. ``batch`` maps each key to
    its rows (``tokens``, and ``frames`` or ``patches`` where the model
    takes them)."""
    xs, _ = _hidden_sharded(cfg, lay, params, batch, dtype)
    logits = _head_sharded(cfg, lay, params,
                           [lay.cells(x)[-1][:, -1] for x in xs])
    return M.all_gather([M.all_gather(parts, -1, lay.home(0))
                         for parts in logits], 0, lay.home(0))


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------


def _angles(pos: torch.Tensor, d: int) -> torch.Tensor:
    """sin and cos of ``pos`` (f32, any shape) over ``10000 ** (2i / d)``,
    concatenated along a new last dim of width ``d``."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    angle = pos[..., None] / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], -1)[..., :d]


def _sinusoidal(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) f32 sinusoidal positions 0 .. n - 1."""
    return _angles(torch.arange(n, dtype=torch.float32, device=device), d)


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (b, n_frames, d) precomputed embeddings (the frontend is a
    stub). Sinusoidal positions, then each encoder block: bidirectional
    self-attention (one ``ops.flash_attention`` call, ``causal=False``)
    and the MLP, pre-norm; then the encoder's final norm. Returns the
    decoder's ``memory``, (b, n_frames, d)."""
    x = frames + _sinusoidal(frames.shape[1], cfg.d_model,
                             frames.device).to(frames.dtype)[None]
    enc = params["encoder"]
    for p in P.unstack(enc["blocks"], cfg.encoder.n_layers):
        h = _norm(cfg, p["norm1"], x)
        x = x + attention.self_attention(cfg, p["mixer"], h, causal=False)
        x = x + layers.mlp(p["ffn"], _norm(cfg, p["norm2"], x), cfg.act)
    return _norm(cfg, enc["final_norm"], x)


def encode_sharded(cfg: ModelConfig, lay, params,
                   frames: List[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`encode` of the rows' frames (each at its row's home; ``lay``
    keeps rows whole, as no rule splits the frames): each encoder
    block's attention over ``heads`` split across ``model``
    (bidirectional) and its MLP over ``mlp``, as the decoder's; the rows'
    ``memory``. No remat wraps a block, as :func:`encode` wraps none."""
    xs = [f + _sinusoidal(f.shape[1], cfg.d_model,
                          f.device).to(f.dtype)[None] for f in frames]
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]
    enc = params["encoder"]
    for p in P.unstack(enc["blocks"], cfg.encoder.n_layers):
        hs = attention.self_attention_sharded(
            cfg, lay, p["mixer"], _norm_sharded(cfg, lay, p["norm1"], xs),
            positions, causal=False)
        xs = [x + h for x, h in zip(xs, hs)]
        hs = layers.mlp_sharded(lay, p["ffn"],
                                _norm_sharded(cfg, lay, p["norm2"], xs),
                                cfg.act)
        xs = [x + h for x, h in zip(xs, hs)]
    return _norm_sharded(cfg, lay, enc["final_norm"], xs)


# ---------------------------------------------------------------------------
# full forward passes
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict]:
    """Prefill forward. batch["tokens"]: (b, s_text) int;
    batch["frames"]: (b, n_frames, d), the encoder's input, for an
    encoder-decoder model; batch["patches"]: (b, n_patch, d), the vision
    prefix, for internvl2: the sequence is [patches ; embed(tokens)] of
    length s = n_patch + s_text, positions (RoPE) taken over all of it.

    Returns (logits (b, s, vocab), aux): the MoE router losses averaged
    over the MoE layers, zero for a model without them."""
    x = layers.embed(params["embed"], batch["tokens"], dtype)
    if has_vision_prefix(cfg):
        x = torch.cat([batch["patches"].to(dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    if _is_ln(cfg):       # whisper's decoder: sinusoidal positions
        x = x + _sinusoidal(x.shape[1], cfg.d_model,
                            x.device).to(dtype)[None]
    memory = None
    if cfg.encoder is not None:
        memory = encode(cfg, params, batch["frames"].to(dtype))
    x, aux = _stack_forward(cfg, params, x, positions, memory)
    return _head(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean token NLL plus, for an MoE model, the weighted router
    losses, as the JAX package's ``loss_fn`` adds them. A vision prefix
    carries no next-token loss: ``labels`` (b, s_text) are padded in
    front with ``num_tokens`` zeros and the prefix is masked out of
    ``loss_mask``, as in the JAX package."""
    logits, aux = forward(cfg, params, batch, dtype)
    labels, mask = _prefix_labels(cfg, batch["labels"],
                                  batch.get("loss_mask"))
    loss, metrics = layers.softmax_xent(logits, labels, mask)
    return _with_router_losses(cfg, loss, metrics, aux)


# ---------------------------------------------------------------------------
# decode: cache init + single-token step
# ---------------------------------------------------------------------------


def _block_cache(cfg: ModelConfig, mixer: str, batch: int, max_seq: int,
                 dtype: torch.dtype, device):
    if _mla(cfg, mixer):
        return mla.init_mla_cache(cfg, batch, max_seq, dtype, device)
    if mixer == "attn":
        return attention.init_kv_cache(cfg, batch, max_seq, dtype, device)
    if mixer == "mamba":
        return mamba.init_mamba_cache(cfg, batch, dtype, device)
    return rwkv.init_rwkv_cache(cfg, batch, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Per-layer decode state: a KV cache of ``max_seq`` slots (an SWA
    ring of at most ``window``) for attention, the latent and rope key
    of ``max_seq`` slots for MLA, the RWKV state or the
    Mamba state and conv tail (which do not grow with the sequence) for
    RWKV and Mamba. Stacked blocks get the per-layer cache repeated
    along a leading ``n_repeats`` dim."""
    dev = P.resolve_device(device)
    cache: Dict[str, Any] = {
        f"prefix{i}": _block_cache(cfg, mixer, batch, max_seq, dtype, dev)
        for i, (mixer, _) in enumerate(cfg.prefix_pattern)}
    stacked = {}
    for i, (mixer, _) in enumerate(cfg.block_pattern):
        one = _block_cache(cfg, mixer, batch, max_seq, dtype, dev)
        stacked[f"pos{i}"] = {
            k: v.repeat((cfg.n_repeats,) + (1,) * v.dim())
            for k, v in one.items()}
    cache["blocks"] = stacked
    return cache


def _decode_block(cfg: ModelConfig, mixer: str, ffn: str, p, x, cache,
                  index: int, memory):
    h = _norm(cfg, p["norm1"], x)
    if _mla(cfg, mixer):
        h, cache = mla.mla_decode_attention(cfg, p["mixer"], h, cache,
                                            index)
    elif (mixer == "attn" and cfg.decode_partial_softmax
          and cfg.attention == "full" and current_rules() is not None):
        h, cache = sharded_decode_attention(cfg, p["mixer"], h, cache,
                                            index, current_rules())
    elif mixer == "attn":
        h, cache = attention.decode_attention(cfg, p["mixer"], h, cache,
                                              index)
    elif mixer == "mamba":
        h, cache = mamba.mamba_decode(cfg, p["mixer"], h, cache)
    else:
        h, cache = rwkv.rwkv_decode(cfg, p["mixer"], h, cache)
    x = _cross(cfg, p, x + h, memory)
    h, _ = _ffn(cfg, ffn, p, x)
    return x + h, cache


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                index: int, memory: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, Any]:
    """token: (b, 1) int; index: tokens so far (the KV cache's write
    slot, the RoPE position and whisper's sinusoidal position; the RWKV
    and Mamba states do not use it); ``memory`` is the encoder's output,
    which every cross-attention of the step reads (its k and v are
    recomputed each step, as the JAX package recomputes them).

    Returns (logits (b, 1, vocab), new_cache); ``cache`` is not
    changed. A vision prefix is not decoded here: the JAX package's
    ``generate`` decodes text tokens only (the prefix reaches the model
    through ``forward``, as ``make_prefill_step`` and ``loss_fn`` pass
    it)."""
    x = layers.embed(params["embed"], token, dtype)
    if _is_ln(cfg):
        # the sinusoidal position at ``index``, in f32
        pos = torch.tensor(float(index), dtype=torch.float32,
                           device=x.device)
        x = x + _angles(pos, cfg.d_model).to(dtype)[None, None]
    new_cache: Dict[str, Any] = {}
    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        x, new_cache[f"prefix{i}"] = _decode_block(
            cfg, mixer, ffn, params[f"prefix{i}"], x, cache[f"prefix{i}"],
            index, memory)
    per_layer = {f"pos{i}": [] for i in range(len(cfg.block_pattern))}
    for layer in range(cfg.n_repeats):
        for i, (mixer, ffn) in enumerate(cfg.block_pattern):
            pos = f"pos{i}"
            x, c = _decode_block(
                cfg, mixer, ffn, P.tree_slice(params["blocks"][pos], layer),
                x, P.tree_slice(cache["blocks"][pos], layer), index, memory)
            per_layer[pos].append(c)
    new_cache["blocks"] = {
        pos: {k: torch.stack([c[k] for c in outs]) for k in outs[0]}
        for pos, outs in per_layer.items()}
    return _head(cfg, params, x), new_cache
