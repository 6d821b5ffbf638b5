"""Model assembly of the port's model zoo: block -> stack -> LM. The
counterpart of the JAX package's ``repro/models/transformer.py``.

This slice runs the decoder-only families whose blocks are GQA attention
(full, sliding-window, qk-norm; RoPE) or an RWKV-6 time-mix, followed by
a gated MLP or a mixture of experts, under rmsnorm: ``rwkv6-7b``,
``granite-moe-3b-a800m``, ``glm4-9b``, ``qwen3-14b`` and
``h2o-danube-1.8b``. MLA, the Mamba mixer, the encoder and the modality
prefixes raise ``NotImplementedError`` naming the ROADMAP item that
ports them.

Layer stacks keep the JAX package's *stacked* layout (every leaf of
``params["blocks"]["pos<i>"]`` has a leading ``n_repeats`` dim), so one
numpy tree drives either package; where the JAX package runs
``lax.scan`` over that dim, the port walks it with a Python loop.
``cfg.remat_policy`` (``jax.checkpoint`` around each repeat) has no
counterpart: serving runs under ``torch.inference_mode``, which keeps
nothing for a backward pass. The JAX package's sharding constraints are
the identity on one device and are dropped, and so is its
``decode_partial_softmax`` branch, which it takes only under mesh rules.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe, params as P
from repro_torch.models import rwkv

# ROADMAP Queue 1 items that port what this slice does not run
_MAMBA = "ROADMAP Queue 1 item 4 (the Mamba slice)"
_ZOO = "ROADMAP Queue 1 item 11 (the rest of the model zoo)"
_AUX = ("load_balance", "router_z")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: {item}")


def _check_block(cfg: ModelConfig, mixer: str) -> None:
    if mixer == "attn" and cfg.attention == "mla":
        raise _unported(f"{cfg.arch_id}: the MLA mixer", _ZOO)
    if mixer == "mamba":
        raise _unported(f"{cfg.arch_id}: the Mamba mixer", _MAMBA)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless this slice runs ``cfg``."""
    if cfg.encoder is not None:
        raise _unported(f"{cfg.arch_id}: the encoder", _ZOO)
    if cfg.frontend is not None:
        raise _unported(f"{cfg.arch_id}: the {cfg.frontend.kind} prefix",
                        _ZOO)
    for mixer, _ in cfg.prefix_pattern + cfg.block_pattern:
        _check_block(cfg, mixer)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, mixer: str, ffn: str):
    _check_block(cfg, mixer)
    return {"norm1": layers.rmsnorm_spec(cfg.d_model),
            "mixer": (attention.attention_spec(cfg) if mixer == "attn"
                      else rwkv.rwkv_spec(cfg)),
            "norm2": layers.rmsnorm_spec(cfg.d_model),
            "ffn": (moe.moe_spec(cfg) if ffn == "moe"
                    else layers.gated_mlp_spec(cfg.d_model, cfg.d_ff))}


def model_spec(cfg: ModelConfig):
    check_ported(cfg)
    spec: Dict[str, Any] = {
        "embed": layers.embedding_spec(cfg.vocab, cfg.d_model),
        "final_norm": layers.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = layers.unembed_spec(cfg.vocab, cfg.d_model)
    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        spec[f"prefix{i}"] = block_spec(cfg, mixer, ffn)
    spec["blocks"] = {
        f"pos{i}": P.stack(block_spec(cfg, mixer, ffn), cfg.n_repeats)
        for i, (mixer, ffn) in enumerate(cfg.block_pattern)}
    return spec


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ffn(cfg: ModelConfig, ffn: str, p, x
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        return moe.moe_ffn(cfg, p["ffn"], h, cfg.act)
    return layers.gated_mlp(p["ffn"], h, cfg.act), {}


def _apply_block(cfg: ModelConfig, mixer: str, ffn: str, p, x,
                 positions) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        h = attention.self_attention(cfg, p["mixer"], h,
                                     positions=positions)
    else:
        h = rwkv.rwkv_mixer(cfg, p["mixer"], h)
    x = x + h
    h, aux = _ffn(cfg, ffn, p, x)
    return x + h, aux


def _stack_forward(cfg: ModelConfig, params, x, positions
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefix blocks, then the pattern blocks, repeat by repeat. The
    router losses are summed over the MoE layers and averaged."""
    aux_losses = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                  for k in _AUX}

    def run(mixer, ffn, p, x):
        x, aux = _apply_block(cfg, mixer, ffn, p, x, positions)
        for k in aux:
            aux_losses[k] = aux_losses[k] + aux[k]
        return x

    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        x = run(mixer, ffn, params[f"prefix{i}"], x)
    for layer in range(cfg.n_repeats):
        for i, (mixer, ffn) in enumerate(cfg.block_pattern):
            x = run(mixer, ffn,
                    P.tree_slice(params["blocks"][f"pos{i}"], layer), x)
    n_moe = sum(f == "moe" for _, f in
                cfg.prefix_pattern + cfg.block_pattern * cfg.n_repeats)
    if n_moe:
        aux_losses = {k: v / n_moe for k, v in aux_losses.items()}
    return x, aux_losses


def _head(cfg: ModelConfig, params, x) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return layers.unembed(params["lm_head"], x)


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict]:
    """Prefill forward. batch["tokens"]: (b, s) int.

    Returns (logits (b, s, vocab), aux): the MoE router losses averaged
    over the MoE layers, zero for a model without them."""
    check_ported(cfg)
    x = layers.embed(params["embed"], batch["tokens"], dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _stack_forward(cfg, params, x, positions)
    return _head(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean token NLL plus, for an MoE model, the weighted router
    losses, as the JAX package's ``loss_fn`` adds them."""
    logits, aux = forward(cfg, params, batch, dtype)
    loss, metrics = layers.softmax_xent(logits, batch["labels"],
                                        batch.get("loss_mask"))
    total = loss
    if cfg.moe is not None:
        total = (total
                 + cfg.moe.router_aux_weight * aux["load_balance"]
                 + cfg.moe.router_z_weight * aux["router_z"])
        metrics["load_balance"] = aux["load_balance"]
    metrics["total_loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# decode: cache init + single-token step
# ---------------------------------------------------------------------------


def _block_cache(cfg: ModelConfig, mixer: str, batch: int, max_seq: int,
                 dtype: torch.dtype, device):
    if mixer == "attn":
        return attention.init_kv_cache(cfg, batch, max_seq, dtype, device)
    return rwkv.init_rwkv_cache(cfg, batch, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Per-layer decode state: a KV cache of ``max_seq`` slots (an SWA
    ring of at most ``window``) for attention, the RWKV state (which does
    not grow with the sequence) for RWKV. Stacked blocks get the
    per-layer cache repeated along a leading ``n_repeats`` dim."""
    check_ported(cfg)
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
                  index: int):
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        h, cache = attention.decode_attention(cfg, p["mixer"], h, cache,
                                              index)
    else:
        h, cache = rwkv.rwkv_decode(cfg, p["mixer"], h, cache)
    x = x + h
    h, _ = _ffn(cfg, ffn, p, x)
    return x + h, cache


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                index: int, memory: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, Any]:
    """token: (b, 1) int; index: tokens so far (the KV cache's write
    slot and the RoPE position; the RWKV state does not use it);
    ``memory`` is the encoder's, which no ported family has.

    Returns (logits (b, 1, vocab), new_cache); ``cache`` is not
    changed."""
    check_ported(cfg)
    if memory is not None:
        raise _unported("cross-attention memory", _ZOO)
    x = layers.embed(params["embed"], token, dtype)
    new_cache: Dict[str, Any] = {}
    for i, (mixer, ffn) in enumerate(cfg.prefix_pattern):
        x, new_cache[f"prefix{i}"] = _decode_block(
            cfg, mixer, ffn, params[f"prefix{i}"], x, cache[f"prefix{i}"],
            index)
    per_layer = {f"pos{i}": [] for i in range(len(cfg.block_pattern))}
    for layer in range(cfg.n_repeats):
        for i, (mixer, ffn) in enumerate(cfg.block_pattern):
            pos = f"pos{i}"
            x, c = _decode_block(
                cfg, mixer, ffn, P.tree_slice(params["blocks"][pos], layer),
                x, P.tree_slice(cache["blocks"][pos], layer), index)
            per_layer[pos].append(c)
    new_cache["blocks"] = {
        pos: {k: torch.stack([c[k] for c in outs]) for k in outs[0]}
        for pos, outs in per_layer.items()}
    return _head(cfg, params, x), new_cache
