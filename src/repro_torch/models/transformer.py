"""Model assembly of the port's model zoo: block -> stack -> LM. The
counterpart of the JAX package's ``repro/models/transformer.py``.

This slice runs the decoder-only families whose blocks are an RWKV-6
time-mix and a gated MLP under rmsnorm (``rwkv6-7b``). The other mixers
and FFNs, the encoder and the modality prefixes raise
``NotImplementedError`` naming the ROADMAP item that ports them.

Layer stacks keep the JAX package's *stacked* layout (every leaf of
``params["blocks"]["pos<i>"]`` has a leading ``n_repeats`` dim), so one
numpy tree drives either package; where the JAX package runs
``lax.scan`` over that dim, the port walks it with a Python loop.
``cfg.remat_policy`` (``jax.checkpoint`` around each repeat) has no
counterpart: serving runs under ``torch.inference_mode``, which keeps
nothing for a backward pass. The JAX package's sharding constraints are
the identity on one device and are dropped.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, params as P
from repro_torch.models import rwkv

# ROADMAP Queue 1 items that port what this slice does not run
_GRANITE = "ROADMAP Queue 1 item 3 (the granite-moe slice)"
_MAMBA = "ROADMAP Queue 1 item 4 (the Mamba slice)"
_ZOO = "ROADMAP Queue 1 item 11 (the rest of the model zoo)"


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: {item}")


def _check_block(cfg: ModelConfig, mixer: str, ffn: str) -> None:
    if mixer == "attn":
        if cfg.attention == "mla":
            raise _unported(f"{cfg.arch_id}: the MLA mixer", _ZOO)
        raise _unported(f"{cfg.arch_id}: the attention mixer", _GRANITE)
    if mixer == "mamba":
        raise _unported(f"{cfg.arch_id}: the Mamba mixer", _MAMBA)
    if ffn == "moe":
        raise _unported(f"{cfg.arch_id}: the MoE FFN", _GRANITE)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless this slice runs ``cfg``."""
    if cfg.encoder is not None:
        raise _unported(f"{cfg.arch_id}: the encoder", _ZOO)
    if cfg.frontend is not None:
        raise _unported(f"{cfg.arch_id}: the {cfg.frontend.kind} prefix",
                        _ZOO)
    for mixer, ffn in cfg.prefix_pattern + cfg.block_pattern:
        _check_block(cfg, mixer, ffn)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, mixer: str, ffn: str):
    _check_block(cfg, mixer, ffn)
    return {"norm1": layers.rmsnorm_spec(cfg.d_model),
            "mixer": rwkv.rwkv_spec(cfg),
            "norm2": layers.rmsnorm_spec(cfg.d_model),
            "ffn": layers.gated_mlp_spec(cfg.d_model, cfg.d_ff)}


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


def _apply_block(cfg: ModelConfig, p, x) -> torch.Tensor:
    h = rwkv.rwkv_mixer(cfg, p["mixer"],
                        layers.rmsnorm(p["norm1"], x, cfg.norm_eps))
    x = x + h
    h = layers.gated_mlp(p["ffn"],
                         layers.rmsnorm(p["norm2"], x, cfg.norm_eps),
                         cfg.act)
    return x + h


def _stack_forward(cfg: ModelConfig, params, x) -> torch.Tensor:
    """Prefix blocks, then the pattern blocks, repeat by repeat."""
    for i in range(len(cfg.prefix_pattern)):
        x = _apply_block(cfg, params[f"prefix{i}"], x)
    for layer in range(cfg.n_repeats):
        for i in range(len(cfg.block_pattern)):
            x = _apply_block(
                cfg, P.tree_slice(params["blocks"][f"pos{i}"], layer), x)
    return x


def _head(cfg: ModelConfig, params, x) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return layers.unembed(params["lm_head"], x)


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict]:
    """Prefill forward. batch["tokens"]: (b, s) int.

    Returns (logits (b, s, vocab), aux); aux holds the MoE router losses
    of the JAX package, zero for the families ported here."""
    check_ported(cfg)
    x = layers.embed(params["embed"], batch["tokens"], dtype)
    x = _stack_forward(cfg, params, x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cfg, params, x), {"load_balance": zero, "router_z": zero}


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict]:
    logits, _ = forward(cfg, params, batch, dtype)
    loss, metrics = layers.softmax_xent(logits, batch["labels"],
                                        batch.get("loss_mask"))
    metrics["total_loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# decode: cache init + single-token step
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Per-layer RWKV state (``max_seq`` is unused: the state does not
    grow with the sequence). Stacked blocks get the per-layer cache
    repeated along a leading ``n_repeats`` dim."""
    check_ported(cfg)
    dev = P.resolve_device(device)
    cache: Dict[str, Any] = {
        f"prefix{i}": rwkv.init_rwkv_cache(cfg, batch, dtype, dev)
        for i in range(len(cfg.prefix_pattern))}
    stacked = {}
    for i in range(len(cfg.block_pattern)):
        one = rwkv.init_rwkv_cache(cfg, batch, dtype, dev)
        stacked[f"pos{i}"] = {
            k: v.repeat((cfg.n_repeats,) + (1,) * v.dim())
            for k, v in one.items()}
    cache["blocks"] = stacked
    return cache


def _decode_block(cfg: ModelConfig, p, x, cache):
    h, cache = rwkv.rwkv_decode(cfg, p["mixer"],
                                layers.rmsnorm(p["norm1"], x, cfg.norm_eps),
                                cache)
    x = x + h
    h = layers.gated_mlp(p["ffn"],
                         layers.rmsnorm(p["norm2"], x, cfg.norm_eps),
                         cfg.act)
    return x + h, cache


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                index, memory: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, Any]:
    """token: (b, 1) int; index: tokens so far (unused by the RWKV state,
    kept for the JAX package's signature); ``memory`` is the encoder's,
    which no ported family has.

    Returns (logits (b, 1, vocab), new_cache); ``cache`` is not
    changed."""
    check_ported(cfg)
    if memory is not None:
        raise _unported("cross-attention memory", _ZOO)
    x = layers.embed(params["embed"], token, dtype)
    new_cache: Dict[str, Any] = {}
    for i in range(len(cfg.prefix_pattern)):
        x, new_cache[f"prefix{i}"] = _decode_block(
            cfg, params[f"prefix{i}"], x, cache[f"prefix{i}"])
    per_layer = {f"pos{i}": [] for i in range(len(cfg.block_pattern))}
    for layer in range(cfg.n_repeats):
        for pos, outs in per_layer.items():
            x, c = _decode_block(
                cfg, P.tree_slice(params["blocks"][pos], layer), x,
                P.tree_slice(cache["blocks"][pos], layer))
            outs.append(c)
    new_cache["blocks"] = {
        pos: {k: torch.stack([c[k] for c in outs]) for k in outs[0]}
        for pos, outs in per_layer.items()}
    return _head(cfg, params, x), new_cache
