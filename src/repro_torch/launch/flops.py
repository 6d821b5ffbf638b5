"""Analytic FLOP / byte models per (arch x shape), the JAX package's
``repro/launch/flops.py`` copied with framework-free imports: the same
counts for the same config and shape. ``chip_smoke.py`` divides
``model_flops`` of a training step by its measured time for the card's
utilisation; the JAX package's compiled-cost cross-checks and TPU
constants have no counterpart here.

Conventions: a matmul (m,k)x(k,n) costs 2mkn; train = 3x forward
(fwd + dL/dx + dL/dw); causal attention halves the score work;
SWA caps context at ``window``; MoE compute includes the capacity factor
(dispatch buffers are padded to capacity).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig


@dataclass
class CostModel:
    flops: float              # total FLOPs for one step (all chips)
    hbm_bytes: float          # total HBM traffic for one step (all chips)
    model_flops: float        # 6*N*D reference (active params for MoE)


def _attn_ctx(cfg: ModelConfig, s: int, kind: str, cache_len: int) -> float:
    """Average attended context length per query token."""
    if kind == "decode":
        ctx = cache_len
        if cfg.attention == "swa":
            ctx = min(ctx, cfg.window)
        return float(ctx)
    if cfg.attention == "swa":
        return float(min(s / 2, cfg.window))
    return s / 2  # causal


def _mixer_flops(cfg: ModelConfig, mixer: str, t: float, s: int,
                 kind: str, cache_len: int) -> float:
    d = cfg.d_model
    if mixer == "attn":
        if cfg.attention == "mla":
            m = cfg.mla
            h = cfg.eff_heads
            qdim = h * (m.nope_head_dim + m.rope_head_dim)
            f = 0.0
            if m.q_lora_rank:
                f += 2 * t * d * m.q_lora_rank + 2 * t * m.q_lora_rank * qdim
            else:
                f += 2 * t * d * qdim
            f += 2 * t * d * (m.kv_lora_rank + m.rope_head_dim)
            ctx = _attn_ctx(cfg, s, kind, cache_len)
            if kind == "decode":
                # absorbed: scores in latent space + rope, readout in latent
                f += 2 * t * h * m.nope_head_dim * m.kv_lora_rank  # absorb q
                f += 2 * t * ctx * h * (m.kv_lora_rank + m.rope_head_dim)
                f += 2 * t * ctx * h * m.kv_lora_rank
                f += 2 * t * h * m.kv_lora_rank * m.v_head_dim
            else:
                f += 2 * t * m.kv_lora_rank * h * (m.nope_head_dim
                                                   + m.v_head_dim)
                f += 2 * t * ctx * h * (m.nope_head_dim + m.rope_head_dim)
                f += 2 * t * ctx * h * m.v_head_dim
            f += 2 * t * h * m.v_head_dim * d  # output proj
            return f
        h, kv, hd = cfg.eff_heads, cfg.n_kv_heads, cfg.head_dim
        f = 2 * t * d * h * hd + 2 * 2 * t * d * kv * hd \
            + 2 * t * h * hd * d
        ctx = _attn_ctx(cfg, s, kind, cache_len)
        f += 2 * 2 * t * ctx * h * hd          # qk + pv
        return f
    if mixer == "mamba":
        mb = cfg.mamba
        di = mb.d_inner(d)
        f = 2 * t * d * 2 * di                       # in_proj
        f += 2 * mb.d_conv * t * di                  # conv
        f += 2 * t * di * (mb.dt_rank + 2 * mb.d_state)
        f += 2 * t * mb.dt_rank * di                 # dt proj
        f += 8 * t * di * mb.d_state                 # scan update + readout
        f += 2 * t * di * d                          # out proj
        return f
    if mixer == "rwkv":
        r = cfg.rwkv
        dh = r.head_dim
        f = 5 * 2 * t * d * d                        # r,k,v,g,o projections
        f += 2 * t * d * r.decay_lora * 2            # decay lora
        f += 6 * t * d * dh                          # state update + read
        return f
    raise ValueError(mixer)


def _ffn_flops(cfg: ModelConfig, ffn: str, t: float) -> float:
    d = cfg.d_model
    if ffn == "moe":
        m = cfg.moe
        f = 2 * t * d * m.num_experts                       # router
        f += 3 * 2 * t * m.top_k * m.capacity_factor * d * m.d_expert
        if m.num_shared:
            f += 3 * 2 * t * d * m.num_shared * m.d_expert
        return f
    n_mats = 2 if cfg.encoder is not None else 3            # whisper: no gate
    return n_mats * 2 * t * d * cfg.d_ff


def step_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Forward FLOPs for one step of this (arch, shape)."""
    kind = shape.kind
    b = shape.global_batch
    if kind == "decode":
        t, s, cache_len = float(b), 1, shape.seq_len
    else:
        t, s, cache_len = float(b) * shape.seq_len, shape.seq_len, 0

    total = 0.0
    for mixer, ffn in (cfg.prefix_pattern
                       + cfg.block_pattern * cfg.n_repeats):
        total += _mixer_flops(cfg, mixer, t, s, kind, cache_len)
        total += _ffn_flops(cfg, ffn, t)
        if cfg.encoder is not None:  # cross attention per decoder layer
            h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            d, fr = cfg.d_model, cfg.encoder.n_frames
            total += 2 * t * d * h * hd * 2                  # q, o proj
            total += 2 * 2 * float(b) * fr * d * kv * hd     # k, v over frames
            total += 2 * 2 * t * fr * h * hd                 # scores + pv
    total += 2 * t * cfg.d_model * cfg.vocab                 # lm head

    if cfg.encoder is not None and kind != "decode":
        # encoder runs once per step on (b, frames)
        te = float(b) * cfg.encoder.n_frames
        d, h, hd, fr = cfg.d_model, cfg.n_heads, cfg.head_dim, \
            cfg.encoder.n_frames
        enc = 2 * te * d * h * hd * 4 + 2 * 2 * te * fr * h * hd \
            + 2 * 2 * te * d * cfg.d_ff
        total += enc * cfg.encoder.n_layers
    return total


def train_flops(cfg: ModelConfig, shape: InputShape) -> float:
    return 3.0 * step_flops(cfg, shape)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """The 6*N*D (dense) / 6*N_active*D (MoE) reference."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        d_tokens = shape.global_batch
        return 2.0 * n * d_tokens          # inference: 2*N per token
    d_tokens = shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * d_tokens
    return 6.0 * n * d_tokens


# ---------------------------------------------------------------------------
# HBM traffic model
# ---------------------------------------------------------------------------


def _param_bytes(cfg: ModelConfig, bytes_per_param: int) -> float:
    return float(cfg.param_count()) * bytes_per_param


def step_bytes(cfg: ModelConfig, shape: InputShape,
               param_bytes_per_el: int = 2,
               opt_bytes_per_el: int = 0) -> float:
    """Coarse HBM traffic: weights + optimizer slots + activations + cache.

    Documented model (EXPERIMENTS.md §Roofline): training reads weights
    twice (fwd, bwd) and writes once, reads+writes optimizer slots, and
    streams ~8 activation tensors of (tokens, d_model) per layer per pass;
    decode reads all weights once per token plus the KV cache.
    """
    pw = _param_bytes(cfg, param_bytes_per_el)
    d = cfg.d_model
    if shape.kind == "decode":
        cache = 0.0
        for mixer, _ in (cfg.prefix_pattern
                         + cfg.block_pattern * cfg.n_repeats):
            if mixer == "attn":
                if cfg.attention == "mla":
                    m = cfg.mla
                    row = m.kv_lora_rank + m.rope_head_dim
                elif cfg.attention == "swa":
                    row = min(shape.seq_len, cfg.window) / shape.seq_len \
                        * cfg.n_kv_heads * cfg.head_dim * 2
                else:
                    row = cfg.n_kv_heads * cfg.head_dim * 2
                cache += shape.global_batch * shape.seq_len * row * 2
            elif mixer == "mamba":
                cache += shape.global_batch * cfg.mamba.d_inner(d) \
                    * cfg.mamba.d_state * 4 * 2        # read + write fp32
            elif mixer == "rwkv":
                hd = cfg.rwkv.head_dim
                cache += shape.global_batch * (d // hd) * hd * hd * 4 * 2
        return pw + cache
    tokens = shape.global_batch * shape.seq_len
    act = 8.0 * tokens * d * 2
    layers = cfg.n_layers
    if shape.kind == "train":
        return 3 * pw + 2 * opt_bytes_per_el / max(param_bytes_per_el, 1) \
            * pw + 2 * act * layers
    return pw + act * layers          # prefill
