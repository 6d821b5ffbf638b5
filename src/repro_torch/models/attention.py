"""GQA attention of the port's model zoo: full-causal, sliding-window,
qk-norm, RoPE; prefill and single-token decode. The counterpart of the
JAX package's ``repro/models/attention.py``.

Prefill (``self_attention``) runs through ``ops.flash_attention``: the
hand-written CUDA kernel on a CUDA tensor, the plain quadratic version
on a CPU tensor. The kernel takes any length, so the JAX package's
``q_chunk`` (``lax.map`` over query chunks) has no counterpart; it masks
by index, which is the JAX package's position mask for the consecutive
positions ``forward`` gives. ``attend`` is the JAX package's masked
attention in its (b, s, h, hd) layout, the plain path. Decode
(``decode_attention``) reads the KV cache in plain torch, as the JAX
package computes it outside any kernel, and returns a new cache; the
one it was given is not changed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import Spec

NEG_INF = -1e30
_ZOO = "ROADMAP Queue 1 item 11 (the rest of the model zoo)"


def attention_spec(cfg: ModelConfig, cross: bool = False):
    # eff_heads >= n_heads when TP head padding is on; the extra heads
    # are zero-output-initialized so the function at init matches the
    # unpadded architecture exactly.
    d, h, kv, hd = cfg.d_model, cfg.eff_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed"),
                   init="zeros" if cfg.pad_heads_to else "normal"),
    }
    if cfg.qk_norm and not cross:
        spec["q_norm"] = {"scale": Spec((hd,), ("head_dim",), init="ones",
                                        dtype=torch.float32)}
        spec["k_norm"] = {"scale": Spec((hd,), ("head_dim",), init="ones",
                                        dtype=torch.float32)}
    return spec


def _qk_norm(scale_params, x, eps):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * scale_params["scale"]).to(x.dtype)


def _mask(q_pos, k_pos, window: int, causal: bool):
    """(q, k) boolean mask. q_pos/k_pos: int position vectors."""
    d = q_pos[:, None] - k_pos[None, :]
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= d >= 0
    if window:
        m &= d < window
    return m


def attend(q, k, v, q_pos, k_pos, *, window=0, causal=True):
    """Masked attention, the plain path. q: (b, sq, h, hd); k/v:
    (b, sk, kv, hd). Returns (b, sq, h, hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    mask = _mask(q_pos, k_pos, window, causal)
    scores = torch.einsum("bqngd,bknd->bnqgk", qg.float() * hd ** -0.5,
                          k.float())
    scores = torch.where(mask[None, None, :, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnqgk,bknd->bqngd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])


def _qkv(cfg: ModelConfig, params, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dnk->bsnk", x, params["wk"])
    v = torch.einsum("bsd,dnk->bsnk", x, params["wv"])
    if cfg.qk_norm:
        q = _qk_norm(params["q_norm"], q, cfg.norm_eps)
        k = _qk_norm(params["k_norm"], k, cfg.norm_eps)
    if cfg.rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(cfg: ModelConfig, params, x, *, positions=None,
                   causal=True) -> torch.Tensor:
    """Training / prefill self-attention. x: (b, s, d); ``positions``
    (s,) the consecutive token positions (RoPE's; ``arange(s)`` when
    None)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(cfg, params, x, positions[None])
    window = cfg.window if cfg.attention == "swa" else 0
    # the kernel's layout is (b, h, s, hd), contiguous
    out = ops.flash_attention(
        *(t.transpose(1, 2).contiguous() for t in (q, k, v)),
        causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), params["wo"])


def cross_attention(cfg: ModelConfig, params, x, memory):
    raise NotImplementedError(
        f"{cfg.arch_id}: cross-attention is not ported to repro_torch yet: "
        f"{_ZOO}")


# ---------------------------------------------------------------------------
# decode (single new token against a KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """KV cache for one attention layer. SWA archs keep a ring of
    ``min(max_seq, window)`` slots."""
    slots = min(max_seq, cfg.window) if cfg.attention == "swa" else max_seq
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(cfg: ModelConfig, params, x, cache, index: int
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d); cache k/v: (b, S, kv, hd); index: count of tokens
    already in the cache. Returns (out (b, 1, d), new_cache)."""
    b = x.shape[0]
    pos = torch.full((1, 1), index, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(cfg, params, x, pos)

    slots = cache["k"].shape[1]
    slot = index % slots if cfg.attention == "swa" else index
    # lax.dynamic_update_slice clamps a start past the end to the last slot
    at = torch.tensor([min(slot, slots - 1)], device=x.device)
    k = cache["k"].index_copy(1, at, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy(1, at, v_new.to(cache["v"].dtype))

    h_eff, kvh = q.shape[2], k.shape[2]
    qg = q.reshape(b, 1, kvh, h_eff // kvh, cfg.head_dim)
    scores = torch.einsum("bqngd,bknd->bnqgk",
                          qg.float() * cfg.head_dim ** -0.5, k.float())
    slot_ids = torch.arange(slots, device=x.device)
    valid = slot_ids <= index
    if cfg.attention == "swa" and index >= slots:
        valid = torch.ones_like(valid)            # ring: all valid once full
    scores = torch.where(valid[None, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnqgk,bknd->bqngd", probs.to(v.dtype), v)
    out = out.reshape(b, 1, h_eff, cfg.head_dim)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, {"k": k, "v": v}
