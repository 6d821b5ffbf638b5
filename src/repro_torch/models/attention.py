"""GQA attention of the port's model zoo: full-causal, sliding-window,
qk-norm, RoPE; prefill and single-token decode; whisper's bidirectional
encoder attention and its decoder's cross-attention. The counterpart of
the JAX package's ``repro/models/attention.py``.

Prefill (``self_attention``) and cross-attention (``cross_attention``,
in prefill and in every decode step) run through ``ops.flash_attention``: the
hand-written CUDA kernel on a CUDA tensor, the plain quadratic version
on a CPU tensor. The kernel takes any length, so the JAX package's
``q_chunk`` (``lax.map`` over query chunks) has no counterpart; it masks
by index, which is the JAX package's position mask for the consecutive
positions ``forward`` gives. ``attend`` is the JAX package's masked
attention in its (b, s, h, hd) layout, the plain path. Decode
(``decode_attention``) reads the KV cache in plain torch, as the JAX
package computes it outside any kernel, and returns a new cache; the
one it was given is not changed.

The projections are 2-D matmuls (``_proj``: ``aten.mm``), so remat
``minimal`` keeps their outputs, as the JAX package's
``dots_with_no_batch_dims_saveable`` keeps its projections'.

``self_attention_sharded`` runs the layer on a mesh of more than one
device (``models/layers.py``'s ``*_sharded`` conventions): model
position j projects its heads' columns of ``wq`` (and of ``wk`` /
``wv`` over ``kv_heads``), attends with the kernel, and multiplies by
its rows of ``wo`` on its row whole (``Layout.enter``); the partial
outputs are summed back into the row (``Layout.leave``: at its home, or
reduce-scattered to its sequence cells). Where the KV heads fall back
to replication (glm4's 2 on a model axis of 4), position j passes the
kernel only the KV heads its q heads use.
``cross_attention_sharded`` splits whisper's cross-attention alike, k
and v projected from each row's encoder output; both take each
position's weights from ``_head_shares``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import layers
from repro_torch.models.params import Spec

NEG_INF = -1e30


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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (..., d) against ``w`` (d, ...) as one 2-D matmul: (...,
    w.shape[1:])."""
    d = w.shape[0]
    y = x.reshape(-1, d) @ w.reshape(d, -1)
    return y.reshape(x.shape[:-1] + w.shape[1:])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(b, s, h, hd) heads against ``wo`` (h, hd, d): (b, s, d)."""
    b, s = out.shape[:2]
    return (out.reshape(b * s, -1) @ wo.reshape(-1, wo.shape[-1])
            ).reshape(b, s, wo.shape[-1])


def _qkv(cfg: ModelConfig, params, x, positions):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
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
    return _attend_out(params, q, k, v, causal, window)


def _attend_out(params, q, k, v, causal: bool, window: int) -> torch.Tensor:
    """``ops.flash_attention`` of q (b, sq, h, hd) against k, v (b, sk,
    kv, hd), in the kernel's contiguous (b, h, s, hd) layout, then the
    output projection: (b, sq, d)."""
    out = ops.flash_attention(
        *(t.transpose(1, 2).contiguous() for t in (q, k, v)),
        causal=causal, window=window)
    return _out_proj(out.transpose(1, 2), params["wo"])


def cross_attention(cfg: ModelConfig, params, x, memory) -> torch.Tensor:
    """Decoder -> encoder attention (whisper). x: (b, s, d); memory:
    (b, frames, d). q from ``x``, k and v from ``memory``, no qk-norm and
    no RoPE, every frame visible to every query: one
    ``ops.flash_attention`` call with ``causal=False`` (sq != sk in
    prefill, sq = 1 in a decode step). k and v are recomputed from
    ``memory`` on every call, as the JAX package recomputes them."""
    q = _proj(x, params["wq"])
    k = _proj(memory, params["wk"])
    v = _proj(memory, params["wv"])
    return _attend_out(params, q, k, v, False, 0)


def kv_heads_of(n_heads: int, n_kv: int, h_local: int, j: int):
    """The KV heads model position j's q heads ``[j h_local, (j + 1)
    h_local)`` read, as (lo, hi, index): the kernel maps q head i of a
    call to KV head i // (q heads / KV heads), so a slice ``lo:hi``
    serves where that map holds (index None), else ``index`` gives each
    q head its own KV head."""
    g = n_heads // n_kv
    want = [(j * h_local + i) // g for i in range(h_local)]
    lo, hi = want[0], want[-1] + 1
    if h_local % (hi - lo) == 0 and want == [
            lo + i // (h_local // (hi - lo)) for i in range(h_local)]:
        return lo, hi, None
    return lo, hi, torch.tensor(want)


def _head_shares(cfg: ModelConfig, lay, params):
    """(n, at): the model positions that share the layer's heads, and
    ``at(r, j)``, the params position (r, j) computes with: its heads'
    columns of ``wq`` (and of ``wk`` / ``wv`` over ``kv_heads``), its
    rows of ``wo``, the qk-norm scales where the layer has them. Where
    the KV heads fall back to replication, ``wk`` / ``wv`` hold only the
    KV heads its q heads read (``kv_heads_of``)."""
    n = lay.n_tp(params["wq"])
    kv_split = n > 1 and lay.n_tp(params["wk"]) == n
    h_l = cfg.eff_heads // n
    w = {k: lay.weights(params[k], n) for k in ("wq", "wk", "wv", "wo")}
    norms = {k: lay.weights(params[k]["scale"], n)
             for k in ("q_norm", "k_norm") if k in params}

    def at(r: int, j: int):
        p = {k: v[j][r] for k, v in w.items()}
        p.update({k: {"scale": v[j][r]} for k, v in norms.items()})
        if n > 1 and not kv_split:
            lo, hi, idx = kv_heads_of(cfg.eff_heads, cfg.n_kv_heads, h_l, j)
            for k in ("wk", "wv"):
                p[k] = p[k][:, lo:hi] if idx is None \
                    else p[k][:, idx.to(p[k].device)]
        return p
    return n, at


def self_attention_sharded(cfg: ModelConfig, lay, params, hs, positions,
                           causal: bool = True):
    """:func:`self_attention` of each row (``hs``, in ``lay``'s form)
    over ``heads`` split across ``model``; see the module's doc.
    ``positions`` is the list of the rows' (s,) positions, whole rows'."""
    n, at = _head_shares(cfg, lay, params)
    window = cfg.window if cfg.attention == "swa" else 0
    out = []
    for r, h in enumerate(hs):
        xs = lay.enter(r, h, n)
        partial = []
        for j in range(n):
            p = at(r, j)
            pos = M.broadcast(positions[r], [xs[j].device])[0]
            q, k, v = _qkv(cfg, p, xs[j], pos[None])
            partial.append(_attend_out(p, q, k, v, causal, window))
        out.append(lay.leave(r, partial))
    return out


def cross_attention_sharded(cfg: ModelConfig, lay, params, hs, memory):
    """:func:`cross_attention` of each row over ``heads`` split across
    ``model``: position j projects q from the row's ``hs`` with its
    heads' columns of ``wq`` (the row whole: a sequence split gathers
    it) and k, v from the row's ``memory`` (the encoder's output, whole
    at the row's home: no rule splits the frames) with its share of
    ``wk`` / ``wv``, attends with the kernel, bidirectional, and
    multiplies by its rows of ``wo``; the partial outputs are summed
    back into the row."""
    n, at = _head_shares(cfg, lay, params)
    out = []
    for r, (h, mem) in enumerate(zip(hs, memory)):
        xs = lay.enter(r, h, n)
        ms = M.fan_out(mem, [lay.dev(r, j) for j in range(n)])
        partial = []
        for j in range(n):
            p = at(r, j)
            q = _proj(xs[j], p["wq"])
            k, v = _proj(ms[j], p["wk"]), _proj(ms[j], p["wv"])
            partial.append(_attend_out(p, q, k, v, False, 0))
        out.append(lay.leave(r, partial))
    return out


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
    return _out_proj(out, params["wo"]), {"k": k, "v": v}
