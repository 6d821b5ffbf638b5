"""Multi-head latent attention (DeepSeek-V2 / MiniCPM3) of the port's
model zoo, the counterpart of the JAX package's ``repro/models/mla.py``.

A low-rank compressed KV latent (``kv_lora_rank``) under rmsnorm, a
decoupled RoPE key shared across the heads, and an optional low-rank q.
The param tree and the decode cache are the JAX package's, key for key
and shape for shape, so one numpy tree and one cache drive either
package.

Prefill (``mla_self_attention``) builds q = [q_nope, rope(q_rope)] and
k = [k_nope, rope(k_rope) broadcast over the heads] and runs them
through ``ops.flash_attention``: the hand-written CUDA kernel on a CUDA
tensor, the plain version on a CPU tensor. The kernel takes k and v of
one head dim, and v's (``v_head_dim``) is narrower than q/k's (nope +
rope), so v gets zero columns up to q's head dim at the call and the
output is sliced back: the extra columns are p . 0 = 0, and the scale
is q's head dim ** -0.5, the reference's.

Decode (``mla_decode_attention``) stores only the latent and the rope
key a token and runs the absorbed form (``w_uk`` folded into the query,
``w_uv`` applied after the latent read-out) in plain torch, as the JAX
package computes it outside any kernel; it returns a new cache and
leaves the one it was given as it was.

``mla_self_attention_sharded`` runs the layer on a mesh of more than
one device (``models/layers.py``'s ``*_sharded`` conventions): the
weights without a head dim (``w_dkv``, ``w_kr``, ``kv_norm``, ``w_dq``,
``q_norm``) are replicated over ``model``, so a row's latent, roped key
and low-rank query are computed once, at its home (a sequence split
gathers the row there first, ``Layout.whole``), and sent to its model
positions; position j holds its heads of ``w_uk``, ``w_uv``, the q
projections and ``wo``, attends with the kernel (v padded as above) and
multiplies by its rows of ``wo``; the partial outputs are summed back
into the row (``Layout.leave``). Where the heads fall back to
replication, the layer runs whole at the home.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import layers
from repro_torch.models.attention import NEG_INF
from repro_torch.models.params import Spec


def mla_spec(cfg: ModelConfig):
    m = cfg.mla
    d, h = cfg.d_model, cfg.eff_heads
    spec = {
        "w_dkv": Spec((d, m.kv_lora_rank), ("embed", "kv_lora")),
        "kv_norm": {"scale": Spec((m.kv_lora_rank,), ("kv_lora",),
                                  init="ones", dtype=torch.float32)},
        "w_kr": Spec((d, m.rope_head_dim), ("embed", "head_dim")),
        "w_uk": Spec((m.kv_lora_rank, h, m.nope_head_dim),
                     ("kv_lora", "heads", "head_dim")),
        "w_uv": Spec((m.kv_lora_rank, h, m.v_head_dim),
                     ("kv_lora", "heads", "head_dim")),
        "wo": Spec((h, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                   init="zeros" if cfg.pad_heads_to else "normal"),
    }
    if m.q_lora_rank:
        spec["w_dq"] = Spec((d, m.q_lora_rank), ("embed", "q_lora"))
        spec["q_norm"] = {"scale": Spec((m.q_lora_rank,), ("q_lora",),
                                        init="ones", dtype=torch.float32)}
        spec["w_uq_nope"] = Spec((m.q_lora_rank, h, m.nope_head_dim),
                                 ("q_lora", "heads", "head_dim"))
        spec["w_uq_rope"] = Spec((m.q_lora_rank, h, m.rope_head_dim),
                                 ("q_lora", "heads", "head_dim"))
    else:
        spec["wq_nope"] = Spec((d, h, m.nope_head_dim),
                               ("embed", "heads", "head_dim"))
        spec["wq_rope"] = Spec((d, h, m.rope_head_dim),
                               ("embed", "heads", "head_dim"))
    return spec


def _q_source(cfg: ModelConfig, params, x):
    """What the q heads project: the normed low-rank query (b, s,
    q_lora) where the model has one, else ``x``."""
    if cfg.mla.q_lora_rank:
        return layers.rmsnorm(params["q_norm"],
                              torch.einsum("bsd,dr->bsr", x, params["w_dq"]),
                              cfg.norm_eps)
    return x


def _q_heads(cfg: ModelConfig, params, src, positions):
    """(q_nope, roped q_rope), (b, s, h, .) each, of ``_q_source``'s
    ``src``."""
    if cfg.mla.q_lora_rank:
        q_nope = torch.einsum("bsr,rhk->bshk", src, params["w_uq_nope"])
        q_rope = torch.einsum("bsr,rhk->bshk", src, params["w_uq_rope"])
    else:
        q_nope = torch.einsum("bsd,dhk->bshk", src, params["wq_nope"])
        q_rope = torch.einsum("bsd,dhk->bshk", src, params["wq_rope"])
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _queries(cfg: ModelConfig, params, x, positions):
    return _q_heads(cfg, params, _q_source(cfg, params, x), positions)


def _latent(cfg: ModelConfig, params, x, positions):
    """The normed KV latent (b, s, kv_lora) and the roped key (b, s, 1,
    rope) of the tokens ``x`` at ``positions``."""
    ckv = layers.rmsnorm(params["kv_norm"],
                         torch.einsum("bsd,dr->bsr", x, params["w_dkv"]),
                         cfg.norm_eps)
    k_rope = torch.einsum("bsd,dk->bsk", x, params["w_kr"])[:, :, None, :]
    return ckv, layers.apply_rope(k_rope, positions, cfg.rope_theta)


def _kernel_layout(t: torch.Tensor, width: int) -> torch.Tensor:
    """(b, s, h, d) -> the kernel's contiguous (b, h, s, ``width``), the
    columns past d zero (d <= ``width``)."""
    t = t.transpose(1, 2)
    if t.shape[-1] < width:
        t = F.pad(t, (0, width - t.shape[-1]))
    return t.contiguous()


def _attend_heads(cfg: ModelConfig, params, src, ckv, k_rope, positions
                  ) -> torch.Tensor:
    """The heads of ``params`` (all of the model's, or a model
    position's share) attending over the latent ``ckv`` and the roped
    key ``k_rope``, then ``wo``: (b, s, d)."""
    m = cfg.mla
    b, s = ckv.shape[:2]
    q_nope, q_rope = _q_heads(cfg, params, src, positions)
    h = q_nope.shape[2]
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, params["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.rope_head_dim)], dim=-1)
    # the kernel takes k and v of one head dim: v gets zero columns up
    # to q's, which change no product, and the scale stays q's
    out = ops.flash_attention(
        *(_kernel_layout(t, q.shape[-1]) for t in (q, k, v)), causal=True,
        window=0)
    out = out[..., :m.v_head_dim].transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def mla_self_attention(cfg: ModelConfig, params, x, *, positions=None
                       ) -> torch.Tensor:
    """Training / prefill. x: (b, s, d); ``positions`` (s,) the
    consecutive token positions (``arange(s)`` when None)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    ckv, k_rope = _latent(cfg, params, x, positions[None])
    return _attend_heads(cfg, params, _q_source(cfg, params, x), ckv,
                         k_rope, positions[None])


# the weights with a head dim, split over ``model``
_HEAD_WEIGHTS = ("w_uk", "w_uv", "wo", "wq_nope", "wq_rope", "w_uq_nope",
                 "w_uq_rope")


def mla_self_attention_sharded(cfg: ModelConfig, lay, params, hs,
                               positions):
    """:func:`mla_self_attention` of each row (``hs``, in ``lay``'s
    form) over ``heads`` split across ``model``; see the module's doc.
    ``positions`` is the list of the rows' (s,) positions, whole rows'."""
    n = lay.n_tp(params["w_uk"])
    w = {k: lay.weights(params[k], n) for k in _HEAD_WEIGHTS if k in params}
    home = {k: lay.weights(params[k], 1)[0]
            for k in ("w_dkv", "w_kr", "w_dq") if k in params}
    norms = {k: lay.weights(params[k]["scale"], 1)[0]
             for k in ("kv_norm", "q_norm") if k in params}
    out = []
    for r, h in enumerate(hs):
        h = lay.whole(r, h)
        p0 = {k: v[r] for k, v in home.items()}
        p0.update({k: {"scale": v[r]} for k, v in norms.items()})
        pos = positions[r][None]
        ckv, k_rope = _latent(cfg, p0, h, pos)
        devs = [lay.dev(r, j) for j in range(n)]
        fanned = [M.fan_out(t, devs)
                  for t in (_q_source(cfg, p0, h), ckv, k_rope)]
        poss = M.broadcast(pos, devs)
        out.append(lay.leave(r, [
            _attend_heads(cfg, {k: v[j][r] for k, v in w.items()},
                          *(f[j] for f in fanned), poss[j])
            for j in range(n)]))
    return out


# ---------------------------------------------------------------------------
# decode with compressed latent cache (absorbed formulation)
# ---------------------------------------------------------------------------


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16, device="cuda"
                   ) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, max_seq, m.rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode_attention(cfg: ModelConfig, params, x, cache, index: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d); the cache holds latents only: ckv (b, S, kv_lora)
    and k_rope (b, S, rope); index: count of tokens already in it.
    Returns (out (b, 1, d), new_cache)."""
    m = cfg.mla
    pos = torch.full((1, 1), index, dtype=torch.int64, device=x.device)
    ckv_t, kr_t = _latent(cfg, params, x, pos)
    slots = cache["ckv"].shape[1]
    # lax.dynamic_update_slice clamps a start past the end to the last slot
    at = torch.tensor([min(index, slots - 1)], device=x.device)
    ckv = cache["ckv"].index_copy(1, at, ckv_t.to(cache["ckv"].dtype))
    k_rope = cache["k_rope"].index_copy(
        1, at, kr_t[:, :, 0, :].to(cache["k_rope"].dtype))

    q_nope, q_rope = _queries(cfg, params, x, pos)
    # absorb W_uk into the query: the scores contract in latent space
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    scores = (torch.einsum("bshr,bSr->bhsS", q_lat.float(), ckv.float())
              + torch.einsum("bshk,bSk->bhsS", q_rope.float(),
                             k_rope.float())) * scale
    valid = torch.arange(slots, device=x.device) <= index
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhsS,bSr->bshr", probs.to(ckv.dtype), ckv)
    out = torch.einsum("bshr,rhk->bshk", out_lat, params["w_uv"])
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, {"ckv": ckv, "k_rope": k_rope}
