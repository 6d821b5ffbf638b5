"""Sequence-sharded decode attention with a partial-softmax combine, the
counterpart of the JAX package's ``repro/models/decode_sharded.py``.

The KV cache's sequence is split over the mesh's ``model`` axis, one
slice a position. Each position computes flash-style partials (m, l, o)
over its slice, and the exact softmax is rebuilt with one ``pmax`` and
two ``psum``s (``launch/mesh.py``), so the combine moves O(b h dh)
instead of the cache. The new token's k and v are written into the slice
that owns its slot. The batch stays whole on every position (values do
not depend on how it is split): the positions are those of the mesh's
first ``data`` index.

``models/transformer.py`` takes this path in a decode step under mesh
rules when ``cfg.decode_partial_softmax`` is set and the attention is
full (``--opt decodeps`` in the JAX package). The local products are
einsums there, and here: no kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.models import attention

NEG_INF = -1e30


def sharded_decode_attention(cfg: ModelConfig, params, x: torch.Tensor,
                             cache: Dict[str, torch.Tensor], index: int,
                             rules) -> Tuple[torch.Tensor,
                                             Dict[str, torch.Tensor]]:
    """GQA decode with the cache's sequence split over ``model``.

    x: (b, 1, d); cache k/v: (b, S, kv, hd), S divisible by the model
    axis. Returns (out (b, 1, d) on x's device, the new cache there)."""
    devs = rules.mesh.axis_devices("model")
    home = x.device
    b = x.shape[0]
    hd = cfg.head_dim
    pos = torch.full((1, 1), index, dtype=torch.int64, device=home)
    q, k_new, v_new = attention._qkv(cfg, params, x, pos)

    n_model = len(devs)
    s_total = cache["k"].shape[1]
    if s_total % n_model:
        raise ValueError(f"the cache's {s_total} slots do not split over "
                         f"a model axis of {n_model}")
    s_local = s_total // n_model
    kvh = cache["k"].shape[2]
    h_eff = q.shape[2]
    g = h_eff // kvh
    scale = hd ** -0.5

    # each position's slice of the cache, sent from the home every step
    slices = [slice(i * s_local, (i + 1) * s_local) for i in range(n_model)]
    k_slices = M.scatter([cache["k"][:, sl] for sl in slices], devs)
    v_slices = M.scatter([cache["v"][:, sl] for sl in slices], devs)
    ks, vs, scores = [], [], []
    for shard, (dev, k_shard, v_shard, q_at) in enumerate(zip(
            devs, k_slices, v_slices, M.broadcast(q, devs))):
        offset = shard * s_local
        # the owning slice writes the new slot (clipped into range);
        # the others keep theirs
        local_idx = min(max(index - offset, 0), s_local - 1)
        if offset <= index < offset + s_local:
            at = torch.tensor([local_idx], device=dev)
            k_at, v_at = M.scatter([k_new, v_new], [dev, dev])
            k_shard = k_shard.index_copy(1, at, k_at.to(k_shard.dtype))
            v_shard = v_shard.index_copy(1, at, v_at.to(v_shard.dtype))
        qg = q_at.reshape(b, 1, kvh, g, hd)
        s = torch.einsum("bqngd,bknd->bnqgk", qg.float() * scale,
                         k_shard.float())                  # (b,kv,1,g,S_l)
        slots = offset + torch.arange(s_local, device=dev)
        valid = slots <= index
        s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
        ks.append(k_shard)
        vs.append(v_shard)
        scores.append(s)

    m_glob = M.pmax([s.max(dim=-1).values for s in scores], home)
    ls, os_ = [], []
    for s, v_shard, m_at in zip(scores, vs, M.broadcast(m_glob, devs)):
        p = torch.exp(s - m_at[..., None])
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bnqgk,bknd->bqngd", p.to(v_shard.dtype),
                                v_shard).float())
    l_glob = M.psum(ls, home)
    o = M.psum(os_, home)
    o = o / torch.clamp(l_glob.transpose(1, 2), min=1e-30)[..., None]
    o = o.reshape(b, 1, h_eff, hd).to(q.dtype)
    y = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return y, {"k": M.all_gather(ks, 1, home),
               "v": M.all_gather(vs, 1, home)}
