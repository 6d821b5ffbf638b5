"""RWKV-6 "Finch" time-mix of the port's model zoo, the counterpart of
the JAX package's ``repro/models/rwkv.py``: linear attention with
data-dependent decay.

Per-channel decay produced by a LoRA on the token-shifted input, bonus
``u`` on the current token, per-head matrix state S of shape
(head_dim, head_dim), group-norm on the read-out, silu output gate.
Token-shift uses learned static mix coefficients (DESIGN.md).

Prefill (``rwkv_mixer``) runs the recurrence through ``ops.rwkv6_wkv``:
the hand-written CUDA kernel on a CUDA tensor, the plain sequential loop
on a CPU tensor. ``wkv_scan`` is the recurrence in the mixer's
(b, s, h, dh) layout with a starting state, as the JAX package keeps it.
Decode (``rwkv_decode``) updates the state one step inline and launches
no WKV kernel, as the JAX package does.

``rwkv_mixer_sharded`` runs the time-mix on a mesh of more than one
device (``models/layers.py``'s ``*_sharded`` conventions): model
position j holds its heads' share of the projections, ``decay_b``, the
per-head ``bonus`` / ``decay_base`` / group norm and the rows of
``w_o``, and the whole ``decay_a`` and token-shift mixes; every head's
work is its own, so each position runs ``rwkv_mixer`` on its heads (the
WKV kernel on (b_row, h / n, s, dh)) on its row whole
(``Layout.enter``) and its output is that position's partial product
with ``w_o``, summed back into the row (``Layout.leave``). Under a
sequence split the row is gathered, not walked cell by cell with a
state passed on (neither WKV kernel takes a starting state): the token
shift and the recurrence see the whole sequence, so a cell boundary
needs no halo. Where the heads fall back to replication, the layer
runs whole at the home.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rwkv6_ref
from repro_torch.models.params import Spec


def rwkv_spec(cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.rwkv
    h = d // r.head_dim
    dh = r.head_dim
    spec = {
        "w_r": Spec((d, h, dh), ("embed", "heads", "head_dim")),
        "w_k": Spec((d, h, dh), ("embed", "heads", "head_dim")),
        "w_v": Spec((d, h, dh), ("embed", "heads", "head_dim")),
        "w_g": Spec((d, h, dh), ("embed", "heads", "head_dim")),
        "w_o": Spec((h, dh, d), ("heads", "head_dim", "embed")),
        "decay_base": Spec((h, dh), ("heads", "head_dim"), init="ones",
                           scale=1.0, dtype=torch.float32),
        "decay_a": Spec((d, r.decay_lora), ("embed", None)),
        "decay_b": Spec((r.decay_lora, h, dh), (None, "heads", "head_dim")),
        "bonus": Spec((h, dh), ("heads", "head_dim"), init="ones",
                      scale=0.5, dtype=torch.float32),
        "gn_scale": Spec((h, dh), ("heads", "head_dim"), init="ones",
                         dtype=torch.float32),
        "gn_bias": Spec((h, dh), ("heads", "head_dim"), init="zeros",
                        dtype=torch.float32),
    }
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        spec[name] = Spec((d,), ("embed",), init="ones", scale=0.5,
                          dtype=torch.float32)
    return spec


def wkv_scan(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 recurrence in the mixer's layout.

    r,k,v,w: (b, s, h, dh) fp32 (w = per-step decay in (0,1));
    u: (h, dh); s0: (b, h, dh, dh) with S[j, i] indexed [key_dim, val_dim].
    Returns (y (b,s,h,dh), s_final).
    """
    y, s_t = rwkv6_ref(*(x.transpose(1, 2) for x in (r, k, v, w)), u, s0)
    return y.transpose(1, 2), s_t


def _project(x, wmat):
    """(b, s, d) @ (d, h, k) -> (b, s, h, k)."""
    d, h, k = wmat.shape
    return (x @ wmat.reshape(d, h * k)).unflatten(-1, (h, k))


def _mix(x, x_prev, mu):
    return x + mu.to(x.dtype) * (x_prev - x)


def _decay(cfg, params, mix_w):
    # the LoRA output goes to f32 before exp(-exp(.)); decay_base is f32
    lora = _project(torch.tanh(mix_w @ params["decay_a"]),
                    params["decay_b"]).float()
    return torch.exp(-torch.exp(params["decay_base"] + lora))


def _groupnorm(params, y, eps=1e-5):
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)     # jnp.var: population
    return (y - mean) * torch.rsqrt(var + eps) * params["gn_scale"] \
        + params["gn_bias"]


def _out(params, y):
    """(b, s, h, k) @ (h, k, d) -> (b, s, d)."""
    h, k, d = params["w_o"].shape
    return y.flatten(-2) @ params["w_o"].reshape(h * k, d)


def rwkv_mixer(cfg: ModelConfig, params, x) -> torch.Tensor:
    """Training / prefill. x: (b, s, d)."""
    # token shift: one zero step in front, the last step dropped
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r = _project(_mix(x, x_prev, params["mu_r"]), params["w_r"])
    k = _project(_mix(x, x_prev, params["mu_k"]), params["w_k"])
    v = _project(_mix(x, x_prev, params["mu_v"]), params["w_v"])
    g = F.silu(_project(_mix(x, x_prev, params["mu_g"]), params["w_g"]))
    w = _decay(cfg, params, _mix(x, x_prev, params["mu_w"]))

    # the kernel's layout is (b, h, s, dh); the recurrence starts at 0
    y, _ = ops.rwkv6_wkv(
        *(t.float().transpose(1, 2).contiguous() for t in (r, k, v, w)),
        params["bonus"])
    y = _groupnorm(params, y.transpose(1, 2)).to(x.dtype) * g
    return _out(params, y)


def rwkv_mixer_sharded(cfg: ModelConfig, lay, params, hs):
    """:func:`rwkv_mixer` of each row (``hs`` in ``lay``'s form) over
    ``heads`` split across ``model``; see the module's doc."""
    n = lay.n_tp(params["w_r"])
    w = {k: lay.weights(v, n) for k, v in params.items()}
    out = []
    for r, h in enumerate(hs):
        xs = lay.enter(r, h, n)
        out.append(lay.leave(r, [
            rwkv_mixer(cfg, {k: v[j][r] for k, v in w.items()}, xs[j])
            for j in range(n)]))
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_rwkv_cache(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    h = d // cfg.rwkv.head_dim
    return {
        "x_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "s": torch.zeros((batch, h, cfg.rwkv.head_dim, cfg.rwkv.head_dim),
                         dtype=torch.float32, device=device),
    }


def rwkv_decode(cfg: ModelConfig, params, x, cache
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d). O(1) state update."""
    x_prev = cache["x_prev"].to(x.dtype)[:, None, :]
    r = _project(_mix(x, x_prev, params["mu_r"]), params["w_r"])
    k = _project(_mix(x, x_prev, params["mu_k"]), params["w_k"])
    v = _project(_mix(x, x_prev, params["mu_v"]), params["w_v"])
    g = F.silu(_project(_mix(x, x_prev, params["mu_g"]), params["w_g"]))
    w = _decay(cfg, params, _mix(x, x_prev, params["mu_w"]))

    rt = r[:, 0].float()
    kt = k[:, 0].float()
    vt = v[:, 0].float()
    wt = w[:, 0]
    kv = kt[..., :, None] * vt[..., None, :]
    y = torch.einsum("bhj,bhji->bhi", rt,
                     cache["s"] + params["bonus"][..., :, None] * kv)
    s = wt[..., :, None] * cache["s"] + kv
    y = _groupnorm(params, y)[:, None].to(x.dtype) * g
    out = _out(params, y)
    return out, {"x_prev": x[:, 0].to(cache["x_prev"].dtype), "s": s}
