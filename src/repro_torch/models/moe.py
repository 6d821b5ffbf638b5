"""Mixture-of-experts FFN with top-k routing and capacity-based dispatch,
the counterpart of the JAX package's ``repro/models/moe.py``.

Every expert matmul (gate, up and down projections of the per-expert
capacity buffer) runs through ``ops.moe_gmm``: the hand-written CUDA
kernel on a CUDA tensor, the plain f32 einsum on a CPU tensor. Routing,
dispatch and combine are plain torch, as the JAX package leaves them to
XLA. Shared experts (DeepSeek style) run densely on every token.

Aux losses: GShard load-balance loss and router z-loss, returned per call
and averaged over layers by the caller. The JAX package's sharding
constraints are the identity on one device and are dropped.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import Spec

MOE_DISPATCH_CHUNK = 128


def moe_spec(cfg: ModelConfig):
    m = cfg.moe
    d = cfg.d_model
    e_ax = "experts" if cfg.moe_expert_parallel else "experts_dp"
    spec = {
        "router": Spec((d, m.num_experts), ("embed", "experts_dp"),
                       dtype=torch.float32),
        "w_gate": Spec((m.num_experts, d, m.d_expert),
                       (e_ax, "embed", "expert_mlp")),
        "w_up": Spec((m.num_experts, d, m.d_expert),
                     (e_ax, "embed", "expert_mlp")),
        "w_down": Spec((m.num_experts, m.d_expert, d),
                       (e_ax, "expert_mlp", "embed")),
    }
    if m.num_shared:
        spec["shared"] = layers.gated_mlp_spec(d, m.num_shared * m.d_expert)
    return spec


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, (c + 3) // 4 * 4)


def _act(act: str):
    # the JAX package takes gelu for every act but silu
    return F.silu if act == "silu" else layers._gelu


def _route(cfg: ModelConfig, x32: torch.Tensor, router: torch.Tensor):
    """Top-k routing of the f32 tokens ``x32`` (..., d). Returns (gate
    values renormalized over the k picks, the picks, aux losses)."""
    m = cfg.moe
    logits = x32 @ router                                       # (..., E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = torch.topk(probs, m.top_k, dim=-1)         # (..., k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)              # renormalize
    lead = tuple(range(probs.dim() - 1))
    me = probs.mean(dim=lead)                                   # (E,)
    ce = F.one_hot(sel[..., 0], m.num_experts).float().mean(dim=lead)
    aux = {
        "load_balance": m.num_experts * torch.sum(me * ce),
        "router_z": torch.logsumexp(logits, -1).square().mean(),
    }
    return gate_vals, sel, aux


def _experts(params, buf: torch.Tensor, act: str) -> torch.Tensor:
    """The gated expert MLP on the capacity buffer (e, c, d): three
    launches of the grouped matmul."""
    a = ops.moe_gmm(buf, params["w_gate"])
    u = ops.moe_gmm(buf, params["w_up"])
    return ops.moe_gmm(_act(act)(a) * u, params["w_down"])


def moe_ffn(cfg: ModelConfig, params, x, act: str = "silu"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if cfg.moe_group_dispatch:
        return moe_ffn_grouped(cfg, params, x, act)
    return moe_ffn_global(cfg, params, x, act)


def moe_ffn_global(cfg: ModelConfig, params, x, act: str = "silu"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GLOBAL token-priority dispatch: capacity slots go to assignments
    in token-major order over the whole batch."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gate_vals, sel, aux = _route(cfg, xf.float(), params["router"])

    # --- capacity dispatch -------------------------------------------------
    cap = _capacity(t, cfg)
    sel_flat = sel.reshape(-1)                    # (t*k,) token-major
    onehot = F.one_hot(sel_flat, m.num_experts)
    pos = torch.cumsum(onehot, dim=0) - onehot                  # (t*k, E)
    pos = pos.gather(1, sel_flat[:, None])[:, 0]
    keep = pos < cap
    idx_e = torch.where(keep, sel_flat, m.num_experts)          # overflow row
    idx_c = torch.where(keep, pos, 0)

    x_rep = xf.repeat_interleave(m.top_k, dim=0)                # (t*k, d)
    buf = torch.zeros((m.num_experts + 1, cap, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((idx_e, idx_c), x_rep, accumulate=True)

    # --- expert computation (grouped gated MLP) ---------------------------
    out = _experts(params, buf[:m.num_experts], act)
    out = torch.cat([out, out.new_zeros((1, cap, d))])          # overflow row

    # --- combine ------------------------------------------------------------
    gathered = out[idx_e, idx_c]                                # (t*k, d)
    w = (gate_vals.reshape(-1) * keep).to(x.dtype)
    y = (gathered * w[:, None]).reshape(t, m.top_k, d).sum(dim=1)

    if m.num_shared:
        y = y + layers.gated_mlp(params["shared"], xf, act)
    return y.reshape(b, s, d), aux


def moe_ffn_grouped(cfg: ModelConfig, params, x, act: str = "silu"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GROUP-LOCAL one-hot einsum dispatch (GShard grouping, chunked):
    capacity is enforced within each chunk of ``MOE_DISPATCH_CHUNK``
    tokens of a sequence row, and an assignment past it gets an all-zero
    one-hot row, which drops it."""
    m = cfg.moe
    b, s, d = x.shape
    gate_vals, sel, aux = _route(cfg, x.float(), params["router"])

    chunk = min(MOE_DISPATCH_CHUNK, s)
    if s % chunk:
        chunk = s
    g = s // chunk                                          # chunks per row
    cap = _capacity(chunk, cfg)
    tk = chunk * m.top_k

    sel_c = sel.reshape(b, g, tk)
    gate_c = gate_vals.reshape(b, g, tk)
    oh_e = F.one_hot(sel_c, m.num_experts).to(x.dtype)
    pos = torch.cumsum(oh_e, dim=2) - oh_e                  # chunk-local
    pos = pos.gather(3, sel_c[..., None])[..., 0].long()
    # jax.nn.one_hot gives a zero row past cap; F.one_hot raises there
    oh_c = F.one_hot(pos.clamp(max=cap), cap + 1)[..., :cap].to(x.dtype)
    # D[b,g,t,e,c]: dispatch one-hot; combine weights fold in the gate
    disp = torch.einsum("bgte,bgtc->bgtec", oh_e, oh_c)
    comb = disp * gate_c[..., None, None].to(x.dtype)

    x_rep = x.reshape(b, g, chunk, d).repeat_interleave(m.top_k, dim=2)
    buf = torch.einsum("bgtec,bgtd->begcd", disp, x_rep)
    # fold (b, e, g*cap, d) into the kernel's (e, b*g*cap, d) and back
    buf = buf.permute(1, 0, 2, 3, 4).reshape(m.num_experts, b * g * cap, d)
    out = _experts(params, buf, act)
    out = out.reshape(m.num_experts, b, g, cap, d).permute(1, 0, 2, 3, 4)

    y = torch.einsum("bgtec,begcd->bgtd", comb, out)
    y = y.reshape(b, g, chunk, m.top_k, d).sum(dim=3).reshape(b, s, d)

    if m.num_shared:
        y = y + layers.gated_mlp(params["shared"], x, act)
    return y, aux
