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

``moe_ffn_sharded`` runs the layer on a mesh of more than one device
(``models/layers.py``'s ``*_sharded`` conventions) with the values of
the unsharded layer: each row routes its own tokens; the load-balance
and z losses come from sums over every row; the global dispatch keeps a
global capacity and a token-major priority over the whole batch (each
row's slots offset by the exclusive prefix, over the rows before it, of
their per-expert counts), the grouped dispatch is local to a sequence
row as it is unsharded. Model position j runs the grouped matmul once,
on its experts' rows of the capacity buffer, which hold every row's
tokens; each row gathers its own tokens' outputs. Under a sequence
split each row's cells are gathered at its home before routing, so the
token-major order, the capacity drops and the router losses are the
unsharded layer's, and the output is cut back into the cells.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
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


def _top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest router probabilities of each token and their
    experts (one place for a caller that holds two runs to one routing,
    as ``chip_smoke.py``'s kernel-against-plain training step does)."""
    return torch.topk(probs, k, dim=-1)


def _router(cfg: ModelConfig, x32: torch.Tensor, router: torch.Tensor):
    """Top-k routing of the f32 tokens ``x32`` (..., d). Returns (gate
    values renormalized over the k picks, the picks, the router's
    logits, its probabilities)."""
    logits = x32 @ router                                       # (..., E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = _top_k(probs, cfg.moe.top_k)               # (..., k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)              # renormalize
    return gate_vals, sel, logits, probs


def _aux(cfg: ModelConfig, me, ce, z) -> Dict[str, torch.Tensor]:
    """GShard's load balance from the mean router probability ``me``
    and top-1 share ``ce`` of each expert, and the mean squared
    log-sum-exp ``z``."""
    return {"load_balance": cfg.moe.num_experts * torch.sum(me * ce),
            "router_z": z}


def _route(cfg: ModelConfig, x32: torch.Tensor, router: torch.Tensor):
    """Top-k routing of the f32 tokens ``x32`` (..., d). Returns (gate
    values renormalized over the k picks, the picks, aux losses)."""
    gate_vals, sel, logits, probs = _router(cfg, x32, router)
    lead = tuple(range(probs.dim() - 1))
    me = probs.mean(dim=lead)                                   # (E,)
    ce = F.one_hot(sel[..., 0], cfg.moe.num_experts).float().mean(dim=lead)
    return gate_vals, sel, _aux(
        cfg, me, ce, torch.logsumexp(logits, -1).square().mean())


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


def _group_dispatch(cfg: ModelConfig, x, gate_vals, sel):
    """The grouped dispatch of ``x`` (b, s, d): (the combine weights,
    the capacity buffer in the kernel's (e, b g cap, d) layout)."""
    m = cfg.moe
    b, s, d = x.shape
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
    return comb, buf.permute(1, 0, 2, 3, 4).reshape(m.num_experts,
                                                    b * g * cap, d)


def _group_combine(cfg: ModelConfig, comb, out, shape):
    """The grouped combine of the experts' ``out`` (e, b g cap, d) into
    (b, s, d)."""
    m = cfg.moe
    b, s, d = shape
    _, g, _, _, cap = comb.shape
    out = out.reshape(m.num_experts, b, g, cap, d).permute(1, 0, 2, 3, 4)
    y = torch.einsum("bgtec,begcd->bgtd", comb, out)
    return y.reshape(b, g, s // g, m.top_k, d).sum(dim=3).reshape(b, s, d)


def moe_ffn_grouped(cfg: ModelConfig, params, x, act: str = "silu"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GROUP-LOCAL one-hot einsum dispatch (GShard grouping, chunked):
    capacity is enforced within each chunk of ``MOE_DISPATCH_CHUNK``
    tokens of a sequence row, and an assignment past it gets an all-zero
    one-hot row, which drops it."""
    m = cfg.moe
    gate_vals, sel, aux = _route(cfg, x.float(), params["router"])
    comb, buf = _group_dispatch(cfg, x, gate_vals, sel)
    y = _group_combine(cfg, comb, _experts(params, buf, act), x.shape)
    if m.num_shared:
        y = y + layers.gated_mlp(params["shared"], x, act)
    return y, aux


# ---------------------------------------------------------------------------
# on a mesh of more than one device (a list a row; see the module's doc)
# ---------------------------------------------------------------------------


def _global_dispatch(cfg: ModelConfig, lay, sels):
    """Each row's (expert, slot, kept) of its token-major assignments
    under one capacity over all rows' tokens: a row's slots continue
    the counts of the rows before it (``exclusive_prefix``), so the
    drops are the unsharded dispatch's."""
    m = cfg.moe
    flat = [s.reshape(-1) for s in sels]
    cap = _capacity(sum(f.shape[0] for f in flat) // m.top_k, cfg)
    hots = [F.one_hot(f, m.num_experts) for f in flat]
    offsets = M.exclusive_prefix([h.sum(0) for h in hots], lay.homes())
    out = []
    for f, h, off in zip(flat, hots, offsets):
        pos = torch.cumsum(h, dim=0) - h + off[None]
        pos = pos.gather(1, f[:, None])[:, 0]
        keep = pos < cap
        out.append((torch.where(keep, f, m.num_experts),
                    torch.where(keep, pos, 0), keep))
    return cap, out


def _experts_sharded(lay, params, bufs, act: str) -> List[torch.Tensor]:
    """Model position j's experts on ``bufs[j]`` (its experts' rows of
    the buffer, every row's tokens), at row 0's position j, with its
    experts' weights gathered there."""
    n = len(bufs)
    w = {k: lay.weights(params[k], n, rows=[0])
         for k in ("w_gate", "w_up", "w_down")}
    return [_experts({k: v[j][0] for k, v in w.items()}, buf, act)
            for j, buf in enumerate(bufs)]


def moe_ffn_sharded(cfg: ModelConfig, lay, params, hs, act: str = "silu"
                    ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """:func:`moe_ffn` of each row (``hs`` (b_r, s, d) in ``lay``'s
    form: a sequence split's cells are gathered at the row's home first,
    so that routing and dispatch see the row's tokens in order); see the
    module's doc. Returns (the rows' outputs, in ``lay``'s form, and
    aux)."""
    m = cfg.moe
    home0 = lay.home(0)
    cells, hs = hs, [lay.whole(r, h) for r, h in enumerate(hs)]
    routers = lay.weights(params["router"], 1)[0]
    routed = [_router(cfg, h.float(), w) for h, w in zip(hs, routers)]
    n_tok = sum(h.shape[0] * h.shape[1] for h in hs)
    me = M.psum([p.reshape(-1, m.num_experts).sum(0)
                 for _, _, _, p in routed], home0) / n_tok
    ce = M.psum([F.one_hot(s[..., 0].reshape(-1), m.num_experts).float()
                 .sum(0) for _, s, _, _ in routed], home0) / n_tok
    z = M.psum([torch.logsumexp(lg, -1).square().sum()
                for _, _, lg, _ in routed], home0) / n_tok
    aux = _aux(cfg, me, ce, z)

    n = lay.n_tp(params["w_gate"])
    e_l = m.num_experts // n
    ep_devs = [lay.dev(0, j) for j in range(n)]
    ys = []
    if cfg.moe_group_dispatch:
        disp = [_group_dispatch(cfg, h, gv, s)
                for h, (gv, s, _, _) in zip(hs, routed)]
        # position j's buffer: its experts' rows of each row's buffer,
        # the rows' tokens in order along the capacity dim
        chunks = [buf.split(e_l, dim=0) for _, buf in disp]
        outs = _experts_sharded(lay, params, [
            M.all_gather([c[j] for c in chunks], 1, ep_devs[j])
            for j in range(n)], act)
        widths = [buf.shape[1] for _, buf in disp]
        pieces = [o.split(widths, dim=1) for o in outs]
        for r, (h, (comb, _)) in enumerate(zip(hs, disp)):
            out = M.all_gather([p[r] for p in pieces], 0, lay.home(r))
            ys.append(_group_combine(cfg, comb, out, h.shape))
    else:
        cap, idx = _global_dispatch(cfg, lay, [s for _, s, _, _ in routed])
        chunks = []
        for h, (e, c, _) in zip(hs, idx):
            xf = h.reshape(-1, h.shape[-1])
            buf = xf.new_zeros((m.num_experts + 1, cap, xf.shape[-1]))
            buf.index_put_((e, c), xf.repeat_interleave(m.top_k, dim=0),
                           accumulate=True)
            chunks.append(buf[:m.num_experts].split(e_l, dim=0))
        # each slot holds one row's token at most: the sum is exact
        outs = _experts_sharded(lay, params, [
            M.psum([c[j] for c in chunks], ep_devs[j]) for j in range(n)],
            act)
        fanned = [M.fan_out(o, lay.homes()) for o in outs]
        for r, (h, (gv, _, _, _), (e, c, keep)) in enumerate(
                zip(hs, routed, idx)):
            b, s, d = h.shape
            out = torch.cat([f[r] for f in fanned]
                            + [h.new_zeros((1, cap, d))])
            w = (gv.reshape(-1) * keep).to(h.dtype)
            ys.append((out[e, c] * w[:, None]).reshape(b * s, m.top_k, d)
                      .sum(dim=1).reshape(b, s, d))
    ys = [lay.leave(r, [y]) for r, y in enumerate(ys)]
    if m.num_shared:
        shared = layers.gated_mlp_sharded(lay, params["shared"], cells, act)
        ys = lay.each(lambda r, j, y, sh: y + sh, ys, shared)
    return ys, aux
