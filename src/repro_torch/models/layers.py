"""Shared primitive layers of the port's model zoo: norms, MLPs,
embeddings, loss. The counterpart of the JAX package's
``repro/models/layers.py``.

All apply-functions are pure: ``apply(params, x, cfg-ish args) -> y``.
Norm params are kept in fp32 (Spec dtype override); matmuls run in the
activation dtype, which must be the weights' dtype (torch does not
promote a mixed product as ``jnp.einsum`` does), and the f32 casts sit
where the JAX package puts them.
Without mesh rules the JAX package's ``reduce_dtype`` is ``None``, so it
has no counterpart here.

The ``*_sharded`` functions run a layer on a mesh of more than one
device (``sharding.rules.Layout``): activations are lists, one row (a
batch position) each, a row one tensor at its home or, under a
sequence split, its sequence cells over ``model``; params are
``Parts``, which ``Layout.weights`` gathers whole over ``data`` (FSDP)
on each position that uses them; a split over ``model`` is tensor
parallelism: each position takes its row whole (``Layout.enter``) and
the partial products are summed back into the row in axis order
(``Layout.leave``). Where a param's dim falls back to replication, the
layer runs whole on the row's home.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as M
from repro_torch.models.params import Spec

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(dim: int):
    return {"scale": Spec((dim,), ("embed",), init="ones",
                          dtype=torch.float32)}


def rmsnorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm_spec(dim: int):
    return {
        "scale": Spec((dim,), ("embed",), init="ones", dtype=torch.float32),
        "bias": Spec((dim,), ("embed",), init="zeros", dtype=torch.float32),
    }


def layernorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)   # jnp.var: population
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int. The
    split-half rotation (the first half of the head dims against the
    second, not interleaved pairs), in f32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gated_mlp_spec(d_model: int, d_ff: int):
    return {
        "w_gate": Spec((d_model, d_ff), ("embed", "mlp")),
        "w_up": Spec((d_model, d_ff), ("embed", "mlp")),
        "w_down": Spec((d_ff, d_model), ("mlp", "embed")),
    }


def gated_mlp(params, x, act: str = "silu"):
    a = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = _act(act)(a) * u
    return h @ params["w_down"]


def mlp_spec(d_model: int, d_ff: int):
    """Non-gated MLP (whisper-style)."""
    return {
        "w_up": Spec((d_model, d_ff), ("embed", "mlp")),
        "b_up": Spec((d_ff,), ("mlp",), init="zeros"),
        "w_down": Spec((d_ff, d_model), ("mlp", "embed")),
        "b_down": Spec((d_model,), ("embed",), init="zeros"),
    }


def mlp(params, x, act: str = "gelu"):
    h = _act(act)(x @ params["w_up"] + params["b_up"].to(x.dtype))
    return h @ params["w_down"] + params["b_down"].to(x.dtype)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, d_model: int):
    return {"table": Spec((vocab, d_model), ("vocab", "embed"), scale=1.0)}


def embed(params, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # gather, then cast: the same values as casting the whole table first
    return params["table"][tokens].to(dtype)


def unembed_spec(vocab: int, d_model: int):
    return {"w": Spec((d_model, vocab), ("embed", "vocab"))}


def unembed(params, x) -> torch.Tensor:
    return x @ params["w"]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 z_weight: float = 0.0):
    """Token-level cross-entropy in fp32; returns (mean_loss, aux)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - target
    if z_weight:
        nll = nll + z_weight * lse.square()
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


# ---------------------------------------------------------------------------
# on a mesh of more than one device (a list a row; see the module's doc)
# ---------------------------------------------------------------------------


def rmsnorm_sharded(lay, params, xs: Sequence, eps: float) -> List:
    """:func:`rmsnorm` of each row, cell by cell, the scale gathered to
    each cell's device."""
    scales = lay.weights(params["scale"], lay.n_cells)
    return lay.each(lambda r, j, x: rmsnorm({"scale": scales[j][r]}, x, eps),
                    xs)


def layernorm_sharded(lay, params, xs: Sequence, eps: float) -> List:
    """:func:`layernorm` of each row, cell by cell, the scale and the
    bias gathered to each cell's device."""
    scales, biases = (lay.weights(params[k], lay.n_cells)
                      for k in ("scale", "bias"))
    return lay.each(lambda r, j, x: layernorm(
        {"scale": scales[j][r], "bias": biases[j][r]}, x, eps), xs)


def gated_mlp_sharded(lay, params, hs: Sequence, act: str = "silu"
                      ) -> List:
    """The gated MLP over ``mlp``'s split: model position j takes the
    columns j of ``w_gate`` / ``w_up`` and the rows j of ``w_down`` on
    its row whole (``Layout.enter``); the partial outputs are summed
    back into the row (``Layout.leave``)."""
    n = lay.n_tp(params["w_gate"])
    w = {k: lay.weights(params[k], n) for k in ("w_gate", "w_up", "w_down")}
    out = []
    for r, h in enumerate(hs):
        xs = lay.enter(r, h, n)
        out.append(lay.leave(r, [gated_mlp({k: v[j][r] for k, v in
                                            w.items()}, xs[j], act)
                                 for j in range(n)]))
    return out


def mlp_sharded(lay, params, hs: Sequence, act: str = "gelu") -> List:
    """The biased, non-gated MLP over ``mlp``'s split: model position j
    takes the columns j of ``w_up``, the entries j of ``b_up`` and the
    rows j of ``w_down``; the partial outputs are summed back into the
    row and ``b_down`` is added once, to each cell of the sum."""
    n = lay.n_tp(params["w_up"])
    w = {k: lay.weights(params[k], n) for k in ("w_up", "b_up", "w_down")}
    b_down = lay.weights(params["b_down"], lay.n_cells)
    out = []
    for r, h in enumerate(hs):
        xs = lay.enter(r, h, n)
        parts = []
        for j in range(n):
            u = xs[j] @ w["w_up"][j][r] + w["b_up"][j][r].to(xs[j].dtype)
            parts.append(_act(act)(u) @ w["w_down"][j][r])
        out.append(lay.leave(r, parts))
    return lay.each(lambda r, j, y: y + b_down[j][r].to(y.dtype), out)


def embed_sharded(lay, params, tokens: Sequence[torch.Tensor],
                  dtype: torch.dtype = torch.bfloat16
                  ) -> List[torch.Tensor]:
    """The lookup with the table's ``vocab`` split over ``model``: each
    position looks up the ids in its range (zero elsewhere) and the
    rows' results are summed, in f32, then cast."""
    table = params["table"]
    n = lay.n_tp(table)
    tabs = lay.weights(table, n)
    if n == 1:
        return [embed({"table": tabs[0][r]}, t, dtype)
                for r, t in enumerate(tokens)]
    v_l = table.shape[0] // n
    out = []
    for r, tok in enumerate(tokens):
        parts = []
        toks = M.broadcast(tok, [tabs[j][r].device for j in range(n)])
        for j in range(n):
            t = tabs[j][r]
            ids = toks[j].long() - j * v_l
            inside = (ids >= 0) & (ids < v_l)
            rows = t[ids.clamp(0, v_l - 1)]
            parts.append(torch.where(inside[..., None], rows,
                                     rows.new_zeros(())))
        out.append(M.psum(parts, lay.home(r)).to(dtype))
    return out


def head_sharded(lay, w, xs: Sequence[torch.Tensor], tied: bool
                 ) -> List[List[torch.Tensor]]:
    """Each row's logits as its model positions' columns over
    ``vocab`` (one whole part where the vocab falls back): ``x @ w``
    for an ``unembed`` weight (embed, vocab), ``x @ table.T`` for a tied
    embedding table (vocab, embed)."""
    n = lay.n_tp(w)
    ws = lay.weights(w, n)
    out = []
    for r, x in enumerate(xs):
        xj = M.fan_out(x, [lay.dev(r, j) for j in range(n)])
        out.append([xj[j] @ (ws[j][r].T if tied else ws[j][r])
                    for j in range(n)])
    return out


def softmax_xent_sharded(lay, logits: Sequence[Sequence[torch.Tensor]],
                         labels: Sequence[torch.Tensor],
                         masks: Optional[Sequence[torch.Tensor]] = None):
    """:func:`softmax_xent` of logits split over ``vocab`` (a list a
    row of the model positions' columns, in order) and the batch split
    over rows. The log-sum-exp through a ``pmax`` of the parts' maxima
    and a ``psum`` of their shifted sums; the label's logit from the
    position whose range holds it; accuracy's argmax global, a tie going
    to the lowest index as ``torch.argmax``'s; the mask's denominator
    and every sum over all rows. Returns (mean loss, metrics) on the
    first row's home."""
    home0 = lay.home(0)
    nll_sums, dens, hits = [], [], []
    for r, parts in enumerate(logits):
        home = lay.home(r)
        ls = [p.float() for p in parts]
        v_l = ls[0].shape[-1]
        devs = [x.device for x in ls]
        m = M.pmax([x.max(-1).values for x in ls], home).detach()
        se = M.psum([torch.exp(x - mj[..., None]).sum(-1)
                     for x, mj in zip(ls, M.broadcast(m, devs))], home)
        lse = m + torch.log(se)
        lab = M.broadcast(labels[r], [home])[0].long()
        tgt, best_v, best_i = [], None, None
        for j, (x, lj) in enumerate(zip(ls, M.broadcast(lab, devs))):
            ids = lj - j * v_l
            inside = (ids >= 0) & (ids < v_l)
            got = x.gather(-1, ids.clamp(0, v_l - 1)[..., None])[..., 0]
            tgt.append(torch.where(inside, got, got.new_zeros(())))
            i = x.argmax(-1)
            v, i = M.gather([x.gather(-1, i[..., None])[..., 0], i], home)
            i = i + j * v_l
            if best_v is None:
                best_v, best_i = v, i
            else:
                # strictly larger: a tie keeps the lower position's index
                take = v > best_v
                best_v = torch.where(take, v, best_v)
                best_i = torch.where(take, i, best_i)
        nll = lse - M.psum(tgt, home)
        mask = (torch.ones_like(nll) if masks is None
                else M.broadcast(masks[r], [home])[0].float())
        nll_sums.append((nll * mask).sum())
        dens.append(mask.sum())
        hits.append(((best_i == lab) * mask).sum())
    denom = torch.clamp(M.psum(dens, home0), min=1.0)
    loss = M.psum(nll_sums, home0) / denom
    acc = M.psum(hits, home0) / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
