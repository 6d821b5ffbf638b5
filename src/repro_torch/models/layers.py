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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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
