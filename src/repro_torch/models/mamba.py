"""Selective SSM (S6 / Mamba-1) mixer of the port's model zoo, used by
Jamba's mamba layers; the counterpart of the JAX package's
``repro/models/mamba.py``.

Prefill (``mamba_mixer``) runs the recurrence through
``ops.selective_scan``: the hand-written CUDA kernel on a CUDA tensor,
the plain sequential loop on a CPU tensor, from h = 0. Where the JAX
package solves it with a chunked ``lax.associative_scan`` (``ssm_scan``,
the Pallas kernel's oracle), the kernel walks the whole sequence itself,
so no chunk has its counterpart here; the mixer still accepts only the
lengths ``ssm_scan`` accepts, so both packages take the same inputs.
Decode (``mamba_decode``) is the O(1) recurrent step on a cached state
and conv tail, in plain torch with no kernel, as the JAX package
computes it.

The JAX package's sharding constraints are the identity on one device,
and its ``reduce_dtype`` is ``None`` without mesh rules: neither has a
counterpart here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import Spec

# the JAX package's ssm_scan chunk: a length must be a multiple of
# min(CHUNK, s)
CHUNK = 128


def mamba_spec(cfg: ModelConfig):
    mb = cfg.mamba
    d = cfg.d_model
    di = mb.d_inner(d)
    return {
        "w_in": Spec((d, 2 * di), ("embed", "d_inner")),
        "conv_w": Spec((mb.d_conv, di), ("conv", "d_inner"), scale=0.5),
        "conv_b": Spec((di,), ("d_inner",), init="zeros"),
        "w_x": Spec((di, mb.dt_rank + 2 * mb.d_state), ("d_inner", None)),
        "w_dt": Spec((mb.dt_rank, di), ("dt_rank", "d_inner")),
        "b_dt": Spec((di,), ("d_inner",), init="ones", scale=-4.6,
                     dtype=torch.float32),   # softplus(-4.6) ~ 0.01
        "a_log": Spec((di, mb.d_state), ("d_inner", "state"), init="ones",
                      scale=0.0, dtype=torch.float32),
        "d_skip": Spec((di,), ("d_inner",), init="ones",
                       dtype=torch.float32),
        "w_out": Spec((di, d), ("d_inner", "embed")),
    }


def _conv1d(x, w, b):
    """Causal depthwise conv. x: (b, s, di); w: (k, di). A sum of the k
    shifted products, as the JAX package writes it: ``F.conv1d`` would
    run through cuDNN, in TF32 by default on the card."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b.to(x.dtype)


def _dt_b_c(cfg: ModelConfig, params, u):
    """u: (b, s, di) post-conv. Returns dt (b, s, di) fp32, B/C (b, s, N)
    fp32."""
    mb = cfg.mamba
    proj = u @ params["w_x"]
    dt_r, bmat, cmat = torch.split(
        proj, [mb.dt_rank, mb.d_state, mb.d_state], dim=-1)
    # F.softplus returns x itself above its threshold of 20, where
    # jax.nn.softplus gives x + log1p(exp(-x)): under 1e-8 relative
    dt = F.softplus((dt_r @ params["w_dt"]).float() + params["b_dt"])
    return dt, bmat.float(), cmat.float()


def mamba_mixer(cfg: ModelConfig, params, x) -> torch.Tensor:
    """Training / prefill. x: (b, s, d) -> (b, s, d)."""
    s = x.shape[1]
    if s % min(CHUNK, s):
        raise ValueError(f"mamba_mixer: sequence length {s} is not a "
                         f"multiple of min({CHUNK}, s), which the JAX "
                         f"package's ssm_scan requires")
    xz = x @ params["w_in"]
    u, z = xz.chunk(2, dim=-1)                          # (b, s, di) each
    u = F.silu(_conv1d(u, params["conv_w"], params["conv_b"]))
    dt, bmat, cmat = _dt_b_c(cfg, params, u)
    a_mat = -torch.exp(params["a_log"])
    # the kernel takes contiguous dt, u (b, s, di) and B, C (b, s, N)
    y, _ = ops.selective_scan(dt, bmat.contiguous(), cmat.contiguous(),
                              u.contiguous(), a_mat)
    y = y + params["d_skip"] * u.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["w_out"]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    mb = cfg.mamba
    di = mb.d_inner(cfg.d_model)
    return {
        "h": torch.zeros((batch, di, mb.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, mb.d_conv - 1, di), dtype=dtype,
                            device=device),
    }


def mamba_decode(cfg: ModelConfig, params, x, cache
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d). O(1) state update; ``cache`` is not changed."""
    xz = x @ params["w_in"]
    u, z = xz.chunk(2, dim=-1)
    window = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
    u = F.silu(torch.einsum("bkd,kd->bd", window, params["conv_w"])
               + params["conv_b"])[:, None, :]
    dt, bmat, cmat = _dt_b_c(cfg, params, u)
    a_mat = -torch.exp(params["a_log"])
    a = torch.exp(dt[:, 0, :, None] * a_mat)            # (b, di, N)
    bx = (dt[:, 0] * u[:, 0].float())[..., None] * bmat[:, 0, None, :]
    h = a * cache["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None, :]
    y = y + params["d_skip"] * u.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["w_out"]
    return out, {"h": h, "conv": window[:, 1:].to(cache["conv"].dtype)}
