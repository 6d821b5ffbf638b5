"""Plain PyTorch versions of the port's hand-written kernels.

They define the semantics each CUDA kernel must reproduce, mirroring
the JAX package's pure-jnp oracles (``repro/kernels/ref.py``) line for
line: quadratic attention with the same ``-1e30`` masking, per-row
symmetric int8 quantization with the same division and rounding, the
RWKV-6 recurrence as a sequential loop over time steps, the grouped
expert matmul as one f32 einsum. A
kernel wrapper takes these only for a tensor that lies on the CPU;
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
# 1/127 rounded to float32. The Pallas kernel's ``absmax / 127.0`` is
# compiled by XLA into a multiply by this reciprocal (so is the jitted
# jnp oracle; only an eager call divides), and the tower runs it jitted:
# the port follows what the reference computes where it runs. The two
# scales differ by at most one ulp.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, h, sq, dh); k/v: (b, kvh, sk, dh). GQA by head grouping."""
    b, h, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, dh).float()
    scale = dh ** -0.5 if scale is None else scale
    s = torch.einsum("bngqd,bnkd->bngqk", qg * scale, k.float())
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= qi - ki < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    return o.reshape(b, h, sq, dh).to(q.dtype)


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul: x (e, c, d) @ w (e, d, f) -> (e, c, f), in f32,
    cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def quantize_int8_ref(x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization. x: (rows, d) ->
    (q int8 (rows, d), scale f32 (rows,)). ``torch.round`` rounds half
    to even, as ``jnp.round`` does; ``x / scale`` is a true division on
    every device (a tensor divisor is never turned into a reciprocal)."""
    x32 = x.float()
    absmax = torch.clamp(x32.abs().amax(dim=1), min=1e-12)
    scale = absmax * INV_127
    q = torch.clamp(torch.round(x32 / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV. r/k/v/w: (b, h, s, dh); u: (h, dh); decay w in (0,1).

    y_t[i] = sum_j r_t[j] * (S[j,i] + u[j] k_t[j] v_t[i])
    S      = diag(w_t) S + k_t v_t^T
    Returns (y (b, h, s, dh) fp32, s_final (b, h, dh, dh) fp32).
    """
    b, h, s, dh = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=r.device)
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    state = s0.float()
    ys = []
    for t in range(s):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]           # (b, h, dh, dh)
        ys.append(torch.einsum("bhj,bhji->bhi", rt,
                               state + u[..., :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, dim=2), state
