"""Plain PyTorch versions of the port's hand-written kernels.

They define the semantics each CUDA kernel must reproduce, mirroring
the JAX package's pure-jnp oracles (``repro/kernels/ref.py``) line for
line: quadratic attention with the same ``-1e30`` masking, per-row
symmetric int8 quantization with the same division and rounding, the
RWKV-6 recurrence and the Mamba selective scan as sequential loops over
time steps, the grouped expert matmul as one f32 einsum. A
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


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 for the sums, or float64 where it is float64 (the
    CPU gradient checks run the plain versions in float64)."""
    return x if x.dtype == torch.float64 else x.float()


def _as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s compute type (:func:`_f32` of it)."""
    return x.to(_f32(like).dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None, return_lse: bool = False):
    """q: (b, h, sq, dh); k/v: (b, kvh, sk, dh). GQA by head grouping.
    With ``return_lse`` also each row's log-sum-exp of its masked,
    scaled scores, (b, h, sq) in the compute type (float32, or float64
    for float64 inputs): the forward kernel's ``lse``. A row that sees
    no key has -1e30 + log(sk), which rounds to -1e30."""
    b, h, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qg = _f32(q.reshape(b, kvh, g, sq, dh))
    scale = dh ** -0.5 if scale is None else scale
    s = torch.einsum("bngqd,bnkd->bngqk", qg * scale, _f32(k))
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= qi - ki < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bnkd->bngqd", p, _f32(v))
    o = o.reshape(b, h, sq, dh).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return o


def attention_vjp_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True,
                      window: int = 0, scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` at (q, k, v) for the output
    cotangent ``do``: autograd through the plain version, the
    counterpart of the backward kernel."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention_ref(qq, kk, vv, causal=causal, window=window,
                            scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), do)


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul: x (e, c, d) @ w (e, d, f) -> (e, c, f), in f32,
    cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", _f32(x), _f32(w)).to(x.dtype)


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
    Returns (y (b, h, s, dh) fp32, s_final (b, h, dh, dh) fp32), float64
    where r is float64.
    """
    b, h, s, dh = r.shape
    r, k, v, w = (_as(x, r) for x in (r, k, v, w))
    u = _as(u, r)
    state = (torch.zeros((b, h, dh, dh), dtype=r.dtype, device=r.device)
             if s0 is None else _as(s0, r))
    ys = []
    for t in range(s):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]           # (b, h, dh, dh)
        ys.append(torch.einsum("bhj,bhji->bhi", rt,
                               state + u[..., :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, dim=2), state


def selective_scan_ref(dt: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential S6 scan. dt/u: (b, s, di); bmat/cmat: (b, s, n);
    a: (di, n).

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * u_t * b_t;  y_t = h_t . c_t
    Returns (y (b, s, di) fp32, h_final (b, di, n) fp32), float64 where
    dt is float64.
    """
    b, s, di = dt.shape
    n = a.shape[-1]
    dt, bmat, cmat, u, a = (_as(x, dt) for x in (dt, bmat, cmat, u, a))
    h = (torch.zeros((b, di, n), dtype=dt.dtype, device=dt.device)
         if h0 is None else _as(h0, dt))
    ys = []
    for t in range(s):
        dt_t = dt[:, t]
        decay = torch.exp(dt_t[..., None] * a)             # (b, di, n)
        h = decay * h + (dt_t * u[:, t])[..., None] * bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    return torch.stack(ys, dim=1), h


def _vjp(fn, inputs, cotangents):
    """Autograd through the plain version ``fn`` at ``inputs`` for the
    output cotangents: the counterpart of a backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        return torch.autograd.grad(outs, leaves, cotangents)


def rwkv6_vjp_ref(r, k, v, w, u, dy, ds
                  ) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw, du) of :func:`rwkv6_ref` (from S = 0) for the
    cotangents ``dy`` of y and ``ds`` of the final state."""
    return _vjp(rwkv6_ref, (r, k, v, w, u), (dy, ds))


def selective_scan_vjp_ref(dt, bmat, cmat, u, a, dy, dh
                           ) -> Tuple[torch.Tensor, ...]:
    """(d(dt), dB, dC, du, dA) of :func:`selective_scan_ref` (from h = 0)
    for the cotangents ``dy`` of y and ``dh`` of the final state."""
    return _vjp(selective_scan_ref, (dt, bmat, cmat, u, a), (dy, dh))
