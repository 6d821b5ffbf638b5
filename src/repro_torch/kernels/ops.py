"""Public entry points of the port's kernels, the counterpart of the JAX
package's ``repro/kernels/ops.py``.

``kernel`` keeps the tower DSL's spellings:

* ``auto``   — the hand-written CUDA kernel for a CUDA tensor, the plain
  PyTorch version for a CPU tensor, the kernel's trace route for a
  tensor on a trace's fake device (``meta``, or ``lazy`` past 256
  positions: ``_build.TRACE_TYPES``; a trace of a step,
  ``launch/hlo_analysis.py``): what the CUDA route allocates, no launch,
  counted in the wrapper's ``trace_calls``; such a tensor has no data
  for any kernel to read;
* ``pallas`` — the hand-written kernel (the name is the JAX package's);
  a CPU tensor raises;
* ``ref``    — the plain version, as asked.

There is no fallback: a CUDA tensor under ``auto`` or ``pallas`` gets
the kernel, or the kernel's error when it cannot build or launch.

Gradients: on a CUDA tensor all four zoo kernels run as
``torch.autograd.Function``s whose backward passes are hand-written
kernels too (``csrc/flash_attention_bwd.cu``; the grouped matmul twice,
for dx and dw; ``csrc/rwkv6_wkv_bwd.cu`` and ``csrc/selective_scan_bwd.cu``,
which recompute the states between the checkpoints their forward
kernels write under grad). On a CPU tensor all four are the plain
versions, differentiated by autograd. The
Pallas tiling knobs (``block_q``, ``block_k``, ``block_r``, ``chunk``,
``block_c``, ``block_f``, ``block_d``)
and ``interpret`` have no counterpart: the CUDA kernels choose their own
tiles and take any length.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_wkv as _wkv
from repro_torch.kernels import selective_scan as _ssm

KERNELS = ("auto", "pallas", "ref")


# each wrapper's count of trace-route calls, by kernel name
TRACE_COUNTERS = {"flash_attention": _fa.trace_calls,
                  "flash_attention_bwd": _fa.bwd_trace_calls,
                  "moe_gmm": _gmm.trace_calls,
                  "quantize_int8": _q.trace_calls,
                  "rwkv6_wkv": _wkv.trace_calls,
                  "rwkv6_wkv_bwd": _wkv.bwd_trace_calls,
                  "selective_scan": _ssm.trace_calls,
                  "selective_scan_bwd": _ssm.bwd_trace_calls}


def default_backend(x: torch.Tensor) -> str:
    """What ``kernel="auto"`` runs for ``x``: ``"cuda"`` (the hand
    kernel) on a CUDA tensor, ``"trace"`` (its trace route) on a trace's
    fake device, ``"ref"`` on a CPU tensor. It depends on the device
    type alone, never on whether a toolchain is installed."""
    if x.device.type == "cuda":
        return "cuda"
    return "trace" if _build.traced(x) else "ref"


def needs_grad(*xs: torch.Tensor) -> bool:
    """Whether autograd records a call on ``xs``: grad mode is on and
    one of them requires grad. Outside grad, attention runs its forward
    kernel alone and writes no log-sum-exp for a backward."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def check_kernel(kernel: str, x: torch.Tensor, op: str) -> None:
    """Raise where ``kernel`` is no spelling of ``KERNELS``, or asks for
    the hand-written kernel (``pallas``) on a CPU tensor."""
    if kernel not in KERNELS:
        raise ValueError(f"{op}: kernel must be auto|pallas|ref, got "
                         f"{kernel!r}")
    if kernel == "pallas" and default_backend(x) == "ref":
        raise ValueError(f"{op}: kernel='pallas' runs the hand-written "
                         f"CUDA kernel, but the tensor is on {x.device}")


def _use_ref(kernel: str, x: torch.Tensor, op: str) -> bool:
    check_kernel(kernel, x, op)
    return kernel == "ref" or default_backend(x) == "ref"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    kernel: str = "auto") -> torch.Tensor:
    """q: (b, h, s, dh); k/v: (b, kvh, s, dh)."""
    if _use_ref(kernel, q, "flash_attention"):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if needs_grad(q, k, v):
        return _fa.FlashAttention.apply(q, k, v, causal, window, scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def moe_gmm(x: torch.Tensor, w: torch.Tensor, *, kernel: str = "auto"
            ) -> torch.Tensor:
    """x: (e, c, d); w: (e, d, f) -> (e, c, f) in x's dtype, summed in
    f32."""
    if _use_ref(kernel, x, "moe_gmm"):
        return ref.gmm_ref(x, w)
    return _gmm.MoeGmm.apply(x, w)


def quantize_int8(x: torch.Tensor, *, kernel: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (rows, d) -> (q int8 (rows, d), scale f32 (rows,))."""
    if _use_ref(kernel, x, "quantize_int8"):
        return ref.quantize_int8_ref(x)
    return _q.quantize_int8(x)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *, kernel: str = "auto"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (b, h, s, dh); u: (h, dh); w is the per-step decay in
    (0, 1). Returns (y f32 (b, h, s, dh), s_final f32 (b, h, dh, dh)),
    the recurrence from S = 0."""
    if _use_ref(kernel, r, "rwkv6_wkv"):
        return ref.rwkv6_ref(r, k, v, w, u)
    return _wkv.rwkv6_wkv(r, k, v, w, u)


def selective_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   u: torch.Tensor, a: torch.Tensor, *, kernel: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt/u: (b, s, di); bmat/cmat: (b, s, n); a: (di, n). Returns
    (y f32 (b, s, di), h_final f32 (b, di, n)), the scan from h = 0."""
    if _use_ref(kernel, dt, "selective_scan"):
        return ref.selective_scan_ref(dt, bmat, cmat, u, a)
    return _ssm.selective_scan(dt, bmat, cmat, u, a)
