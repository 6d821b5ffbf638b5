"""Public entry points of the port's kernels, the counterpart of the JAX
package's ``repro/kernels/ops.py``.

``kernel`` keeps the tower DSL's spellings:

* ``auto``   — the hand-written CUDA kernel for a CUDA tensor, the plain
  PyTorch version for a CPU tensor;
* ``pallas`` — the hand-written kernel (the name is the JAX package's);
  a CPU tensor raises;
* ``ref``    — the plain version, as asked.

There is no fallback: a CUDA tensor under ``auto`` or ``pallas`` gets
the kernel, or the kernel's error when it cannot build or launch. The
Pallas tiling knobs (``block_q``, ``block_k``, ``block_r``, ``chunk``,
``block_c``, ``block_f``, ``block_d``)
and ``interpret`` have no counterpart: the CUDA kernels choose their own
tiles and take any length.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_wkv as _wkv

KERNELS = ("auto", "pallas", "ref")


def default_backend(x: torch.Tensor) -> str:
    """What ``kernel="auto"`` runs for ``x``: ``"cuda"`` (the hand
    kernel) on a CUDA tensor, ``"ref"`` on a CPU tensor. It never
    depends on whether a toolchain is installed."""
    return "cuda" if x.device.type == "cuda" else "ref"


def _use_ref(kernel: str, x: torch.Tensor, op: str) -> bool:
    if kernel not in KERNELS:
        raise ValueError(f"{op}: kernel must be auto|pallas|ref, got "
                         f"{kernel!r}")
    if kernel == "pallas" and x.device.type != "cuda":
        raise ValueError(f"{op}: kernel='pallas' runs the hand-written "
                         f"CUDA kernel, but the tensor is on {x.device}")
    return kernel == "ref" or default_backend(x) == "ref"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    kernel: str = "auto") -> torch.Tensor:
    """q: (b, h, s, dh); k/v: (b, kvh, s, dh)."""
    if _use_ref(kernel, q, "flash_attention"):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def moe_gmm(x: torch.Tensor, w: torch.Tensor, *, kernel: str = "auto"
            ) -> torch.Tensor:
    """x: (e, c, d); w: (e, d, f) -> (e, c, f) in x's dtype, summed in
    f32."""
    if _use_ref(kernel, x, "moe_gmm"):
        return ref.gmm_ref(x, w)
    return _gmm.moe_gmm(x, w)


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
