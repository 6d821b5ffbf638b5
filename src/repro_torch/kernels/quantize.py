"""Wrapper of the hand-written int8 quantization kernel
(``csrc/quantize.cu``, the port of the Pallas kernel in
``repro/kernels/quantize.py``).

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
computes the plain version (``ref.quantize_int8_ref``), and that is the
only way the plain version is taken. On a trace's fake device
(``meta``) it takes its trace route: it allocates what the CUDA route
allocates, launches nothing and counts the call in ``trace_calls``. A
row of whole 16-byte chunks on a 16-byte aligned tensor runs the
vector variant, any other the scalar one (``variant``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_int8_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter()
trace_calls = _build.LaunchCounter()


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (rows, d) -> (q int8 (rows, d), scale f32 (rows,))."""
    if x.device.type == "cpu":
        return quantize_int8_ref(x)
    _check(x)
    rows, d = x.shape
    q = torch.empty((rows, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if _build.traced(x):
        trace_calls.add()
        return q, scale
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_quantize_int8(x.data_ptr(), q.data_ptr(),
                                      scale.data_ptr(), rows, d,
                                      DTYPES[x.dtype], stream)
    _build.check(err, "quantize_int8")
    launches.add()
    return q, scale


def variant(x: torch.Tensor) -> str:
    """Which kernel a call on this CUDA tensor runs, as the .cu
    dispatches it: "vector" (16-byte loads, a row over a lane group) or
    "scalar" (a warp a row)."""
    _check(x)
    v = _build.library().repro_quantize_int8_variant(
        x.data_ptr(), x.shape[1], DTYPES[x.dtype])
    return "vector" if v == 1 else "scalar"


def _check(x: torch.Tensor) -> None:
    if x.device.type != "cuda" and not _build.traced(x):
        raise ValueError(f"quantize_int8: tensor on {x.device}; the "
                         f"kernel takes CUDA tensors (CPU ones take the "
                         f"plain version, a trace's fake ones its trace "
                         f"route)")
    if x.dtype not in DTYPES:
        raise ValueError(f"quantize_int8: dtype {x.dtype} not in "
                         f"{sorted(map(str, DTYPES))}")
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"quantize_int8: need a non-empty (rows, d) "
                         f"tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8: x is not contiguous")
