"""Wrapper of the hand-written grouped expert matmul kernel
(``csrc/moe_gmm.cu``, the port of the Pallas kernel in
``repro/kernels/moe_gmm.py``).

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
computes the plain version (``ref.gmm_ref``), and that is the only way
the plain version is taken.

Layout: x (e, c, d) and w (e, d, f), contiguous, both float32 or both
bfloat16; out (e, c, f) in x's dtype. Any c, d and f: no tile has to
divide them (the Pallas kernel's blocks did).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gmm_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter()


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (e, c, d); w: (e, d, f) -> (e, c, f)."""
    if x.device.type == "cpu":
        return gmm_ref(x, w)
    _check(x, w)
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                e, c, d, f, DTYPES[x.dtype], stream)
    _build.check(err, "moe_gmm")
    launches.add()
    return out


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: tensors on {x.device}; the kernel "
                         f"takes CUDA tensors (CPU ones take the plain "
                         f"version)")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"moe_gmm: w is {w.dtype} on {w.device}, x is "
                         f"{x.dtype} on {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"moe_gmm: dtype {x.dtype} not in "
                         f"{sorted(map(str, DTYPES))}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: need x (e, c, d) and w (e, d, f), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if min(x.shape) == 0 or w.shape[2] == 0:
        raise ValueError(f"moe_gmm: empty operand {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"moe_gmm: {name} is not contiguous")
