"""Wrapper of the hand-written selective-scan kernel
(``csrc/selective_scan.cu``, the port of the Pallas kernel in
``repro/kernels/selective_scan.py``).

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
computes the plain version (``ref.selective_scan_ref``), and that is the
only way the plain version is taken. The kernel has no backward yet: a CUDA
input that requires grad, with grad enabled, raises.

Layout: dt, u (b, s, di); B, C (b, s, n); A (di, n) float32; all
contiguous. dt, B and C are all float32 or all bfloat16, u is float32 or
bfloat16 on its own (the Mamba mixer passes f32 dt/B/C and u in the
activation dtype); any state dim n >= 1, as the Pallas kernel takes
(4, 8 and 16 have registers of their own, other n up to 64 run masked,
wider ones loop). The scan starts from h = 0, as the Pallas kernel's
does; any s and di work.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter()
# the ROADMAP entry that ports its backward kernel
BWD_ITEM = ("ROADMAP Queue 2, backward kernels for rwkv6_wkv and "
            "selective_scan")


def selective_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   u: torch.Tensor, a: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y f32 (b, s, di), h_final f32 (b, di, n))."""
    if dt.device.type == "cpu":
        return selective_scan_ref(dt, bmat, cmat, u, a)
    _refuse_grad(dt, bmat, cmat, u, a)
    _check(dt, bmat, cmat, u, a)
    b, s, di = dt.shape
    n = a.shape[1]
    y = torch.empty((b, s, di), dtype=torch.float32, device=dt.device)
    h_final = torch.empty((b, di, n), dtype=torch.float32, device=dt.device)
    lib = _build.library()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.repro_selective_scan(
            dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), u.data_ptr(),
            a.data_ptr(), y.data_ptr(), h_final.data_ptr(), b, s, di, n,
            DTYPES[dt.dtype], DTYPES[u.dtype], stream)
    _build.check(err, "selective_scan")
    launches.add()
    return y, h_final


def _refuse_grad(*inputs: torch.Tensor) -> None:
    """The kernel has no backward yet: a CUDA input that asks for a
    gradient raises rather than leave it None (or take a plain VJP that
    would hide the kernel)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"selective_scan: no backward kernel on the card yet "
            f"({BWD_ITEM}); run it under torch.no_grad() or "
            f"inference_mode, or train on the CPU, where the plain "
            f"version is differentiable")


def _check(dt, bmat, cmat, u, a) -> None:
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan: tensors on {dt.device}; the "
                         f"kernel takes CUDA tensors (CPU ones take the "
                         f"plain version)")
    if dt.dtype not in DTYPES or u.dtype not in DTYPES:
        raise ValueError(f"selective_scan: dt is {dt.dtype}, u is "
                         f"{u.dtype}; each must be one of "
                         f"{sorted(map(str, DTYPES))}")
    if dt.dim() != 3 or a.dim() != 2:
        raise ValueError(f"selective_scan: need dt (b, s, di) and a (di, n),"
                         f" got {tuple(dt.shape)} and {tuple(a.shape)}")
    b, s, di = dt.shape
    n = a.shape[1]
    for name, t, shape, dtype in (
            ("B", bmat, (b, s, n), dt.dtype), ("C", cmat, (b, s, n), dt.dtype),
            ("u", u, (b, s, di), u.dtype),
            ("a", a, (di, n), torch.float32)):
        if t.device != dt.device or t.dtype != dtype \
                or tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: need {name} {dtype} {shape} "
                             f"on {dt.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if b == 0 or s == 0 or di == 0 or n == 0:
        raise ValueError("selective_scan: empty batch, sequence, "
                         "channels or state")
    for name, t in (("dt", dt), ("B", bmat), ("C", cmat), ("u", u),
                    ("a", a)):
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} is not contiguous")
