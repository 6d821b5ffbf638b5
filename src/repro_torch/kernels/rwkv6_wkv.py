"""Wrapper of the hand-written RWKV-6 WKV kernel (``csrc/rwkv6_wkv.cu``,
the port of the Pallas kernel in ``repro/kernels/rwkv6_wkv.py``).

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
computes the plain version (``ref.rwkv6_ref``), and that is the only way
the plain version is taken. The kernel has no backward yet: a CUDA
input that requires grad, with grad enabled, raises.

Layout: r, k, v, w (b, h, s, dh), contiguous, all float32 or all
bfloat16; u (h, dh) float32; any head dim dh >= 1 (32 and 64 are
compiled, narrower dims run in the next wider width with the extra rows
and columns zero, wider heads in a plain kernel). The
recurrence starts from S = 0, as the Pallas kernel's does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter()
# the ROADMAP entry that ports its backward kernel
BWD_ITEM = ("ROADMAP Queue 2, backward kernels for rwkv6_wkv and "
            "selective_scan")


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y f32 (b, h, s, dh), s_final f32 (b, h, dh, dh))."""
    if r.device.type == "cpu":
        return rwkv6_ref(r, k, v, w, u)
    _refuse_grad(r, k, v, w, u)
    _check(r, k, v, w, u)
    b, h, s, dh = r.shape
    y = torch.empty((b, h, s, dh), dtype=torch.float32, device=r.device)
    s_final = torch.empty((b, h, dh, dh), dtype=torch.float32,
                          device=r.device)
    lib = _build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_rwkv6_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s_final.data_ptr(), b, h, s, dh,
            DTYPES[r.dtype], stream)
    _build.check(err, "rwkv6_wkv")
    launches.add()
    return y, s_final


def _refuse_grad(*inputs: torch.Tensor) -> None:
    """The kernel has no backward yet: a CUDA input that asks for a
    gradient raises rather than leave it None (or take a plain VJP that
    would hide the kernel)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"rwkv6_wkv: no backward kernel on the card yet "
            f"({BWD_ITEM}); run it under torch.no_grad() or "
            f"inference_mode, or train on the CPU, where the plain "
            f"version is differentiable")


def _check(r, k, v, w, u) -> None:
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv: tensors on {r.device}; the kernel "
                         f"takes CUDA tensors (CPU ones take the plain "
                         f"version)")
    if r.dtype not in DTYPES:
        raise ValueError(f"rwkv6_wkv: dtype {r.dtype} not in "
                         f"{sorted(map(str, DTYPES))}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv: need r (b, h, s, dh), got "
                         f"{tuple(r.shape)}")
    b, h, s, dh = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.device != r.device or t.dtype != r.dtype \
                or t.shape != r.shape:
            raise ValueError(f"rwkv6_wkv: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, r is "
                             f"{r.dtype} {tuple(r.shape)} on {r.device}")
    if u.device != r.device or u.dtype != torch.float32 \
            or tuple(u.shape) != (h, dh):
        raise ValueError(f"rwkv6_wkv: need u float32 {(h, dh)} on "
                         f"{r.device}, got {u.dtype} {tuple(u.shape)} on "
                         f"{u.device}")
    if b == 0 or h == 0 or s == 0 or dh == 0:
        raise ValueError("rwkv6_wkv: empty batch, heads, sequence or head "
                         "dim")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"rwkv6_wkv: {name} is not contiguous")
