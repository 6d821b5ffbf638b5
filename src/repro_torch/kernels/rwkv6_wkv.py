"""Wrappers of the hand-written RWKV-6 WKV kernels: the forward
(``csrc/rwkv6_wkv.cu``, the port of the Pallas kernel in
``repro/kernels/rwkv6_wkv.py``) and its backward
(``csrc/rwkv6_wkv_bwd.cu``), joined by :class:`Rwkv6Wkv`, the
``torch.autograd.Function`` that :func:`rwkv6_wkv` applies to CUDA
inputs that need a gradient.

On a CUDA tensor each launches its kernel, or raises; on a CPU tensor
it computes the plain version (``ref.rwkv6_ref``, and for the backward
that function's VJP, ``ref.rwkv6_vjp_ref``), and that is the only way
the plain version is taken. Under grad the forward kernel also writes
the state before every 8th step, from which the backward kernel
recomputes the states it walks back over; without grad it writes
nothing more than y and the final state. On a trace's fake device
(``meta``: a step traced by ``launch/hlo_analysis.py``) each takes its
trace route: it allocates what the CUDA route allocates, checkpoints
included, by the same code, launches nothing and counts the call in
``trace_calls`` / ``bwd_trace_calls``.

Layout: r, k, v, w (b, h, s, dh), contiguous, all float32 or all
bfloat16; u (h, dh) float32; any head dim dh >= 1 forward (32 and 64
are compiled, narrower dims run in the next wider width with the extra
rows and columns zero, wider heads in a plain kernel), and up to 64
under grad: the backward kernel takes no wider head. The
recurrence starts from S = 0, as the Pallas kernel's does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_ref, rwkv6_vjp_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward writes the state before every CHECKPOINT-th step under
# grad (csrc/recurrence_bwd.cuh, kWkvCheckpoint)
CHECKPOINT = 8
MAX_GRAD_HEAD_DIM = 64

launches = _build.LaunchCounter()
bwd_launches = _build.LaunchCounter()
trace_calls = _build.LaunchCounter()
bwd_trace_calls = _build.LaunchCounter()


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y f32 (b, h, s, dh), s_final f32 (b, h, dh, dh)); on CUDA
    inputs that need a gradient, through :class:`Rwkv6Wkv`."""
    if r.device.type == "cpu":
        return rwkv6_ref(r, k, v, w, u)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return Rwkv6Wkv.apply(r, k, v, w, u)
    y, s_final, _ = wkv_forward(r, k, v, w, u)
    return y, s_final


def wkv_forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, checkpoints: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """One launch of the forward kernel on CUDA tensors: (y, s_final,
    the states before every CHECKPOINT-th step (b, h, ceil(s / 8), dh,
    dh) f32 where ``checkpoints``, else None)."""
    _check(r, k, v, w, u)
    b, h, s, dh = r.shape
    if checkpoints:
        _check_grad_width(dh)
    y = torch.empty((b, h, s, dh), dtype=torch.float32, device=r.device)
    s_final = torch.empty((b, h, dh, dh), dtype=torch.float32,
                          device=r.device)
    chk = (torch.empty((b, h, -(-s // CHECKPOINT), dh, dh),
                       dtype=torch.float32, device=r.device)
           if checkpoints else None)
    if _build.traced(r):
        trace_calls.add()
        return y, s_final, chk
    lib = _build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_rwkv6_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            None if chk is None else chk.data_ptr(), b, h, s, dh,
            DTYPES[r.dtype], stream)
    _build.check(err, "rwkv6_wkv")
    launches.add()
    return y, s_final, chk


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  chk: Optional[torch.Tensor], dy: torch.Tensor,
                  ds: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw f32 (b, h, s, dh), du f32 (h, dh)) of the
    recurrence at (r, k, v, w, u) for the cotangents ``dy`` of y and
    ``ds`` of the final state; ``chk``: the forward's checkpoints (unused
    on the CPU, where this is the plain version's VJP)."""
    if r.device.type == "cpu":
        return rwkv6_vjp_ref(r, k, v, w, u, dy, ds)
    _check(r, k, v, w, u)
    b, h, s, dh = r.shape
    _check_grad_width(dh)
    for name, t, shape in (
            ("chk", chk, (b, h, -(-s // CHECKPOINT), dh, dh)),
            ("dy", dy, (b, h, s, dh)), ("ds", ds, (b, h, dh, dh))):
        if t is None or t.device != r.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"rwkv6_wkv_bwd: need {name} a contiguous "
                             f"float32 {shape} on {r.device}, got {got}")
    dr, dk, dv, dw = (torch.empty((b, h, s, dh), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du_part = torch.empty((b, h, dh), dtype=torch.float32, device=r.device)
    du = torch.empty((h, dh), dtype=torch.float32, device=r.device)
    if _build.traced(r):
        bwd_trace_calls.add()
        return dr, dk, dv, dw, du
    lib = _build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_rwkv6_wkv_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), chk.data_ptr(), dy.data_ptr(), ds.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du_part.data_ptr(), du.data_ptr(), b, h, s, dh,
            DTYPES[r.dtype], stream)
    _build.check(err, "rwkv6_wkv_bwd")
    bwd_launches.add()
    return dr, dk, dv, dw, du


class Rwkv6Wkv(torch.autograd.Function):
    """The recurrence with the backward kernel as its gradient: the
    forward kernel writes the checkpoints the backward recomputes from,
    and they are saved with the inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, s_final, chk = wkv_forward(r, k, v, w, u, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, chk)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, chk = ctx.saved_tensors
        grads = rwkv6_wkv_bwd(r, k, v, w, u, chk, dy.contiguous(),
                              ds.contiguous())
        return tuple(g.to(x.dtype)
                     for g, x in zip(grads, (r, k, v, w, u)))


def _check_grad_width(dh: int) -> None:
    if dh > MAX_GRAD_HEAD_DIM:
        raise ValueError(f"rwkv6_wkv: the backward kernel takes head dims "
                         f"up to {MAX_GRAD_HEAD_DIM}, got {dh}; run the "
                         f"forward without grad, or train on the CPU")


def _check(r, k, v, w, u) -> None:
    if r.device.type != "cuda" and not _build.traced(r):
        raise ValueError(f"rwkv6_wkv: tensors on {r.device}; the kernel "
                         f"takes CUDA tensors (CPU ones take the plain "
                         f"version, a trace's fake ones its trace route)")
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
