"""Wrappers of the hand-written selective-scan kernels: the forward
(``csrc/selective_scan.cu``, the port of the Pallas kernel in
``repro/kernels/selective_scan.py``) and its backward
(``csrc/selective_scan_bwd.cu``), joined by :class:`SelectiveScan`, the
``torch.autograd.Function`` that :func:`selective_scan` applies to CUDA
inputs that need a gradient.

On a CUDA tensor each launches its kernel, or raises; on a CPU tensor it
computes the plain version (``ref.selective_scan_ref``, and for the
backward that function's VJP, ``ref.selective_scan_vjp_ref``), and that
is the only way the plain version is taken. Under grad the forward
kernel also writes h before every 4th step, from which the backward
kernel recomputes the states it walks back over. On a trace's fake
device (``meta``: a step traced by ``launch/hlo_analysis.py``) each
takes its trace route: it allocates what the CUDA route allocates,
checkpoints and scratch included, by the same code, launches nothing
and counts the call in ``trace_calls`` / ``bwd_trace_calls``.

Layout: dt, u (b, s, di); B, C (b, s, n); A (di, n) float32; all
contiguous. dt, B and C are all float32 or all bfloat16, u is float32 or
bfloat16 on its own (the Mamba mixer passes f32 dt/B/C and u in the
activation dtype); any state dim n >= 1 forward, as the Pallas kernel
takes (4, 8 and 16 have registers of their own, other n up to 64 run
masked, wider ones loop), and up to 16 under grad: the backward kernel
takes no wider state. The scan starts from h = 0, as the Pallas kernel's
does; any s and di work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan_ref, selective_scan_vjp_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward writes h before every CHECKPOINT-th step under grad
# (csrc/recurrence_bwd.cuh, kScanCheckpoint); the backward sums dB and
# dC over blocks of BLOCK channels
CHECKPOINT = 4
BLOCK = 128
MAX_GRAD_STATE = 16

launches = _build.LaunchCounter()
bwd_launches = _build.LaunchCounter()
trace_calls = _build.LaunchCounter()
bwd_trace_calls = _build.LaunchCounter()


def selective_scan(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                   u: torch.Tensor, a: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y f32 (b, s, di), h_final f32 (b, di, n)); on CUDA inputs that
    need a gradient, through :class:`SelectiveScan`."""
    if dt.device.type == "cpu":
        return selective_scan_ref(dt, bmat, cmat, u, a)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, bmat, cmat, u, a)):
        return SelectiveScan.apply(dt, bmat, cmat, u, a)
    y, h_final, _ = scan_forward(dt, bmat, cmat, u, a)
    return y, h_final


def scan_forward(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 u: torch.Tensor, a: torch.Tensor, checkpoints: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """One launch of the forward kernel on CUDA tensors: (y, h_final, h
    before every CHECKPOINT-th step, state-major (b, ceil(s / 4), n, di)
    f32, where ``checkpoints``, else None)."""
    _check(dt, bmat, cmat, u, a)
    b, s, di = dt.shape
    n = a.shape[1]
    if checkpoints:
        _check_grad_state(n)
    y = torch.empty((b, s, di), dtype=torch.float32, device=dt.device)
    h_final = torch.empty((b, di, n), dtype=torch.float32, device=dt.device)
    chk = (torch.empty((b, -(-s // CHECKPOINT), n, di), dtype=torch.float32,
                       device=dt.device) if checkpoints else None)
    if _build.traced(dt):
        trace_calls.add()
        return y, h_final, chk
    lib = _build.library()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.repro_selective_scan(
            dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), u.data_ptr(),
            a.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            None if chk is None else chk.data_ptr(), b, s, di, n,
            DTYPES[dt.dtype], DTYPES[u.dtype], stream)
    _build.check(err, "selective_scan")
    launches.add()
    return y, h_final, chk


def selective_scan_bwd(dt: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                       chk: Optional[torch.Tensor], dy: torch.Tensor,
                       dh: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(d(dt) f32 (b, s, di), dB, dC f32 (b, s, n), du f32 (b, s, di),
    dA f32 (di, n)) of the scan at (dt, B, C, u, A) for the cotangents
    ``dy`` of y and ``dh`` of the final state; ``chk``: the forward's
    checkpoints (unused on the CPU, where this is the plain version's
    VJP)."""
    if dt.device.type == "cpu":
        return selective_scan_vjp_ref(dt, bmat, cmat, u, a, dy, dh)
    _check(dt, bmat, cmat, u, a)
    b, s, di = dt.shape
    n = a.shape[1]
    _check_grad_state(n)
    for name, t, shape in (
            ("chk", chk, (b, -(-s // CHECKPOINT), n, di)),
            ("dy", dy, (b, s, di)), ("dh", dh, (b, di, n))):
        if t is None or t.device != dt.device \
                or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"selective_scan_bwd: need {name} a "
                             f"contiguous float32 {shape} on {dt.device}, "
                             f"got {got}")
    f32 = dict(dtype=torch.float32, device=dt.device)
    ddt, du = (torch.empty((b, s, di), **f32) for _ in range(2))
    dbc_part = torch.empty((-(-di // BLOCK), 2, b, s, n), **f32)
    da_part = torch.empty((b, di, n), **f32)
    dbc = torch.empty((2, b, s, n), **f32)
    da = torch.empty((di, n), **f32)
    if _build.traced(dt):
        bwd_trace_calls.add()
        return ddt, dbc[0], dbc[1], du, da
    lib = _build.library()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.repro_selective_scan_bwd(
            dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), u.data_ptr(),
            a.data_ptr(), chk.data_ptr(), dy.data_ptr(), dh.data_ptr(),
            ddt.data_ptr(), du.data_ptr(), dbc_part.data_ptr(),
            da_part.data_ptr(), dbc.data_ptr(), da.data_ptr(), b, s, di, n,
            DTYPES[dt.dtype], DTYPES[u.dtype], stream)
    _build.check(err, "selective_scan_bwd")
    bwd_launches.add()
    return ddt, dbc[0], dbc[1], du, da


class SelectiveScan(torch.autograd.Function):
    """The scan with the backward kernel as its gradient: the forward
    kernel writes the checkpoints the backward recomputes from, and they
    are saved with the inputs."""

    @staticmethod
    def forward(ctx, dt, bmat, cmat, u, a):
        y, h_final, chk = scan_forward(dt, bmat, cmat, u, a,
                                       checkpoints=True)
        ctx.save_for_backward(dt, bmat, cmat, u, a, chk)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh):
        dt, bmat, cmat, u, a, chk = ctx.saved_tensors
        grads = selective_scan_bwd(dt, bmat, cmat, u, a, chk,
                                   dy.contiguous(), dh.contiguous())
        return tuple(g.to(x.dtype)
                     for g, x in zip(grads, (dt, bmat, cmat, u, a)))


def _check_grad_state(n: int) -> None:
    if n > MAX_GRAD_STATE:
        raise ValueError(f"selective_scan: the backward kernel takes state "
                         f"dims up to {MAX_GRAD_STATE}, got {n}; run the "
                         f"forward without grad, or train on the CPU")


def _check(dt, bmat, cmat, u, a) -> None:
    if dt.device.type != "cuda" and not _build.traced(dt):
        raise ValueError(f"selective_scan: tensors on {dt.device}; the "
                         f"kernel takes CUDA tensors (CPU ones take the "
                         f"plain version, a trace's fake ones its trace "
                         f"route)")
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
