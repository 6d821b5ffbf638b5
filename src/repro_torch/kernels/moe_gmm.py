"""Wrapper of the hand-written grouped expert matmul kernel
(``csrc/moe_gmm.cu``, the port of the Pallas kernel in
``repro/kernels/moe_gmm.py``).

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
computes the plain version (``ref.gmm_ref``), and that is the only way
the plain version is taken. On a trace's fake device (``meta``: a
step traced by ``launch/hlo_analysis.py``) it takes its trace route: it
allocates what the CUDA route allocates, the d split's scratch by the
kernel's plan at an H100's SM count, launches nothing and counts the
call in ``trace_calls``. :class:`MoeGmm` (which ``ops.moe_gmm``
applies to CUDA tensors) gives it a gradient through two more launches
of the same kernel, each a grouped matmul it already computes: dx = dy
@ w^T and dw = x^T @ dy, per expert, on contiguous transposes.

Layout: x (e, c, d) and w (e, d, f), contiguous, both float32 or both
bfloat16; out (e, c, f) in x's dtype. Any c, d and f: no tile has to
divide them (the Pallas kernel's blocks did). The kernel streams the
weights at a capacity of 16 or less (decode), cutting d across blocks
where the experts' column strips are too few to fill the card (the
parts go to a scratch buffer allocated here and are added in a fixed
order), and runs 3xTF32 (f32) or bf16 tensor-core tiles above it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gmm_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plan's constants (csrc/moe_gmm.cu: kDecodeMaxC, kMinSplitStages)
# and the SMs of an H100 SXM, which a trace plans for
DECODE_MAX_C = 16
MIN_SPLIT_STAGES = 8
H100_SMS = 132

launches = _build.LaunchCounter()
trace_calls = _build.LaunchCounter()


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (e, c, d); w: (e, d, f) -> (e, c, f)."""
    if x.device.type == "cpu":
        return gmm_ref(x, w)
    _check(x, w)
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if _build.traced(x):
        lib, (_, _, splits) = None, plan(e, c, d, f, H100_SMS)
    else:
        lib = _build.library()
        with torch.cuda.device(x.device):
            _, _, splits = _plan(lib, e, c, d, f)
    # the d split's parts, added by the kernel's second pass
    ws = torch.empty(splits * e * c * f, dtype=torch.float32,
                     device=x.device) if splits > 1 else None
    if lib is None:
        trace_calls.add()
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_moe_gmm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                None if ws is None else ws.data_ptr(),
                                e, c, d, f, DTYPES[x.dtype], stream)
    _build.check(err, "moe_gmm")
    launches.add()
    return out


class MoeGmm(torch.autograd.Function):
    """The grouped matmul whose backward is the grouped matmul."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return moe_gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_gmm(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = moe_gmm(x.transpose(1, 2).contiguous(), dy)
        return dx, dw



def _plan(lib, e: int, c: int, d: int, f: int) -> Tuple[int, int, int]:
    """(kernel, strip, splits) of a call on the current device: kernel 0
    streams the weights in strips of ``strip`` columns, cutting d into
    ``splits`` blocks (1: no second pass); 1 runs tensor-core tiles."""
    strip, splits = ctypes.c_int(0), ctypes.c_int(1)
    kernel = lib.repro_moe_gmm_plan(e, c, d, f, ctypes.byref(strip),
                                    ctypes.byref(splits))
    return kernel, strip.value, splits.value


def plan(e: int, c: int, d: int, f: int, sms: int) -> Tuple[int, int, int]:
    """The kernel's plan (csrc/moe_gmm.cu ``plan``) on a card of ``sms``
    SMs, in Python: (kernel, strip, splits) as :func:`_plan` gives
    them."""
    if c > DECODE_MAX_C:
        return 1, 0, 1
    target = 4 * sms
    wide, narrow = -(-f // 128) * e, -(-f // 64) * e
    strip = 64 if wide < target <= narrow else 128
    blocks = narrow if strip == 64 else wide
    kr = 4096 // strip
    stages = -(-d // kr)
    want = max(1, min(-(-target // blocks), stages // MIN_SPLIT_STAGES))
    chunk = -(-stages // want) * kr
    return 0, strip, -(-d // chunk)


def variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel a call on these CUDA tensors runs, as the .cu
    dispatches it: "stream" (its strip width and d split) or "mma"
    (3xTF32 for f32, bf16)."""
    _check(x, w)
    e, c, d = x.shape
    with torch.cuda.device(x.device):
        kernel, strip, splits = _plan(_build.library(), e, c, d, w.shape[2])
    if kernel == 0:
        return f"stream {strip} cols" + (f", d split {splits}"
                                         if splits > 1 else "")
    return "mma_3xtf32" if x.dtype == torch.float32 else "mma_bf16"


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" and not _build.traced(x):
        raise ValueError(f"moe_gmm: tensors on {x.device}; the kernel "
                         f"takes CUDA tensors (CPU ones take the plain "
                         f"version, a trace's fake ones its trace route)")
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
