"""Wrappers of the hand-written flash-attention kernels: the forward
(``csrc/flash_attention.cu``, the port of the Pallas kernel in
``repro/kernels/flash_attention.py``) and its backward
(``csrc/flash_attention_bwd.cu``), joined by :class:`FlashAttention`,
the ``torch.autograd.Function`` that ``ops.flash_attention`` applies to
CUDA tensors under grad. Under grad the forward also writes each row's
log-sum-exp (``return_lse``), which the backward's tensor-core route
reads in place of recomputing the softmax statistics.

On a CUDA tensor each launches its kernel, or raises; on a CPU tensor
it computes the plain version (``ref.attention_ref``, and for the
backward that function's VJP, ``ref.attention_vjp_ref``), and that is
the only way the plain version is taken. On a trace's fake device
(``meta``: a step traced by ``launch/hlo_analysis.py``) each takes its
trace route: it allocates what the CUDA route allocates, by the same
code, launches nothing and counts the call in ``trace_calls`` /
``bwd_trace_calls``.

Layout: q (b, h, sq, dh); k/v (b, kvh, sk, dh), contiguous, float32 or
bfloat16; any head dim 1 <= dh <= 512 (16, 32, 64, 80 and 128 are
compiled, other dims run in the next wider width with the extra
columns zero). GQA by head grouping. The kernel runs its products on
the tensor cores (3xTF32 for f32) where sq > 16 and dh <= 128, and on
f32 FMAs for short queries (the split-NN tower's 8 tokens) and wider
heads; the backward takes the same two routes at the same gate
(:func:`bwd_variant`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref, attention_vjp_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
# the widest head the tensor-core routes take (csrc: kMaxMmaDh)
MAX_MMA_HEAD_DIM = 128

launches = _build.LaunchCounter()
bwd_launches = _build.LaunchCounter()
trace_calls = _build.LaunchCounter()
bwd_trace_calls = _build.LaunchCounter()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, return_lse: bool = False):
    """q: (b, h, sq, dh); k/v: (b, kvh, sk, dh) -> o (b, h, sq, dh), and
    with ``return_lse`` (o, lse), lse f32 (b, h, sq): each row's
    log-sum-exp of its masked, scaled scores (``ref.attention_ref``'s).
    ``o`` is the same to the bit either way."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, return_lse=return_lse)
    _check(q, k, v)
    b, h, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if _build.traced(q):
        trace_calls.add()
        return (o, lse) if return_lse else o
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, kvh, sq, sk, dh,
            DTYPES[q.dtype], int(bool(causal)), int(window), float(scale),
            stream)
    _build.check(err, "flash_attention")
    launches.add()
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        lse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention at (q, k, v), whose output is ``o``,
    for the output cotangent ``do`` (both shaped as q). ``lse``: the
    forward's (``flash_attention(..., return_lse=True)``), which the
    tensor-core route (:func:`bwd_variant`) needs and reads in place of
    the softmax statistics; the FMA route recomputes them and ignores
    it."""
    if q.device.type == "cpu":
        return attention_vjp_ref(q, k, v, do, causal=causal, window=window,
                                 scale=scale)
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    b, h, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    route = bwd_variant(q, k, v)
    if route != "simt":
        if lse is None or lse.shape != (b, h, sq) \
                or lse.dtype != torch.float32 or lse.device != q.device \
                or not lse.is_contiguous():
            raise ValueError(
                f"flash_attention_bwd: the {route} route needs the "
                f"forward's lse, a contiguous float32 {(b, h, sq)} on "
                f"{q.device} (flash_attention(..., return_lse=True)), got "
                f"{None if lse is None else (lse.dtype, tuple(lse.shape))}")
        # the route stages O and dO by 16-byte copies
        o, do = (t.clone() if _misaligned(t) else t for t in (o, do))
        # D = rowsum(do * o), from the dq kernel to the dk / dv kernel;
        # with GQA each query head's share of dk and dv, which a third
        # kernel adds over the group
        dvec = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        part = (torch.empty((2, b, h, sk, dh), dtype=torch.float32,
                            device=q.device) if h > kvh else None)
        if _build.traced(q):
            bwd_trace_calls.add()
            return dq, dk, dv
        entry = _build.library().repro_flash_attention_bwd_mma
        before = (lse.data_ptr(), dvec.data_ptr(),
                  None if part is None else part.data_ptr())
        after = ()
    else:
        # each row's max, 1 / denominator and rowsum(do * o), from the
        # first kernel to the second
        stats = torch.empty(3 * b * h * sq, dtype=torch.float32,
                            device=q.device)
        if _build.traced(q):
            bwd_trace_calls.add()
            return dq, dk, dv
        entry = _build.library().repro_flash_attention_bwd
        before, after = (), (stats.data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the routes' scratch goes before dq (lse, D, GQA shares) or
        # after dv (the statistics)
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), *before, dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), *after, b, h, kvh, sq, sk, dh,
                    DTYPES[q.dtype], int(bool(causal)), int(window),
                    float(scale), stream)
    _build.check(err, "flash_attention_bwd")
    bwd_launches.add()
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The attention with the backward kernel as its gradient: it saves
    q, k, v, the output and each row's log-sum-exp, from which the
    backward recomputes the softmax (on a CPU tensor both directions are
    the plain versions). ``ops.flash_attention`` applies it only under
    grad, so calls outside grad write no log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=causal, window=window,
                                         scale=scale, lse=lse)
        return dq, dk, dv, None, None, None



def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which kernel a call on these CUDA tensors runs, as the .cu
    dispatches it: "simt", or "mma_3xtf32" / "mma_bf16"."""
    _check(q, k, v)
    mma = _build.library().repro_flash_attention_variant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.shape[2], q.shape[3])
    if not mma:
        return "simt"
    return "mma_3xtf32" if q.dtype == torch.float32 else "mma_bf16"


def bwd_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which route :func:`flash_attention_bwd` runs for these CUDA
    tensors: the forward's gate (sq > 16, dh <= 128, aligned q, k, v)
    takes the tensor cores, "mma_3xtf32" / "mma_bf16"; the rest "simt",
    the f32-FMA kernels. On a trace's fake device the same gate in Python
    (a trace has no library), alignment from the storage offset."""
    if not _build.traced(q):
        return variant(q, k, v)
    _check(q, k, v)
    if q.shape[2] <= 16 or q.shape[3] > MAX_MMA_HEAD_DIM \
            or any(_misaligned(t) for t in (q, k, v)):
        return "simt"
    return "mma_3xtf32" if q.dtype == torch.float32 else "mma_bf16"


def _misaligned(t: torch.Tensor) -> bool:
    """Does ``t`` start off a 16-byte boundary? A fake tensor has no
    address: its storage's block is taken as aligned (the caching
    allocator's are), so its offset into it decides."""
    if _build.traced(t):
        return bool(t.storage_offset() * t.element_size() % 16)
    return bool(t.data_ptr() % 16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda" and not _build.traced(q):
        raise ValueError(f"flash_attention: tensors on {q.device}; the "
                         f"kernel takes CUDA tensors (CPU ones take the "
                         f"plain version, a trace's fake ones its trace "
                         f"route)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{sorted(map(str, DTYPES))}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: need q (b, h, sq, dh) and "
                         f"k/v (b, kvh, sk, dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} above "
                         f"{MAX_HEAD_DIM}")
    if q.shape[2] == 0 or k.shape[2] == 0 or b == 0 or dh == 0:
        raise ValueError("flash_attention: empty sequence, batch or head")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
