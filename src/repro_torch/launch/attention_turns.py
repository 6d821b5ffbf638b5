"""Times this checkout's attention kernel against another checkout's, in
turns, on one card.

    python -m repro_torch.launch.attention_turns OTHER_CSRC \\
        [--order other,this,this,other] [--out FILE]

``OTHER_CSRC`` is the ``csrc`` directory of another checkout (unpack one
with ``git archive <commit> src/repro_torch/csrc | tar -x -C DIR``). Its
``flash_attention.cu`` is built into a library of its own with this
package's nvcc flags, and called through ``repro_flash_attention_lse``
with a null lse, or ``repro_flash_attention`` where it is older. At the zoo's causal f32 prefill shapes (granite-moe-3b-a800m, h2o-danube-1.8b
with its window of 4096, jamba-1.5-large-398b) it checks that the two
give the same output bit for bit on random finite inputs, times each
with CUDA events as the median over 15 replays of a CUDA graph of 100
calls, in the order given, and profiles this checkout's calls for the
device time of each of its kernels (the attention kernel and its
hidden-key fix-up apart). It prints one JSON line a shape, between two lines with
the card's name and power limit, and writes the lines to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

# (q, k/v, window) of each model's prefill self-attention, 511 tokens
SHAPES = {
    "granite": ((4, 24, 511, 64), (4, 8, 511, 64), 0),
    "h2o": ((4, 32, 511, 80), (4, 8, 511, 80), 4096),
    "jamba": ((4, 64, 512, 128), (4, 8, 512, 128), 0),
}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def build_other(csrc: Path, out_dir: Path) -> ctypes.CDLL:
    """``csrc/flash_attention.cu`` alone, as a shared library."""
    lib = out_dir / "libother_attention.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(csrc / "flash_attention.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def other_call(lib: ctypes.CDLL):
    """The other build's forward, without the log-sum-exp: its
    ``repro_flash_attention_lse`` given a null lse, or, in a build from
    before that entry, its ``repro_flash_attention``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    try:
        entry, lse = lib.repro_flash_attention_lse, (None,)
    except AttributeError:
        entry, lse = lib.repro_flash_attention, ()
    entry.argtypes = [p] * (4 + len(lse)) + [i] * 9 + [f, p]
    entry.restype = i

    def run(q, k, v, window):
        b, h, sq, dh = q.shape
        o = torch.empty_like(q)
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *lse, b,
            h, k.shape[1], sq, k.shape[2], dh, fa.DTYPES[q.dtype], 1, window,
            dh ** -0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "other flash_attention")
        return o
    return run


def graph_ms(fn, reps: int = 100, trials: int = 15) -> float:
    """Median over ``trials`` of the mean time of ``reps`` calls captured
    in one CUDA graph and replayed, from CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def kernel_us(fn, calls: int = 20) -> dict:
    """Device time a launch of each kernel ``fn`` launches, profiled: the
    mean over the launches the profiler recorded (it may drop some)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us and e.count:
            out[e.key.split("::")[-1].split("<")[0]] = us / e.count
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--order", default="other,this,this,other")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    order = args.order.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("attention_turns: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = [gpu_line()]
    print(lines[0], flush=True)
    _build.library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        other = other_call(build_other(args.other_csrc, Path(tmp)))
        runs = {"this": lambda q, k, v, w: fa.flash_attention(
            q, k, v, causal=True, window=w), "other": other}
        g = torch.Generator().manual_seed(0)
        for tag, (qs, ks, window) in SHAPES.items():
            q = torch.randn(qs, generator=g).cuda()
            k, v = (torch.randn(ks, generator=g).cuda() for _ in range(2))
            same = torch.equal(runs["this"](q, k, v, window),
                               runs["other"](q, k, v, window))
            ms = {name: [] for name in runs}
            for name in order:
                ms[name].append(graph_ms(
                    lambda: runs[name](q, k, v, window)))
            row = {"shape": tag, "q": qs, "kv": ks, "window": window,
                   "bit_identical": same, "order": order, "ms": ms,
                   "this_kernel_us": kernel_us(
                       lambda: runs["this"](q, k, v, window)),
                   "variant": fa.variant(q, k, v)}
            lines.append(json.dumps(row))
            print(lines[-1], flush=True)
    lines.append(gpu_line())
    print(lines[-1], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
