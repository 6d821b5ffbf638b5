"""Times this checkout's forward WKV and selective-scan kernels against
another checkout's, in turns, on one card.

    python -m repro_torch.launch.recurrence_turns OTHER_CSRC \\
        [--rounds 3] [--out FILE]

``OTHER_CSRC`` is the ``csrc`` directory of a checkout from before the
recurrences' backward kernels (unpack one with ``git archive <commit>
src/repro_torch/csrc | tar -x -C DIR``): its ``rwkv6_wkv.cu`` and
``selective_scan.cu`` are built into a library of their own with this
package's nvcc flags, and their entry points take no checkpoint
argument. This checkout's are called with a null checkpoint pointer,
the serving path. At rwkv6-7b's prefill shape (4, 64, 511, 64) and
jamba's (4, 512, 16384, 16) (dt around the model's b_dt of -4.6), f32,
it checks that both give the same outputs bit for bit, and times each
with CUDA events as the median over 15 replays of a CUDA graph of 100
calls, in the order other, this, this, other, ``--rounds`` times. It
prints one JSON line a kernel, between two lines with the card's name
and power limit, and writes the lines to ``--out``.
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
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.launch.attention_turns import gpu_line, graph_ms


def build_other(csrc: Path, out_dir: Path) -> ctypes.CDLL:
    """The other checkout's two forward kernels, as a shared library with
    their entry points typed (no checkpoint argument)."""
    lib = out_dir / "libother_recurrences.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(csrc / "rwkv6_wkv.cu"),
                    str(csrc / "selective_scan.cu")],
                   check=True, capture_output=True, text=True)
    other = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    other.repro_rwkv6_wkv.argtypes = [p] * 7 + [i] * 5 + [p]
    other.repro_selective_scan.argtypes = [p] * 7 + [i] * 6 + [p]
    return other


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def calls(other: ctypes.CDLL, g: torch.Generator):
    """name -> (other's call, this checkout's call, the inputs, the
    outputs, the shape). The calls take raw pointers: the inputs are
    returned so that they outlive the calls."""
    dev = torch.device("cuda")
    this = _build.library()
    b, h, s, dh = 4, 64, 511, 64
    r, k, v = (torch.randn((b, h, s, dh), generator=g).to(dev)
               for _ in range(3))
    w = (torch.sigmoid(torch.randn((b, h, s, dh), generator=g)) * 0.5
         + 0.45).to(dev)
    u = (torch.randn((h, dh), generator=g) * 0.3).to(dev)
    y, sf = torch.empty_like(r), torch.empty((b, h, dh, dh), device=dev)
    wkv = [t.data_ptr() for t in (r, k, v, w, u, y, sf)]
    sb, ss, di, n = 4, 512, 16384, 16
    dt = F.softplus(torch.randn((sb, ss, di), generator=g) - 4.6).to(dev)
    bm, cm = (torch.randn((sb, ss, n), generator=g).to(dev)
              for _ in range(2))
    uu = torch.randn((sb, ss, di), generator=g).to(dev)
    a = -torch.exp(torch.randn((di, n), generator=g) * 0.5).to(dev)
    ys, hf = torch.empty_like(dt), torch.empty((sb, di, n), device=dev)
    scan = [t.data_ptr() for t in (dt, bm, cm, uu, a, ys, hf)]
    return {
        "rwkv6_wkv": (
            lambda: other.repro_rwkv6_wkv(*wkv, b, h, s, dh, 0, _stream()),
            lambda: this.repro_rwkv6_wkv(*wkv, None, b, h, s, dh, 0,
                                         _stream()),
            (r, k, v, w, u), (y, sf), [b, h, s, dh]),
        "selective_scan": (
            lambda: other.repro_selective_scan(*scan, sb, ss, di, n, 0, 0,
                                               _stream()),
            lambda: this.repro_selective_scan(*scan, None, sb, ss, di, n, 0,
                                              0, _stream()),
            (dt, bm, cm, uu, a), (ys, hf), [sb, ss, di, n]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    card = gpu_line()
    lines = [card]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        other = build_other(args.other_csrc, Path(tmp))
        g = torch.Generator().manual_seed(5)
        for name, (o_call, t_call, _, outs, shape) in calls(other,
                                                            g).items():
            o_call()
            torch.cuda.synchronize()
            o_out = [t.clone() for t in outs]
            t_call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(o_out, outs))
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for side in ("other", "this", "this", "other"):
                    fn = o_call if side == "other" else t_call
                    times[side].append(graph_ms(fn))
            line = json.dumps({
                "kernel": name, "shape": shape, "f32": True,
                "bit_identical": same, "other_ms": times["other"],
                "this_ms": times["this"],
                "other_median_ms": statistics.median(times["other"]),
                "this_median_ms": statistics.median(times["this"]),
                "this_always_slower": min(times["this"])
                > max(times["other"]),
                "this_always_faster": max(times["this"])
                < min(times["other"])})
            lines.append(line)
            print(line, flush=True)
    lines.append(gpu_line())
    print(lines[-1], flush=True)
    if args.out:
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
