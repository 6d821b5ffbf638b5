"""Times this checkout's WKV and selective-scan kernels, forward and
backward, against another checkout's, in turns, on one card.

    python -m repro_torch.launch.recurrence_turns OTHER_CSRC \\
        [--rounds 3] [--out FILE]

``OTHER_CSRC`` is another checkout's ``csrc`` directory (unpack one with
``git archive <commit> src/repro_torch/csrc | tar -x -C DIR``). Its
``rwkv6_wkv.cu`` and ``selective_scan.cu``, and its ``rwkv6_wkv_bwd.cu``
and ``selective_scan_bwd.cu`` where it has them, are built into a
library of their own with this package's nvcc flags and ``-Xptxas -v``,
and so are this checkout's; each backward kernel's registers, spills and
static shared memory at the path's instantiation (f32, head dim 64,
state dim 16) are printed for both. A checkout without the backward
kernels predates them, and its forward entry points take no checkpoint
argument; this checkout's forwards are then called with a null
checkpoint pointer, the serving path.

At rwkv6-7b's shape (4, 64, 511, 64) and jamba's (4, 512, 16384, 16) (dt
around the model's b_dt of -4.6), f32, it checks that the two forwards
give the same outputs bit for bit (and times them with the checkpoints
they write under grad too, where both have them), and that the two
backward kernels,
from this checkout's forward's checkpoints and the same cotangents, give
every gradient within 1e-4 of its largest magnitude (the summation order
differs, so not bits), this checkout's twice the same to the bit; each
backward reads the checkpoints its own checkout's forward writes (their
layouts may differ: the scan's are state-major now, not before). It
times each kernel with CUDA events as the median over 15 replays of a
CUDA graph of 100 calls (20 for the backward kernels), in the order
other, this, this, other, ``--rounds`` times. It prints one JSON line a
kernel, between two lines with the card's name and power limit, and
writes the lines to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.launch.attention_turns import gpu_line, graph_ms

FWD = ("rwkv6_wkv", "selective_scan")
BWD = ("rwkv6_wkv_bwd", "selective_scan_bwd")
# the backward kernels' instantiations on the training paths (mangled
# name fragments): f32, head dim 64 exact; f32 dt/B/C and u, 16 states
PATH_KERNELS = {"rwkv6_wkv_bwd": "rwkv6_wkv_bwd_kernelIfLi64ELb1E",
                "selective_scan_bwd": "selective_scan_bwd_kernelIffLi16ELb1E"}


def build(csrc: Path, out_dir: Path, tag: str):
    """The recurrence sources of ``csrc`` (the backward ones where it
    has them) as a shared library with typed entry points, and ptxas's
    resource lines of the path's backward instantiations."""
    names = [n for n in FWD + BWD if (csrc / f"{n}.cu").exists()]
    with_bwd = all((csrc / f"{n}.cu").exists() for n in BWD)
    procs, objs, usage = [], [], {}
    for name in names:
        obj = out_dir / f"{tag}_{name}.o"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               str(csrc / f"{name}.cu"), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(str(obj))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {csrc / name}.cu failed:\n{log}")
        if name in PATH_KERNELS:
            usage[name] = resource_usage(log, PATH_KERNELS[name])
    lib_path = out_dir / f"lib{tag}_recurrences.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), *objs], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    chk = [p] if with_bwd else []
    lib.repro_rwkv6_wkv.argtypes = [p] * 7 + chk + [i] * 5 + [p]
    lib.repro_selective_scan.argtypes = [p] * 7 + chk + [i] * 6 + [p]
    if with_bwd:
        lib.repro_rwkv6_wkv_bwd.argtypes = [p] * 14 + [i] * 5 + [p]
        lib.repro_selective_scan_bwd.argtypes = [p] * 14 + [i] * 6 + [p]
    for fn in ([lib.repro_rwkv6_wkv, lib.repro_selective_scan]
               + ([lib.repro_rwkv6_wkv_bwd, lib.repro_selective_scan_bwd]
                  if with_bwd else [])):
        fn.restype = i
    return lib, with_bwd, usage


def resource_usage(ptxas_log: str, fragment: str) -> dict:
    """Registers, spill bytes and static shared memory ptxas reports for
    the entry whose mangled name contains ``fragment``."""
    out, cur = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or fragment not in cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out["spill_stores"], out["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ok(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")


def wkv_case(g: torch.Generator) -> dict:
    dev = torch.device("cuda")
    b, h, s, dh = 4, 64, 511, 64
    r, k, v = (torch.randn((b, h, s, dh), generator=g).to(dev)
               for _ in range(3))
    w = (torch.sigmoid(torch.randn((b, h, s, dh), generator=g)) * 0.5
         + 0.45).to(dev)
    u = (torch.randn((h, dh), generator=g) * 0.3).to(dev)
    y, sf = torch.empty_like(r), torch.empty((b, h, dh, dh), device=dev)
    chk = torch.empty((b, h, -(-s // 8), dh, dh), device=dev)
    dy = torch.randn((b, h, s, dh), generator=g).to(dev)
    ds = torch.randn((b, h, dh, dh), generator=g).to(dev)
    return {"shape": [b, h, s, dh], "dims": (b, h, s, dh),
            "ins": (r, k, v, w, u), "outs": (y, sf), "chk": chk,
            "cots": (dy, ds), "grads": [(b, h, s, dh)] * 4 + [(h, dh)],
            "scratch": [(b, h, dh)], "names": ("dr", "dk", "dv", "dw",
                                                 "du")}


def scan_case(g: torch.Generator) -> dict:
    dev = torch.device("cuda")
    b, s, di, n = 4, 512, 16384, 16
    dt = F.softplus(torch.randn((b, s, di), generator=g) - 4.6).to(dev)
    bm, cm = (torch.randn((b, s, n), generator=g).to(dev) for _ in range(2))
    u = torch.randn((b, s, di), generator=g).to(dev)
    a = -torch.exp(torch.randn((di, n), generator=g) * 0.5).to(dev)
    y, hf = torch.empty_like(dt), torch.empty((b, di, n), device=dev)
    chk = torch.empty((b, -(-s // 4), di, n), device=dev)
    dy = torch.randn((b, s, di), generator=g).to(dev)
    dh = torch.randn((b, di, n), generator=g).to(dev)
    nblk = -(-di // 128)
    return {"shape": [b, s, di, n], "dims": (b, s, di, n),
            "ins": (dt, bm, cm, u, a), "outs": (y, hf), "chk": chk,
            "cots": (dy, dh),
            "grads": [(b, s, di), (b, s, di), (2, b, s, n), (di, n)],
            "scratch": [(nblk, 2, b, s, n), (b, di, n)],
            "names": ("ddt", "du", "dB_dC", "dA")}


def forward_call(lib, name: str, case: dict, chk):
    ptrs = [t.data_ptr() for t in case["ins"] + case["outs"]]
    extra = [] if chk is False else [chk]
    dims, tail = case["dims"], ([0] if name == FWD[0] else [0, 0])
    fn = getattr(lib, f"repro_{name}")
    return lambda: _ok(fn(*ptrs, *extra, *dims, *tail, _stream()), name)


def backward_call(lib, name: str, case: dict, chk: torch.Tensor):
    """The backward entry of ``lib`` at the case from the checkpoints
    ``chk``, into outputs and scratch of its own: (the call, the
    gradients)."""
    dev = case["ins"][0].device
    grads = [torch.empty(sh, device=dev) for sh in case["grads"]]
    scratch = [torch.empty(sh, device=dev) for sh in case["scratch"]]
    ins = [t.data_ptr() for t in case["ins"]]
    cots = [t.data_ptr() for t in case["cots"]]
    fn = getattr(lib, f"repro_{name}")
    if name == BWD[0]:
        dr, dk, dv, dw, du = (t.data_ptr() for t in grads)
        args = [*ins, chk.data_ptr(), *cots, dr, dk, dv, dw,
                scratch[0].data_ptr(), du, *case["dims"], 0]
    else:
        ddt, d_u, dbc, da = (t.data_ptr() for t in grads)
        args = [*ins, chk.data_ptr(), *cots, ddt, d_u,
                scratch[0].data_ptr(), scratch[1].data_ptr(), dbc, da,
                *case["dims"], 0, 0]
    keep = grads + scratch  # the call holds raw pointers into these

    def call():
        _ok(fn(*args, _stream()), name)
        return keep
    return call, grads


def in_turns(o_call, t_call, rounds: int, **timing) -> dict:
    times = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            fn = o_call if side == "other" else t_call
            times[side].append(graph_ms(fn, **timing))
    o_med = statistics.median(times["other"])
    t_med = statistics.median(times["this"])
    return {"other_ms": times["other"], "this_ms": times["this"],
            "other_median_ms": o_med, "this_median_ms": t_med,
            "speedup": o_med / t_med,
            "this_always_slower": min(times["this"]) > max(times["other"]),
            "this_always_faster": max(times["this"]) < min(times["other"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    card = gpu_line()
    lines = [card]
    print(card, flush=True)

    def emit(obj: dict) -> None:
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        other, other_bwd, o_usage = build(args.other_csrc, Path(tmp),
                                          "other")
        this, _, t_usage = build(_build.CSRC, Path(tmp), "this")
        g = torch.Generator().manual_seed(5)
        for name, make in zip(FWD, (wkv_case, scan_case)):
            case = make(g)
            o_call = forward_call(other, name, case,
                                  None if other_bwd else False)
            t_call = forward_call(this, name, case, None)
            o_call()
            torch.cuda.synchronize()
            o_out = [t.clone() for t in case["outs"]]
            t_call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(o_out, case["outs"]))
            emit({"kernel": name, "shape": case["shape"], "f32": True,
                  "bit_identical": same,
                  **in_turns(o_call, t_call, args.rounds)})
            if not other_bwd:
                continue
            # each checkout's forward writes the checkpoints its
            # backward reads (the same size in either layout)
            o_chk = torch.empty_like(case["chk"])
            o_ck = forward_call(other, name, case, o_chk.data_ptr())
            t_ck = forward_call(this, name, case, case["chk"].data_ptr())
            emit({"kernel": f"{name} with checkpoints", "shape":
                  case["shape"], "f32": True,
                  **in_turns(o_ck, t_ck, args.rounds)})
            bname = f"{name}_bwd"
            o_bwd, o_grads = backward_call(other, bname, case, o_chk)
            t_bwd, t_grads = backward_call(this, bname, case, case["chk"])
            o_bwd()
            t_bwd()
            first = [t.clone() for t in t_grads]
            t_bwd()
            torch.cuda.synchronize()
            errs = {n: ((a - b).abs().max() / b.abs().max()).item()
                    for n, a, b in zip(case["names"], t_grads, o_grads)}
            emit({"kernel": bname, "shape": case["shape"], "f32": True,
                  "grad_rel_diff": errs,
                  "within_1e-4": max(errs.values()) <= 1e-4,
                  "two_runs_bit_identical": all(
                      torch.equal(a, b) for a, b in zip(first, t_grads)),
                  "other_resources": o_usage.get(bname),
                  "this_resources": t_usage.get(bname),
                  **in_turns(o_bwd, t_bwd, args.rounds, reps=20)})
            del case, o_grads, t_grads, first, o_chk
            torch.cuda.empty_cache()
    lines.append(gpu_line())
    print(lines[-1], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
