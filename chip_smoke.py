#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the port's CUDA kernels from ``src/repro_torch/csrc`` for
   ``sm_90a`` and turns TF32 off for matmuls and convolutions;
3. holds each kernel against its plain PyTorch version on the card, at
   the split-NN path's shapes (R = 512 rows a round) and at the JAX
   package's kernel-test shapes: attention within 2e-5 (f32) / 2e-2
   (bf16), int8 quantization exactly;
4. serves the paper's vfl-recsys workload at its published scale
   (190,439 users, a 1,345-feature master silo with 19 items, a
   381-feature member silo on 60% of the users) with the benchmarked
   transformer tower ``embed + attn_block + quantize + mlp`` in both
   parties, random weights from a seed, through ``VFLJob`` and
   ``FederatedServer``: 16 caller threads send 8 queries each of 64
   matched rows (some repeated); every answer must be finite (64, 19)
   scores, each kernel must have launched twice per federated round (the
   master's bottom tower and the member's), a lone query must be
   bit-identical to offline ``predict`` of its rows, and the served
   scores must agree with the same model run on the plain versions;
5. times each kernel, its plain version and, for attention,
   ``scaled_dot_product_attention`` (a yardstick only: the port never
   calls it) with CUDA events at the path's shapes, and prints them in
   one ``kernels`` JSON line with each kernel's least possible time;
6. prints ``{"ok": true, "device": {...}}`` as its last line.

Any failure raises and the script exits non-zero; it needs the repo's
``src/repro_torch`` beside it and a CUDA device, and prints no result
without them. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the split-NN path's round: R rows through each party's bottom tower
ROUNDS_ROWS = 512
HEADS, TOKENS, DIM = 4, 8, 64
CALLERS, QUERIES, QUERY_ROWS = 16, 8, 64

# H100 SXM peaks (NVIDIA's data sheet): device memory rate, and the
# float32 rate outside the tensor cores (both kernels use no MMA)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12

TOWER = ("embed:tokens=8,dim=64", "attn_block:heads=4", "quantize",
         "mlp:hidden=64")
TOP_TOWER = ("mlp:hidden=64,final_act=0",)

ATT_CASES = [
    # b, h, kvh, s, dh, causal, window, dtype name (tests/test_kernels.py)
    (2, 4, 2, 256, 64, True, 0, "float32"),
    (1, 4, 4, 128, 32, True, 64, "float32"),
    (2, 2, 1, 128, 128, False, 0, "float32"),
    (1, 8, 2, 512, 64, True, 128, "float32"),
    (1, 2, 2, 256, 64, True, 0, "bfloat16"),
]


def log(*a) -> None:
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _event_ms(run, per: int, trials: int) -> float:
    import torch
    times = []
    for _ in range(trials):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / per)
    return statistics.median(times)


def eager_ms(fn, reps: int = 200, trials: int = 15) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    eager calls, from CUDA events: what a caller pays per call, host
    dispatch included when the host is the slower side."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _event_ms(run, reps, trials)


def graph_ms(fn, reps: int = 100, trials: int = 15) -> float:
    """Median over ``trials`` of the mean device time of ``reps`` calls
    captured in one CUDA graph and replayed, from CUDA events: the
    kernels' own time, without the host's dispatch."""
    import torch
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
    return _event_ms(graph.replay, reps, trials)


def check_kernels(torch, dev):
    """Phase 3: every kernel against its plain version on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    errs = {}
    r = ROUNDS_ROWS
    path_case = (r, HEADS, HEADS, TOKENS, DIM // HEADS, False, 0,
                 "float32")
    for case in [path_case] + ATT_CASES:
        b, h, kvh, s, dh, causal, window, dt = case
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=g).to(dtype).to(dev)
                   for shape in ((b, h, s, dh), (b, kvh, s, dh),
                                 (b, kvh, s, dh)))
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        exp = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)
        err = (out.float() - exp.float()).abs().max().item()
        log(f"attention {case}: max_abs_err {err:.3e} (tol {tol})")
        if case is path_case:
            errs["flash_attention"] = err
    for rows, d, dt in [(TOKENS * r, DIM, "float32"), (300, 64, "float32"),
                        (7, 1000, "float32"), (513, 96, "bfloat16")]:
        x = torch.randn((rows, d), generator=g)
        x[0] = 0.0                                 # an all-zero row
        x[1, :4] = torch.tensor([0.5, 1.5, 2.5, 127.0])   # exact ties
        x = x.to(getattr(torch, dt)).to(dev)
        q1, s1 = qz.quantize_int8(x)
        q2, s2 = ref.quantize_int8_ref(x)
        torch.cuda.synchronize()
        if not (torch.equal(q1, q2) and torch.equal(s1, s2)):
            raise AssertionError(
                f"quantize_int8 ({rows}, {d}) {dt}: "
                f"{int((q1 != q2).sum())} codes and "
                f"{int((s1 != s2).sum())} scales differ from the plain "
                f"version")
        log(f"quantize_int8 ({rows}, {d}) {dt}: exact")
        if rows == TOKENS * r:
            errs["quantize_int8"] = float(
                (q1.float() - q2.float()).abs().max().item())
    return errs


def make_slice():
    """The paper's demo data at its published scale, as
    examples/vfl_recsys_demo.py builds it."""
    import numpy as np
    from repro_torch.configs.vfl_recsys import VFLRecsysConfig
    from repro_torch.core.protocols.base import (MasterData, MemberData,
                                                 VFLConfig)
    from repro_torch.data.synthetic import make_recsys_silos
    data = make_recsys_silos(VFLRecsysConfig(), seed=0)
    master = MasterData(data.ids, data.labels.astype(np.float64),
                        data.features)
    members = [MemberData(ids, x) for ids, x in
               zip(data.member_ids, data.member_features)]
    cfg = VFLConfig(protocol="split_nn", seed=0, use_psi=False,
                    batch_size=512, embedding_dim=64, tower=TOWER,
                    top_tower=TOP_TOWER)
    return cfg, master, members


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve_slice(torch, dev, cfg, master, members):
    """Phase 4: the main path, driven through the entry points a user
    calls. Returns (launch counts of the concurrent run, rounds, serve
    stats, the lone query's rows and scores, the job's results)."""
    import numpy as np
    from repro_torch.core.party import VFLJob
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.serve.federated import FederatedServer, ServeCfg
    n = len(set(master.ids) & set(members[0].ids))
    items = master.y.shape[1]
    rng = np.random.default_rng(1)
    hot = rng.choice(n, 256, replace=False)

    def query_rows(r):
        rows = np.concatenate([r.choice(n, QUERY_ROWS - 16),
                               r.choice(hot, 16)])
        rows[-1] = rows[0]                 # a duplicate inside the query
        return rows

    t0 = time.perf_counter()
    job = VFLJob(cfg, master, members, mode="thread", device=dev)
    srv = FederatedServer(job, ServeCfg(max_batch=512, max_wait_ms=2.0))
    srv.start()
    log(f"job + serve session up in {time.perf_counter() - t0:.1f} s "
        f"({n} matched rows)")
    # warm-up round (cuBLAS handles, the kernel library), not counted
    srv.query(query_rows(rng))
    sync(torch, dev)
    batches0 = srv.stats.batches
    failures = []

    def caller(i):
        r = np.random.default_rng(100 + i)
        for _ in range(QUERIES):
            rows = query_rows(r)
            s = srv.query(rows, timeout=300.0)
            if s.shape != (QUERY_ROWS, items) or not np.isfinite(s).all():
                failures.append((i, s.shape))

    fa.launches.reset()
    qz.launches.reset()
    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(CALLERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = {"flash_attention": fa.launches.count,
              "quantize_int8": qz.launches.count}
    rounds = srv.stats.batches - batches0
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a caller thread did not finish in 600 s")
    if failures:
        raise AssertionError(f"bad answers: {failures[:5]}")
    log(f"served {CALLERS * QUERIES} queries of {QUERY_ROWS} rows in "
        f"{wall:.3f} s over {rounds} federated rounds; launches {counts}")
    for name, c in counts.items():
        if c != 2 * rounds:
            raise AssertionError(f"{name} launched {c} times in "
                                 f"{rounds} rounds, expected {2 * rounds}")
    lone_rows = query_rows(np.random.default_rng(7))
    lone = srv.query(lone_rows)
    stats = srv.stop()
    log("ServeStats " + json.dumps(stats))
    offline = job.predict(rows=lone_rows, batch_size=len(lone_rows))
    if not np.array_equal(lone, offline):
        raise AssertionError("served scores differ from offline predict "
                             "of the same rows")
    log("lone query bit-identical to offline predict")
    results = job.shutdown()
    return counts, rounds, stats, lone_rows, lone, results


def plain_scores(torch, dev, cfg, master, members, results, rows):
    """The lone query's rows through the same weights with every block
    on its plain version (``kernel=ref``), on the card."""
    import dataclasses
    import numpy as np
    from repro_torch.core.protocols import base
    from repro_torch.core.protocols.split_nn import bottom_spec, top_spec
    from repro_torch.models import tower as twr
    ref_cfg = dataclasses.replace(
        cfg, tower=tuple(b if b.startswith(("embed", "mlp"))
                         else b + ("," if ":" in b else ":") + "kernel=ref"
                         for b in cfg.tower))
    order = results["master"]["order"]
    xm = base._select(master.ids, order, master.x)[rows]
    xp = base._select(members[0].ids, order, members[0].x)[rows]
    with torch.no_grad():
        def bottom(x, params):
            spec = bottom_spec(ref_cfg, x.shape[1])
            return twr.apply(spec, twr.from_numpy(params, dev),
                             torch.as_tensor(x, dtype=torch.float32,
                                             device=dev))
        u = bottom(xm, results["master"]["bottom"]) \
            + bottom(xp, results["member0"]["params"])
        top = top_spec(cfg, master.y.shape[1])
        out = twr.apply(top, twr.from_numpy(results["master"]["top"], dev),
                        u)
    return out.cpu().numpy().astype(np.float64)


def time_kernels(torch, dev):
    """Phase 5: CUDA-event times at the path's shapes (inputs hot in L2,
    as the path's preceding matmuls leave them)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(3)
    r = ROUNDS_ROWS
    q, k, v = (torch.randn((r, HEADS, TOKENS, DIM // HEADS),
                           generator=g).to(dev) for _ in range(3))
    x = torch.randn((TOKENS * r, DIM), generator=g).to(dev)
    calls = {
        "flash_attention": (
            lambda: fa.flash_attention(q, k, v, causal=False),
            lambda: ref.attention_ref(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(q, k, v)),
        "quantize_int8": (lambda: qz.quantize_int8(x),
                          lambda: ref.quantize_int8_ref(x), None)}
    out = {}
    for name, (kernel, plain, library) in calls.items():
        # device times from graph replay; the eager time per call is
        # kept beside them, since the host dispatch bounds it
        out[name] = {
            "ms": graph_ms(kernel), "plain_ms": graph_ms(plain),
            "library_ms": graph_ms(library) if library else None,
            "eager_ms": eager_ms(kernel),
            "plain_eager_ms": eager_ms(plain)}
    att, quant = out["flash_attention"], out["quantize_int8"]
    # least time: bytes each input read once and each output written
    # once over the memory rate, or operations over the f32 rate
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    att_bytes = 2 * nbytes(q) + nbytes(k, v)
    b, h, s, dh = q.shape
    att_flops = 4.0 * b * h * s * s * dh          # q.k and p.v
    qo, so = qz.quantize_int8(x)
    quant_bytes = nbytes(x, qo, so)
    quant_ops = 5.0 * x.numel()     # abs, max, divide, round, clamp
    for d, by, work in ((att, att_bytes, att_flops),
                        (quant, quant_bytes, quant_ops)):
        t_bytes = by / HBM_BYTES_S * 1e3
        t_ops = work / F32_FLOP_S * 1e3
        d["bound_ms"] = max(t_bytes, t_ops)
        d["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return att, quant


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run this "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    t_start = time.perf_counter()
    log(gpu_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"built {lib.relative_to(ROOT)} from "
        f"{[s.name for s in _build.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s")

    errs = check_kernels(torch, dev)

    import numpy as np
    t0 = time.perf_counter()
    cfg, master, members = make_slice()
    log(f"vfl-recsys data built in {time.perf_counter() - t0:.1f} s: "
        f"master x {master.x.shape}, y {master.y.shape}, member x "
        f"{members[0].x.shape}")
    counts, rounds, stats, rows, lone, results = serve_slice(
        torch, dev, cfg, master, members)
    plain = plain_scores(torch, dev, cfg, master, members, results, rows)
    # a quantize code may flip by one step where the attention kernel's
    # output differs from the plain version's by an ulp; one step moves
    # a score by about 1e-3, hence the tolerance
    e2e_err = float(np.abs(lone - plain).max())
    log(f"served vs plain-version scores: max_abs_err {e2e_err:.3e} "
        f"(tol 5e-3)")
    if not e2e_err <= 5e-3:
        raise AssertionError("served scores disagree with the plain "
                             "versions")

    att, quant = time_kernels(torch, dev)
    kernels = []
    for name, src, replaces, t in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:69", att),
            ("quantize_int8", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize.py:29", quant)):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": errs[name], **t})
    log(f"rounds {rounds}; launches per round "
        f"{ {k: v / rounds for k, v in counts.items()} }; "
        f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
