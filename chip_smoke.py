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
   calls it) with CUDA events at the path's shapes;
6. serves ``rwkv6-7b`` from the model zoo at full width and depth (32
   layers, d_model 4096, 8.9 B params, 35.5 GB in f32, random weights
   drawn on the card from a seed) through ``ServeEngine``: the WKV
   kernel first against its plain version at the prefill shape
   (4, 64, 511, 64) and at the JAX package's kernel-test shapes, within
   5e-5 (f32) / 5e-2 (bf16); then ``score`` of a (4, 512) token batch, which must launch
   the WKV kernel once per layer (32 times) and give a finite loss;
   teacher-forced ``decode_step`` logits of one 64-token sequence (a path
   with no WKV kernel) against ``forward`` logits within 2e-3; greedy
   ``generate`` of 16 tokens from 4 prompts of 16; it prints the prefill
   and decode tokens/s, runs the timed ``score`` and ``generate`` once
   more under ``torch.profiler`` to print where their device time goes
   (the WKV kernel, matmuls, the rest; the top kernels) and the device's
   busy share, and times the WKV kernel as in step 5;
7. serves ``granite-moe-3b-a800m`` from the model zoo at full width and
   depth (32 layers, d_model 1536, 24 query and 8 KV heads of 64, 40
   experts top-8 of width 512, vocab 49155; 3.37 B params, 13.5 GB in
   f32, drawn on the card from a seed) after the rwkv6-7b weights are
   freed: the grouped-expert-matmul kernel first against its plain
   version at the path's four shapes (gate/up and down at the
   prefill's capacity 512 and at decode's capacity 4) and at the JAX package's
   kernel-test shapes, within 2e-4 (f32) / 5e-2 (bf16), and the
   flash-attention kernel at the prefill shape (causal, GQA 3:1) within
   2e-5; then ``score`` of a (4, 512) batch, which must give a finite
   loss with exactly 96 grouped-matmul launches (3 a layer) and 32
   flash-attention launches; the same ``score`` with group-local
   dispatch (``moe_group_dispatch``), again 96 launches; decode-vs-
   prefill logits over 64 tokens within 2e-3 at the capacity where no
   assignment drops (``capacity_factor`` = 40 / 8); greedy ``generate``
   of 16 tokens from 4 prompts of 16; prefill and decode tokens/s and
   the same profiles as step 6 (device time of the grouped matmul, the
   attention kernel, matmuls and the rest); and it times both kernels
   at the path's shapes as in step 5, beside ``torch.bmm`` and SDPA;
8. prints all kernels in one ``kernels`` JSON line with each kernel's
   least possible time and its launches on each path, then
   ``{"ok": true, "device": {...}}`` as its last line.

Any failure raises and the script exits non-zero; it needs the repo's
``src/repro_torch`` beside it and a CUDA device, and prints no result
without them. It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
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

# the model-zoo phase: rwkv6-7b at full width and depth, f32
ZOO_ARCH = "rwkv6-7b"
SCORE_BATCH, SCORE_TOKENS = 4, 512        # score() prefills 511 of them
CONSIST_TOKENS = 64
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 16, 16
# substrings of the cuBLAS / CUTLASS kernel names the profile counts as
# matmuls
MATMUL_MARKS = ("gemm", "gemv", "cutlass", "xmma")
WKV_CASES = [
    # b, h, s, dh, dtype name (tests/test_kernels.py)
    (1, 2, 64, 32, "float32"),
    (2, 4, 128, 64, "float32"),
    (1, 2, 128, 32, "bfloat16"),
]

# the MoE phase: granite-moe-3b-a800m at full width and depth, f32
MOE_ARCH = "granite-moe-3b-a800m"
GMM_CASES = [
    # e, c, d, f, dtype name (tests/test_kernels.py), then capacities,
    # depths and widths no tile divides
    (4, 128, 64, 96, "float32"),
    (8, 256, 128, 128, "float32"),
    (2, 128, 128, 64, "bfloat16"),
    (3, 37, 50, 33, "float32"),
    (3, 37, 50, 33, "bfloat16"),
    (2, 65, 24, 72, "bfloat16"),
]

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


def _bound(nbytes: float, ops: float) -> dict:
    """The least time of a call: ``nbytes`` over the memory rate or
    ``ops`` over the f32 rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / F32_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    """Phase 5: the split-NN kernels timed at the path's shapes (inputs
    hot in L2, as the path's preceding matmuls leave them)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(3)
    r = ROUNDS_ROWS
    q, k, v = (torch.randn((r, HEADS, TOKENS, DIM // HEADS),
                           generator=g).to(dev) for _ in range(3))
    x = torch.randn((TOKENS * r, DIM), generator=g).to(dev)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    b, h, s, dh = q.shape
    att = time_call(lambda: fa.flash_attention(q, k, v, causal=False),
                    lambda: ref.attention_ref(q, k, v, causal=False),
                    lambda: F.scaled_dot_product_attention(q, k, v),
                    2 * nbytes(q) + nbytes(k, v),
                    4.0 * b * h * s * s * dh)          # q.k and p.v
    qo, so = qz.quantize_int8(x)
    quant = time_call(lambda: qz.quantize_int8(x),
                      lambda: ref.quantize_int8_ref(x), None,
                      nbytes(x, qo, so),
                      5.0 * x.numel())  # abs, max, divide, round, clamp
    return att, quant


def time_call(kernel, plain, library, nbytes: float, ops: float,
              timing: dict | None = None,
              plain_timing: dict | None = None) -> dict:
    """CUDA-event times of a kernel's wrapper, its plain version and the
    one PyTorch call that computes the same function (``library``, None
    where there is none), all on the same inputs, and the least time of
    ``nbytes`` and ``ops`` (``_bound``: each input read once and each
    output written once, the operations at the f32 rate). Device times
    come from graph replay; the eager times per call stand beside them,
    since the host's dispatch bounds those. ``timing`` and
    ``plain_timing`` are ``graph_ms`` / ``eager_ms`` keywords."""
    timing = timing or {}
    plain_timing = plain_timing or timing
    out = {"ms": graph_ms(kernel, **timing),
           "eager_ms": eager_ms(kernel, **timing),
           "plain_ms": graph_ms(plain, **plain_timing),
           "plain_eager_ms": eager_ms(plain, **plain_timing),
           "library_ms": graph_ms(library, **timing) if library else None}
    out.update(_bound(nbytes, ops))
    return out


def wkv_inputs(torch, dev, b, h, s, dh, dtype, g):
    """r, k, v, w (b, h, s, dh) of ``dtype`` and u (h, dh) f32 on the
    card, drawn as the JAX kernel test draws them."""
    r, k, v = (torch.randn((b, h, s, dh), generator=g) for _ in range(3))
    w = torch.sigmoid(torch.randn((b, h, s, dh), generator=g)) * 0.5 + 0.45
    u = torch.randn((h, dh), generator=g) * 0.3
    return ([t.to(dtype).to(dev) for t in (r, k, v, w)]
            + [u.to(dev)])


def check_wkv(torch, dev):
    """Phase 6a: the WKV kernel against its plain version on the card,
    at the prefill path's shape and the JAX kernel test's shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    cfg = zoo_config()
    h, dh = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    path_case = (SCORE_BATCH, h, SCORE_TOKENS - 1, dh, "float32")
    g = torch.Generator().manual_seed(5)
    err = None
    for case in [path_case, (SCORE_BATCH, h, SCORE_TOKENS, dh,
                             "float32")] + WKV_CASES:
        b, hh, s, d, dt = case
        ins = wkv_inputs(torch, dev, b, hh, s, d, getattr(torch, dt), g)
        y, sf = wkv.rwkv6_wkv(*ins)
        ey, es = ref.rwkv6_ref(*ins)
        torch.cuda.synchronize()
        tol = 5e-2 if dt == "bfloat16" else 5e-5
        torch.testing.assert_close(y, ey, atol=tol, rtol=tol)
        torch.testing.assert_close(sf, es, atol=tol, rtol=tol)
        e = max((y - ey).abs().max().item(), (sf - es).abs().max().item())
        log(f"rwkv6_wkv {case}: max_abs_err {e:.3e} (tol {tol})")
        if case is path_case:
            err = e
    return err


def zoo_config():
    from repro_torch.configs import get_config
    cfg = get_config(ZOO_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == \
        (32, 4096, 14336, 65536), "the full rwkv6-7b config"
    return cfg


def draw_params(torch, dev, cfg):
    """The model's f32 params, drawn on the card from seed 0; logs their
    count and size."""
    from repro_torch.models import params as PRM, transformer as T
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = PRM.init_tree(T.model_spec(cfg),
                               torch.Generator(dev).manual_seed(0),
                               torch.float32, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    # the spec's count is above the config's analytic one, which leaves
    # out the norms (and for rwkv6-7b the mixes, and counts its gate as a
    # LoRA where the spec, the JAX package's, has a full projection)
    log(f"{cfg.arch_id}: {n_params:,} params ({cfg.param_count():,} by "
        f"the config's count) in f32, {n_params * 4 / 1e9:.2f} GB, drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    return params


def decode_vs_prefill(torch, dev, cfg, params, seq) -> float:
    """Teacher-forced ``decode_step`` logits of the tokens ``seq`` (1, s)
    against ``forward``'s, each within 2e-3; returns the largest
    difference."""
    from repro_torch.models import transformer as T
    err = 0.0
    with torch.inference_mode():
        ref_logits, _ = T.forward(cfg, params, {"tokens": seq},
                                  torch.float32)
        cache = T.init_cache(cfg, 1, seq.shape[1], torch.float32, dev)
        for i in range(seq.shape[1]):
            logits, cache = T.decode_step(cfg, params, seq[:, i:i + 1],
                                          cache, i, None, torch.float32)
            torch.testing.assert_close(logits[:, 0], ref_logits[:, i],
                                       rtol=2e-3, atol=2e-3)
            err = max(err, (logits[:, 0] - ref_logits[:, i]
                            ).abs().max().item())
    return err


def check_generated(out, prompts, vocab: int) -> None:
    """``generate``'s output: the prompts, then GEN_NEW in-vocab tokens."""
    import numpy as np
    if out.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW) \
            or not ((out >= 0) & (out < vocab)).all() \
            or not np.array_equal(out[:, :GEN_PROMPT], prompts):
        raise AssertionError(f"generate gave {out.shape} {out[:, -4:]}")


def serve_model(torch, dev, cfg, tag: str, kernels: dict,
                variants: dict | None = None):
    """Phases 6b and 7b: ``cfg`` served at full width and depth through
    ``ServeEngine``, on f32 weights drawn on the card: ``score`` of a
    (4, 512) batch, which must give a finite loss (router losses
    included where the model has them); the same ``score`` through an
    engine of each config in ``variants`` (name -> config) on the same
    weights; decode-vs-prefill logits; greedy ``generate``; prefill and
    decode tokens/s and their profiles. ``kernels`` maps each kernel of
    the path to (its launch counter, its launches in a ``score``, its
    launches in a decode step): each counted run sets every count to 0
    just before it and must read exactly those just after. Returns (the
    launches of each counted run, by ``{tag}_{run}``, the measured
    numbers)."""
    import numpy as np
    from repro_torch.serve.engine import ServeEngine
    params = draw_params(torch, dev, cfg)
    steps = GEN_PROMPT + GEN_NEW - 1
    per_score = {name: n for name, (_, n, _) in kernels.items()}
    per_generate = {name: n * steps for name, (_, _, n) in kernels.items()}
    launches = {}

    def counted(run, fn, expected):
        for counter, _, _ in kernels.values():
            counter.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: c.count for name, (c, _, _) in kernels.items()}
        launches[f"{tag}_{run}"] = got
        if got != expected:
            raise AssertionError(f"{cfg.arch_id} {run} launched {got}, "
                                 f"expected {expected}")
        return out, wall

    def engine(c):
        return ServeEngine(c, params, max_seq=GEN_PROMPT + GEN_NEW + 1,
                           dtype=torch.float32, device=dev)

    eng = engine(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (SCORE_BATCH, SCORE_TOKENS))
    torch.cuda.reset_peak_memory_stats()
    eng.score(toks)                    # warm-up: cuBLAS, the library
    torch.cuda.synchronize()
    loss, score_s = counted("score", lambda: eng.score(toks), per_score)
    if not np.isfinite(loss):
        raise AssertionError(f"score gave a non-finite loss {loss}")
    prefill_tok = SCORE_BATCH * (SCORE_TOKENS - 1)
    log(f"{cfg.arch_id} score of ({SCORE_BATCH}, {SCORE_TOKENS}) tokens: "
        f"loss {loss:.6f} (ln vocab {np.log(cfg.vocab):.6f}) in "
        f"{score_s * 1e3:.1f} ms; launches {launches[f'{tag}_score']}")
    log(f"{cfg.arch_id} prefill tokens/s: {prefill_tok / score_s:.1f}")
    prof_prefill = profile_window(torch, lambda: eng.score(toks), score_s)
    log(f"{tag} profile prefill " + json.dumps(prof_prefill))
    measured = {"loss": loss, "score_s": score_s,
                "prefill_tok_s": prefill_tok / score_s}

    for name, vcfg in (variants or {}).items():
        v = engine(vcfg)
        v_loss, v_s = counted(f"{name}_score", lambda: v.score(toks),
                              per_score)
        if not np.isfinite(v_loss):
            raise AssertionError(f"{name} score gave a non-finite loss "
                                 f"{v_loss}")
        log(f"{cfg.arch_id} {name} score: loss {v_loss:.6f} in "
            f"{v_s * 1e3:.1f} ms (one call, not warmed up); launches "
            f"{launches[f'{tag}_{name}_score']}")
        measured.update({f"{name}_loss": v_loss, f"{name}_score_s": v_s})
        del v

    # decode against prefill where no assignment drops: capacity_factor
    # E / top_k gives every expert room for every token, at any count
    nd = cfg
    if cfg.moe is not None:
        m = cfg.moe
        nd = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    seq = torch.as_tensor(rng.integers(0, cfg.vocab, (1, CONSIST_TOKENS)),
                          device=dev)
    consist_err = decode_vs_prefill(torch, dev, nd, params, seq)
    at = "" if nd.moe is None else \
        f" at capacity_factor {nd.moe.capacity_factor}"
    log(f"{cfg.arch_id} decode vs prefill logits over {CONSIST_TOKENS} "
        f"tokens{at}: max_abs_err {consist_err:.3e} (tol 2e-3)")

    prompts = rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))
    eng.generate(prompts[:, :2], 2)             # warm-up
    torch.cuda.synchronize()
    out, gen_s = counted("generate",
                         lambda: eng.generate(prompts, GEN_NEW), per_generate)
    check_generated(out, prompts, cfg.vocab)
    # every decode step advances the whole batch by one token: the
    # prompt's teacher-forced steps and the new tokens' (the last new
    # token needs no step of its own)
    decode_tok = GEN_BATCH * steps
    log(f"{cfg.arch_id} generate {GEN_NEW} tokens from {GEN_BATCH} prompts "
        f"of {GEN_PROMPT}: {gen_s * 1e3:.1f} ms; launches "
        f"{launches[f'{tag}_generate']}; first new tokens "
        f"{out[:, GEN_PROMPT:GEN_PROMPT + 4].tolist()}")
    log(f"{cfg.arch_id} decode tokens/s: {decode_tok / gen_s:.1f}")
    prof_decode = profile_window(
        torch, lambda: eng.generate(prompts, GEN_NEW), gen_s)
    log(f"{tag} profile decode " + json.dumps(prof_decode))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{cfg.arch_id} peak device memory {peak:.2f} GiB")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    measured.update({"consist_err": consist_err, "generate_s": gen_s,
                     "decode_tok_s": decode_tok / gen_s,
                     "prefill_busy_share": prof_prefill["device_busy_share"],
                     "decode_busy_share": prof_decode["device_busy_share"],
                     "peak_gib": peak})
    log(f"{tag} " + json.dumps(measured))
    return launches, measured


def _device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def profile_window(torch, fn, wall_s: float) -> dict:
    """Runs ``fn`` once under ``torch.profiler`` and sums its kernels'
    device time, by kind (the port's WKV, grouped-matmul and attention
    kernels, library matmuls, the rest) and for the
    six longest kernels. The busy share is that device time over
    ``wall_s``, the wall time of the same call timed without the
    profiler: the profiler slows the host's dispatch, not the kernels,
    and the kernels run one at a time on one stream."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type is not None
               and "cuda" in str(e.device_type).lower()
               and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    kinds = {"wkv": 0.0, "gmm": 0.0, "attention": 0.0, "matmul": 0.0,
             "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        kind = ("wkv" if "rwkv6_wkv" in name else
                "gmm" if "moe_gmm" in name else
                "attention" if "flash_attention" in name else
                "matmul" if any(m in name for m in MATMUL_MARKS) else
                "other")
        kinds[kind] += _device_us(e) / 1e3
    ranked = sorted(kernels, key=_device_us, reverse=True)[:6]
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / wall_s,
            "kernel_launches": sum(e.count for e in kernels),
            "device_ms_by_kind": kinds,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": _device_us(e) / 1e3}
                            for e in ranked]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def time_wkv(torch, dev):
    """Phase 6c: the WKV kernel at the prefill path's shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_wkv as wkv
    cfg = zoo_config()
    b, h, s, dh = (SCORE_BATCH, cfg.d_model // cfg.rwkv.head_dim,
                   SCORE_TOKENS - 1, cfg.rwkv.head_dim)
    g = torch.Generator().manual_seed(6)
    ins = wkv_inputs(torch, dev, b, h, s, dh, torch.float32, g)
    # least time: r, k, v, w read once, y and S_final written once; and
    # the least f32 work of a step of one (batch, head) pair, 5 * dh^2
    # flops (read-out r.S: dh^2 FMAs; update w*S + k v^T: a multiply
    # and an FMA per element; the bonus term is O(dh))
    nbytes = 4 * ins[0].numel() * 4 + ins[4].numel() * 4 \
        + b * h * s * dh * 4 + b * h * dh * dh * 4
    flops = 5.0 * b * h * s * dh * dh
    out = time_call(lambda: wkv.rwkv6_wkv(*ins), lambda: ref.rwkv6_ref(*ins),
                    None,        # no PyTorch call computes the recurrence
                    nbytes, flops,
                    # the plain version is a loop of ~3,000 small kernels
                    plain_timing=dict(reps=2, trials=5))
    log(f"rwkv6_wkv at {(b, h, s, dh)} f32: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP; bound {out['bound_ms'] * 1e3:.1f} us "
        f"({out['bound_by']})")
    return out


def moe_config():
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    m = cfg.moe
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, m.num_experts, m.top_k, m.d_expert, cfg.vocab) == \
        (32, 1536, 24, 8, 64, 40, 8, 512, 49155), \
        "the full granite-moe-3b-a800m config"
    assert cfg.block_pattern == (("attn", "moe"),)
    return cfg


def gmm_path_shapes(cfg):
    """(name, (e, c, d, f)) of the grouped-matmul calls on the MoE path:
    gate/up (two launches a layer) and down (one) at the capacity of a
    (4, 511)-token ``score`` and at that of a batch-4 decode step."""
    from repro_torch.models import moe
    pre = moe._capacity(SCORE_BATCH * (SCORE_TOKENS - 1), cfg)
    dec = moe._capacity(GEN_BATCH, cfg)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    return [("prefill_gate_up", (e, pre, d, f)),
            ("prefill_down", (e, pre, f, d)),
            ("decode_gate_up", (e, dec, d, f)),
            ("decode_down", (e, dec, f, d))]


def moe_attention_shapes(cfg):
    """q and k/v shapes of the MoE model's prefill self-attention."""
    s = SCORE_TOKENS - 1
    return ((SCORE_BATCH, cfg.n_heads, s, cfg.head_dim),
            (SCORE_BATCH, cfg.n_kv_heads, s, cfg.head_dim))


def check_moe_kernels(torch, dev, cfg):
    """Phase 7a: the grouped-matmul kernel against its plain version at
    the MoE path's shapes and the JAX kernel test's, and the attention
    kernel at the MoE prefill's shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(8)
    errs = {}
    cases = [(name, shape + ("float32",))
             for name, shape in gmm_path_shapes(cfg)]
    for name, case in cases + [(None, c) for c in GMM_CASES]:
        e, c, d, f, dt = case
        dtype = getattr(torch, dt)
        x = torch.randn((e, c, d), generator=g)
        w = torch.randn((e, d, f), generator=g)
        if name:
            # the path's magnitudes: rmsnorm-ed activations, weights of
            # std 1/sqrt(d) at most (the spec's std is smaller still)
            w = w * d ** -0.5
        x, w = x.to(dtype).to(dev), w.to(dtype).to(dev)
        out = gmm.moe_gmm(x, w)
        exp = ref.gmm_ref(x, w)
        torch.cuda.synchronize()
        tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)
        err = (out.float() - exp.float()).abs().max().item()
        log(f"moe_gmm {case}: max_abs_err {err:.3e} (atol = rtol = {tol})")
        if name:
            errs[name] = err
    qs, ks = moe_attention_shapes(cfg)
    q = torch.randn(qs, generator=g).to(dev)
    k, v = (torch.randn(ks, generator=g).to(dev) for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=True)
    exp = ref.attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)
    errs["attention"] = (out - exp).abs().max().item()
    log(f"attention q {qs} k/v {ks} causal f32: max_abs_err "
        f"{errs['attention']:.3e} (tol 2e-5)")
    return errs


def time_moe_kernels(torch, dev, cfg):
    """Phase 7c: the grouped matmul at the MoE path's four shapes and
    the attention kernel at its prefill shape, beside ``torch.bmm`` and
    SDPA (yardsticks only: the port calls neither)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(9)
    few = dict(reps=20, trials=10)
    gmm_t = {}
    for name, (e, c, d, f) in gmm_path_shapes(cfg):
        x = torch.randn((e, c, d), generator=g).to(dev)
        w = (torch.randn((e, d, f), generator=g) * d ** -0.5).to(dev)
        # x and w read once, the output written once; 2 e c d f flops
        t = time_call(lambda: gmm.moe_gmm(x, w), lambda: ref.gmm_ref(x, w),
                      lambda: torch.bmm(x, w),
                      (x.numel() + w.numel() + e * c * f) * 4,
                      2.0 * e * c * d * f, few)
        log(f"moe_gmm {name} {(e, c, d, f)} f32: {t}")
        gmm_t[name] = t
    qs, ks = moe_attention_shapes(cfg)
    q = torch.randn(qs, generator=g).to(dev)
    k, v = (torch.randn(ks, generator=g).to(dev) for _ in range(2))
    # q, k, v read once, o written once; q.k and p.v over the causal
    # pairs only, s (s + 1) / 2 a (batch, head)
    b, h, s, dh = qs
    att = time_call(lambda: fa.flash_attention(q, k, v, causal=True),
                    lambda: ref.attention_ref(q, k, v, causal=True),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True),
                    (2 * q.numel() + k.numel() + v.numel()) * 4,
                    4.0 * b * h * dh * s * (s + 1) / 2, few)
    log(f"flash_attention {MOE_ARCH} prefill q {qs} k/v {ks} causal f32: "
        f"{att}")
    return gmm_t, att


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

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import rwkv6_wkv as wkv
    errs["rwkv6_wkv"] = check_wkv(torch, dev)
    zoo_cfg = zoo_config()
    # one WKV launch a layer in prefill; decode's one-step update has none
    zoo_launches, _ = serve_model(
        torch, dev, zoo_cfg, "rwkv6",
        {"rwkv6_wkv": (wkv.launches, zoo_cfg.n_layers, 0)})
    wkv_t = time_wkv(torch, dev)

    # the rwkv6-7b weights are freed by now
    moe_cfg = moe_config()
    moe_errs = check_moe_kernels(torch, dev, moe_cfg)
    n = moe_cfg.n_layers      # every layer is (attn, moe): gate, up, down
    moe_launches, _ = serve_model(
        torch, dev, moe_cfg, "granite",
        {"moe_gmm": (gmm.launches, 3 * n, 3 * n),
         "flash_attention": (fa.launches, n, 0)},
        {"grouped": dataclasses.replace(moe_cfg, moe_group_dispatch=True)})
    gmm_t, moe_att = time_moe_kernels(torch, dev, moe_cfg)

    # launches of each kernel on each path's counted run
    by_path = {
        "flash_attention": {"split_nn_serve": counts["flash_attention"]},
        "quantize_int8": {"split_nn_serve": counts["quantize_int8"]},
        "rwkv6_wkv": {}, "moe_gmm": {}}
    for run, got in (zoo_launches | moe_launches).items():
        for name, c in got.items():
            by_path[name][run] = c
    errs["moe_gmm"] = max(moe_errs[name] for name, _ in
                          gmm_path_shapes(moe_cfg))
    extra = {
        # the attention kernel's times at the MoE prefill's shape
        "flash_attention": {"granite_prefill": dict(
            moe_att, max_abs_err=moe_errs["attention"])},
        # the grouped matmul's at each of its four shapes; the top-level
        # times are those of the prefill's gate/up
        "moe_gmm": {"shapes": gmm_t}}
    kernels = []
    for name, src, replaces, t in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:69", att),
            ("quantize_int8", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize.py:29", quant),
            ("rwkv6_wkv", "src/repro_torch/csrc/rwkv6_wkv.cu",
             "src/repro/kernels/rwkv6_wkv.py:48", wkv_t),
            ("moe_gmm", "src/repro_torch/csrc/moe_gmm.cu",
             "src/repro/kernels/moe_gmm.py:39", gmm_t["prefill_gate_up"])):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(by_path[name].values()),
                        "launches_by_path": by_path[name],
                        "max_abs_err": errs[name], **t,
                        **extra.get(name, {})})
    per_round = {k: counts[k] / rounds
                 for k in ("flash_attention", "quantize_int8")}
    log(f"rounds {rounds}; launches per round {per_round}; zoo launches "
        f"{zoo_launches | moe_launches}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
