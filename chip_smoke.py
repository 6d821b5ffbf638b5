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
7. prints all kernels in one ``kernels`` JSON line with each kernel's
   least possible time, then ``{"ok": true, "device": {...}}`` as its
   last line.

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


def serve_zoo(torch, dev):
    """Phase 6b: rwkv6-7b served at full width and depth through
    ``ServeEngine``. Returns (WKV launches in the counted ``score``,
    measured numbers)."""
    import numpy as np
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.models import params as PRM, transformer as T
    from repro_torch.serve.engine import ServeEngine
    cfg = zoo_config()
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = PRM.init_tree(T.model_spec(cfg),
                               torch.Generator(dev).manual_seed(0),
                               torch.float32, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    # the spec's count is above the config's analytic one, which leaves
    # out the norms and mixes and counts the gate as a LoRA, where the
    # spec (the JAX package's) has a full projection
    log(f"{ZOO_ARCH}: {n_params:,} params ({cfg.param_count():,} by the "
        f"config's count) in f32, {n_params * 4 / 1e9:.2f} GB, drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    engine = ServeEngine(cfg, params, max_seq=GEN_PROMPT + GEN_NEW + 1,
                         dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (SCORE_BATCH, SCORE_TOKENS))
    torch.cuda.reset_peak_memory_stats()
    engine.score(toks)                 # warm-up: cuBLAS, the library
    torch.cuda.synchronize()
    wkv.launches.reset()
    t0 = time.perf_counter()
    loss = engine.score(toks)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = wkv.launches.count
    if launches != cfg.n_layers:
        raise AssertionError(f"score launched the WKV kernel {launches} "
                             f"times, expected {cfg.n_layers}")
    if not np.isfinite(loss):
        raise AssertionError(f"score gave a non-finite loss {loss}")
    prefill_tok = SCORE_BATCH * (SCORE_TOKENS - 1)
    log(f"score of ({SCORE_BATCH}, {SCORE_TOKENS}) tokens: loss "
        f"{loss:.6f} (ln vocab {np.log(cfg.vocab):.6f}) in "
        f"{score_s * 1e3:.1f} ms, {launches} WKV launches")
    log(f"prefill tokens/s: {prefill_tok / score_s:.1f}")
    prof_prefill = profile_window(torch, lambda: engine.score(toks), score_s)
    log("zoo profile prefill " + json.dumps(prof_prefill))

    # decode (no WKV kernel) against prefill (the kernel) on one sequence
    seq = torch.as_tensor(rng.integers(0, cfg.vocab, (1, CONSIST_TOKENS)),
                          device=dev)
    with torch.inference_mode():
        ref_logits, _ = T.forward(cfg, params, {"tokens": seq},
                                  torch.float32)
        cache = engine.init_cache(1)
        consist_err = 0.0
        for i in range(CONSIST_TOKENS):
            logits, cache = T.decode_step(cfg, params, seq[:, i:i + 1],
                                          cache, i, None, torch.float32)
            torch.testing.assert_close(logits[:, 0], ref_logits[:, i],
                                       rtol=2e-3, atol=2e-3)
            consist_err = max(consist_err, (logits[:, 0] - ref_logits[:, i]
                                            ).abs().max().item())
        del cache, ref_logits
    log(f"decode vs prefill logits over {CONSIST_TOKENS} tokens: "
        f"max_abs_err {consist_err:.3e} (tol 2e-3)")

    prompts = rng.integers(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT))
    engine.generate(prompts[:, :2], 2)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, GEN_NEW)
    gen_s = time.perf_counter() - t0
    if out.shape != (GEN_BATCH, GEN_PROMPT + GEN_NEW) \
            or not ((out >= 0) & (out < cfg.vocab)).all() \
            or not np.array_equal(out[:, :GEN_PROMPT], prompts):
        raise AssertionError(f"generate gave {out.shape} {out[:, -4:]}")
    # every decode step advances the whole batch by one token: the
    # prompt's teacher-forced steps and the new tokens' (the last new
    # token needs no step of its own)
    decode_tok = GEN_BATCH * (GEN_PROMPT + GEN_NEW - 1)
    log(f"generate {GEN_NEW} tokens from {GEN_BATCH} prompts of "
        f"{GEN_PROMPT}: {gen_s * 1e3:.1f} ms; first new tokens "
        f"{out[:, GEN_PROMPT:GEN_PROMPT + 4].tolist()}")
    log(f"decode tokens/s: {decode_tok / gen_s:.1f}")
    prof_decode = profile_window(
        torch, lambda: engine.generate(prompts, GEN_NEW), gen_s)
    log("zoo profile decode " + json.dumps(prof_decode))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"peak device memory {peak:.2f} GiB")
    del engine, params
    torch.cuda.empty_cache()
    return launches, {"loss": loss, "score_s": score_s,
                      "prefill_tok_s": prefill_tok / score_s,
                      "consist_err": consist_err, "generate_s": gen_s,
                      "decode_tok_s": decode_tok / gen_s,
                      "prefill_busy_share":
                          prof_prefill["device_busy_share"],
                      "decode_busy_share": prof_decode["device_busy_share"],
                      "peak_gib": peak}


def _device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def profile_window(torch, fn, wall_s: float) -> dict:
    """Runs ``fn`` once under ``torch.profiler`` and sums its kernels'
    device time, by kind (the WKV kernel, matmuls, the rest) and for the
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
    kinds = {"wkv": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        kind = ("wkv" if "rwkv6_wkv" in name else
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
    kernel = lambda: wkv.rwkv6_wkv(*ins)           # noqa: E731
    plain = lambda: ref.rwkv6_ref(*ins)            # noqa: E731
    out = {"ms": graph_ms(kernel), "eager_ms": eager_ms(kernel),
           # the plain version is a loop of ~3,000 small kernels a call
           "plain_ms": graph_ms(plain, reps=2, trials=5),
           "plain_eager_ms": eager_ms(plain, reps=2, trials=5),
           # no PyTorch call computes the WKV recurrence
           "library_ms": None}
    # least time: r, k, v, w read once, y and S_final written once; and
    # the least f32 work of a step of one (batch, head) pair, 5 * dh^2
    # flops (read-out r.S: dh^2 FMAs; update w*S + k v^T: a multiply
    # and an FMA per element; the bonus term is O(dh))
    nbytes = 4 * ins[0].numel() * 4 + ins[4].numel() * 4 \
        + b * h * s * dh * 4 + b * h * dh * dh * 4
    flops = 5.0 * b * h * s * dh * dh
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOP_S * 1e3
    out["bound_ms"] = max(t_bytes, t_ops)
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"rwkv6_wkv at {(b, h, s, dh)} f32: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP; bound {out['bound_ms'] * 1e3:.1f} us "
        f"({out['bound_by']})")
    return out


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

    errs["rwkv6_wkv"] = check_wkv(torch, dev)
    counts["rwkv6_wkv"], zoo = serve_zoo(torch, dev)
    wkv_t = time_wkv(torch, dev)
    log("zoo " + json.dumps(zoo))
    kernels = []
    for name, src, replaces, t in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:69", att),
            ("quantize_int8", "src/repro_torch/csrc/quantize.cu",
             "src/repro/kernels/quantize.py:29", quant),
            ("rwkv6_wkv", "src/repro_torch/csrc/rwkv6_wkv.cu",
             "src/repro/kernels/rwkv6_wkv.py:48", wkv_t)):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": errs[name], **t})
    per_round = {k: counts[k] / rounds
                 for k in ("flash_attention", "quantize_int8")}
    log(f"rounds {rounds}; launches per round {per_round}; WKV launches "
        f"per score {counts['rwkv6_wkv']}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
