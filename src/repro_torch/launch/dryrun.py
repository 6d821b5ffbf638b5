"""The dry-run of a sharded step on the production mesh, the counterpart
of the JAX package's ``repro/launch/dryrun.py``: per-position memory,
the collective inventory, the hand kernels' calls and an H100 roofline
of every (arch x shape x mesh), with nothing compiled and nothing
allocated.

The JAX package lowers and compiles the step for 512 placeholder host
devices. The port has no compiler: it runs its own eager step once
under ``FakeTensorMode`` on a mesh of fake devices (``meta:0 ..
meta:255``, then ``lazy``: ``hlo_analysis.fake_devices``;
``launch/mesh.py`` ``make_production_mesh``), with
``launch/hlo_analysis.py``'s ``StepTracker`` recording what it holds,
moves and calls, and the kernels taking their trace routes
(``kernels/ops.py``). An op that mixed two positions without a
collective would raise there. No process-wide setting is changed.

An eager trace costs ~100 us an op, and its ops grow with the positions
and the layers, so the step is traced at one and at two layer periods
(a period: the block pattern, above the prefix layers; whisper's
encoder cut with its decoder) and extrapolated affinely to full depth:
each position's rise above its start, the bytes it receives by
collective and sender, and the kernel calls. The bytes resident at the
start (placed params, optimizer slots, the batch; a decode step's
params, cache and token) are not extrapolated: they are those of the
full-depth tensors, placed by their specs on the fake mesh.
``--full-depth`` traces the whole model instead.

The levers (``--opt``) are the JAX package's, with the same effect on
the config and the rules, except ``bf16reduce``: it is recorded in
``opts`` and does nothing here, as a product of bf16 tensors is bf16
already and the collectives move the dtype they are given
(``sharding/rules.py``).

The roofline's rates are the card's datasheet figures (below), so every
roofline number here is an estimate from them; ``collective_s`` is the
busiest position's received bytes, those from a position of its own
8-card node at NVLink's rate and the rest at the network's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 10x4 sweep
Records go to ``build/repro_torch/dryrun/<arch>__<shape>__<mesh>.json``;
``python -m repro_torch.launch.roofline`` tabulates them.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import flops as F
from repro_torch.launch import specs as S
from repro_torch.launch import steps as ST
from repro_torch.launch.hlo_analysis import (CollectiveRecord, HloReport,
                                             StepTracker, fake_devices,
                                             summarize)
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.models import params as PRM
from repro_torch.sharding.rules import MeshRules
from repro_torch.train import optimizer as O

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] \
    / "build" / "repro_torch" / "dryrun"

# NVIDIA H100 80GB HBM3, 700 W: datasheet figures (SXM part, dense)
PEAK_FLOPS = {torch.bfloat16: 989.4e12,   # bf16 on the tensor cores
              torch.float32: 66.9e12}     # f32 on FMAs (TF32 off)
HBM_BW = 3.35e12                          # HBM3, bytes/s
NVLINK_BW = 450e9                         # NVLink 4, bytes/s a direction
NET_BW = 50e9                             # 400 Gb/s a card across nodes
NODE_CARDS = 8                            # cards joined by NVLink
# NVIDIA H100 80GB HBM3, 700 W: torch.cuda.get_device_properties(0)
# .total_memory, as chip_smoke.py phase 13 prints it
HBM_BYTES = 85_017_493_504
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def recommended_opts(cfg: ModelConfig, shape: InputShape) -> str:
    """Per-(arch, shape) recommended levers, the JAX package's."""
    opts = []
    if cfg.moe is not None:
        opts.append("moegroup")
        if cfg.moe.d_expert <= 1024:
            opts.append("moedp")       # small experts: DP beats EP
    if shape.kind == "decode":
        opts.append("noweightfsdp")    # FSDP gathers dominate decode
        # partial-softmax decode needs a data-shardable batch
        if (cfg.attention == "full" and cfg.uses_attention
                and shape.global_batch >= 16):
            opts.append("decodeps")
    return ",".join(opts)


def _apply_opts(cfg: ModelConfig, rules: MeshRules, opts: str):
    """The JAX package's levers: ``moegroup,seqshard,padheads=48``..."""
    for opt in filter(None, (opts or "").split(",")):
        if opt == "moegroup":
            cfg = dataclasses.replace(cfg, moe_group_dispatch=True)
        elif opt == "moedp":
            cfg = dataclasses.replace(cfg, moe_expert_parallel=False)
        elif opt == "seqshard":
            rules.act_rules["seq"] = ("model",)
        elif opt == "bf16reduce":
            pass                       # see the module's doc
        elif opt == "decodeps":
            cfg = dataclasses.replace(cfg, decode_partial_softmax=True)
        elif opt.startswith("accum="):
            rules.accum_steps = int(opt.split("=")[1])
        elif opt == "noweightfsdp":
            rules.param_rules["embed"] = None
        elif opt.startswith("padheads="):
            cfg = dataclasses.replace(cfg,
                                      pad_heads_to=int(opt.split("=")[1]))
        else:
            raise ValueError(f"unknown --opt {opt!r}")
    return cfg


# ---------------------------------------------------------------------------
# one trace
# ---------------------------------------------------------------------------


def with_periods(cfg: ModelConfig, k: int) -> ModelConfig:
    """``cfg`` cut to ``k`` periods of its block pattern above its prefix
    layers; an encoder cut in proportion."""
    enc = cfg.encoder
    if enc is not None:
        enc = dataclasses.replace(
            enc, n_layers=k * enc.n_layers // cfg.n_repeats)
    return dataclasses.replace(
        cfg, n_layers=len(cfg.prefix_pattern) + k * len(cfg.block_pattern),
        encoder=enc)


def fallbacks(cfg: ModelConfig, shape: InputShape, rules: MeshRules,
              dtype: torch.dtype = torch.bfloat16) -> list:
    """What ``rules`` (a fresh copy) record resolving the step's params,
    for training its optimizer slots, and its batch (a decode step's
    token and cache), in the JAX package's order and words."""
    fresh = MeshRules(rules.mesh, param_rules=dict(rules.param_rules),
                      act_rules=dict(rules.act_rules))
    with FakeTensorMode():
        abstract, axes, _ = ST.resolve_param_shardings(cfg, fresh, dtype)
        if shape.kind == "train":
            ST.opt_state_specs(O.make_optimizer(cfg.optimizer), abstract,
                               axes, fresh)
        if shape.kind == "decode":
            fresh.act_spec(("batch", "seq"), (shape.global_batch, 1))
            S.cache_specs(cfg, shape, fresh, dtype)
        else:
            S.batch_specs(cfg, shape, fresh,
                          with_labels=shape.kind == "train", dtype=dtype)
    return fresh.fallbacks


def _at(tree, device):
    """A tree of ``meta`` stand-ins as fake tensors on ``device``."""
    return PRM.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=device), tree)


def _inputs(cfg, shape, rules, dtype):
    """(params, optimizer state, step arguments) of a step of ``shape``
    under ``rules`` (None: no mesh), as fake tensors: a sharded train or
    prefill step's params placed, a decode step's whole at the home."""
    home = torch.device("meta:0") if rules is None \
        else rules.mesh.devices.reshape(-1)[0]
    abstract, _, _ = ST.resolve_param_shardings(cfg, None, dtype)
    if shape.kind != "decode" and ST.sharded(rules):
        params = ST.place_params(cfg, abstract, rules)
    else:
        params = _at(abstract, home)
    if shape.kind == "decode":
        token = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                            device=home)
        cache = _at(S.cache_specs(cfg, shape, None, dtype), home)
        args = [token, cache, shape.seq_len - 1]
        if cfg.encoder is not None:
            args.append(torch.empty(
                (shape.global_batch, cfg.encoder.n_frames, cfg.d_model),
                dtype=dtype, device=home))
        return params, None, args
    batch = _at(S.batch_specs(cfg, shape, None,
                              with_labels=shape.kind == "train",
                              dtype=dtype), home)
    if shape.kind == "train":
        return params, O.make_optimizer(cfg.optimizer).init(params), [batch]
    return params, None, [batch]


def resident(cfg: ModelConfig, shape: InputShape, rules,
             dtype: torch.dtype = torch.bfloat16) -> Dict[int, int]:
    """Each position's bytes at a step's start (params, optimizer state,
    the step's arguments), from the tensors themselves on the fake
    mesh."""
    with FakeTensorMode():
        tracker, inputs = StepTracker(), _inputs(cfg, shape, rules, dtype)
        tracker.hold(*inputs)
        return dict(tracker.live)


def trace(cfg: ModelConfig, shape: InputShape, rules=None,
          dtype: torch.dtype = torch.bfloat16, lr: float = 3e-4
          ) -> Dict[str, Any]:
    """One step of ``cfg`` on ``shape`` under ``rules`` (a ``MeshRules``
    over a mesh of ``meta`` devices; None: no mesh, on ``meta:0``),
    params and compute in ``dtype``, traced: each position's bytes at
    the start and at the peak, the copies between positions
    (``CollectiveRecord``s), the kernels' calls, the ops and the
    seconds."""
    t0 = time.perf_counter()
    with FakeTensorMode():
        params, state, args = _inputs(cfg, shape, rules, dtype)
        if shape.kind == "train":
            step = ST.make_train_step(
                cfg, O.make_optimizer(cfg.optimizer), lr=lr, rules=rules,
                compute_dtype=dtype,
                accum_steps=getattr(rules, "accum_steps", 1))
            args = [state] + args
        elif shape.kind == "prefill":
            step = ST.make_prefill_step(cfg, rules=rules, compute_dtype=dtype)
        else:
            step = ST.make_decode_step(cfg, rules=rules, compute_dtype=dtype,
                                       with_memory=cfg.encoder is not None)
        tracker = StepTracker()
        tracker.hold(params, state, args)
        with tracker:
            step(params, *args)
        del params, state, args
    mem = tracker.memory()
    return {"start": {p: m["start"] for p, m in mem.items()},
            "peak": {p: m["peak"] for p, m in mem.items()},
            "collectives": tracker.report.collectives,
            "kernel_calls": tracker.kernel_calls, "ops": tracker.ops,
            "seconds": time.perf_counter() - t0}


def _pair_bytes(records) -> Dict[Tuple[str, int, int], int]:
    out: Dict[Tuple[str, int, int], int] = collections.defaultdict(int)
    for c in records:
        out[(c.op, c.src, c.dst)] += c.total
    return dict(out)


def extrapolate(t1: Dict[str, Any], t2: Dict[str, Any], k: int,
                start: Dict[int, int]) -> Dict[str, Any]:
    """A trace at ``k`` periods from traces at 1 and 2 (affine in the
    periods): each position's rise above its start, the bytes it
    receives by collective and sender, and the kernel calls; ``start``
    the exact bytes at the start of the full-depth step."""
    def line(a, b):
        return a + (b - a) * (k - 1)
    rise = {p: line(t1["peak"].get(p, 0) - t1["start"].get(p, 0),
                    t2["peak"].get(p, 0) - t2["start"].get(p, 0))
            for p in set(t1["peak"]) | set(t2["peak"]) | set(start)}
    b1, b2 = _pair_bytes(t1["collectives"]), _pair_bytes(t2["collectives"])
    records = [CollectiveRecord(op, line(b1.get(key, 0), b2.get(key, 0)), 1,
                                "extrapolated", src, dst)
               for key in sorted(set(b1) | set(b2))
               for op, src, dst in [key]]
    return {"start": dict(start),
            "peak": {p: start.get(p, 0) + rise[p] for p in rise},
            "collectives": records,
            "kernel_calls": {n: line(t1["kernel_calls"][n],
                                     t2["kernel_calls"][n])
                             for n in t1["kernel_calls"]}}


def collective_seconds(records) -> float:
    """The busiest position's receive time: bytes from its own node at
    NVLINK_BW, from another node at NET_BW."""
    t: Dict[int, float] = collections.defaultdict(float)
    for c in records:
        same = c.src // NODE_CARDS == c.dst // NODE_CARDS
        t[c.dst] += c.total / (NVLINK_BW if same else NET_BW)
    return max(t.values(), default=0.0)


def roofline(cfg: ModelConfig, shape: InputShape, records, chips: int,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The roofline terms of a step (``launch/flops.py``'s analytic
    flops and bytes, called as the JAX package's dry-run calls them)
    over ``chips`` cards at the datasheet rates."""
    fwd = F.step_flops(cfg, shape)
    total_flops = F.train_flops(cfg, shape) if shape.kind == "train" else fwd
    opt_bpe = 8 if cfg.optimizer == "adamw" else 0
    total_bytes = F.step_bytes(cfg, shape, dtype.itemsize, opt_bpe)
    out = {"analytic_flops": total_flops,
           "analytic_hbm_bytes": total_bytes,
           "model_flops": F.model_flops(cfg, shape),
           "compute_s": total_flops / (chips * PEAK_FLOPS[dtype]),
           "memory_s": total_bytes / (chips * HBM_BW),
           "collective_s": collective_seconds(records)}
    terms = {k: out[k] for k in ("compute_s", "memory_s", "collective_s")}
    out["dominant"] = max(terms, key=terms.get)
    return out


def depth_trace(cfg: ModelConfig, shape: InputShape, rules=None,
                dtype: torch.dtype = torch.bfloat16,
                full_depth: bool = False) -> Dict[str, Any]:
    """:func:`trace` at full depth, or at one and two periods and
    extrapolated (see the module's doc); ``traced_layers`` says which,
    ``seconds`` sums the traces'."""
    if full_depth or cfg.n_repeats <= 2:
        got = trace(cfg, shape, rules, dtype)
        got["traced_layers"] = [cfg.n_layers]
        return got
    t1, t2 = (trace(with_periods(cfg, i), shape, rules, dtype)
              for i in (1, 2))
    got = extrapolate(t1, t2, cfg.n_repeats,
                      resident(cfg, shape, rules, dtype))
    got["traced_layers"] = [with_periods(cfg, i).n_layers for i in (1, 2)]
    got["seconds"] = t1["seconds"] + t2["seconds"]
    return got


def run_one(arch: str, shape_name: str, mesh_kind: str,
            save: bool = True, verbose: bool = True, opts: str = "",
            tag: str = "", dtype: str = "bf16",
            full_depth: bool = False) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind + tag,
        "opts": opts, "dtype": dtype,
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        if save:
            _save(record)
        return record
    param_dtype = DTYPES[dtype]
    try:
        n = 512 if mesh_kind == "multi" else 256
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    devices=fake_devices(n))
        chips = mesh_chips(mesh)
        rules = MeshRules(mesh)
        if opts == "auto":
            opts = recommended_opts(cfg, shape)
            record["opts"] = opts
        cfg = _apply_opts(cfg, rules, opts)
        falls = fallbacks(cfg, shape, rules, param_dtype)
        got = depth_trace(cfg, shape, rules, param_dtype, full_depth)
    except Exception as e:
        record["status"] = "error"
        record["error"] = traceback.format_exc(limit=20)
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: {e}")
        if save:
            _save(record)
        return record
    report = HloReport(got["collectives"])
    peak = [got["peak"].get(p, 0) for p in range(chips)]
    record.update({
        "status": "ok", "chips": chips,
        "traced_layers": got["traced_layers"],
        "trace_s": round(got["seconds"], 2),
        "memory": {
            "resident_bytes": [got["start"].get(p, 0)
                               for p in range(chips)],
            "peak_bytes": peak,
            "per_device_gib_estimate": round(max(peak) / 2 ** 30, 3),
            "fits_hbm": max(peak) <= HBM_BYTES},
        "collective_bytes_per_device": report.collective_bytes,
        "collectives_by_op": report.by_op(),
        "kernel_calls": {k: v for k, v in got["kernel_calls"].items() if v},
        "sharding_fallbacks": falls[:20],
        "roofline": roofline(cfg, shape, report.collectives, chips,
                             param_dtype)})
    if verbose:
        rf = record["roofline"]
        print(f"[OK] {arch} x {shape_name} x {mesh_kind} (trace "
              f"{record['trace_s']:.1f}s at {got['traced_layers']} layers)")
        print(f"  mem/device: "
              f"{record['memory']['per_device_gib_estimate']:.2f} GiB  "
              f"kernel calls: {record['kernel_calls']}")
        print(f"  roofline (estimate, NVIDIA H100 80GB HBM3 datasheet, "
              f"700 W): compute {rf['compute_s'] * 1e3:.2f}ms memory "
              f"{rf['memory_s'] * 1e3:.2f}ms collective "
              f"{rf['collective_s'] * 1e3:.2f}ms -> {rf['dominant']}")
        print("  " + summarize(report).replace("\n", "\n  "))
    if save:
        _save(record)
    return record


def _save(record: Dict[str, Any]):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    (RESULTS_DIR / name).write_text(json.dumps(record, indent=1))


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true",
                    help="sweep all (arch, shape) on --mesh")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma list: moegroup,seqshard,padheads=<n>")
    ap.add_argument("--tag", default="",
                    help="suffix for the result file (opt variants)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                    help="params and compute (f32: the card's checks)")
    ap.add_argument("--full-depth", action="store_true",
                    help="trace every layer instead of extrapolating")
    args = ap.parse_args(argv)
    kw = dict(opts=args.opt, tag=args.tag, dtype=args.dtype,
              full_depth=args.full_depth)
    if args.all:
        for arch in list_archs():
            for shape in sorted(SHAPES):
                out = RESULTS_DIR / f"{arch}__{shape}__{args.mesh}.json"
                if args.skip_done and out.exists():
                    prev = json.loads(out.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        continue
                run_one(arch, shape, args.mesh, **kw)
        return
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    run_one(args.arch, args.shape, args.mesh, **kw)


if __name__ == "__main__":
    main()
