"""The port's dry-run (``launch/dryrun.py``, ``launch/hlo_analysis.py``,
``launch/roofline.py``'s table) on the CPU.

* Every family's reduced training step traces on a mesh of distinct
  fake devices (``meta:0 .. meta:n-1`` under ``FakeTensorMode``), where
  an op that mixes two positions without a collective raises: qwen3,
  granite with the global and the grouped dispatch, deepseek, minicpm3,
  rwkv6-7b, jamba cut to one Mamba, one attention and one MoE layer,
  whisper and internvl2 on (2, 2) (rwkv6 on (2, 1)), one with a sequence
  split, one on (2, 1, 2), one with ``accum_steps`` 2; the glm4 and
  internvl2 prefills; a decode step with ``decode_partial_softmax``.
  Every byte that crosses positions sits under a ``launch/mesh.py``
  collective: nothing is ``unlabelled``. The AdamW families raised on
  AdamW's bias corrections (on ``count``'s device) before the repair.
* The JAX package's ``repro/launch/dryrun.py``: ``recommended_opts``
  for every (arch, shape), ``_apply_opts`` for every lever (config
  fields and rules; ``bf16reduce`` is recorded and does nothing here),
  the fallbacks the rules record over the params, the optimizer slots
  and the batch (a decode step's token and cache) on both production
  meshes, the analytic roofline terms and params, the skipped record,
  and ``launch/roofline.py``'s table text for the same records.
* The tracker: live and peak bytes of scripted allocations and frees
  on two positions; each collective's received bytes against its
  closed form at model 2 and 4; a dense step's bytes a layer against
  the closed form of ``Layout.enter`` / ``leave``, with the sequence
  split and without; the extrapolation from 1 and 2 periods to 4
  against the trace at 4; each kernel's trace route allocating the
  CUDA route's shapes and dtypes, counted apart from its launches.
"""
import dataclasses
import os
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import flops as jF  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jS  # noqa: E402
from repro.models import params as jPRM  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.sharding import rules as jR  # noqa: E402
from repro.train import optimizer as jO  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402
from repro_torch.kernels import selective_scan as ssm  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.hlo_analysis import (HloReport,  # noqa: E402
                                             StepTracker, fake_devices,
                                             position)
from repro_torch.sharding.rules import MeshRules  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402

# its first lines set XLA_FLAGS for 512 host devices: restored at once,
# before any JAX backend reads it
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jD  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _rules(shape, seq=False):
    n = 1
    for s in shape:
        n *= s
    rules = MeshRules(M.make_mesh(shape, AXES[len(shape)],
                                  [f"meta:{i}" for i in range(n)]))
    if seq:
        rules.act_rules["seq"] = ("model",)
    return rules


def _unlabelled(got):
    return HloReport(got["collectives"]).unlabelled()


# ---------------------------------------------------------------------------
# every family on a mesh of distinct fake devices
# ---------------------------------------------------------------------------

# one Mamba, one attention and one MoE layer of jamba's
JAMBA3 = {"n_layers": 2, "block_pattern": (("mamba", "mlp"),
                                           ("attn", "moe"))}
TRAIN_CASES = [
    # (id, arch, mesh, config changes, sequence split, accum_steps)
    ("qwen3", "qwen3-14b", (2, 2), {}, False, 1),
    ("granite-global", "granite-moe-3b-a800m", (2, 2), {}, False, 1),
    ("granite-grouped", "granite-moe-3b-a800m", (2, 2),
     {"moe_group_dispatch": True}, False, 1),
    ("deepseek", "deepseek-v2-lite-16b", (2, 2), {}, False, 1),
    ("minicpm3", "minicpm3-4b", (2, 2), {}, False, 1),
    ("rwkv6", "rwkv6-7b", (2, 1), {}, False, 1),
    ("jamba3", "jamba-1.5-large-398b", (2, 2), JAMBA3, False, 1),
    ("whisper", "whisper-large-v3", (2, 2), {}, False, 1),
    ("internvl2", "internvl2-76b", (2, 2), {}, False, 1),
    ("granite-seq", "granite-moe-3b-a800m", (2, 2), {}, True, 1),
    ("h2o-2x1x2", "h2o-danube-1.8b", (2, 1, 2), {}, False, 1),
    ("qwen3-accum2", "qwen3-14b", (2, 2), {}, False, 2),
]
BATCH, SEQ = 4, 16


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[c[0] for c in TRAIN_CASES])
def test_train_step_traces_on_distinct_devices(case):
    _, arch, mesh, changes, seq, accum = case
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    rules = _rules(mesh, seq)
    rules.accum_steps = accum
    got = D.trace(cfg, InputShape("t", SEQ, BATCH, "train"), rules,
                  torch.float32)
    assert _unlabelled(got) == {}
    mixer = "rwkv6_wkv" if arch == "rwkv6-7b" else "flash_attention"
    assert got["kernel_calls"][mixer] > 0
    assert got["kernel_calls"][mixer + "_bwd"] > 0
    # every position works (a spec that replicates over an axis keeps
    # one part, at the axis's first position: pod 1 of (2, 1, 2) starts
    # with nothing)
    assert len(got["start"]) == len(rules.mesh.devices.reshape(-1))
    assert got["start"][0] > 0
    assert all(got["peak"][p] > got["start"][p] for p in got["start"])


@pytest.mark.parametrize("arch,mesh", [("glm4-9b", (1, 2)),
                                       ("internvl2-76b", (2, 2))])
def test_prefill_traces_on_distinct_devices(arch, mesh):
    cfg = get_config(arch).reduced()
    got = D.trace(cfg, InputShape("p", SEQ, BATCH, "prefill"),
                  _rules(mesh), torch.float32)
    assert _unlabelled(got) == {}
    assert got["kernel_calls"]["flash_attention"] > 0
    assert got["kernel_calls"]["flash_attention_bwd"] == 0


def test_decode_partial_softmax_traces_on_distinct_devices():
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(),
                              decode_partial_softmax=True)
    got = D.trace(cfg, InputShape("d", SEQ, BATCH, "decode"), _rules((2, 2)),
                  torch.float32)
    assert _unlabelled(got) == {}
    ops_ = HloReport(got["collectives"]).by_op(1)
    # the cache's slice and the query go out each step; the combine's
    # maxima and sums come back
    assert ops_["scatter"] > 0 and ops_["broadcast"] > 0
    assert HloReport(got["collectives"]).by_op(0)["psum"] > 0


# ---------------------------------------------------------------------------
# parity with the JAX package's dry-run
# ---------------------------------------------------------------------------

LEVERS = ["moegroup", "moedp", "seqshard", "bf16reduce", "decodeps",
          "accum=4", "noweightfsdp", "padheads=48"]
STAND_INS = {"single": {"data": 16, "model": 16},
             "multi": {"pod": 2, "data": 16, "model": 16}}


def _jrules(mesh_kind):
    return jR.MeshRules(types.SimpleNamespace(shape=STAND_INS[mesh_kind]))


def _trules(mesh_kind):
    n = 512 if mesh_kind == "multi" else 256
    return MeshRules(M.make_production_mesh(
        multi_pod=mesh_kind == "multi", devices=fake_devices(n)))


def test_recommended_opts_match_jax():
    for arch in list_archs():
        for name in SHAPES:
            assert D.recommended_opts(get_config(arch), SHAPES[name]) \
                == jD.recommended_opts(jget_config(arch), JSHAPES[name])


FIELDS = ("moe_group_dispatch", "moe_expert_parallel",
          "decode_partial_softmax", "pad_heads_to")


@pytest.mark.parametrize("lever", LEVERS + ["moegroup,seqshard,accum=2"])
def test_apply_opts_matches_jax(lever):
    for arch in ("granite-moe-3b-a800m", "qwen3-14b"):
        tr, jr = _trules("single"), _jrules("single")
        cfg = D._apply_opts(get_config(arch), tr, lever)
        jcfg = jD._apply_opts(jget_config(arch), jr, lever)
        for f in FIELDS:
            assert getattr(cfg, f) == getattr(jcfg, f), (lever, f)
        assert tr.param_rules == jr.param_rules
        assert tr.act_rules == jr.act_rules
        assert getattr(tr, "accum_steps", 1) == getattr(jr, "accum_steps", 1)
    with pytest.raises(ValueError, match="unknown --opt"):
        D._apply_opts(get_config("qwen3-14b"), _trules("single"), "nope")


def _sorted_leaves(tree, is_leaf):
    if is_leaf(tree):
        yield tree
        return
    for k in sorted(tree):
        yield from _sorted_leaves(tree[k], is_leaf)


def _jax_fallbacks(arch, name, mesh_kind):
    """What the JAX package's ``MeshRules`` records over the step's
    params, slots and batch (a decode step's token and cache), built
    from the spec trees and called leaf by leaf in its tree order."""
    jcfg, shape = jget_config(arch), JSHAPES[name]
    rules = _jrules(mesh_kind)
    spec = jT.model_spec(jcfg)
    is_spec = jPRM.is_spec
    for s in _sorted_leaves(spec, is_spec):
        rules.spec(s.axes, s.shape, rules.param_rules, "param")
    if shape.kind == "train":
        # the slots' shapes as the port's state holds them (the same
        # layout), their axes from the JAX optimizer
        with FakeTensorMode():
            abstract = {k: v for k, v in O.make_optimizer(
                jcfg.optimizer).init(D.ST.resolve_param_shardings(
                    get_config(arch), None)[0]).items()}
        axes = jO.make_optimizer(jcfg.optimizer).state_axes(
            jPRM.axes_tree(spec))
        shapes = list(_sorted_leaves(abstract, torch.is_tensor))
        names = list(_sorted_leaves(axes, lambda x: isinstance(x, tuple)))
        assert len(shapes) == len(names)
        for t, ax in zip(shapes, names):
            rules.spec(tuple(ax), tuple(t.shape), rules.param_rules, "opt")
    b = shape.global_batch
    if shape.kind == "decode":
        rules.act_spec(("batch", "seq"), (b, 1))
        cache = S.cache_specs(get_config(arch), shape)
        shapes = list(_sorted_leaves(cache, torch.is_tensor))
        names = list(_sorted_leaves(jS.cache_axes(jcfg),
                                    lambda x: isinstance(x, tuple)))
        for t, ax in zip(shapes, names):
            rules.act_spec(ax, tuple(t.shape))
        return rules.fallbacks
    s = jS.text_len(jcfg, shape)
    rules.act_spec(("batch", "seq"), (b, s))
    if shape.kind == "train":
        rules.act_spec(("batch", "seq"), (b, s))
    if jcfg.frontend is not None and jcfg.frontend.kind == "vision":
        rules.act_spec(("batch", "seq", "embed"),
                       (b, jcfg.frontend.num_tokens, jcfg.d_model))
    elif jcfg.encoder is not None:
        rules.act_spec(("batch", "frames", "embed"),
                       (b, jcfg.encoder.n_frames, jcfg.d_model))
    return rules.fallbacks


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_fallbacks_match_jax(mesh_kind):
    rules = _trules(mesh_kind)
    for arch in list_archs():
        for name in SHAPES:
            got = D.fallbacks(get_config(arch), SHAPES[name], rules)
            assert got == _jax_fallbacks(arch, name, mesh_kind), (arch, name)


def test_record_fields_match_jax():
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name in SHAPES:
            shape, jshape = SHAPES[name], JSHAPES[name]
            rf = D.roofline(cfg, shape, [], 256)
            fwd = jF.step_flops(jcfg, jshape)
            total = jF.train_flops(jcfg, jshape) if jshape.kind == "train" \
                else fwd
            opt_bpe = 8 if jcfg.optimizer == "adamw" else 0
            assert rf["analytic_flops"] == total
            assert rf["analytic_hbm_bytes"] == jF.step_bytes(
                jcfg, jshape, 2, opt_bpe)
            assert rf["model_flops"] == jF.model_flops(jcfg, jshape)
            assert cfg.param_count() == jcfg.param_count()
            assert cfg.active_param_count() == jcfg.active_param_count()
        # a skipped (arch, shape): the same record, but the port's dtype
        if not jD.shape_applicable(jcfg, JSHAPES["long_500k"])[0]:
            got = D.run_one(arch, "long_500k", "single", save=False,
                            verbose=False)
            want = jD.run_one(arch, "long_500k", "single", save=False,
                              verbose=False)
            assert got.pop("dtype") == "bf16"
            assert got == want and got["status"] == "skipped"


def test_roofline_table_matches_jax(monkeypatch):
    ok = {"arch": "granite-moe-3b-a800m", "shape": "train_4k",
          "status": "ok", "memory": {"per_device_gib_estimate": 12.345},
          "roofline": {"compute_s": 0.0306, "memory_s": 0.002,
                       "collective_s": 1.5, "dominant": "collective_s",
                       "model_flops": 3e15, "analytic_flops": 4e15}}
    rows = [ok, {"arch": "glm4-9b", "shape": "long_500k",
                 "status": "skipped", "reason": "long_500k needs "
                 "sub-quadratic attention (see DESIGN.md)"},
            {"arch": "qwen3-14b", "shape": "decode_32k", "status": "error"}]
    monkeypatch.setattr(roofline, "rows_for", lambda mesh: rows)
    monkeypatch.setattr(jroofline, "rows_for", lambda mesh: rows)
    assert roofline.table("single") == jroofline.table("single")


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------


def test_fake_devices_are_distinct_positions():
    """A device index is a signed byte: past 127 the positions wrap to
    negative ``meta`` indices and plain ``meta``, past 255 to ``lazy``;
    each position its own device, and back."""
    devs = [torch.device(d) for d in fake_devices(512)]
    assert len(set(devs)) == 512
    assert [position(d) for d in devs] == list(range(512))
    assert (str(devs[200]), str(devs[255]), str(devs[256])) == (
        "meta:-56", "meta", "lazy:0")
    assert position(torch.device("cpu")) is None
    with pytest.raises(ValueError, match="at most 512"):
        fake_devices(513)


def test_step_traces_across_the_wrapped_positions():
    """Positions 254-257 (``meta:-2``, ``meta``, ``lazy:0``,
    ``lazy:1``) as a (2, 2) mesh: the step traces, the kernels take
    their trace routes on both device types, each position is read
    back."""
    devs = fake_devices(258)[254:]
    rules = MeshRules(M.make_mesh((2, 2), ("data", "model"), devs))
    got = D.trace(get_config("granite-moe-3b-a800m").reduced(),
                  InputShape("t", SEQ, BATCH, "train"), rules, torch.float32)
    assert _unlabelled(got) == {}
    assert sorted(got["start"]) == [254, 255, 256, 257]
    assert got["kernel_calls"]["flash_attention"] > 0
    assert got["kernel_calls"]["moe_gmm"] > 0
    assert HloReport(got["collectives"]).received().keys() == {
        254, 255, 256, 257}


def test_tracker_memory_scripted():
    with FakeTensorMode():
        held = torch.empty(100, device="meta:0")
        tracker = StepTracker()
        tracker.hold({"a": [held]})
        with tracker:
            a = torch.empty(250, device="meta:0")        # +1000 at 0
            b = torch.empty(10, dtype=torch.float64,
                            device="meta:1")              # +80 at 1
            view = a[10:]                                 # no storage
            del a                                         # the view holds
            c = torch.empty(500, device="meta:0")         # +2000 at 0
            del view, c                                   # -3000 at 0
            d = b.to("meta:0")                            # +80 at 0
            del b                                         # -80 at 1
    mem = tracker.memory()
    assert mem[0] == {"start": 400, "peak": 3400, "now": 480}
    assert mem[1] == {"start": 0, "peak": 80, "now": 0}
    del d


def _collective_bytes(fn, n):
    """Each position's received bytes by op of ``fn(parts, devices)``,
    ``parts`` one (4, 8) f32 tensor (128 bytes) a position."""
    with FakeTensorMode():
        devs = [torch.device(f"meta:{i}") for i in range(n)]
        parts = [torch.empty(4, 8, device=d, requires_grad=True)
                 for d in devs]
        tracker = StepTracker()
        with tracker:
            out = fn(parts, devs)
            outs = [o for o in ([out] if torch.is_tensor(out) else out)
                    if o.requires_grad]
            torch.autograd.grad(outs, parts, [torch.ones_like(o)
                                              for o in outs],
                                allow_unused=True)
    report = tracker.report
    return {p: report.by_op(p) for p in range(n)}


@pytest.mark.parametrize("n", [2, 4])
def test_collective_bytes_closed_forms(n):
    B = 128
    # psum onto position 0: n - 1 parts arrive there; the backward sends
    # the cotangent to each other part
    got = _collective_bytes(lambda ps, ds: M.psum(ps, ds[0]), n)
    assert got[0]["psum"] == (n - 1) * B
    assert all(got[p] == {"psum_bwd": B} for p in range(1, n))
    got = _collective_bytes(lambda ps, ds: M.all_gather(ps, 0, ds[0]), n)
    assert got[0]["all_gather"] == (n - 1) * B
    got = _collective_bytes(lambda ps, ds: M.pmax(ps, ds[0]), n)
    assert got[0]["pmax"] == (n - 1) * B
    # one part to every position, its gradient summed back at its home
    got = _collective_bytes(lambda ps, ds: M.broadcast(ps[0], ds), n)
    assert all(got[p]["broadcast"] == B for p in range(1, n))
    assert got[0]["broadcast_bwd"] == (n - 1) * B
    got = _collective_bytes(lambda ps, ds: M.fan_out(ps[0], ds), n)
    assert all(got[p] == {"fan_out": B} for p in range(1, n))
    assert got[0]["fan_out_bwd"] == (n - 1) * B
    # the parts (each a chunk of a (4 n, 8) whole) gathered on every
    # position; the backward's reduce-scatter sums at the first part's
    # position and sends each its chunk
    sl = [(slice(4 * i, 4 * i + 4), slice(None)) for i in range(n)]
    got = _collective_bytes(lambda ps, ds: M.spread(ps, sl, ds), n)
    assert all(got[p]["spread"] == (n - 1) * B for p in range(n))
    assert got[0]["spread_bwd"] == (n - 1) * n * B
    assert all(got[p]["spread_bwd"] == B for p in range(1, n))
    # reduce-scatter: the sum at position 0, a row of it to each other
    got = _collective_bytes(lambda ps, ds: M.reduce_scatter(
        ps, ds, [(slice(i, i + 1),) for i in range(n)]), n)
    assert got[0]["reduce_scatter"] == (n - 1) * B
    assert all(got[p]["reduce_scatter"] == B // 4 for p in range(1, n))
    # the running sum at position 0 and each position's prefix from it
    got = _collective_bytes(lambda ps, ds: M.exclusive_prefix(ps, ds), n)
    assert got[0]["exclusive_prefix"] == (n - 1) * B
    assert all(got[p]["exclusive_prefix"] == B for p in range(1, n))


@pytest.mark.parametrize("seq", [False, True], ids=["rows", "cells"])
def test_dense_step_bytes_a_layer(seq):
    """qwen3 on (1, 2): a layer enters its row (B bytes) on both model
    positions twice (attention, MLP) and leaves it twice. Unsplit, the
    row is at its home: ``fan_out`` sends it to position 1 and ``psum``
    brings position 1's partial back, and the backward runs both the
    other way. Split into cells, position j holds its cell (B / 2)
    between layers: ``spread`` brings the other cell, ``leave`` sends
    each cell the other position's partial of it, and the backward's
    reduce-scatter gathers both cotangents at position 0 and sends
    position 1 its cell's. Besides: attention's positions (s int64)
    and the replicated qk-norm scales go to position 1, and with cells
    the two RMSNorm scales too (a norm runs cell by cell); their
    gradients come back to position 0."""
    cfg = get_config("qwen3-14b").reduced()
    shape = InputShape("t", SEQ, BATCH, "train")
    rules = _rules((1, 2), seq)
    per = {}
    for k in (1, 2):
        got = D.trace(D.with_periods(cfg, k), shape, rules, torch.float32)
        rep = HloReport(got["collectives"])
        per[k] = {p: rep.by_op(p) for p in (0, 1)}
    layer = {p: {op: per[2][p].get(op, 0) - per[1][p].get(op, 0)
                 for op in set(per[2][p]) | set(per[1][p])}
             for p in (0, 1)}
    layer = {p: {op: b for op, b in ops_.items() if b} for p, ops_ in
             layer.items()}
    B = BATCH * SEQ * cfg.d_model * 4
    pos, qk, ln = SEQ * 8, 2 * cfg.head_dim * 4, 2 * cfg.d_model * 4
    if not seq:
        assert layer[0] == {"psum": 2 * B, "fan_out_bwd": 2 * B,
                            "spread_bwd": qk}
        assert layer[1] == {"fan_out": 2 * B, "psum_bwd": 2 * B,
                            "spread": qk, "broadcast": pos}
    else:
        assert layer[0] == {"spread": B, "psum": B, "psum_bwd": B,
                            "spread_bwd": 2 * B + qk + ln}
        assert layer[1] == {"spread": B + qk + ln, "psum": B,
                            "spread_bwd": B, "psum_bwd": B,
                            "broadcast": pos}


def test_extrapolation_matches_the_trace_at_four_periods():
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              n_layers=4)
    shape = InputShape("t", SEQ, BATCH, "train")
    rules = _rules((1, 2))
    full = D.trace(cfg, shape, rules, torch.float32)
    ex = D.extrapolate(*(D.trace(D.with_periods(cfg, k), shape, rules,
                                 torch.float32) for k in (1, 2)),
                       cfg.n_repeats, D.resident(cfg, shape, rules,
                                                 torch.float32))
    assert ex["kernel_calls"] == full["kernel_calls"]
    assert ex["start"] == full["start"]
    got, want = HloReport(ex["collectives"]), HloReport(full["collectives"])
    assert got.received() == want.received()
    assert all(got.by_op(p) == want.by_op(p) for p in (0, 1))
    for p in full["peak"]:
        assert abs(ex["peak"][p] - full["peak"][p]) <= 0.01 * full["peak"][p]


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _sig(t):
    return tuple(t.shape), t.dtype, t.device.type


def test_trace_routes_allocate_the_cuda_routes_tensors():
    counters = dict(ops.TRACE_COUNTERS)
    before = {k: c.count for k, c in counters.items()}
    launched = (fa.launches.count, gmm.launches.count, wkv.launches.count,
                ssm.launches.count, qz.launches.count)
    assert ops.default_backend(_meta(1)) == "trace"
    b, h, kvh, sq, dh = 2, 4, 2, 24, 16
    q, k, v = (_meta(b, n, sq, dh, grad=True) for n in (h, kvh, kvh))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert _sig(o) == _sig(q) and _sig(lse) == ((b, h, sq), torch.float32,
                                                "meta")
    assert fa.bwd_variant(q, k, v) == "mma_3xtf32"
    assert fa.bwd_variant(_meta(b, h, 16, dh), k, v) == "simt"
    odd = _meta(b * h * sq * dh + 1)[1:].view(b, h, sq, dh)
    assert fa.bwd_variant(odd, k, v) == "simt"
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, o, lse=lse)
    assert [_sig(t) for t in (dq, dk, dv)] == [_sig(t) for t in (q, k, v)]
    gq, = torch.autograd.grad(ops.flash_attention(q, k, v).sum(), [q])
    assert _sig(gq) == _sig(q)
    x, w = _meta(3, 5, 7, dtype=torch.bfloat16), _meta(3, 7, 9,
                                                         dtype=torch.bfloat16)
    assert _sig(ops.moe_gmm(x, w)) == ((3, 5, 9), torch.bfloat16, "meta")
    r = _meta(b, h, 20, 32)
    u = _meta(h, 32)
    y, s_fin, chk = wkv.wkv_forward(r, r, r, r, u, checkpoints=True)
    assert [_sig(t)[0] for t in (y, s_fin, chk)] == [
        (b, h, 20, 32), (b, h, 32, 32), (b, h, 3, 32, 32)]
    assert all(t.dtype == torch.float32 for t in (y, s_fin, chk))
    grads = wkv.rwkv6_wkv_bwd(r, r, r, r, u, chk, y, s_fin)
    assert [_sig(g)[0] for g in grads] == [(b, h, 20, 32)] * 4 + [(h, 32)]
    dt, bm, a = _meta(b, 10, 6), _meta(b, 10, 4), _meta(6, 4)
    y, h_fin, chk = ssm.scan_forward(dt, bm, bm, dt, a, checkpoints=True)
    assert [_sig(t)[0] for t in (y, h_fin, chk)] == [
        (b, 10, 6), (b, 6, 4), (b, 3, 4, 6)]
    grads = ssm.selective_scan_bwd(dt, bm, bm, dt, a, chk, y, h_fin)
    assert [_sig(g)[0] for g in grads] == [(b, 10, 6), (b, 10, 4),
                                           (b, 10, 4), (b, 10, 6), (6, 4)]
    qq, scale = ops.quantize_int8(_meta(5, 64))
    assert _sig(qq) == ((5, 64), torch.int8, "meta")
    assert _sig(scale) == ((5,), torch.float32, "meta")
    calls = {k: c.count - before[k] for k, c in counters.items()}
    assert calls == {"flash_attention": 2, "flash_attention_bwd": 2,
                     "moe_gmm": 1, "quantize_int8": 1, "rwkv6_wkv": 1,
                     "rwkv6_wkv_bwd": 1, "selective_scan": 1,
                     "selective_scan_bwd": 1}
    assert (fa.launches.count, gmm.launches.count, wkv.launches.count,
            ssm.launches.count, qz.launches.count) == launched


def test_gmm_trace_plans_the_d_split():
    # a decode-sized call (c <= 16) over few column strips cuts d, and
    # its scratch is held while the kernel would run
    assert gmm.plan(4, 4, 8192, 128, gmm.H100_SMS) == (0, 128, 32)
    assert gmm.plan(4, 512, 8192, 128, gmm.H100_SMS) == (1, 0, 1)
    with FakeTensorMode():
        x = torch.empty(4, 4, 8192, device="meta:0")
        w = torch.empty(4, 8192, 128, device="meta:0")
        tracker = StepTracker()
        tracker.hold(x, w)
        with tracker:
            out = gmm.moe_gmm(x, w)
    rise = tracker.memory()[0]["peak"] - tracker.memory()[0]["start"]
    assert rise == out.numel() * 4 + 32 * 4 * 4 * 128 * 4
