"""The port's train and prefill steps on a mesh of more than one device,
on the CPU device repeated, against the port's unsharded steps and the
JAX package's.

* Parity: reduced qwen3 (qk-norm, untied and tied embeddings, the
  ``noweightfsdp`` lever), h2o-danube with a window shorter than the
  sequence, glm4 (its KV heads fall back to replication on a model axis
  of 4), granite with the global and the grouped dispatch, expert data
  parallelism (``moedp``) and a vocab that falls back, on (2, 2), (1, 4),
  (4, 1) and a ``pod x data x model`` (2, 1, 2), with ``accum_steps`` 1
  and 2 and remat ``none`` / ``minimal`` / ``full``: one AdamW step of
  ``make_train_step`` from the same numpy-made params and batch gives
  the unsharded step's loss within 1e-6 relative and its metrics, every
  gradient the step hands its optimizer within 1e-5 of its leaf's
  largest, and every updated param within 1e-5 of its leaf's largest
  plus what AdamW's first step makes of the gradients' difference
  (``assert_adamw_updates``); ``make_prefill_step``'s last logits
  within 1e-5 of their largest. Two sharded runs agree to the bit.
* The JAX package's unsharded ``make_train_step`` (its gradients as it
  hands them to its optimizer) and ``make_prefill_step`` hold the
  sharded steps at ``tests/test_torch_lm_train.py``'s tolerances:
  metrics at rtol 1e-5, gradients within 1e-4 of each leaf's largest,
  logits within 1e-5 of their largest; on every mesh shape at
  ``accum_steps`` 1 and 2, dense and each MoE dispatch, and glm4's
  prefill over its replicated KV heads. One JAX run serves every mesh
  it is held to.
* The MoE dispatch over rows keeps global capacity and token-major
  priority: a batch that overflows an expert drops the unsharded
  step's assignments, and the load balance is the unsharded value.
* The mixer families (ROADMAP Queue 1 item 10b's second part): reduced
  rwkv6-7b, minicpm3-4b (a low-rank q), deepseek-v2-lite-16b (a dense
  prefix layer, a shared expert) and jamba-1.5-large-398b (its first
  two layers, mamba + mlp and mamba + moe) on (2, 2), (1, 4) and (4,
  1), AdamW and Adafactor, against
  the unsharded steps (Adafactor's updated params within 1e-5 of each
  leaf's largest: its first step is linear in the gradient) and the JAX
  package's; one case a family whose split dim falls back to
  replication (heads, or d_inner where 2 d_inner still splits, so that
  ``w_in`` alone is split); Mamba's ``w_in`` gradient in its columns
  through the column map; Adafactor's placed slots by the specs
  ``opt_state_specs`` resolves.
* The encoder-decoder and the vision prefix (item 10b's third part):
  reduced whisper-large-v3 (AdamW; its 2 KV heads fall back on model
  4) and internvl2-76b (Adafactor) on (2, 2), (1, 4), (4, 1) and (2,
  1, 2), accum_steps 1 and 2, their frames or patches drawn with the
  batch, held as the mixer families are; the biased MLP's output bias
  added once over a model axis of 2 and 4.
* The sequence split (``act_rules["seq"] = ("model",)``, each row's
  residual stream as sequence cells over ``model`` between layers):
  every family's steps held as the mixer families' are, to the port's
  unsharded step and, on the keys of the cases above (so that one JAX
  run serves both), the JAX package's: qwen3 (untied on (2, 2), tied on
  (4, 1), accum_steps 2), h2o-danube's window of 5 across a cell
  boundary on (2, 1, 2), glm4's KV fallback on (1, 4), granite's global
  and grouped dispatch and expert data parallelism (``moedp``, on (2,
  1, 2)) (and at capacity factor 0.5, every step dropping
  assignments, under remat ``minimal`` and ``full``), rwkv6, minicpm3,
  deepseek, jamba's two layers (the token shift and the conv across a
  cell), whisper (its decoder split, its encoder not), internvl2 (its
  prefix across a cell); a length that does not divide over ``model``
  falls back, recorded, and one whose tokens do not divide while its
  whole sequence does is split. The seven families that raised before
  the split ran step with it on a model axis of 2 (the test keeps its
  name); decode takes any mesh. ``Layout``'s gather and reduce-scatter
  along the sequence, forward and backward, against the whole tensor;
  each row holds all of its tokens, labels and patches; the MoE layer
  over cells keeps the unsharded drops.
* Remat ``minimal``: the backward recomputes no matmul without batch
  dims (the attention projections included).
* Checkpoints: a sharded ``train()`` saves whole arrays that restore
  into the unsharded port and into the JAX package bit for bit, and a
  run resumed on the mesh gives the uninterrupted run's history.
* The placement helpers and the new collectives.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as jST  # noqa: E402
from repro.train import checkpoint as jC  # noqa: E402
from repro.train import optimizer as jO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import make_lm_batches  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import steps as tST  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.train import checkpoint as tC  # noqa: E402
from repro_torch.train import optimizer as tO  # noqa: E402
from repro_torch.train.trainer import TrainJob, train  # noqa: E402

LR = 1e-3
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _rules(shape, **param_rules):
    mesh = M.make_mesh(shape, AXES[len(shape)], ["cpu"] * int(
        np.prod(shape)))
    rules = R.MeshRules(mesh)
    rules.param_rules.update(param_rules)
    return rules


def _np_params(cfg, seed=0):
    """Params drawn with numpy: each matrix normal over the square root
    of its fan-in, each vector around 1 (norm scales)."""
    rng = np.random.default_rng(seed)
    abstract = tP.abstract_tree(tT.model_spec(cfg), torch.float32)

    def leaf(t):
        shape = tuple(t.shape)
        if len(shape) == 1:
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(
            np.float32)
    return tP.tree_map(leaf, abstract)


def _batch(cfg, b, s=16, seed=0):
    """Tokens and labels (b, s), and the frames (b, n_frames, d) or the
    patches (b, num_tokens, d) an encoder or a vision prefix takes,
    normal x 0.02 from a numpy generator of the seed (as
    ``chip_smoke.py``'s ``train_batches`` draws them)."""
    batch = next(make_lm_batches(cfg.vocab, b, s, 1, seed=seed))
    rng = np.random.default_rng(seed)
    for key, n in _stubs(cfg).items():
        batch[key] = rng.standard_normal((b, n, cfg.d_model),
                                         dtype=np.float32) * 0.02
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _stubs(cfg):
    """The stub inputs a model takes beside its tokens, by key, and
    their length a row."""
    if cfg.encoder is not None:
        return {"frames": cfg.encoder.n_frames}
    if tT.has_vision_prefix(cfg):
        return {"patches": cfg.frontend.num_tokens}
    return {}


def _inputs(batch):
    """A prefill step's batch: every key of ``batch`` but the labels."""
    return {k: v for k, v in batch.items() if k != "labels"}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _capture(inner=None):
    """An optimizer that keeps the gradients the step hands it (whole),
    then updates as ``inner`` does, or leaves the params as they are."""
    got = []

    def update(grads, state, params, lr):
        got.append(tP.tree_map(lambda t: t.detach().clone(),
                               tP.whole_tree(grads)))
        if inner is None:
            return params, state
        return inner.update(grads, state, params, lr)
    if inner is None:
        return tO.Optimizer("capture", lambda p: {}, update,
                            lambda a: {}), got
    return dataclasses.replace(inner, update=update), got


def _port_steps(cfg, np_params, batch, rules, accum, inner=None, steps=1):
    """``steps`` ``make_train_step`` steps on ``batch`` from the numpy
    params: for each, (the params after it, whole; its metrics; the
    gradients it handed its optimizer, whole; the optimizer's state
    after it, whole). ``inner`` makes the updates, else the params
    stay."""
    opt, got = _capture(inner)
    params = tP.from_numpy(np_params, "cpu")
    if tST.sharded(rules):
        params = tST.place_params(cfg, params, rules)
    step = tST.make_train_step(cfg, opt, lr=LR, rules=rules,
                               compute_dtype=torch.float32,
                               accum_steps=accum)
    state = opt.init(params)
    out = []
    for _ in range(steps):
        params, state, metrics = step(params, state, batch)
        # the next step updates the unsharded leaves in place
        p_now, st_now = (tP.tree_map(lambda t: t.detach().clone(),
                                     tP.whole_tree(tree))
                         for tree in (params, state))
        out.append((p_now, metrics, got[-1], st_now))
    return out


def _port_step(cfg, np_params, batch, rules, accum, inner=None):
    """One step of ``_port_steps``: (the params after it, its metrics,
    its gradients)."""
    return _port_steps(cfg, np_params, batch, rules, accum, inner)[0][:3]


def _prefill(cfg, np_params, tokens, rules, **stubs):
    """``make_prefill_step``'s last logits of ``tokens`` and the frames
    or patches in ``stubs``."""
    params = tP.from_numpy(np_params, "cpu")
    if tST.sharded(rules):
        params = tST.place_params(cfg, params, rules)
    return tST.make_prefill_step(cfg, rules, torch.float32)(
        params, {"tokens": tokens, **stubs})


# the JAX package's step hands its optimizer the gradients; this one
# returns them as the new params
_JAX_CAPTURE = jO.Optimizer("capture", lambda p: {},
                            lambda g, s, p, lr: (g, s), lambda a: {})
# config changes that choose only where a value lives (the experts' mesh
# axis), not what it is: the unsharded JAX reference runs without them
_PLACEMENT_ONLY = ("moe_expert_parallel",)
_JAX_RUNS = {}


def _jax_ref(arch, changes, b, seed, accum):
    """The JAX package's unsharded ``make_train_step`` (its metrics and
    the gradients it hands its optimizer) and ``make_prefill_step`` (the
    last logits), in one jit, on ``_np_params(cfg, seed)`` and
    ``_batch(cfg, b, seed)``; run once a module for each key, since the
    reference does not depend on the mesh it is held to."""
    changes = {k: v for k, v in changes.items() if k not in _PLACEMENT_ONLY}
    key = (arch, tuple(sorted(changes.items())), b, seed, accum)
    if key not in _JAX_RUNS:
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        jcfg = dataclasses.replace(jget_config(arch).reduced(), **changes)
        train = jST.make_train_step(jcfg, _JAX_CAPTURE, lr=0.0,
                                    compute_dtype=jnp.float32,
                                    accum_steps=accum)
        prefill = jST.make_prefill_step(jcfg, compute_dtype=jnp.float32)
        both = jax.jit(lambda p, bt: (train(p, {}, bt), prefill(
            p, _inputs(bt))))
        batch = _batch(cfg, b, seed=seed)
        (grads, _, metrics), logits = both(
            jax.tree.map(jnp.asarray, _np_params(cfg, seed)),
            {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        _JAX_RUNS[key] = (
            tP.tree_map(torch.as_tensor, jax.tree.map(np.array, grads)),
            {k: float(v) for k, v in metrics.items()},
            torch.as_tensor(np.array(logits)))
    return _JAX_RUNS[key]


def _check_against_jax(arch, changes, shape, accum, b, seed):
    """The port's sharded train step on a ``shape`` mesh against the JAX
    package's unsharded one at ``tests/test_torch_lm_train.py``'s
    tolerances: metrics at rtol 1e-5, gradients within 1e-4 of each
    leaf's largest; its prefill's last logits within 1e-5 of their
    largest."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    np_params = _np_params(cfg, seed=seed)
    batch = _batch(cfg, b, seed=seed)
    rules = _rules(shape)
    jg, jm, jl = _jax_ref(arch, changes, b, seed, accum)
    _, tm, tg = _port_step(cfg, np_params, batch, rules, accum)
    assert tm.keys() == jm.keys()
    for k, v in tm.items():
        np.testing.assert_allclose(float(v), jm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for (path, a), (_, e) in zip(tP.tree_items(tg), tP.tree_items(jg)):
        assert _rel(a, e) <= 1e-4, path
    assert _rel(_prefill(cfg, np_params, batch["tokens"], rules), jl) \
        <= 1e-5


def assert_adamw_updates(got, exp, g_got, g_exp, lr, tol=1e-5, eps=1e-8):
    """Every param after one AdamW step within ``tol`` of its leaf's
    largest, plus what the step makes of the two runs' gradient
    difference (held within 1e-5 of the largest gradient on its own):
    the first step moves an entry by lr g / (|g| + eps), whose two
    values differ by lr |g1 - g2| eps / ((|g1| + eps)(|g2| + eps)) where
    the signs agree and by at most 2 lr where they do not, so near
    |g| = eps a rounding of the gradient moves the entry by O(lr)
    (``tests/test_torch_lm_train.py``'s LR)."""
    for (path, a), (_, e), (_, g1), (_, g2) in zip(
            tP.tree_items(got), tP.tree_items(exp), tP.tree_items(g_got),
            tP.tree_items(g_exp)):
        same = torch.sign(g1) == torch.sign(g2)
        moved = torch.where(
            same, (g1 - g2).abs() * eps / ((g1.abs() + eps)
                                           * (g2.abs() + eps)), 2.0)
        allow = tol * e.abs().max() + lr * moved * (1 + 1e-3)
        assert bool(((a - e).abs() <= allow).all()), ("updated", path)


# (id, arch, mesh shape, config changes, param-rule changes, batch,
# accum_steps)
CASES = [
    ("qwen3-2x2", "qwen3-14b", (2, 2), {}, {}, 4, 1),
    ("qwen3-tied-4x1-accum2", "qwen3-14b", (4, 1),
     {"tie_embeddings": True}, {}, 8, 2),
    ("qwen3-noweightfsdp-2x2-minimal", "qwen3-14b", (2, 2),
     {"remat_policy": "minimal"}, {"embed": None}, 4, 1),
    ("h2o-window-pod2x1x2", "h2o-danube-1.8b", (2, 1, 2), {"window": 5},
     {}, 4, 1),
    ("glm4-kvfallback-1x4-accum2", "glm4-9b", (1, 4), {}, {}, 4, 2),
    ("granite-global-2x2-minimal", "granite-moe-3b-a800m", (2, 2),
     {"remat_policy": "minimal"}, {}, 4, 1),
    ("granite-grouped-2x2-accum2-full", "granite-moe-3b-a800m", (2, 2),
     {"moe_group_dispatch": True, "remat_policy": "full"}, {}, 8, 2),
    ("granite-moedp-oddvocab-pod2x1x2", "granite-moe-3b-a800m", (2, 1, 2),
     {"moe_expert_parallel": False, "vocab": 509}, {}, 4, 1),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_steps_match_unsharded(case):
    _, arch, shape, changes, prules, b, accum = case
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    rules = _rules(shape, **prules)
    np_params = _np_params(cfg)
    batch = _batch(cfg, b)
    exp_p, exp_m, exp_g = _port_step(cfg, np_params, batch, None, accum,
                                     tO.adamw())
    got_p, got_m, got_g = _port_step(cfg, np_params, batch, rules, accum,
                                     tO.adamw())
    assert got_m.keys() == exp_m.keys()
    for k in exp_m:
        np.testing.assert_allclose(float(got_m[k]), float(exp_m[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for (path, a), (_, e) in zip(tP.tree_items(got_g),
                                 tP.tree_items(exp_g)):
        assert _rel(a, e) <= 1e-5, ("grad", path)
    assert_adamw_updates(got_p, exp_p, got_g, exp_g, LR)
    exp = _prefill(cfg, np_params, batch["tokens"], None)
    got = _prefill(cfg, np_params, batch["tokens"], rules)
    assert got.shape == exp.shape and _rel(got, exp) <= 1e-5
    # the same bits again
    again = _prefill(cfg, np_params, batch["tokens"], rules)
    assert torch.equal(got, again)
    if cfg.n_kv_heads % shape[-1]:
        assert any("kv_heads" in f for f in rules.fallbacks)


@pytest.mark.parametrize("arch,shape,accum", [
    ("qwen3-14b", (2, 2), 2), ("granite-moe-3b-a800m", (2, 2), 1)])
def test_sharded_train_step_matches_jax(arch, shape, accum):
    _check_against_jax(arch, {}, shape, accum, 8, 1)


# (id, arch, config changes, mesh shape, accum_steps): with the test
# above, every mesh shape at accum_steps 1 and 2, dense and each MoE
# dispatch (global, grouped, experts over ``experts_dp``), on its batch
# of 8 and seed, so that one JAX run serves several meshes
JAX_MESH_CASES = [
    ("qwen3-1x4-accum2", "qwen3-14b", {}, (1, 4), 2),
    ("qwen3-4x1-accum2", "qwen3-14b", {}, (4, 1), 2),
    ("qwen3-pod2x1x2-accum2", "qwen3-14b", {}, (2, 1, 2), 2),
    ("granite-global-1x4", "granite-moe-3b-a800m", {}, (1, 4), 1),
    ("granite-global-4x1", "granite-moe-3b-a800m", {}, (4, 1), 1),
    ("granite-moedp-pod2x1x2", "granite-moe-3b-a800m",
     {"moe_expert_parallel": False}, (2, 1, 2), 1),
    ("granite-grouped-2x2-accum2", "granite-moe-3b-a800m",
     {"moe_group_dispatch": True}, (2, 2), 2),
]


@pytest.mark.parametrize("case", JAX_MESH_CASES,
                         ids=[c[0] for c in JAX_MESH_CASES])
def test_sharded_steps_match_jax_on_every_mesh(case):
    _, arch, changes, shape, accum = case
    _check_against_jax(arch, changes, shape, accum, 8, 1)


def test_sharded_prefill_matches_jax():
    """glm4, whose 2 KV heads fall back to replication on model 4."""
    cfg, jcfg = get_config("glm4-9b").reduced(), \
        jget_config("glm4-9b").reduced()
    np_params = _np_params(cfg, seed=2)
    tokens = _batch(cfg, 4, seed=2)["tokens"]
    exp = jax.jit(jST.make_prefill_step(jcfg, compute_dtype=jnp.float32))(
        jax.tree.map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(tokens.numpy())})
    got = _prefill(cfg, np_params, tokens, _rules((1, 4)))
    exp = torch.as_tensor(np.asarray(exp))
    assert _rel(got, exp) <= 1e-5


@pytest.mark.parametrize("grouped", [False, True])
def test_moe_dispatch_over_rows_is_global(grouped):
    """At capacity factor 0.5 experts overflow: the sharded layer keeps
    the unsharded layer's assignments (its output equal, the same
    number dropped) and its load balance and z loss."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(cfg, moe_group_dispatch=grouped, moe=(
        dataclasses.replace(cfg.moe, capacity_factor=0.5)))
    params = tP.from_numpy(_np_params(cfg, seed=3), "cpu")
    p = tP.tree_slice(params["blocks"]["pos0"]["ffn"], 0)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    rules = _rules((2, 2))
    lay = R.Layout(rules.mesh, "data")
    specs = tST.resolve_param_shardings(cfg, rules)[2]
    placed = tP.unstack(tP.place_tree(
        params["blocks"]["pos0"]["ffn"], specs["blocks"]["pos0"]["ffn"],
        rules.mesh), cfg.n_repeats)[0]
    with torch.no_grad():
        exp, exp_aux = tmoe.moe_ffn(cfg, p, x, cfg.act)
        got, got_aux = tmoe.moe_ffn_sharded(cfg, lay, placed,
                                            list(x.chunk(2)), cfg.act)
    torch.testing.assert_close(torch.cat(got), exp, rtol=1e-5, atol=1e-6)
    for k in exp_aux:
        torch.testing.assert_close(got_aux[k], exp_aux[k], rtol=1e-6,
                                   atol=0)
    if not grouped:
        sel = tmoe._router(cfg, x.float(), p["router"])[1]
        _, rows = tmoe._global_dispatch(cfg, lay, list(sel.chunk(2)))
        kept = torch.cat([keep for _, _, keep in rows])
        t = x.shape[0] * x.shape[1]
        flat = sel.reshape(-1)
        hot = torch.nn.functional.one_hot(flat, cfg.moe.num_experts)
        pos = (torch.cumsum(hot, 0) - hot).gather(1, flat[:, None])[:, 0]
        assert torch.equal(kept, pos < tmoe._capacity(t, cfg))
        assert 0 < int((~kept).sum())


@pytest.mark.parametrize("heads,kv,model", [(4, 2, 4), (32, 2, 4),
                                              (6, 3, 2)])
def test_attention_over_kv_heads_that_fall_back(heads, kv, model):
    """Where the KV heads do not split over ``model``, each position's
    q heads read their own KV heads: a slice where the kernel's grouping
    maps them (glm4's 2 KV heads on 4 positions), else each q head's KV
    head given to it (6 q heads over 3 KV heads on 2 positions)."""
    from repro_torch.models import attention as tatt
    lo_hi = [tatt.kv_heads_of(heads, kv, heads // model, j)
             for j in range(model)]
    for j, (lo, hi, idx) in enumerate(lo_hi):
        want = [(j * (heads // model) + i) // (heads // kv)
                for i in range(heads // model)]
        got = (list(range(lo, hi)) if idx is None else idx.tolist())
        if idx is None:
            g = (heads // model) // (hi - lo)
            got = [lo + i // g for i in range(heads // model)]
        assert got == want
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(),
                              n_heads=heads, n_kv_heads=kv, head_dim=16)
    rules = _rules((1, model))
    np_params = _np_params(cfg, seed=6)
    tokens = _batch(cfg, 2, seed=6)["tokens"]
    exp = _prefill(cfg, np_params, tokens, None)
    got = _prefill(cfg, np_params, tokens, rules)
    assert _rel(got, exp) <= 1e-5
    assert any("kv_heads" in f for f in rules.fallbacks)


@pytest.mark.parametrize("arch,changes", [
    ("deepseek-v2-lite-16b", {"seqshard": True}),
    ("rwkv6-7b", {"seqshard": True}),
    ("jamba-1.5-large-398b", {"seqshard": True}),
    ("whisper-large-v3", {"seqshard": True}),
    ("internvl2-76b", {"seqshard": True}),
    ("qwen3-14b", {"adafactor": True, "seqshard": True}),
    ("qwen3-14b", {"seqshard": True})])
def test_unported_families_raise(arch, changes):
    """A sequence split on a mesh of more than one device runs for
    every family (it raised before the split was ported; the name is
    kept): one step of the reduced model on a model axis of 2 with
    ``act_rules["seq"]``, held to the unsharded step as
    ``_check_family`` holds it; Adafactor's ``init`` takes placed params;
    decode takes any mesh."""
    cfg = get_config(arch).reduced()
    rules = _rules((1, 2))
    if changes.get("seqshard"):
        rules.act_rules["seq"] = ("model",)
    opt = "adafactor" if changes.get("adafactor") else "adamw"
    _check_family((arch, arch, (1, 2), {}, opt, 8, 1, False), rules)
    if changes.get("adafactor"):
        placed = tST.place_params(cfg, tP.from_numpy(_np_params(cfg),
                                                     "cpu"), rules)
        assert isinstance(tO.adafactor().init(placed)["slots"]["embed"][
            "table"]["v_row"], R.Parts)
    tST.make_decode_step(cfg, rules=rules)          # any mesh


def _matmuls_in_backward(cfg, params, batch):
    """The matmuls without batch dims (``mm``, ``addmm``, a ``bmm`` of
    one batch) that the backward of one loss runs, recomputation
    included."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten

    class Log(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (aten.mm.default, aten.addmm.default) or (
                    func is aten.bmm.default and args[0].shape[0] == 1):
                Log.n += 1
            return func(*args, **(kwargs or {}))

    tracked = tP.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tP.tree_leaves(tracked)
    loss, _ = tT.loss_fn(cfg, tracked, batch, torch.float32)
    with Log():
        torch.autograd.grad(loss, leaves, allow_unused=True)
    return Log.n


def test_remat_minimal_recomputes_no_projection():
    """Under ``minimal`` the backward runs the matmuls of ``none``'s
    backward and no more: the q / k / v / o projections, the MLP's and
    the head's outputs are kept; ``full`` recomputes them."""
    base = get_config("qwen3-14b").reduced()
    params = tP.from_numpy(_np_params(base, seed=5), "cpu")
    batch = _batch(base, 2, seed=5)
    n = {pol: _matmuls_in_backward(
        dataclasses.replace(base, remat_policy=pol), params, batch)
        for pol in ("none", "minimal", "full")}
    assert n["minimal"] == n["none"] < n["full"], n


def test_checkpoint_round_trip_across_meshes(tmp_path):
    cfg = get_config("qwen3-14b").reduced()
    rules = _rules((2, 2))
    batches = list(make_lm_batches(cfg.vocab, 4, 16, 4, seed=0))

    def job(steps, ckpt=None):
        return TrainJob(cfg=cfg, lr=LR, steps=steps, seed=0, log_every=1,
                        ckpt_dir=ckpt, rules=rules, device="cpu")
    full = train(job(4), iter(batches))
    ckpt = str(tmp_path / "ckpt")
    half = train(job(2, ckpt), iter(batches[:2]))
    opt = tO.adamw()
    like = tP.abstract_tree(tT.model_spec(cfg), torch.float32)
    params, state = tC.restore(ckpt, 2, like, opt.init(like))
    for (path, a), (_, b) in zip(tP.tree_items(params),
                                 tP.tree_items(half["params"])):
        assert torch.equal(a, b), path
    np_like = tP.to_numpy(params)
    jparams, jstate = jC.restore(ckpt, 2, np_like, jax.tree.map(
        np.asarray, jO.adamw().init(jax.tree.map(jnp.asarray, np_like))))
    for (path, a), (_, b) in zip(
            tP.tree_items(params), tP.tree_items(jax.tree.map(np.asarray,
                                                             jparams))):
        assert np.array_equal(a.numpy(), b), path
    assert int(jstate["count"]) == int(state["count"]) == 2
    # resumed on the mesh: the uninterrupted run's last two steps
    placed = tST.place_params(cfg, params, rules)
    _, placed_again = tC.restore(ckpt, 2, placed, opt.init(placed))
    step = tST.make_train_step(cfg, opt, lr=LR, rules=rules,
                               compute_dtype=torch.float32)
    losses = []
    for b in batches[2:]:
        placed, placed_again, m = step(
            placed, placed_again,
            {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert losses == [r["loss"] for r in full["history"][2:]]
    for (path, a), (_, b) in zip(tP.tree_items(tP.whole_tree(placed)),
                                 tP.tree_items(full["params"])):
        assert torch.equal(a, b), path


def test_placement_and_collectives():
    mesh = M.make_mesh((2, 1, 2), AXES[3], ["cpu"] * 4)
    x = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    for spec in [R.P(("pod", "data"), "model"), R.P("model", None),
                 R.P(None, ("pod", "model")), R.P()]:
        parts = R.place(x, spec, mesh)
        assert torch.equal(parts.whole(), x)
    parts = R.place(x, R.P("pod", "model"), mesh)
    assert len(parts.parts) == 4
    assert torch.equal(parts.part(pod=1, model=0), x[2:, :4])
    ps = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]),
          torch.tensor([5.0, 6.0])]
    assert [t.tolist() for t in M.exclusive_prefix(ps, ["cpu"] * 3)] == \
        [[0.0, 0.0], [1.0, 2.0], [4.0, 6.0]]
    got = M.reduce_scatter(ps, ["cpu"] * 2, [(slice(0, 1),),
                                             (slice(1, 2),)])
    assert [t.tolist() for t in got] == [[9.0], [12.0]]
    # the all-gather's backward is the ordered reduce-scatter
    a, b = (t.clone().requires_grad_() for t in ps[:2])
    ga, gb = torch.autograd.grad(
        sum((i + 1) * o.sum() for i, o in enumerate(
            M.spread([a, b], [(slice(0, 2),), (slice(2, 4),)],
                     ["cpu"] * 3))), (a, b))
    assert ga.tolist() == gb.tolist() == [6.0, 6.0]
    # a param the model axis does not split reaches every position it
    # serves through one gather, whose backward sums them in mesh order
    mesh = M.make_mesh((2, 2), AXES[2], ["cpu"] * 4)
    lay = R.Layout(mesh, "data")
    w = R.place(torch.ones(4, 3).requires_grad_(), R.P("data", None), mesh)
    w.parts = [p.requires_grad_() for p in w.parts]
    got = lay.weights(w, 2)
    assert len({id(t.grad_fn) for col in got for t in col}) == 1
    gs = torch.autograd.grad(sum((2 * j + r + 1) * t.sum()
                                 for j, col in enumerate(got)
                                 for r, t in enumerate(col)), w.parts)
    assert [g[0, 0].item() for g in gs] == [10.0, 10.0]


# ---------------------------------------------------------------------------
# the mixer families: RWKV-6, Mamba (and the jamba hybrid), MLA; Adafactor
# ---------------------------------------------------------------------------

# jamba's first two layers, mamba + mlp and mamba + moe
JAMBA2 = {"n_layers": 2, "block_pattern": (("mamba", "mlp"),
                                           ("mamba", "moe"))}
_OPTS = {"adamw": tO.adamw, "adafactor": tO.adafactor}

# (id, arch, mesh shape, config changes, optimizer, batch, accum_steps,
# held to the JAX package's step too): every family on (2, 2), (1, 4)
# and (4, 1), accum_steps 1 and 2; a JAX run a family serves its meshes
MIXER_CASES = [
    ("rwkv6-2x2", "rwkv6-7b", (2, 2), {}, "adamw", 8, 1, True),
    ("rwkv6-1x4", "rwkv6-7b", (1, 4), {}, "adamw", 8, 1, True),
    ("rwkv6-4x1-accum2", "rwkv6-7b", (4, 1), {}, "adamw", 8, 2, False),
    # 6 heads of 32 do not split over model 4
    ("rwkv6-headfallback-1x4", "rwkv6-7b", (1, 4), {"d_model": 192},
     "adamw", 4, 1, False),
    ("minicpm3-2x2-accum2", "minicpm3-4b", (2, 2), {}, "adamw", 8, 2, True),
    ("minicpm3-4x1-accum2", "minicpm3-4b", (4, 1), {}, "adamw", 8, 2, True),
    ("minicpm3-adafactor-1x4-accum2", "minicpm3-4b", (1, 4), {}, "adafactor",
     8, 2, True),
    ("deepseek-1x4", "deepseek-v2-lite-16b", (1, 4), {}, "adamw", 8, 1,
     True),
    ("deepseek-2x2", "deepseek-v2-lite-16b", (2, 2), {}, "adamw", 8, 1,
     True),
    ("deepseek-4x1-accum2", "deepseek-v2-lite-16b", (4, 1), {}, "adamw",
     8, 2, False),
    ("deepseek-headfallback-1x4", "deepseek-v2-lite-16b", (1, 4),
     {"n_heads": 6}, "adamw", 4, 1, False),
    ("jamba2-2x2-adafactor", "jamba-1.5-large-398b", (2, 2), JAMBA2,
     "adafactor", 8, 1, True),
    ("jamba2-4x1", "jamba-1.5-large-398b", (4, 1), JAMBA2, "adamw", 8, 1,
     True),
    ("jamba2-1x4-accum2-adafactor", "jamba-1.5-large-398b", (1, 4), JAMBA2,
     "adafactor", 8, 2, False),
    # d_inner 258 does not split over model 4, 2 d_inner does: w_in alone
    # is split, the mixer runs whole at the row's home
    ("jamba2-dinnerfallback-1x4", "jamba-1.5-large-398b", (1, 4),
     dict(JAMBA2, d_model=129), "adafactor", 4, 1, False),
    # nor 2 d_inner over model 3: w_in is replicated too
    ("jamba2-winfallback-1x3", "jamba-1.5-large-398b", (1, 3), JAMBA2,
     "adamw", 4, 1, False),
]


def _assert_updates(opt, got, exp, g_got, g_exp):
    if opt == "adamw":
        assert_adamw_updates(got, exp, g_got, g_exp, LR)
        return
    for (path, a), (_, e) in zip(tP.tree_items(got), tP.tree_items(exp)):
        assert _rel(a, e) <= 1e-5, ("updated", path)


@pytest.mark.parametrize("case", MIXER_CASES, ids=[c[0] for c in MIXER_CASES])
def test_sharded_mixers_match_unsharded_and_jax(case):
    _check_family(case)


_PORT_RUNS = {}


def _unsharded(cfg, np_params, batch, accum, opt, steps, key):
    """The port's unsharded steps (``_port_steps``) and prefill logits of
    a ``_check_family`` case, run once a module for each ``key``: the
    sequence-split cases reuse their unsplit twins' reference."""
    if key not in _PORT_RUNS:
        stubs = {k: batch[k] for k in _stubs(cfg)}
        _PORT_RUNS[key] = (
            _port_steps(cfg, np_params, batch, None, accum, _OPTS[opt](),
                        steps),
            _prefill(cfg, np_params, batch["tokens"], None, **stubs))
    return _PORT_RUNS[key]


def _check_family(case, rules=None):
    """A ``MIXER_CASES``-like case: its steps on the mesh (``rules``,
    else the case's mesh shape's default rules) against the unsharded
    port's and, where the case says, the JAX package's."""
    _, arch, shape, changes, opt, b, accum, with_jax = case
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    rules = rules or _rules(shape)
    np_params = _np_params(cfg, seed=1)
    batch = _batch(cfg, b, seed=1)
    # Adafactor's first step reads no slot (beta2 = 0 at step 1): a
    # second step reads back the slots the first wrote
    steps = 2 if opt == "adafactor" else 1
    exp, exp_logits = _unsharded(cfg, np_params, batch, accum, opt, steps, (
        arch, repr(sorted(changes.items())), b, accum, opt))
    got = _port_steps(cfg, np_params, batch, rules, accum, _OPTS[opt](),
                      steps)
    (exp_p, exp_m, exp_g, exp_s), (got_p, got_m, got_g, got_s) = \
        exp[0], got[0]
    assert got_m.keys() == exp_m.keys()
    for k in exp_m:
        np.testing.assert_allclose(float(got_m[k]), float(exp_m[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    for (path, a), (_, e) in zip(tP.tree_items(got_g),
                                 tP.tree_items(exp_g)):
        assert _rel(a, e) <= 1e-5, ("grad", path)
    _assert_updates(opt, got_p, exp_p, got_g, exp_g)
    if opt == "adafactor":
        slots = [tP.tree_items(st["slots"]) for st in (got_s, exp_s)]
        assert [k for k, _ in slots[0]] == [k for k, _ in slots[1]]
        for (path, a), (_, e) in zip(*slots):
            assert _rel(a, e) <= 1e-5, ("slot", path)
        for (path, a), (_, e) in zip(tP.tree_items(got[1][0]),
                                     tP.tree_items(exp[1][0])):
            assert _rel(a, e) <= 1e-5, ("second step", path)
    # a second sharded run: the same bits
    _, again_m, again_g = _port_step(cfg, np_params, batch, rules, accum)
    assert float(again_m["loss"]) == float(got_m["loss"])
    for (path, a), (_, e) in zip(tP.tree_items(again_g),
                                 tP.tree_items(got_g)):
        assert torch.equal(a, e), ("rerun", path)
    stubs = {k: batch[k] for k in _stubs(cfg)}
    logits = _prefill(cfg, np_params, batch["tokens"], rules, **stubs)
    assert _rel(logits, exp_logits) <= 1e-5
    assert torch.equal(logits, _prefill(cfg, np_params, batch["tokens"],
                                        rules, **stubs))
    if "fallback" in case[0]:
        assert any(("heads" in f or "d_inner" in f) and "replicated" in f
                   for f in rules.fallbacks), rules.fallbacks
    if "winfallback" in case[0]:
        assert any(f"d_inner={2 * cfg.mamba.d_inner(cfg.d_model)}" in f
                   for f in rules.fallbacks), rules.fallbacks
    if with_jax:
        jg, jm, jl = _jax_ref(arch, changes, b, 1, accum)
        for k, v in got_m.items():
            np.testing.assert_allclose(float(v), jm[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for (path, a), (_, e) in zip(tP.tree_items(got_g),
                                     tP.tree_items(jg)):
            assert _rel(a, e) <= 1e-4, ("jax grad", path)
        assert _rel(logits, jl) <= 1e-5


def test_mamba_w_in_gradient_reaches_its_columns():
    """On a model axis of 2, ``w_in``'s model parts are its first and
    second 2 d_inner / 2 columns, all of u and all of z: position j
    computes with the columns j of both halves (``Layout.columns``), and
    the gradient the sharded mixer gives each part is the unsharded
    mixer's at that part's columns."""
    from repro_torch.models import mamba as tmamba
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              **JAMBA2)
    params = tP.from_numpy(_np_params(cfg, seed=4), "cpu")
    p = tP.tree_slice(params["blocks"]["pos0"]["mixer"], 0)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((2, 16, cfg.d_model))
                        .astype(np.float32))
    cot = torch.as_tensor(rng.standard_normal((2, 16, cfg.d_model))
                          .astype(np.float32))
    rules = _rules((1, 2))
    lay = R.Layout(rules.mesh, "data")
    specs = tST.resolve_param_shardings(cfg, rules)[2]
    placed = tP.unstack(tP.place_tree(
        params["blocks"]["pos0"]["mixer"], specs["blocks"]["pos0"]["mixer"],
        rules.mesh), cfg.n_repeats)[0]
    w_in = placed["w_in"]
    assert tuple(w_in.spec)[-1] == "model"
    w_in.parts = [t.detach().requires_grad_() for t in w_in.parts]
    got = tmamba.mamba_mixer_sharded(cfg, lay, placed, [x])[0]
    g_parts = torch.autograd.grad((got * cot).sum(), w_in.parts)
    whole = p["w_in"].detach().requires_grad_()
    exp = tmamba.mamba_mixer(cfg, dict(p, w_in=whole), x)
    g_whole, = torch.autograd.grad((exp * cot).sum(), whole)
    assert _rel(got.detach(), exp.detach()) <= 1e-5
    di = cfg.mamba.d_inner(cfg.d_model)
    for j, g in enumerate(g_parts):
        assert g.shape == (cfg.d_model, di)
        assert _rel(g, g_whole[:, j * di:(j + 1) * di]) <= 1e-5, j
    # each half's gradient is nonzero: neither half was left out
    assert all(float(g.abs().max()) > 0 for g in g_parts)


@pytest.mark.parametrize("arch,shape", [
    ("jamba-1.5-large-398b", (2, 2)), ("deepseek-v2-lite-16b", (1, 4)),
    ("rwkv6-7b", (4, 1)), ("granite-moe-3b-a800m", (2, 1, 2))])
def test_adafactor_places_its_slots_by_their_specs(arch, shape):
    """Adafactor's ``init`` of placed params gives each slot the spec
    its axes resolve to (``opt_state_specs``), a part a position on its
    device, all zero."""
    cfg = get_config(arch).reduced()
    rules = _rules(shape)
    opt = tO.adafactor()
    abstract, axes, _ = tST.resolve_param_shardings(cfg, rules,
                                                    torch.float32)
    _, want = tST.opt_state_specs(opt, abstract, axes, rules)
    placed = tST.place_params(cfg, tP.from_numpy(_np_params(cfg), "cpu"),
                              rules)
    state = opt.init(placed)

    def walk(got, spec, path=()):
        if isinstance(got, dict):
            for k in got:
                walk(got[k], spec[k], path + (k,))
            return
        if isinstance(got, R.Parts):
            assert tuple(got.spec) == tuple(spec), path
            for key, t in zip(got.keys, got.parts):
                assert t.shape == got.part_shape(key) and not t.any(), path
    walk(state, want)


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper) and the vision prefix (internvl2)
# ---------------------------------------------------------------------------

# (id, arch, mesh shape, config changes, optimizer, batch, accum_steps,
# held to the JAX package's step too), as MIXER_CASES: each model on
# (2, 2), (1, 4), (4, 1) with accum_steps 2 and a pod x data x model
# (2, 1, 2); whisper's 2 KV heads fall back on model 4; a JAX run a
# model serves its accum-1 meshes
ENC_VLM_CASES = [
    ("whisper-2x2", "whisper-large-v3", (2, 2), {}, "adamw", 8, 1, True),
    ("whisper-kvfallback-1x4", "whisper-large-v3", (1, 4), {}, "adamw", 8,
     1, True),
    ("whisper-4x1-accum2", "whisper-large-v3", (4, 1), {}, "adamw", 8, 2,
     False),
    ("whisper-pod2x1x2", "whisper-large-v3", (2, 1, 2), {}, "adamw", 8, 1,
     False),
    ("internvl2-2x2", "internvl2-76b", (2, 2), {}, "adafactor", 8, 1,
     True),
    ("internvl2-1x4-accum2", "internvl2-76b", (1, 4), {}, "adafactor", 8, 2,
     False),
    ("internvl2-4x1", "internvl2-76b", (4, 1), {}, "adafactor", 8, 1, True),
    ("internvl2-pod2x1x2", "internvl2-76b", (2, 1, 2), {}, "adafactor", 8,
     1, False),
]


@pytest.mark.parametrize("case", ENC_VLM_CASES,
                         ids=[c[0] for c in ENC_VLM_CASES])
def test_sharded_enc_vlm_match_unsharded_and_jax(case):
    """The frames or patches go with their tokens' rows: the encoder
    over the rows, the prefix prepended and masked out of each row's
    loss; the same tolerances as the mixer families'."""
    _check_family(case)


@pytest.mark.parametrize("model", [2, 4])
def test_mlp_sharded_adds_its_output_bias_once(model):
    """Whisper's biased MLP over ``mlp`` split across ``model``: the
    partial outputs summed, then ``b_down`` added once (each position
    adding it would count it ``model`` times)."""
    from repro_torch.models import layers as tlayers
    cfg = get_config("whisper-large-v3").reduced()
    params = tP.from_numpy(_np_params(cfg, seed=7), "cpu")
    p = tP.tree_slice(params["blocks"]["pos0"]["ffn"], 0)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    rules = _rules((1, model))
    specs = tST.resolve_param_shardings(cfg, rules)[2]
    placed = tP.unstack(tP.place_tree(
        params["blocks"]["pos0"]["ffn"], specs["blocks"]["pos0"]["ffn"],
        rules.mesh), cfg.n_repeats)[0]
    assert tuple(placed["w_down"].spec)[0] == "model"
    with torch.no_grad():
        got = tlayers.mlp_sharded(R.Layout(rules.mesh, "data"), placed,
                                  [x], cfg.act)[0]
        exp = tlayers.mlp(p, x, cfg.act)
    assert _rel(got, exp) <= 1e-5
    # the bias counted once a position would be far off
    assert _rel(got + (model - 1) * p["b_down"], exp) > 1e-2


# ---------------------------------------------------------------------------
# the sequence split (act_rules["seq"]): each row's residual stream as
# sequence cells over ``model`` between layers
# ---------------------------------------------------------------------------

# granite's reduced MoE at capacity factor 0.5: every step overflows an
# expert and drops assignments
_OVERFLOW = {"moe": dataclasses.replace(
    get_config("granite-moe-3b-a800m").reduced().moe, capacity_factor=0.5)}

# (id, arch, mesh shape, config changes, optimizer, batch, accum_steps,
# held to the JAX package's step too), as MIXER_CASES, each run with
# ``act_rules["seq"] = ("model",)``; a case held to JAX shares its key
# with a case above, so ``_jax_ref``'s run serves it. The 16-token rows
# (24 positions behind internvl2's 8 patches) cut into cells of 8 on
# model 2 and of 4 (6) on model 4: h2o's window of 5 and the recurrences'
# token shift and conv cross a cell boundary, internvl2's prefix spans
# cells 0 and 1; on model 3 qwen3's 16 positions do not divide (the
# spec falls back, recorded, and rows stay whole) and internvl2's
# tokens do not while its 24 positions do (cells of 8)
SEQ_CASES = [
    ("qwen3-2x2-accum2", "qwen3-14b", (2, 2), {}, "adamw", 8, 2, True),
    ("qwen3-tied-4x1-accum2", "qwen3-14b", (4, 1),
     {"tie_embeddings": True}, "adamw", 8, 2, False),
    ("h2o-window-pod2x1x2", "h2o-danube-1.8b", (2, 1, 2), {"window": 5},
     "adamw", 4, 1, False),
    ("glm4-kvfallback-1x4-accum2", "glm4-9b", (1, 4), {}, "adamw", 4, 2,
     False),
    ("granite-global-2x2", "granite-moe-3b-a800m", (2, 2), {}, "adamw", 8,
     1, True),
    ("granite-grouped-2x2-accum2", "granite-moe-3b-a800m", (2, 2),
     {"moe_group_dispatch": True}, "adamw", 8, 2, True),
    ("granite-moedp-pod2x1x2", "granite-moe-3b-a800m", (2, 1, 2),
     {"moe_expert_parallel": False}, "adamw", 8, 1, True),
    ("granite-global-overflow-1x4-minimal", "granite-moe-3b-a800m", (1, 4),
     dict(_OVERFLOW, remat_policy="minimal"), "adamw", 4, 1, False),
    ("granite-grouped-overflow-2x2-full", "granite-moe-3b-a800m", (2, 2),
     dict(_OVERFLOW, moe_group_dispatch=True, remat_policy="full"),
     "adamw", 4, 1, False),
    ("rwkv6-1x4", "rwkv6-7b", (1, 4), {}, "adamw", 8, 1, True),
    ("minicpm3-2x2-accum2", "minicpm3-4b", (2, 2), {}, "adamw", 8, 2, True),
    ("deepseek-1x4", "deepseek-v2-lite-16b", (1, 4), {}, "adamw", 8, 1,
     True),
    ("jamba2-2x2-adafactor", "jamba-1.5-large-398b", (2, 2), JAMBA2,
     "adafactor", 8, 1, True),
    ("whisper-2x2", "whisper-large-v3", (2, 2), {}, "adamw", 8, 1, True),
    ("internvl2-1x4", "internvl2-76b", (1, 4), {}, "adafactor", 8, 1,
     True),
    ("qwen3-indivisible-1x3", "qwen3-14b", (1, 3), {}, "adamw", 4, 1,
     False),
    ("internvl2-tokens-indivisible-1x3", "internvl2-76b", (1, 3), {},
     "adafactor", 4, 1, False),
]


@pytest.mark.parametrize("case", SEQ_CASES, ids=[c[0] for c in SEQ_CASES])
def test_sequence_split_matches_unsharded_and_jax(case):
    """The steps with a sequence split, at the unsharded step's and the
    JAX package's tolerances (``_check_family``); the residual stream is
    cut into cells where its whole length divides over ``model``, and a
    length that does not falls back, recorded in the JAX package's
    words."""
    _, arch, shape, changes, _, b, accum, _ = case
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    rules = _rules(shape)
    rules.act_rules["seq"] = ("model",)
    _check_family(case, rules)
    s_total = 16 + _stubs(cfg).get("patches", 0)
    lay, rows = tST._Rows(cfg, rules)(_batch(cfg, b // accum))
    assert lay.n_cells == (shape[-1] if s_total % shape[-1] == 0 else 1)
    assert all(t.shape[1] == 16 for t in rows["tokens"])
    fell_back = f"act: dim seq={s_total} not divisible by ('model',)"
    assert any(f.startswith(fell_back) for f in rules.fallbacks) == \
        (lay.n_cells == 1 and shape[-1] > 1)


@pytest.mark.parametrize("model", [2, 4])
def test_layout_cells_gather_and_reduce_scatter(model):
    """``Layout.leave`` cuts a row into its cells and sums partial rows
    into them, ``enter`` and ``whole`` gather the cells in order; the
    values and gradients of the whole tensor's ops, the same bits over
    two runs."""
    mesh = M.make_mesh((1, model), AXES[2], ["cpu"] * model)
    lay = R.Layout(mesh, "data", seq=True)
    assert lay.n_cells == model and R.Layout(mesh, "data").n_cells == 1
    rng = np.random.default_rng(8)
    parts = [torch.as_tensor(rng.standard_normal((2, 12, 3)).astype(
        np.float32)).requires_grad_() for _ in range(model)]
    weights = torch.as_tensor(rng.standard_normal((model, 2, 12, 3))
                              .astype(np.float32))

    def run():
        cells = lay.leave(0, parts)
        gathered = lay.enter(0, cells, model) + (lay.whole(0, cells),)
        loss = sum((w * g).sum() for w, g in zip(weights, gathered))
        return cells, gathered, torch.autograd.grad(loss, parts)
    cells, gathered, grads = run()
    total = sum(parts).detach()
    c = 12 // model
    assert [tuple(x.shape) for x in cells] == [(2, c, 3)] * model
    for j, x in enumerate(cells):
        torch.testing.assert_close(x, total[:, j * c:(j + 1) * c],
                                   rtol=1e-6, atol=1e-6)
    for g in gathered:
        torch.testing.assert_close(g, total, rtol=1e-6, atol=1e-6)
    # every part's gradient is the gathered rows' weights summed, and the
    # whole row's (the ``whole`` gather) once more
    want = weights.sum(0)
    for g in grads:
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)
    again = run()
    for a, b in zip(cells + list(gathered) + list(grads),
                    again[0] + list(again[1]) + list(again[2])):
        assert torch.equal(a, b)
    # one part: the row cut into its cells, its gradient the cells'
    x = total.clone().requires_grad_()
    cut = lay.leave(0, [x])
    assert torch.equal(torch.cat(cut, 1), total)
    g, = torch.autograd.grad(sum((j + 1) * t.sum()
                                 for j, t in enumerate(cut)), x)
    assert torch.equal(g, torch.arange(1, model + 1).float()
                       .repeat_interleave(c)[None, :, None].expand_as(x))


def test_rows_take_every_token_under_a_sequence_split():
    """With ``act_rules["seq"]`` the tokens' spec splits the sequence
    over ``model``, but a step's rows take the batch by its batch entry
    alone: each row holds all of its tokens, labels and patches, not the
    chunk at model position 0."""
    cfg = get_config("internvl2-76b").reduced()
    rules = _rules((2, 2))
    rules.act_rules["seq"] = ("model",)
    batch = _batch(cfg, 4)
    assert tuple(rules.act_spec(("batch", "seq"), (4, 16))) == \
        ("data", "model")
    lay, rows = tST._Rows(cfg, rules)(batch)
    assert lay.n_cells == 2 and len(lay.rows) == 2
    for k in ("tokens", "labels", "patches"):
        for r, t in enumerate(rows[k]):
            assert torch.equal(t, batch[k][2 * r:2 * (r + 1)]), (k, r)


@pytest.mark.parametrize("grouped", [False, True])
def test_moe_dispatch_over_cells_keeps_the_drops(grouped):
    """At capacity factor 0.5 experts overflow: over rows cut into
    sequence cells the layer gathers each row before routing, so its
    output, its drops and its router losses are the unsharded layer's,
    and its output comes back in cells."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(cfg, moe_group_dispatch=grouped, moe=(
        dataclasses.replace(cfg.moe, capacity_factor=0.5)))
    params = tP.from_numpy(_np_params(cfg, seed=3), "cpu")
    p = tP.tree_slice(params["blocks"]["pos0"]["ffn"], 0)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    rules = _rules((2, 2))
    lay = R.Layout(rules.mesh, "data", seq=True)
    specs = tST.resolve_param_shardings(cfg, rules)[2]
    placed = tP.unstack(tP.place_tree(
        params["blocks"]["pos0"]["ffn"], specs["blocks"]["pos0"]["ffn"],
        rules.mesh), cfg.n_repeats)[0]
    with torch.no_grad():
        exp, exp_aux = tmoe.moe_ffn(cfg, p, x, cfg.act)
        cells = [lay.leave(r, [row]) for r, row in enumerate(x.chunk(2))]
        got, got_aux = tmoe.moe_ffn_sharded(cfg, lay, placed, cells,
                                            cfg.act)
    assert all(len(row) == 2 and row[0].shape[1] == 8 for row in got)
    torch.testing.assert_close(torch.cat([torch.cat(row, 1) for row in got]),
                               exp, rtol=1e-5, atol=1e-6)
    for k in exp_aux:
        torch.testing.assert_close(got_aux[k], exp_aux[k], rtol=1e-6,
                                   atol=0)
