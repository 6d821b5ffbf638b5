"""The port's sharding on the CPU: meshes, rule resolution, the
tensor-parallel member tower, and the sharded paths against the JAX
package's own sharded functions.

* Rule resolution: for every registered arch, every param leaf's
  (axes, shape) of both packages' ``model_spec`` and every activation of
  ``batch_specs`` / ``cache_specs`` resolve to equal specs with equal
  fallback lists, on shape-only meshes (16, 16) and (2, 16, 16) (as
  ``tests/test_sharding_optim.py``'s ``_FakeMesh``) and on the (1, 1)
  mesh of one device.
* Meshes: the default takes distinct CUDA devices and raises naming the
  count; an explicit list may repeat a device; the collectives combine
  in order into fresh tensors.
* The sharded tower at ``tests/test_tower.py``'s spec, model axis 2
  and 4 on the CPU device repeated: forward and the member's backward
  (``split_nn.member_step``) against the JAX package's unsharded ones
  within rtol 1e-5 / atol 1e-6; the device-count guard; a split-NN job
  with ``tower_shard=2`` against ``tower_shard=1``.
* ``--mesh`` training: the (1, 1) mesh gives the values of no mesh bit
  for bit; whisper-large-v3's train and prefill steps on a larger mesh
  with a sequence split give the unsharded step's loss and logits;
  decode takes any mesh.
* One JAX subprocess with 8 forced host devices (the test worker has
  one device, ``tests/conftest.py``) runs the JAX package's sharded
  tower (model 2 and 4), ``make_mesh_vfl_step`` (2 pods, masked, 3
  steps) and ``sharded_decode_attention`` (the reduced glm4 of
  ``tests/test_sharded_decode.py`` on a (2, 4) mesh, 16 steps) once a
  session (pytest-xdist's workers share it through a lock); the port's
  sharded counterparts are held to its numbers.

Every input (params, features, tokens) is drawn with numpy from seed 0
and goes, the same arrays, through both packages.
"""
import dataclasses
import fcntl
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.protocols.split_nn import mlp_init as jmlp_init  # noqa: E402
from repro.core.vfl_step import init_party_params as jinit_party  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.mesh import make_local_mesh as jmake_local_mesh  # noqa: E402
from repro.models import params as JP, transformer as JT  # noqa: E402
from repro.models import tower as jtwr  # noqa: E402
from repro.sharding.rules import MeshRules as JMeshRules  # noqa: E402
from repro.sharding.rules import PARAM_RULES as JPARAM_RULES  # noqa: E402
from repro.sharding.rules import TRAIN_RULES as JTRAIN_RULES  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.core import secure_agg as SA  # noqa: E402
from repro_torch.core import vfl_step as V  # noqa: E402
from repro_torch.core.party import run_vfl  # noqa: E402
from repro_torch.core.protocols import split_nn as tsn  # noqa: E402
from repro_torch.core.protocols.base import VFLConfig  # noqa: E402
from repro_torch.data.vertical import vertical_partition  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import params as TP, transformer as TT  # noqa: E402
from repro_torch.models import tower as twr  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.trainer import TrainJob, train  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOWER = ("embed:tokens=4,dim=16", "attn_block:heads=2", "mlp:hidden=16")


class _FakeMesh:
    """Shape-only stand-in, as ``tests/test_sharding_optim.py``'s."""

    def __init__(self, **shape):
        self.shape = shape


FAKE = {"16x16": dict(data=16, model=16),
        "2x16x16": dict(pod=2, data=16, model=16)}


def _jax_rules(mesh):
    """The JAX package's rules over a shape-only mesh (its dataclass
    init takes a real one)."""
    r = JMeshRules.__new__(JMeshRules)
    r.mesh, r.fallbacks, r.bf16_collectives = mesh, [], False
    r.param_rules, r.act_rules = dict(JPARAM_RULES), dict(JTRAIN_RULES)
    return r


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, tree


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


# ---------------------------------------------------------------------------
# inputs, drawn with numpy, shared with the JAX subprocess
# ---------------------------------------------------------------------------

GLM4_SMALL = dict(n_kv_heads=2, n_heads=4, head_dim=32)


def _glm4(get):
    """``tests/test_sharded_decode.py``'s reduced glm4 from ``get``
    (either package's ``get_config``)."""
    return dataclasses.replace(get("glm4-9b").reduced(), **GLM4_SMALL)


@functools.lru_cache(maxsize=None)
def _shapes():
    """The JAX package's param trees of every run, as shapes."""
    key = jax.random.PRNGKey(0)
    return {
        "tower": jax.eval_shape(lambda: jtwr.init(
            jtwr.resolve(TOWER, in_dim=5, out_dim=8), key)),
        "bottoms": jax.eval_shape(lambda: jinit_party(key, 2, 6, (8,), 4)),
        "top": jax.eval_shape(lambda: jmlp_init(key, (4, 8, 2))),
        "glm4": jax.eval_shape(lambda: JP.init_tree(
            JT.model_spec(_glm4(jget_config)), key, jnp.float32)),
    }


def _draw(rng, shapes):
    """Numpy params in ``shapes``' tree: N(0, 1 / fan_in) for a matrix,
    fan_in the product of all but its last dim; 1 + 0.1 N(0, 1) for a
    vector."""
    def leaf(s):
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree.map(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Every input by name; leaf i of param tree t is ``t.i``, in the
    JAX package's leaf order."""
    rng = np.random.default_rng(0)
    out = {}
    for name, shapes in _shapes().items():
        for i, a in enumerate(jax.tree.leaves(_draw(rng, shapes))):
            out[f"{name}.{i}"] = a
    out["tower_x"] = rng.standard_normal((32, 5)).astype(np.float32)
    out["tower_du"] = rng.standard_normal((32, 8)).astype(np.float32)
    out["vfl_x"] = rng.standard_normal((2, 16, 6)).astype(np.float32)
    out["vfl_y"] = (rng.random((16, 2)) < 0.5).astype(np.float32)
    out["toks"] = rng.integers(0, _glm4(jget_config).vocab, (4, 16)
                               ).astype(np.int32)
    return out


def _tree(name):
    """Param tree ``name`` of :func:`_inputs` (numpy)."""
    shapes = _shapes()[name]
    n = len(jax.tree.leaves(shapes))
    return jax.tree.unflatten(jax.tree.structure(shapes),
                              [_inputs()[f"{name}.{i}"] for i in range(n)])


# ---------------------------------------------------------------------------
# rule resolution against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_param_and_activation_specs_match_jax(arch, monkeypatch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    spec, jspec = TT.model_spec(cfg), JT.model_spec(jcfg)
    # the JAX package's batch_specs, with its stand-ins' packing taken
    # off: the logical axes it names, resolved by its own rules
    monkeypatch.setattr(
        jspecs, "_sds",
        lambda shape, dtype, rules, logical: rules.act_spec(logical, shape))
    for mesh in FAKE.values():
        tr, jr = R.MeshRules(_FakeMesh(**mesh)), _jax_rules(_FakeMesh(**mesh))
        got = R.param_shardings(tr, TP.axes_tree(spec), TP.abstract_tree(spec))
        want = jax.tree.map(
            lambda ax, sds: jr.spec(ax, sds.shape, jr.param_rules, "param"),
            JP.axes_tree(jspec), JP.abstract_tree(jspec), is_leaf=_is_axes)
        g, w = list(_flat(got)), list(_flat(want))
        assert [p for p, _ in g] == [p for p, _ in w]
        assert [tuple(s) for _, s in g] == [tuple(s) for _, s in w]
        assert tr.fallbacks == jr.fallbacks
        for name, sh in SHAPES.items():
            jsh = JSHAPES[name]
            tr.fallbacks.clear()
            jr.fallbacks.clear()
            for labels in (True, False):
                _, tb = tspecs.batch_specs(cfg, sh, tr, labels)
                jb = jspecs.batch_specs(jcfg, jsh, jr, labels)
                assert list(tb) == list(jb)
                assert all(tuple(tb[k]) == tuple(jb[k]) for k in tb)
            _, cache = tspecs.cache_specs(cfg, sh, tr, torch.float32)
            jabs = jax.eval_shape(lambda: JT.init_cache(
                jcfg, jsh.global_batch, jsh.seq_len, jnp.float32))
            jcache = jax.tree.map(lambda s, a: jr.act_spec(a, s.shape),
                                  jabs, jspecs.cache_axes(jcfg),
                                  is_leaf=lambda s: hasattr(s, "shape"))
            g, w = list(_flat(cache)), list(_flat(jcache))
            assert [p for p, _ in g] == [p for p, _ in w]
            for (path, t), (_, s) in zip(g, w):
                assert tuple(t) == tuple(s), path
            assert tr.fallbacks == jr.fallbacks, name


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m",
                                  "jamba-1.5-large-398b"])
def test_one_device_mesh_specs_match_jax(arch):
    """The real (1, 1) mesh: ``resolve_param_shardings`` and
    ``opt_state_specs`` against the JAX package's, whose shardings name
    these specs."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    tr = R.MeshRules(M.make_local_mesh(devices=["cpu"]))
    jr = JMeshRules(jmake_local_mesh())
    from repro.launch import steps as JST
    from repro.train import optimizer as JO
    ab, axes, specs = ST.resolve_param_shardings(cfg, tr)
    jab, jaxes, jsh = JST.resolve_param_shardings(jcfg, jr)
    got = [tuple(s) for _, s in _flat(specs)]
    want = [tuple(s.spec) for s in jax.tree.leaves(
        jsh, is_leaf=lambda x: hasattr(x, "spec"))]
    assert got == want
    opt, jopt = TO.make_optimizer(cfg.optimizer), JO.make_optimizer(
        jcfg.optimizer)
    st, st_specs = ST.opt_state_specs(opt, ab, axes, tr)
    jst = JST.opt_state_specs(jopt, jab, jaxes, jr)
    g = [(tuple(p.shape), tuple(s)) for (_, p), (_, s)
         in zip(_flat(st), _flat(st_specs))]
    w = [(tuple(s.shape), tuple(s.sharding.spec))
         for s in jax.tree.leaves(jst)]
    assert g == w
    assert tr.fallbacks == jr.fallbacks
    sh, jsh_ = SHAPES["train_4k"], JSHAPES["train_4k"]
    _, tb = tspecs.batch_specs(cfg, sh, tr, True)
    jb = jspecs.batch_specs(jcfg, jsh_, jr, True)
    assert {k: tuple(v) for k, v in tb.items()} == \
        {k: tuple(v.sharding.spec) for k, v in jb.items()}


def test_partition_spec_compares_as_the_jax_one():
    from jax.sharding import PartitionSpec as JP_
    assert R.PartitionSpec("data", None, ("pod", "data")) == \
        JP_("data", None, ("pod", "data"))
    assert R.PartitionSpec() == JP_()


def test_use_rules_nests_and_restores():
    outer = R.MeshRules(_FakeMesh(data=2, model=1))
    inner = R.MeshRules(_FakeMesh(data=1, model=2))
    assert R.current_rules() is None
    with R.use_rules(outer):
        assert R.current_rules() is outer
        with R.use_rules(inner):
            assert R.current_rules() is inner
        with pytest.raises(KeyError):
            with R.use_rules(None):
                assert R.current_rules() is None
                raise KeyError("x")
        assert R.current_rules() is outer
    assert R.current_rules() is None


# ---------------------------------------------------------------------------
# meshes and collectives
# ---------------------------------------------------------------------------


def test_mesh_takes_distinct_cuda_devices_or_raises():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=rf"needs {n + 1} CUDA device\(s\), "
                                         rf"but only {n}"):
        M.make_mesh((n + 1,), ("model",))
    mesh = M.make_local_mesh(2, 3, devices=["cpu"] * 6)
    assert mesh.shape == {"data": 2, "model": 3}
    assert M.mesh_chips(mesh) == 6
    assert mesh.axis_devices("model") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="needs 6 devices, 5 given"):
        M.make_local_mesh(2, 3, devices=["cpu"] * 5)
    prod = M.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}


def test_collectives_combine_in_order_into_fresh_tensors():
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(5, generator=g) * 10 ** i for i in range(4)]
    before = [p.clone() for p in parts]
    s = M.psum(parts, "cpu")
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(s, want)
    assert torch.equal(M.pmax(parts, "cpu"),
                       torch.stack(parts).max(0).values)
    assert torch.equal(M.all_gather(parts, 0, "cpu"), torch.cat(parts))
    same = M.psum([parts[0], parts[0]], "cpu")
    assert same.data_ptr() != parts[0].data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(parts, before))


# ---------------------------------------------------------------------------
# the tensor-parallel member tower
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tower_case():
    # the JAX package's plain attention (its Pallas kernel's reference);
    # the subprocess below runs its default, the kernel in interpret mode
    spec = jtwr.resolve(TOWER[:1] + ("attn_block:heads=2,kernel=ref",)
                        + TOWER[2:], in_dim=5, out_dim=8)
    params = _tree("tower")
    x, du = _inputs()["tower_x"], _inputs()["tower_du"]

    @jax.jit
    def fwd_bwd(p):
        out, vjp = jax.vjp(lambda q: jtwr.apply(spec, q, x), p)
        (g,) = vjp(du)
        return out, jax.tree.map(lambda a, gg: a - jnp.float32(0.1) * gg,
                                 p, g)
    out, new = fwd_bwd(params)
    return {"params": params, "x": x, "du": du, "out": np.asarray(out),
            "new": [np.asarray(a) for a in jax.tree.leaves(new)]}


def _port_sharded_tower(case, shard):
    spec = twr.resolve(TOWER, in_dim=5, out_dim=8)
    rules = twr.make_tower_rules(shard, devices=["cpu"] * shard)
    params = twr.shard_tower(twr.from_numpy(case["params"], "cpu"), spec,
                             rules)
    x = torch.tensor(case["x"])
    with torch.no_grad():
        out = twr.apply(spec, params, x, rules).numpy()
    new = tsn.member_step(spec, params, x, torch.tensor(case["du"]),
                          float(np.float32(0.1)), rules)
    return params, out, jax.tree.leaves(twr.to_numpy(new))


@pytest.mark.parametrize("shard", [2, 4])
def test_sharded_tower_matches_jax_unsharded(tower_case, shard):
    params, out, new = _port_sharded_tower(tower_case, shard)
    # every weight the logical axes split is split over the model axis
    split = [type(t).__name__ for t in jax.tree.leaves(
        params, is_leaf=lambda t: isinstance(t, twr.Shards))]
    assert split.count("Shards") == 13, split
    np.testing.assert_allclose(out, tower_case["out"], rtol=1e-5,
                               atol=1e-6)
    assert len(new) == len(tower_case["new"])
    for a, b in zip(new, tower_case["new"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_make_tower_rules_guards_device_count():
    assert twr.make_tower_rules(1) is None
    n = torch.cuda.device_count()
    with pytest.raises(ValueError,
                       match=rf"tower_shard=64 but only {n} local CUDA"):
        twr.make_tower_rules(64)
    with pytest.raises(ValueError, match="only 1 local cpu device"):
        twr.make_tower_rules(2, device="cpu")
    rules = twr.make_tower_rules(3, devices=["cpu"] * 3)
    assert rules.mesh.shape == {"data": 1, "model": 3}


def _silos():
    rng = np.random.default_rng(0)
    n = 96
    x = rng.normal(size=(n, 13)).astype(np.float32)
    y = (rng.random((n, 3)) < 0.3).astype(np.float32)
    ids = [f"u{i:04d}" for i in range(n)]
    return vertical_partition(ids, x, y, widths=[6], seed=1)


def _cfg(shard):
    return VFLConfig(protocol="split_nn", epochs=1, batch_size=32, lr=0.1,
                     embedding_dim=8, hidden=(16,), use_psi=False,
                     tower=TOWER, tower_shard=shard)


def test_split_nn_tower_shard_on_the_cpu(monkeypatch):
    """``tower_shard > 1`` asks for that many distinct devices of the
    party's type (the CPU has one); with the model axis placed on the
    CPU device repeated, the job's losses and the member's final tower
    are the unsharded job's."""
    master, members = _silos()
    with pytest.raises(RuntimeError, match="agent member0 failed") as err:
        run_vfl(_cfg(2), master, members, device="cpu")
    assert isinstance(err.value.__cause__, ValueError)
    assert "tower_shard=2 but only 1 local cpu device" in str(
        err.value.__cause__)
    base = run_vfl(_cfg(1), master, members, device="cpu")
    make = twr.make_tower_rules
    monkeypatch.setattr(twr, "make_tower_rules",
                        lambda shard, devices=None, device=None:
                        make(shard, devices=[device] * shard))
    got = run_vfl(_cfg(2), master, members, device="cpu")
    np.testing.assert_allclose(
        [h["loss"] for h in got["master"]["history"]],
        [h["loss"] for h in base["master"]["history"]], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(got["member0"]["params"]),
                    jax.tree.leaves(base["member0"]["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# --mesh training: one device gives the values of no mesh
# ---------------------------------------------------------------------------


def _train(rules):
    from repro_torch.data.synthetic import make_lm_batches
    cfg = get_config("qwen3-14b").reduced()
    job = TrainJob(cfg=cfg, lr=3e-3, steps=3, seed=0, rules=rules,
                   device="cpu", log_every=1)
    return train(job, make_lm_batches(cfg.vocab, 2, 16, 4, seed=0))


def test_one_device_mesh_trains_bit_equal_and_larger_meshes_raise():
    base = _train(None)
    got = _train(R.MeshRules(M.make_local_mesh(devices=["cpu"])))
    assert [r["loss"] for r in got["history"]] == \
        [r["loss"] for r in base["history"]]
    for (p, a), (_, b) in zip(TP.tree_items(got["params"]),
                              TP.tree_items(base["params"])):
        assert torch.equal(a, b), p
    cfg = get_config("whisper-large-v3").reduced()
    big = R.MeshRules(M.make_local_mesh(1, 2, devices=["cpu"] * 2))
    # the encoder-decoder builds on a larger mesh, and steps with a
    # sequence split: the unsharded step's loss and last logits
    ST.make_train_step(cfg, TO.adamw(), rules=big)
    ST.make_prefill_step(cfg, rules=big)
    big.act_rules["seq"] = ("model",)
    from repro_torch.data.synthetic import make_lm_batches
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v) for k, v in next(make_lm_batches(
        cfg.vocab, 2, 8, 1, seed=0)).items()}
    batch["frames"] = torch.as_tensor(rng.standard_normal(
        (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32) * 0.02)
    got = []
    for rules in (None, big):
        params = TP.init_tree(TT.model_spec(cfg),
                              torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
        if rules is not None:
            params = ST.place_params(cfg, params, rules)
        logits = ST.make_prefill_step(cfg, rules, torch.float32)(
            params, {k: v for k, v in batch.items() if k != "labels"})
        opt = TO.adamw()
        _, _, metrics = ST.make_train_step(
            cfg, opt, rules=rules, compute_dtype=torch.float32)(
                params, opt.init(params), batch)
        got.append((float(metrics["loss"]), logits))
    (exp_loss, exp_l), (loss, logits) = got
    np.testing.assert_allclose(loss, exp_loss, rtol=1e-6)
    assert float((logits - exp_l).abs().max()) <= \
        1e-5 * float(exp_l.abs().max())
    ST.make_decode_step(cfg, rules=big)          # any mesh


# ---------------------------------------------------------------------------
# the JAX package's sharded functions, once, in a subprocess
# ---------------------------------------------------------------------------

_JAX_MESH = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
inp = dict(np.load(sys.argv[1]))
out = {}
key = jax.random.PRNGKey(0)


def tree(name, init):
    shapes = jax.eval_shape(init)
    n = len(jax.tree.leaves(shapes))
    return jax.tree.unflatten(jax.tree.structure(shapes),
                              [jnp.asarray(inp[f"{name}.{i}"])
                               for i in range(n)])


from repro.models import tower as twr
from repro.core.protocols.split_nn import _make_member_fns
spec = twr.resolve(("embed:tokens=4,dim=16", "attn_block:heads=2",
                    "mlp:hidden=16"), in_dim=5, out_dim=8)
params = tree("tower", lambda: twr.init(spec, key))
x, du = jnp.asarray(inp["tower_x"]), jnp.asarray(inp["tower_du"])
for shard in (2, 4):
    rules = twr.make_tower_rules(shard)
    sh = twr.shard_tower(params, spec, rules)
    fwd, bwd = _make_member_fns(spec, rules)
    out[f"tower{shard}_out"] = np.asarray(fwd(sh, x))
    new = bwd(sh, x, du, jnp.float32(0.1))
    for i, leaf in enumerate(jax.tree.leaves(new)):
        out[f"tower{shard}_new{i}"] = np.asarray(leaf)
from repro.core.vfl_step import make_mesh_vfl_step, init_party_params
from repro.core.protocols.split_nn import mlp_init
from repro.launch.mesh import make_mesh
mesh = make_mesh((2,), ("pod",))
b = tree("bottoms", lambda: init_party_params(key, 2, 6, (8,), 4))
t = tree("top", lambda: mlp_init(key, (4, 8, 2)))
xv, y = jnp.asarray(inp["vfl_x"]), jnp.asarray(inp["vfl_y"])
step = make_mesh_vfl_step(mesh, 2, lr=0.1)
losses = []
with mesh:
    for i in range(3):
        b, t, loss = step(b, t, xv, y, jax.random.fold_in(key, i))
        losses.append(float(loss))
out["vfl_losses"] = np.asarray(losses)
for i, leaf in enumerate(jax.tree.leaves((b, t))):
    out[f"vfl_leaf{i}"] = np.asarray(leaf)
from repro.configs import get_config
from repro.models import params as PRM, transformer as T
from repro.launch import specs as S
from repro.launch.mesh import make_local_mesh
from repro.sharding.rules import MeshRules, use_rules
cfg = dataclasses.replace(get_config("glm4-9b").reduced(), n_kv_heads=2,
                          n_heads=4, head_dim=32,
                          decode_partial_softmax=True)
mesh = make_local_mesh(2, 4)
rules = MeshRules(mesh)
p = tree("glm4", lambda: PRM.init_tree(T.model_spec(cfg), key, jnp.float32))
bsz, s = 4, 16
toks = jnp.asarray(inp["toks"])
cache = T.init_cache(cfg, bsz, s, jnp.float32)
cache = jax.tree.map(
    lambda c, a: jax.device_put(
        c, NamedSharding(mesh, rules.act_spec(a, c.shape))),
    cache, S.cache_axes(cfg), is_leaf=lambda c: hasattr(c, "shape"))


def step_fn(pp, tk, ch, i):
    with use_rules(rules):
        return T.decode_step(cfg, pp, tk, ch, i, None, jnp.float32)


step = jax.jit(step_fn)
logits = []
with mesh:
    for i in range(s):
        lg, cache = step(p, toks[:, i:i + 1], cache, i)
        logits.append(np.asarray(lg[:, 0]))
out["decode_logits"] = np.stack(logits, 1)
np.savez(sys.argv[2], **out)
print("JAX_MESH_OK")
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The subprocess's numbers, made once a session: pytest-xdist's
    workers share one run through a lock in their common temp dir."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    ref = base / "jax_mesh_ref.npz"
    with open(base / "jax_mesh.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not ref.exists():
            inp, tmp = base / "jax_mesh_in.npz", base / "jax_mesh_tmp.npz"
            np.savez(inp, **_inputs())
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       JAX_PLATFORMS="cpu")
            r = subprocess.run(
                [sys.executable, "-c", _JAX_MESH, str(inp), str(tmp)],
                capture_output=True, text=True, timeout=120, env=env)
            assert "JAX_MESH_OK" in r.stdout, r.stderr[-3000:]
            os.replace(tmp, ref)
    return dict(np.load(ref))


@pytest.mark.parametrize("shard", [2, 4])
def test_sharded_tower_matches_jax_sharded(jax_mesh, tower_case, shard):
    _, out, new = _port_sharded_tower(tower_case, shard)
    np.testing.assert_allclose(out, jax_mesh[f"tower{shard}_out"],
                               rtol=1e-5, atol=1e-6)
    for i, a in enumerate(new):
        np.testing.assert_allclose(a, jax_mesh[f"tower{shard}_new{i}"],
                                   rtol=1e-5, atol=1e-6)


def test_mesh_vfl_step_matches_jax_mesh_step(jax_mesh):
    """The port's masked step against the JAX package's
    ``make_mesh_vfl_step``: the masks differ (each package its own
    draws), the losses and parameters agree."""
    bottoms, top = _tree("bottoms"), _tree("top")
    x, y = _inputs()["vfl_x"], _inputs()["vfl_y"]
    mesh = M.make_mesh((2,), ("pod",), ["cpu"] * 2)
    b = V.place_party_params(bottoms, mesh)
    t = twr.from_numpy(top, "cpu")
    step = V.make_mesh_vfl_step(mesh, 2, lr=0.1)
    losses = []
    for i in range(3):
        b, t, loss = step(b, t, torch.tensor(x), torch.tensor(y),
                          SA.fold_in(0, i))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_mesh["vfl_losses"], rtol=1e-6)
    got = jax.tree.leaves((twr.to_numpy(V.stack_party_params(b)),
                           twr.to_numpy(t)))
    for i, a in enumerate(got):
        np.testing.assert_allclose(a, jax_mesh[f"vfl_leaf{i}"], rtol=1e-5,
                                   atol=1e-6)


def test_sharded_decode_matches_jax_sharded(jax_mesh):
    cfg = dataclasses.replace(_glm4(get_config), decode_partial_softmax=True)
    params = TP.from_numpy(_tree("glm4"), "cpu")
    toks = _inputs()["toks"]
    rules = R.MeshRules(M.make_local_mesh(2, 4, devices=["cpu"] * 8))
    step = ST.make_decode_step(cfg, rules, torch.float32)
    cache = TT.init_cache(cfg, 4, 16, torch.float32, "cpu")
    out = []
    for i in range(16):
        logits, cache = step(params, torch.as_tensor(toks[:, i:i + 1]),
                             cache, i)
        out.append(logits[:, 0].numpy())
    err = float(np.abs(np.stack(out, 1) - jax_mesh["decode_logits"]).max())
    print(f"sharded decode vs the JAX package's sharded decode: {err:.3e}")
    assert err < 2e-3, err
