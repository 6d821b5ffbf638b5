"""Checkpoints between the two packages, on the CPU.

A JAX checkpoint (``repro.train.checkpoint.save``: params with bf16
leaves, an AdamW state with its int32 ``count``) restores into the port
(``repro_torch.train.checkpoint.restore``) bit for bit, dtypes included,
and a port checkpoint into the JAX package; both write the same keys.
``latest_step`` reads either. A port checkpoint of the reduced
granite's params restores on the meta-device ``abstract_tree`` too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jC  # noqa: E402
from repro.train import optimizer as jO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.train import checkpoint as tC  # noqa: E402
from repro_torch.train import optimizer as tO  # noqa: E402


def _jax_tree(seed):
    rng = np.random.default_rng(seed)
    params = {
        "blocks": {"pos0": {"w": rng.standard_normal((2, 4, 3)),
                            "norm": rng.standard_normal((2, 4))}},
        "embed": {"table": rng.standard_normal((5, 4))},
        "z_bf16": rng.standard_normal((3, 2)),
        "a_last": rng.standard_normal((4,)),
    }
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    params["z_bf16"] = params["z_bf16"].astype(jnp.bfloat16)
    return params


def _as_np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    if x.dtype == jnp.bfloat16:
        return np.asarray(x).view(np.int16), "bfloat16"
    return np.asarray(x), str(np.asarray(x).dtype)


def _assert_same(torch_tree, jax_tree):
    t = dict(tP.tree_items(torch_tree))
    j = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
         leaf for path, leaf in jax.tree_util.tree_flatten_with_path(
             jax_tree)[0]}
    assert t.keys() == j.keys()
    for path in t:
        (a, da), (b, db) = _as_np(t[path]), _as_np(j[path])
        assert da == db and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    params = _jax_tree(0)
    opt = jO.adamw()
    state = opt.init(params)
    g = jax.tree.map(lambda p: jnp.ones_like(p) * 0.1, params)
    params, state = opt.update(g, state, params, jnp.float32(1e-2))
    jC.save(str(tmp_path), 7, params, state, extra={"arch": "x"})
    like = tP.tree_map(lambda _: torch.zeros(()), jax.tree.map(
        np.asarray, params))
    opt_like = tO.adamw().init(tP.tree_map(
        lambda a: torch.zeros(a.shape), jax.tree.map(np.asarray, params)))
    tp, ts = tC.restore(str(tmp_path), 7, like, opt_like)
    _assert_same(tp, params)
    _assert_same(ts, state)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 1
    assert tC.latest_step(str(tmp_path)) == 7


def test_port_checkpoint_restores_into_jax(tmp_path):
    params = _jax_tree(1)
    tp = tP.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32),
        params)
    topt = tO.adamw()
    ts = topt.init(tp)
    tp, ts = topt.update(tP.tree_map(lambda p: torch.full_like(p, 0.1), tp),
                         ts, tp, 1e-2)
    tC.save(str(tmp_path), 3, tp, ts)
    tC.save(str(tmp_path), 12, tp)
    jp, js = jC.restore(str(tmp_path), 3, params, jO.adamw().init(params))
    _assert_same(tp, jp)
    _assert_same(ts, js)
    assert jC.latest_step(str(tmp_path)) == 12 == tC.latest_step(
        str(tmp_path))
    with np.load(tmp_path / "step_00000003.npz") as data:
        assert "params/z_bf16|bf16" in data.files
        assert "opt/count" in data.files


def test_restore_onto_abstract_tree(tmp_path):
    cfg = get_config("granite-moe-3b-a800m").reduced()
    spec = tT.model_spec(cfg)
    params = tP.init_tree(spec, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    tC.save(str(tmp_path), 0, params)
    got, none = tC.restore(str(tmp_path), 0, tP.abstract_tree(spec))
    assert none is None
    for (pa, a), (pb, b) in zip(tP.tree_items(got), tP.tree_items(params)):
        assert pa == pb and a.device.type == "cpu" and torch.equal(a, b)
    assert tC.latest_step(str(tmp_path / "missing")) == -1
