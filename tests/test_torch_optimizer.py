"""The port's optimizers (``repro_torch/train/optimizer.py``) against the
JAX package's, on the CPU, from one numpy tree.

Params of mixed ranks (a stacked 3-d leaf, matrices, a vector, a
scalar; f32 and one bf16 leaf for SGD-momentum) and three steps of
gradients, all made with numpy, go through both packages' ``init`` and
``update``: the params and every state leaf (``count`` included, an
int32 scalar in both) agree at rtol 1e-6 after each step. The port
updates in place, here on copies. Also ``warmup_cosine``'s values and
``state_axes``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as jO  # noqa: E402
from repro_torch.models.params import tree_items, tree_map  # noqa: E402
from repro_torch.train import optimizer as tO  # noqa: E402

SHAPES = {"blocks": {"w": (3, 6, 5), "norm": (3, 5)},
          "embed": {"table": (7, 5)}, "bias": (5,), "gain": ()}
LR = 3e-2


def _tree(rng, scale=1.0):
    def leaf(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"blocks": {k: leaf(s) for k, s in SHAPES["blocks"].items()},
            "embed": {"table": leaf(SHAPES["embed"]["table"])},
            "bias": leaf(SHAPES["bias"]), "gain": leaf(SHAPES["gain"])}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _assert_trees_close(got, exp, rtol):
    g, e = dict(tree_items(got)), dict(tree_items(jax.tree.map(
        lambda x: x, exp)))
    assert g.keys() == e.keys()
    for path in g:
        a, b = _np(g[path]), _np(e[path])
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-7,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("name", ["sgdm", "adamw", "adafactor"])
def test_three_updates_match_jax(name):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.1 * (s + 1)) for s in range(3)]
    jopt, topt = jO.make_optimizer(name), tO.make_optimizer(name)
    if name == "sgdm":      # a bf16 leaf, with a decay that reads it
        jopt, topt = jO.sgdm(0.9, 1e-2), tO.sgdm(0.9, 1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(lambda a: torch.tensor(a), params)
    if name == "sgdm":
        jp["bias"] = jp["bias"].astype(jnp.bfloat16)
        tp["bias"] = tp["bias"].to(torch.bfloat16)
    js, ts = jopt.init(jp), topt.init(tp)
    _assert_trees_close(ts, js, 0)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.asarray(LR, jnp.float32))
        tp, ts = topt.update(tree_map(lambda a: torch.tensor(a), g), ts,
                             tp, LR)
        _assert_trees_close(tp, jp, 1e-6)
        _assert_trees_close(ts, js, 1e-6)
    assert ts.get("count", torch.zeros((), dtype=torch.int32)).dtype \
        == torch.int32


def test_update_in_slices_equals_whole(monkeypatch):
    """A leaf above ``CHUNK`` elements is updated slice by slice: the
    same values as one pass over it."""
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 50)).astype(np.float32)}
    grads = {"w": rng.standard_normal((4, 50)).astype(np.float32)}
    outs = []
    for chunk in (tO.CHUNK, 64):
        monkeypatch.setattr(tO, "CHUNK", chunk)
        opt = tO.adamw()
        p = tree_map(torch.tensor, params)
        s = opt.init(p)
        for _ in range(2):
            p, s = opt.update(tree_map(torch.tensor, grads), s, p, LR)
        outs.append((p["w"], s["m"]["w"], s["v"]["w"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_warmup_cosine_matches_jax():
    jl, tl = jO.warmup_cosine(3e-3, 10, 100), tO.warmup_cosine(3e-3, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 130):
        a, b = np.float32(tl(step)), np.float32(jl(step))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                   err_msg=str(step))


@pytest.mark.parametrize("name", ["sgdm", "adamw", "adafactor"])
def test_state_axes_match_jax(name):
    axes = {"blocks": {"w": ("layers", "embed", "mlp"),
                       "norm": ("layers", "embed")},
            "bias": ("embed",), "gain": ()}
    assert tO.make_optimizer(name).state_axes(axes) == \
        jO.make_optimizer(name).state_axes(axes)
