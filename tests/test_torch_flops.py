"""The port's analytic cost model and abstract param trees against the
JAX package's, on the CPU.

``repro_torch.launch.flops`` (``step_flops``, ``train_flops``,
``model_flops``, ``step_bytes``) gives the JAX package's numbers exactly
for every architecture and every ``SHAPES`` entry, and
``params.abstract_tree`` / ``axes_tree`` give its shapes, dtypes and
logical axes, path for path, for every config the port builds (full
size: nothing is allocated on either side).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import flops as jF  # noqa: E402
from repro.models import params as jP  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import flops as tF  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

PORTED = ["rwkv6-7b", "granite-moe-3b-a800m", "glm4-9b", "qwen3-14b",
          "h2o-danube-1.8b", "jamba-1.5-large-398b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", list_archs())
def test_cost_model_matches_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert SHAPES.keys() == JSHAPES.keys()
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        for fn in ("step_flops", "train_flops", "model_flops"):
            assert getattr(tF, fn)(cfg, shape) == \
                getattr(jF, fn)(jcfg, jshape), (fn, name)
        for pb, ob in ((2, 0), (4, 8)):
            assert tF.step_bytes(cfg, shape, pb, ob) == \
                jF.step_bytes(jcfg, jshape, pb, ob), name


def _jax_items(tree, is_leaf=None):
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_abstract_and_axes_trees_match_jax(arch, dtype):
    spec, jspec = tT.model_spec(get_config(arch)), \
        jT.model_spec(jget_config(arch))
    got = dict(tP.tree_items(tP.abstract_tree(spec, getattr(torch, dtype))))
    exp = _jax_items(jP.abstract_tree(jspec, getattr(jnp, dtype)))
    assert got.keys() == exp.keys()
    for path, t in got.items():
        assert t.is_meta, path
        assert tuple(t.shape) == exp[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == \
            str(exp[path].dtype), path
    axes = tP.axes_tree(spec)
    got_axes = {path: ax for path, ax in _items_to_tuples(axes)}
    exp_axes = _jax_items(jP.axes_tree(jspec),
                          is_leaf=lambda x: isinstance(x, tuple))
    assert got_axes == exp_axes


def _items_to_tuples(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items_to_tuples(tree[k], path + (k,))
    else:
        yield path, tree
