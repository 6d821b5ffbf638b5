"""Sequence-sharded decode in the port on the CPU
(``models/decode_sharded.py`` and its branch in ``models/transformer.py``).

At ``tests/test_sharded_decode.py``'s model, the reduced glm4 with 4
heads, 2 KV heads of 32 (b 4, 16 positions), on a (2, 4) ``data x
model`` mesh of the CPU device repeated: 16 decode steps with
``decode_partial_softmax`` under the rules against the JAX package's
unsharded ``decode_step`` on the same params and tokens, within its test's
2e-3 (the error itself is printed); the cache the sharded step returns
equals the unsharded step's (the owning slice wrote the new slot); the
branch is taken only under rules, with the flag and full attention; a
cache that does not split over the model axis raises.
(``tests/test_torch_sharding.py`` holds the same run to the JAX
package's own sharded decode.) The params and tokens are drawn with
numpy and go, the same arrays, through both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import params as JP, transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import decode_sharded as DS  # noqa: E402
from repro_torch.models import params as TP, transformer as TT  # noqa: E402
from repro_torch.sharding.rules import MeshRules  # noqa: E402

B, S = 4, 16


def _cfgs():
    small = dict(n_kv_heads=2, n_heads=4, head_dim=32)
    jcfg = dataclasses.replace(jget_config("glm4-9b").reduced(), **small)
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(), **small,
                              decode_partial_softmax=True)
    return cfg, jcfg


def _draw(rng, shapes):
    """Numpy params in ``shapes``' tree (``jax.eval_shape`` of the JAX
    package's init): N(0, 1 / fan_in) for a matrix, fan_in the product
    of all but its last dim; 1 + 0.1 N(0, 1) for a vector."""
    def leaf(s):
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree.map(leaf, shapes)


@pytest.fixture(scope="module")
def case():
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(0)
    params = _draw(rng, jax.eval_shape(lambda: JP.init_tree(
        JT.model_spec(jcfg), jax.random.PRNGKey(0), jnp.float32)))
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    step = jax.jit(lambda p, t, c, i: JT.decode_step(jcfg, p, t, c, i, None,
                                                     jnp.float32))
    cache = JT.init_cache(jcfg, B, S, jnp.float32)
    logits = []
    for i in range(S):
        lg, cache = step(params, toks[:, i:i + 1], cache, i)
        logits.append(np.asarray(lg[:, 0]))
    return {"cfg": cfg,
            "params": TP.from_numpy(params, "cpu"), "toks": toks,
            "logits": np.stack(logits, 1)}


def _decode(cfg, params, toks, rules, steps=S):
    step = ST.make_decode_step(cfg, rules, torch.float32)
    cache = TT.init_cache(cfg, B, S, torch.float32, "cpu")
    out = []
    for i in range(steps):
        logits, cache = step(params, torch.tensor(toks[:, i:i + 1]), cache, i)
        out.append(logits[:, 0].numpy())
    return np.stack(out, 1), cache


def test_sharded_decode_matches_jax_unsharded(case):
    rules = MeshRules(make_local_mesh(2, 4, devices=["cpu"] * 8))
    got, cache = _decode(case["cfg"], case["params"], case["toks"], rules)
    err = float(np.abs(got - case["logits"]).max())
    print(f"sharded decode vs the JAX package's unsharded decode: "
          f"{err:.3e} (bound 2e-3)")
    assert err < 2e-3, err
    plain, plain_cache = _decode(case["cfg"], case["params"], case["toks"],
                                 None)
    for (p, a), (_, b) in zip(TP.tree_items(cache),
                              TP.tree_items(plain_cache)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{p}: {m}")


def test_branch_needs_rules_the_flag_and_full_attention(case, monkeypatch):
    calls = []
    orig = DS.sharded_decode_attention
    monkeypatch.setattr(TT, "sharded_decode_attention",
                        lambda *a: calls.append(1) or orig(*a))
    rules = MeshRules(make_local_mesh(1, 2, devices=["cpu"] * 2))
    cfg = case["cfg"]
    _decode(cfg, case["params"], case["toks"], None, steps=1)
    _decode(dataclasses.replace(cfg, decode_partial_softmax=False),
            case["params"], case["toks"], rules, steps=1)
    assert not calls
    _decode(cfg, case["params"], case["toks"], rules, steps=1)
    assert len(calls) == cfg.n_layers


def test_cache_must_split_over_the_model_axis(case):
    rules = MeshRules(make_local_mesh(1, 3, devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="16 slots do not split over a "
                                         "model axis of 3"):
        _decode(case["cfg"], case["params"], case["toks"], rules, steps=1)
