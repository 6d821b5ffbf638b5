"""Mesh-mode VFL in the port on the CPU: the pairwise masks, the masked
step and the VFL x LLM example, against the JAX package.

* Masks (``core/secure_agg``): each pair's draws cancel in the sum (to
  the bit for two parties, within 1e-6 up to four), and every mask is a
  pure function of (seed, i, j).
* ``make_mesh_vfl_step`` on a pod axis of 2 and 3 positions (the CPU
  device repeated), masked and not, against ``jax.value_and_grad`` of
  the JAX package's unsharded loss and a plain SGD step, over 3 steps at
  ``tests/test_system.py``'s shapes: loss within rtol 1e-6, params
  within 1e-5, and the gradient's scale (the update over lr against the
  JAX gradient) 1: a sum whose backward added the cotangents of every
  position would give n. (``tests/test_torch_sharding.py`` holds the
  step to the JAX package's own ``make_mesh_vfl_step`` as well.)
* ``repro_torch.examples.vfl_llm`` on the reduced granite: its first two
  masked steps against a JAX loss written as ``examples/vfl_llm.py``'s
  but unmasked and unsharded, on the same numpy inputs: loss within
  rtol 1e-5, every update within 1e-4 of its leaf's largest.

Every input (params, features, labels) is drawn with numpy and goes, the
same arrays, through both packages.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.protocols.split_nn import _bce as jbce  # noqa: E402
from repro.core.protocols.split_nn import mlp_apply as jmlp_apply  # noqa: E402
from repro.core.protocols.split_nn import mlp_init as jmlp_init  # noqa: E402
from repro.core.vfl_step import init_party_params as jinit_party  # noqa: E402
from repro.models import params as JP, transformer as JT  # noqa: E402
from repro.models.layers import softmax_xent as jxent  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import secure_agg as SA  # noqa: E402
from repro_torch.core import vfl_step as V  # noqa: E402
from repro_torch.examples import vfl_llm  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import tower as twr  # noqa: E402

LR = 0.1


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


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
def test_pairwise_masks_cancel(n):
    masks = [SA.pairwise_mask(11, p, n, (64, 32)) for p in range(n)]
    total = SA.aggregate(masks)
    if n == 2:
        assert torch.count_nonzero(total) == 0
    assert float(total.abs().max()) <= 1e-6
    assert all(float(m.abs().max()) > 1.0 for m in masks)


def test_masks_are_a_pure_function_of_seed_and_pair():
    assert SA.pair_seed(5, 1, 3) == SA.pair_seed(5, 3, 1)
    assert SA.pair_seed(5, 1, 3) != SA.pair_seed(6, 1, 3)
    assert SA.pair_seed(5, 1, 3) != SA.pair_seed(5, 1, 2)
    a = SA.pairwise_mask(5, 0, 3, (8,))
    assert torch.equal(a, SA.pairwise_mask(5, 0, 3, (8,)))
    assert not torch.equal(a, SA.pairwise_mask(6, 0, 3, (8,)))

    def draw(i, j):
        g = torch.Generator().manual_seed(SA.pair_seed(5, i, j))
        return torch.randn((8,), generator=g)
    # party 1 of 3 adds the pair below it negated, the pair above it
    assert torch.equal(SA.pairwise_mask(5, 1, 3, (8,)),
                       (torch.zeros(8) - draw(0, 1)) + draw(1, 2))
    x = torch.linspace(-1, 1, 8)
    got = SA.aggregate([SA.mask_contribution(5, p, 3, x) for p in range(3)])
    torch.testing.assert_close(got, 3 * x, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the masked mesh step against the JAX package's unsharded gradient
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_case(n):
    rng = np.random.default_rng(n)
    key = jax.random.PRNGKey(0)
    bottoms = _draw(rng, jax.eval_shape(lambda: jinit_party(key, n, 6, (8,),
                                                            4)))
    top = _draw(rng, jax.eval_shape(lambda: jmlp_init(key, (4, 8, 2))))
    x = rng.standard_normal((n, 16, 6)).astype(np.float32)
    y = (rng.random((16, 2)) < 0.5).astype(np.float32)

    def loss_fn(b, t):
        agg = jmlp_apply(jax.tree.map(lambda a: a[0], b), x[0],
                         final_act=True)
        for p in range(1, n):
            agg = agg + jmlp_apply(jax.tree.map(lambda a: a[p], b), x[p],
                                   final_act=True)
        return jbce(jmlp_apply(t, agg), y)
    return bottoms, top, x, y, \
        jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("use_masks", [True, False])
def test_mesh_vfl_step_matches_jax_unsharded(n, use_masks):
    jb, jt, x, y, grad_fn = _jax_case(n)
    mesh = make_mesh((n,), ("pod",), ["cpu"] * n)
    b = V.place_party_params(jb, mesh)
    t = twr.from_numpy(jt, "cpu")
    step = V.make_mesh_vfl_step(mesh, n, lr=LR, use_masks=use_masks)
    for i in range(3):
        loss_j, (gb, gt) = grad_fn(jb, jt)
        old = jax.tree.leaves((twr.to_numpy(V.stack_party_params(b)),
                               twr.to_numpy(t)))
        b, t, loss = step(b, t, torch.tensor(x), torch.tensor(y),
                          SA.fold_in(3, i))
        new = jax.tree.leaves((twr.to_numpy(V.stack_party_params(b)),
                               twr.to_numpy(t)))
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
        # the update over lr against the JAX package's gradient
        got = np.concatenate([((o - w) / np.float32(LR)).ravel()
                              for o, w in zip(old, new)])
        want = np.concatenate([np.asarray(g).ravel() for g in
                               jax.tree.leaves((gb, gt))])
        scale = float(got @ want / (want @ want))
        assert abs(scale - 1.0) < 1e-4, scale
        jb = jax.tree.map(lambda p, g: p - LR * g, jb, gb)
        jt = jax.tree.map(lambda p, g: p - LR * g, jt, gt)
        for a, w in zip(new, jax.tree.leaves((jb, jt))):
            np.testing.assert_allclose(a, np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def test_mesh_vfl_step_guards():
    mesh = make_mesh((2,), ("pod",), ["cpu"] * 2)
    with pytest.raises(ValueError, match="2 positions for 3 parties"):
        V.make_mesh_vfl_step(mesh, 3)
    stacked = V.init_party_params(0, 2, 6, (8,), 4)
    assert [tuple(l["w"].shape) for l in stacked] == [(2, 6, 8), (2, 8, 4)]
    placed = V.place_party_params(stacked, mesh)
    back = V.stack_party_params(placed)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(stacked, back)
               for k in ("w", "b"))


# ---------------------------------------------------------------------------
# the VFL x LLM example
# ---------------------------------------------------------------------------


def test_vfl_llm_steps_match_jax_unmasked():
    n, b, d_feat, seq = (vfl_llm.N_PARTIES, vfl_llm.BATCH, vfl_llm.D_FEAT,
                         vfl_llm.SEQ)
    jcfg = jget_config("granite-moe-3b-a800m").reduced()
    cfg = get_config("granite-moe-3b-a800m").reduced()
    rng = np.random.default_rng(0)
    backbone = _draw(rng, jax.eval_shape(lambda: JP.init_tree(
        JT.model_spec(jcfg), jax.random.PRNGKey(0), jnp.float32)))
    fronts = (rng.standard_normal((n, d_feat, seq * jcfg.d_model))
              * 0.02).astype(np.float32)
    x = rng.standard_normal((n, b, d_feat)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (b, seq)).astype(np.int32)

    def loss_fn(fr, bb):
        agg = sum((x[p] @ fr[p]).reshape(b, seq, jcfg.d_model)
                  for p in range(n))
        h, aux = JT._stack_forward(jcfg, bb, agg)
        h = JT._norm(jcfg, bb["final_norm"], h)
        logits = jnp.einsum("bsd,dv->bsv", h, bb["lm_head"]["w"])
        loss, _ = jxent(logits, labels)
        return loss + 0.01 * aux["load_balance"]
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))

    mesh = vfl_llm.silo_mesh("cpu", n)
    t_fronts = [torch.tensor(f) for f in fronts]
    t_back = TP.from_numpy(backbone, "cpu")
    t_x = [torch.tensor(xp) for xp in x]
    t_labels = torch.tensor(labels)
    step = vfl_llm.make_vfl_llm_step(cfg, mesh)
    for i in range(2):
        key = SA.fold_in(0, 100 + i)
        loss_j, (gf, gb) = grad_fn(fronts, backbone)
        # the update is -lr x the gradient: held leaf by leaf before the
        # step applies it
        loss, g_f, g_b = vfl_llm.vfl_llm_grads(cfg, mesh, t_fronts, t_back,
                                               t_x, t_labels, key)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        got = g_f + TP.tree_leaves(g_b)
        want = list(np.asarray(gf)) + [np.asarray(g)
                                       for g in jax.tree.leaves(gb)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            # the token embedding is not on this path: JAX's zeros
            g = np.zeros_like(w) if g is None else g.numpy()
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        loss = step(t_fronts, t_back, t_x, t_labels, key)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        fronts = fronts - vfl_llm.LR * gf
        backbone = jax.tree.map(lambda p, g: p - vfl_llm.LR * g, backbone,
                                gb)


def test_vfl_llm_example_runs_on_the_cpu(capsys):
    losses = vfl_llm.main(["--device", "cpu", "--steps", "3"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "trained OK" in capsys.readouterr().out
