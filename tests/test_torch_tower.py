"""The PyTorch port's tower factory against the JAX package's: the same
spec layer, the same param layout (JAX-made params load through
``from_numpy``), the same forward on the CPU, the same analytic cost."""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import tower as jtwr  # noqa: E402
from repro_torch.models import tower as ttwr  # noqa: E402

NARROW = ("embed:tokens=4,dim=16", "attn_block:heads=2", "quantize",
          "mlp:hidden=16")
BENCH = ("embed:tokens=8,dim=64", "attn_block:heads=4", "quantize",
         "mlp:hidden=64")

VALID = [
    NARROW,
    BENCH,
    ("mlp:hidden=64|32,final_act=0",),
    ("embed", "mlp", "quantize"),
    ("embed:dim=8,buckets=4",
     {"kind": "attn", "heads": 2, "mlp": 12, "kernel": "ref"},
     "quantize:kernel=pallas", {"kind": "mlp", "hidden": (8,)}),
]

INVALID = [
    (),
    ("mlp", "embed"),
    ("attn_block:heads=2", "mlp"),
    ("embed", "mlp", "attn_block:heads=2", "mlp"),
    ("embed", "mlp", "embed:tokens=2"),
    ("embed",),
    ("mlp:widht=3",),
    ("wat",),
    ("mlp:hidden",),
    ("embed", "attn_block:heads=2,kernel=cuda", "mlp"),
    (3,),
    ({"hidden": (4,)},),
    ("embed:dim=10", "attn_block:heads=4", "mlp"),      # indivisible
]


@pytest.mark.parametrize("blocks", VALID)
def test_spec_layer_same_dicts(blocks):
    assert ttwr.check_blocks(blocks) == jtwr.check_blocks(blocks)
    tspec = ttwr.resolve(blocks, 13, 8)
    jspec = jtwr.resolve(blocks, 13, 8)
    assert tspec.blocks == jspec.blocks
    assert (tspec.in_dim, tspec.out_dim, tspec.kinds) == \
        (jspec.in_dim, jspec.out_dim, jspec.kinds)


@pytest.mark.parametrize("blocks", INVALID)
def test_spec_layer_same_rejections(blocks):
    with pytest.raises(ValueError) as jerr:
        jtwr.resolve(blocks, 5, 8)
    with pytest.raises(ValueError) as terr:
        ttwr.resolve(blocks, 5, 8)
    assert str(terr.value) == str(jerr.value)


def test_mlp_and_legacy_towers_match():
    assert ttwr.mlp_tower(5, (16,), 8).blocks == \
        jtwr.mlp_tower(5, (16,), 8).blocks
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert ttwr.legacy_dims_tower((5, 16, 8), final_act=False) \
            .blocks == jtwr.legacy_dims_tower((5, 16, 8),
                                              final_act=False).blocks


def _jax_params(spec, seed):
    return jax.tree.map(np.asarray,
                        jtwr.init(spec, jax.random.key(seed)))


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("blocks", [NARROW, BENCH,
                                    ("mlp:hidden=16|12",)])
def test_init_layout_matches_jax(blocks):
    spec = ttwr.resolve(blocks, 13, 8)
    mine = ttwr.init(spec, torch.Generator().manual_seed(0), "cpu")
    theirs = _jax_params(jtwr.resolve(blocks, 13, 8), 0)
    a = [(p, tuple(t.shape), t.dtype) for p, t in _leaves_with_paths(mine)]
    b = [(p, tuple(x.shape), torch.float32)
         for p, x in _leaves_with_paths(theirs)]
    assert a == b
    # the same seed gives the same tree; another seed another one
    again = ttwr.init(spec, torch.Generator().manual_seed(0), "cpu")
    other = ttwr.init(spec, torch.Generator().manual_seed(1), "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves_with_paths(mine), _leaves_with_paths(again)))
    assert not all(torch.equal(x, y) for (_, x), (_, y) in
                   zip(_leaves_with_paths(mine),
                       _leaves_with_paths(other)))


def _features(n, d, seed):
    # standardized features, as the recsys silos are
    return np.random.default_rng(seed).normal(size=(n, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("blocks,in_dim,out_dim", [
    (("mlp:hidden=16",), 12, 8),              # the legacy MLP tower
    (("mlp:hidden=16,final_act=0",), 8, 3),   # a top tower
    (NARROW, 13, 8),
])
def test_apply_matches_jax(blocks, in_dim, out_dim):
    jspec = jtwr.resolve(blocks, in_dim, out_dim)
    tspec = ttwr.resolve(blocks, in_dim, out_dim)
    params = _jax_params(jspec, 3)
    x = _features(32, in_dim, 5)
    # jitted, as the JAX protocols run their towers
    expect = np.asarray(jax.jit(functools.partial(jtwr.apply, jspec))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got = ttwr.apply(tspec, ttwr.from_numpy(params, "cpu"),
                         torch.from_numpy(x)).numpy()
    assert got.shape == expect.shape == (32, out_dim)
    # a quantize code may flip by one step when its input differs by an
    # ulp between the packages; at this size and seed none does, so the
    # plain float tolerance holds for every element
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


def test_embed_bucket_ids_identical():
    """The bucket ids are f32 chunk means (padding zeros included) then
    an int truncation: a mean on a bucket edge could flip between the
    packages. None sits on one for this data."""
    spec = ttwr.resolve(NARROW, 13, 8)
    b = spec.blocks[0]
    assert b["tokens"] * b["chunk"] > 13           # padding is exercised
    x = _features(32, 13, 5)
    _, ids = ttwr.embed_buckets(b, torch.from_numpy(x))

    @jax.jit
    def jax_ids(x):
        t, c, nb = b["tokens"], b["chunk"], b["buckets"]
        x = jnp.pad(x, ((0, 0), (0, t * c - x.shape[-1])))
        mean = jnp.mean(x.reshape(x.shape[0], t, c), axis=-1)
        return jnp.clip(((mean + jtwr._BUCKET_SPAN / 2)
                         * (nb / jtwr._BUCKET_SPAN)).astype(jnp.int32),
                        0, nb - 1)

    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax_ids(x)))


def test_from_numpy_roundtrip_and_cost():
    jspec = jtwr.resolve(NARROW, 13, 8)
    params = _jax_params(jspec, 1)
    tparams = ttwr.from_numpy(params, "cpu")
    back = ttwr.to_numpy(tparams)
    for (pa, a), (pb, b) in zip(_leaves_with_paths(params),
                                _leaves_with_paths(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    assert ttwr.params_bytes(tparams) == jtwr.params_bytes(params)
    tspec = ttwr.resolve(NARROW, 13, 8)
    for batch in (1, 32, 512):
        assert ttwr.tower_flops(tspec, batch) == \
            jtwr.tower_flops(jspec, batch)


def test_kernel_pallas_on_cpu_raises():
    spec = ttwr.resolve(("embed:tokens=4,dim=16",
                         "attn_block:heads=2,kernel=pallas", "mlp"), 13, 8)
    params = ttwr.init(spec, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="kernel='pallas'"):
        ttwr.apply(spec, params, torch.zeros((2, 13)))
