"""The PyTorch port's multi-head latent attention (MLA) and its two
models against the JAX package's, on the CPU, where attention and every
expert matmul take their plain versions.

* ``mla_spec`` and the whole model spec: the same leaves, shapes, axes,
  initializers and dtypes as the JAX package's, for the full
  ``deepseek-v2-lite-16b`` and ``minicpm3-4b`` (specs only, nothing
  allocated) and their reduced configs (q/k of 32 + 16 = 48 against v of
  32, so v is padded at the kernel's call; minicpm3 with a q-LoRA of 64,
  deepseek without).
* ``mla_self_attention`` within 1e-5, through ``ops.flash_attention``
  once with v padded to q's head dim and the padded output columns
  exactly 0; ``mla_decode_attention`` over 8 steps within 1e-5, cache
  included, the last write past the cache's end clamped to its last
  slot as ``lax.dynamic_update_slice`` clamps it.
* The reduced models, on params drawn with numpy (the norms' scales
  away from 1) and loaded into both packages: ``forward`` logits within 1e-4 (one attention call a
  layer), ``score`` with the router losses, ``decode_step`` logits and
  cache, greedy ``generate`` tokens equal, the loss and its gradients
  against ``jax.value_and_grad`` (every gradient within 1e-4 of its
  leaf's largest, as ``tests/test_torch_lm_train.py`` holds them), and
  decode against the port's own prefill.

The JAX side of each model comes from one module-scoped fixture: one
jitted forward-and-gradient, one engine whose jitted decode step serves
both the decode and the generate checks."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jP  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import steps as tST  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]
TOL = dict(rtol=1e-4, atol=1e-4)
ATT_TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 16                 # the model checks' batch and prefill length
DECODE_STEPS, MAX_SEQ = 8, 16
PROMPT, NEW = 4, 6


def _both(arch, reduced=True):
    cfgs = [get(arch) for get in (get_config, jget_config)]
    return [c.reduced() for c in cfgs] if reduced else cfgs


def _spec_leaves(spec, path=()):
    """(path, shape, axes, init, dtype name or None) of every Spec leaf,
    keys sorted; either package's Spec."""
    if isinstance(spec, dict):
        return [x for k in sorted(spec)
                for x in _spec_leaves(spec[k], path + (k,))]
    dt = None if spec.dtype is None else \
        str(spec.dtype).split(".")[-1] if isinstance(spec.dtype, torch.dtype) \
        else np.dtype(spec.dtype).name
    return [(path, tuple(spec.shape), tuple(spec.axes), spec.init, dt)]


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _params(spec, seed):
    """Params of the JAX package's ``spec`` drawn with numpy: normal of
    std ``scale / sqrt(fan_in)`` as ``init_tree`` draws them, zeros, and
    the norms' scales ("ones") uniform in [0.5, 1.5], so the norms are
    checked; as JAX arrays and as the same CPU tensors."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        dtype = np.dtype(s.dtype or jnp.float32)
        if s.init == "zeros":
            return np.zeros(s.shape, dtype)
        if s.init == "ones":
            return rng.uniform(0.5, 1.5, s.shape).astype(dtype)
        fan_in = s.shape[0] if len(s.shape) == 1 else np.prod(s.shape[:-1])
        std = s.scale / max(1.0, fan_in) ** 0.5
        return (rng.normal(size=s.shape) * std).astype(dtype)
    tree = jax.tree.map(leaf, spec, is_leaf=jP.is_spec)
    return (jax.tree.map(jnp.asarray, tree),
            tP.from_numpy(tree, "cpu"))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_jax(arch, reduced):
    cfg, jcfg = _both(arch, reduced)
    assert repr(cfg) == repr(jcfg)
    mine, theirs = tmla.mla_spec(cfg), jmla.mla_spec(jcfg)
    assert _spec_leaves(mine) == _spec_leaves(theirs)
    keys = set(mine)
    if cfg.mla.q_lora_rank:
        assert {"w_dq", "q_norm", "w_uq_nope", "w_uq_rope"} <= keys
    else:
        assert {"wq_nope", "wq_rope"} <= keys
    assert _spec_leaves(tT.model_spec(cfg)) == \
        _spec_leaves(jT.model_spec(jcfg))
    # the abstract tree allocates nothing, even for 15.7 B params
    meta = tP.abstract_tree(tT.model_spec(cfg))
    assert all(t.device.type == "meta" for _, t in _tree_leaves(meta))


def test_full_sizes_and_moe_capacity():
    """The full configs' sizes, and deepseek's MoE capacities at the
    card's (4, 511)-token prefill and a batch-4 decode step."""
    ds, jds = _both("deepseek-v2-lite-16b", reduced=False)
    mc, jmc = _both("minicpm3-4b", reduced=False)
    assert tP.param_bytes(tT.model_spec(ds), 1) == \
        jP.param_bytes(jT.model_spec(jds), 1) == 15_706_484_224
    assert tP.param_bytes(tT.model_spec(mc), 1) == \
        jP.param_bytes(jT.model_spec(jmc), 1) == 4_261_902_848
    assert (ds.n_layers, ds.d_model, ds.n_heads, ds.moe.num_experts,
            ds.moe.top_k, ds.moe.num_shared, ds.moe.d_expert) == \
        (27, 2048, 16, 64, 6, 2, 1408)
    for n, cap in ((4 * 511, 240), (4, 4)):
        assert tmoe._capacity(n, ds) == jmoe._capacity(n, jds) == cap


# ---------------------------------------------------------------------------
# the mixer alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_self_attention_matches_jax(arch, monkeypatch):
    cfg, jcfg = _both(arch)
    m = cfg.mla
    jp, tp = _params(jmla.mla_spec(jcfg), 1)
    x = np.random.default_rng(2).normal(
        size=(2, 17, cfg.d_model)).astype(np.float32)
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, **kwargs):
        out = real(q, k, v, **kwargs)
        calls.append((q, k, v, kwargs, out))
        return out
    monkeypatch.setattr(tops, "flash_attention", spy)
    got = tmla.mla_self_attention(cfg, tp, torch.from_numpy(x))
    want = jax.jit(functools.partial(jmla.mla_self_attention, jcfg))(
        jp, jnp.asarray(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)

    assert len(calls) == 1
    q, k, v, kwargs, out = calls[0]
    dq, dv = m.nope_head_dim + m.rope_head_dim, m.v_head_dim
    assert dv < dq
    h = cfg.eff_heads
    assert tuple(q.shape) == tuple(k.shape) == tuple(v.shape) == \
        (2, h, 17, dq)
    assert all(t.is_contiguous() for t in (q, k, v))
    assert kwargs == {"causal": True, "window": 0}     # q's dh ** -0.5
    # v's padding is zero, and so are the output's padded columns
    assert torch.count_nonzero(v[..., dv:]) == 0
    assert torch.count_nonzero(out[..., dv:]) == 0
    assert torch.count_nonzero(out[..., :dv]) > 0
    # the rope key is one for all heads
    torch.testing.assert_close(k[:, :1, :, m.nope_head_dim:].expand(
        -1, h, -1, -1), k[..., m.nope_head_dim:], rtol=0, atol=0)
    assert tfa.launches.count == 0       # the plain version, uncounted


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_decode_attention_matches_jax(arch):
    """Eight steps into a cache of seven slots: the last step's write
    lands past the end and is clamped to the last slot, as
    ``lax.dynamic_update_slice`` clamps it."""
    cfg, jcfg = _both(arch)
    m = cfg.mla
    jp, tp = _params(jmla.mla_spec(jcfg), 4)
    jdecode = jax.jit(functools.partial(jmla.mla_decode_attention, jcfg))
    b, slots = 2, DECODE_STEPS - 1
    tcache = tmla.init_mla_cache(cfg, b, slots, torch.float32, "cpu")
    jcache = jmla.init_mla_cache(jcfg, b, slots, jnp.float32)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()} == \
        {"ckv": (b, slots, m.kv_lora_rank), "k_rope": (b, slots,
                                                       m.rope_head_dim)}
    xs = np.random.default_rng(5).normal(
        size=(DECODE_STEPS, b, 1, cfg.d_model)).astype(np.float32)
    for i in range(DECODE_STEPS):
        before = {k: v.clone() for k, v in tcache.items()}
        got, new = tmla.mla_decode_attention(cfg, tp, torch.from_numpy(xs[i]),
                                             tcache, i)
        want, jcache = jdecode(jp, jnp.asarray(xs[i]), jcache, i)
        for k in tcache:                  # not changed in place
            assert torch.equal(tcache[k], before[k])
        tcache = new
        assert got.shape == (b, 1, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATT_TOL)
        for k in ("ckv", "k_rope"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), **ATT_TOL)
    # the clamped write replaced slot 6's latent
    assert not torch.equal(tcache["ckv"][:, -1], before["ckv"][:, -1])


# ---------------------------------------------------------------------------
# the models, whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """Both packages on one reduced MLA model: numpy-drawn params as JAX
    arrays and as CPU tensors; the JAX package's logits, loss, metrics and
    gradients on one (B, S + 1) token batch from one jitted function; its
    engine (one jitted decode step) and the decode logits and cache of
    DECODE_STEPS teacher-forced steps."""
    cfg, jcfg = _both(request.param)
    assert repr(cfg) == repr(jcfg)
    jp, tp = _params(jT.model_spec(jcfg), 0)
    toks = _tokens(cfg, B, S + 1, 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def ref(p):
        logits, aux = jT.forward(jcfg, p, {"tokens": jb["tokens"]},
                                 jnp.float32)
        (_, metrics), grads = jax.value_and_grad(
            lambda p: jT.loss_fn(jcfg, p, jb, jnp.float32),
            has_aux=True)(p)
        return logits, aux, metrics, grads

    logits, aux, metrics, grads = ref(jp)
    eng = JEngine(jcfg, jp, max_seq=MAX_SEQ)
    jcache = eng.init_cache(B)
    decode = []
    for i in range(DECODE_STEPS):
        jl, jcache = eng._decode(jp, jnp.asarray(toks[:, i:i + 1]), jcache,
                                 i, None)
        decode.append(np.asarray(jl))
    return dict(
        cfg=cfg, params=tp, toks=toks, batch=batch, engine=eng,
        logits=np.asarray(logits),
        aux={k: float(v) for k, v in aux.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        grads=jax.tree.map(np.asarray, grads), decode=decode,
        cache=jax.tree.map(np.asarray, jcache))


def test_forward_logits_match_jax(model, monkeypatch):
    cfg, tp = model["cfg"], model["params"]
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((tuple(q.shape), tuple(v.shape)))
        return real(q, k, v, **kwargs)
    monkeypatch.setattr(tops, "flash_attention", spy)
    with torch.inference_mode():
        got, aux = tT.forward(
            cfg, tp, {"tokens": torch.from_numpy(model["batch"]["tokens"])},
            torch.float32)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), model["logits"], **TOL)
    # one attention call a layer, v padded to q's head dim
    dq = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
    assert calls == [((B, cfg.eff_heads, S, dq),) * 2] * cfg.n_layers
    assert aux.keys() == model["aux"].keys()
    for k, v in aux.items():
        if cfg.moe is not None:
            assert float(v) > 0
        np.testing.assert_allclose(float(v), model["aux"][k], rtol=1e-5,
                                   atol=1e-7)


def test_score_matches_jax_with_router_losses(model):
    cfg, tp = model["cfg"], model["params"]
    got = ServeEngine(cfg, tp, max_seq=MAX_SEQ, device="cpu").score(
        model["toks"])
    want = model["metrics"]["total_loss"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if cfg.moe is not None:             # the router losses are in it
        assert model["metrics"]["loss"] < got


def test_loss_and_grads_match_jax(model):
    loss, metrics, grads = tST.loss_and_grads(
        model["cfg"], model["params"],
        {k: torch.from_numpy(v) for k, v in model["batch"].items()},
        torch.float32)
    assert metrics.keys() == model["metrics"].keys()
    np.testing.assert_allclose(float(loss), model["metrics"]["total_loss"],
                               rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), model["metrics"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got, exp = tP.tree_items(grads), tP.tree_items(model["grads"])
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, g), (_, e) in zip(got, exp):
        assert g is not None, path
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=1e-4 * np.abs(e).max(),
                                   err_msg="/".join(path))


def test_decode_step_logits_match_jax(model):
    cfg, tp, toks = model["cfg"], model["params"], model["toks"]
    tcache = tT.init_cache(cfg, B, MAX_SEQ, torch.float32, "cpu")
    jcache = model["engine"].init_cache(B)
    assert [(p, tuple(x.shape)) for p, x in _tree_leaves(tcache)] == \
        [(p, x.shape) for p, x in _tree_leaves(jcache)]
    for i in range(DECODE_STEPS):
        with torch.inference_mode():
            tl, new = tT.decode_step(cfg, tp,
                                     torch.from_numpy(toks[:, i:i + 1]),
                                     tcache, i, None, torch.float32)
        assert new is not tcache
        tcache = new
        np.testing.assert_allclose(tl.numpy(), model["decode"][i], **TOL)
    for (p1, x1), (p2, x2) in zip(_tree_leaves(tcache),
                                  _tree_leaves(model["cache"])):
        assert p1 == p2
        np.testing.assert_allclose(x1.numpy(), x2, **TOL)


def test_greedy_generate_matches_jax(model):
    cfg, tp = model["cfg"], model["params"]
    prompts = _tokens(cfg, B, PROMPT, 6)
    want = model["engine"].generate(prompts, NEW)
    got = ServeEngine(cfg, tp, max_seq=MAX_SEQ, device="cpu").generate(
        prompts, NEW)
    assert got.shape == (B, PROMPT + NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[:, :PROMPT], prompts)


def test_decode_matches_own_forward_at_no_drop_capacity(model):
    """Teacher-forced decode logits (the absorbed form over the latent
    cache) against the port's own prefill (the padded attention call).
    An MoE model runs at capacity_factor = E / top_k, where nothing can
    drop, so prefill and decode route alike."""
    cfg, tp = model["cfg"], model["params"]
    if cfg.moe is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    toks = torch.from_numpy(_tokens(cfg, 2, 12, 8))
    with torch.inference_mode():
        ref, _ = tT.forward(cfg, tp, {"tokens": toks}, torch.float32)
        cache = tT.init_cache(cfg, 2, 12, torch.float32, "cpu")
        for i in range(12):
            logits, cache = tT.decode_step(cfg, tp, toks[:, i:i + 1], cache,
                                           i, None, torch.float32)
            torch.testing.assert_close(logits[:, 0], ref[:, i], rtol=2e-3,
                                       atol=2e-3)
