"""The PyTorch port's GQA attention and the dense attention families
against the JAX package's, on the CPU, where the prefill's attention
takes the flash-attention kernel's plain version.

RoPE, prefill self-attention (full, GQA, qk-norm, sliding window) and
decode against the KV cache (the SWA ring wrapping past its slots
included) agree at 1e-5 on shared numpy inputs; the reduced ``glm4-9b``,
``qwen3-14b`` and ``h2o-danube-1.8b`` load JAX-made params through
``from_numpy`` and give the same prefill and decode logits at 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ATT_TOL = dict(rtol=1e-5, atol=1e-5)

# attention layer cases: (arch whose reduced config they start from,
# replaced fields); reduced configs have 4 query heads of 64
ATT_CASES = {
    "full_mha": ("glm4-9b", dict(n_kv_heads=4)),
    "gqa": ("glm4-9b", {}),
    "qk_norm": ("qwen3-14b", {}),
    "swa_window_5": ("h2o-danube-1.8b", dict(window=5)),
}


def _both(arch, **kw):
    """The reduced config of ``arch`` in both packages, ``kw`` replaced."""
    return [dataclasses.replace(get(arch).reduced(), **kw)
            for get in (get_config, jget_config)]


def _attn_params(jcfg, seed):
    """JAX attention params of one layer and the same as CPU tensors."""
    spec = jatt.attention_spec(jcfg)
    jp = jparams.init_tree(spec, jax.random.key(seed), jnp.float32)
    if jcfg.qk_norm:
        # non-trivial norm scales, so the norms are checked
        rng = np.random.default_rng(seed)
        for name in ("q_norm", "k_norm"):
            jp[name]["scale"] = jnp.asarray(
                rng.uniform(0.5, 1.5, jcfg.head_dim).astype(np.float32))
    return jp, tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 64)).astype(np.float32)
    pos = (np.arange(9)[None] + np.array([[0], [40]])).astype(np.int32)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)
    np.testing.assert_allclose(
        tlayers.rope_frequencies(64, theta).numpy(),
        np.asarray(jlayers.rope_frequencies(64, theta)), rtol=1e-6)
    # split-half: position 0 is the identity
    torch.testing.assert_close(got[:, :1][0], torch.from_numpy(x)[:, :1][0])


@pytest.mark.parametrize("case", sorted(ATT_CASES))
def test_self_attention_matches_jax(case, monkeypatch):
    arch, kw = ATT_CASES[case]
    cfg, jcfg = _both(arch, **kw)
    jp, tp = _attn_params(jcfg, 1)
    x = np.random.default_rng(2).normal(
        size=(2, 17, cfg.d_model)).astype(np.float32)
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((tuple(q.shape), tuple(k.shape), kwargs))
        return real(q, k, v, **kwargs)
    monkeypatch.setattr(tops, "flash_attention", spy)
    got = tatt.self_attention(cfg, tp, torch.from_numpy(x))
    want = jatt.self_attention(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.window if cfg.attention == "swa" else 0
    assert calls == [((2, h, 17, hd), (2, kvh, 17, hd),
                      {"causal": True, "window": window})]
    assert tfa.launches.count == 0       # the plain version, uncounted


def test_attend_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
            for _ in range(2))
    qp, kp = np.arange(3, 9), np.arange(9)
    for window, causal in ((0, True), (3, True), (0, False)):
        got = tatt.attend(*map(torch.from_numpy, (q, k, v, qp, kp)),
                          window=window, causal=causal)
        want = jatt.attend(*map(jnp.asarray, (q, k, v, qp, kp)),
                           window=window, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATT_TOL)


@pytest.mark.parametrize("case", sorted(ATT_CASES))
def test_decode_attention_matches_jax(case):
    """Steps past the ring's slots when the window is small: the new
    key lands at index % slots and every slot counts once the ring is
    full."""
    arch, kw = ATT_CASES[case]
    cfg, jcfg = _both(arch, **kw)
    jp, tp = _attn_params(jcfg, 4)
    b, steps, max_seq = 2, 9, 12
    tcache = tatt.init_kv_cache(cfg, b, max_seq, torch.float32, "cpu")
    jcache = jatt.init_kv_cache(jcfg, b, max_seq, jnp.float32)
    slots = 5 if cfg.attention == "swa" else max_seq
    assert tcache["k"].shape == jcache["k"].shape == \
        (b, slots, cfg.n_kv_heads, cfg.head_dim)
    xs = np.random.default_rng(5).normal(
        size=(steps, b, 1, cfg.d_model)).astype(np.float32)
    for i in range(steps):
        before = tcache["k"].clone()
        got, new = tatt.decode_attention(cfg, tp, torch.from_numpy(xs[i]),
                                         tcache, i)
        want, jcache = jatt.decode_attention(jcfg, jp, jnp.asarray(xs[i]),
                                             jcache, i)
        assert torch.equal(tcache["k"], before)     # not changed in place
        tcache = new
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATT_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **ATT_TOL)


def test_cross_attention_is_not_ported(monkeypatch):
    """Cross-attention runs as one ``ops.flash_attention`` call,
    bidirectional (``causal=False``, no window), q of the decoder's
    length against k and v of the memory's, contiguous in the kernel's
    (b, h, s, hd) layout. (tests/test_torch_whisper.py holds its values
    to the JAX package's.)"""
    cfg = get_config("whisper-large-v3").reduced()
    tp = tparams.init_tree(tatt.attention_spec(cfg, cross=True),
                           torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((q, k, v, kwargs))
        return real(q, k, v, **kwargs)
    monkeypatch.setattr(tops, "flash_attention", spy)
    x = torch.randn((2, 3, cfg.d_model))
    memory = torch.randn((2, 7, cfg.d_model))
    out = tatt.cross_attention(cfg, tp, x, memory)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert len(calls) == 1
    q, k, v, kwargs = calls[0]
    assert kwargs == {"causal": False, "window": 0}
    assert tuple(q.shape) == (2, cfg.eff_heads, 3, cfg.head_dim)
    assert tuple(k.shape) == tuple(v.shape) == \
        (2, cfg.n_kv_heads, 7, cfg.head_dim)
    assert all(t.is_contiguous() for t in (q, k, v))


# ---------------------------------------------------------------------------
# the dense attention families, whole
# ---------------------------------------------------------------------------

FAMILIES = {
    "glm4-9b": {},
    "qwen3-14b": {},
    "h2o-danube-1.8b": {},
    # the ring wraps inside the decode run below
    "h2o-danube-1.8b-window-4": dict(window=4),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    arch = request.param.split("-window")[0]
    cfg, jcfg = _both(arch, **FAMILIES[request.param])
    jp = jparams.init_tree(jT.model_spec(jcfg), jax.random.key(7),
                           jnp.float32)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jcfg, jp, tp


def test_family_forward_logits_match_jax(family):
    cfg, jcfg, jp, tp = family
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)
    want, _ = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         jnp.float32)
    with torch.inference_mode():
        got, aux = tT.forward(cfg, tp,
                              {"tokens": torch.from_numpy(toks).long()},
                              torch.float32)
    assert got.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux["load_balance"]) == float(aux["router_z"]) == 0.0


def test_family_decode_logits_match_jax(family):
    cfg, jcfg, jp, tp = family
    b, s = 2, 8
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    jcache = jT.init_cache(jcfg, b, s, jnp.float32)
    tcache = tT.init_cache(cfg, b, s, torch.float32, "cpu")
    for i in range(s):
        jl, jcache = jT.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                    jcache, i, None, jnp.float32)
        with torch.inference_mode():
            tl, tcache = tT.decode_step(
                cfg, tp, torch.from_numpy(toks[:, i:i + 1]).long(), tcache,
                i, None, torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # and the port's own prefill, as the JAX archs smoke test holds its own
    with torch.inference_mode():
        ref, _ = tT.forward(cfg, tp, {"tokens": torch.from_numpy(toks)
                                      .long()}, torch.float32)
    torch.testing.assert_close(tl[:, 0], ref[:, -1], rtol=2e-3, atol=2e-3)
