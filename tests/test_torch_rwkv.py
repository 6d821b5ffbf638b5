"""The PyTorch port's RWKV-6 serving path against the JAX package's, on
the reduced ``rwkv6-7b`` (2 layers, d 256, head dim 32, vocab 512):
JAX-made params load through ``from_numpy``, and the mixer, the prefill
logits, the decode logits, ``score`` and greedy ``generate`` agree on the
CPU, where the WKV recurrence runs its plain version. Also the port's
own decode-vs-prefill consistency, its refusals, and its launcher."""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as twkv  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import tower as ttwr  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "rwkv6-7b"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    """(cfg, the JAX package's cfg, JAX params, the same params as CPU
    tensors)."""
    cfg = get_config(ARCH).reduced()
    jcfg = jget_config(ARCH).reduced()
    assert repr(cfg) == repr(jcfg)
    jp = jparams.init_tree(jT.model_spec(jcfg), jax.random.key(0),
                           jnp.float32)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jcfg, jp, tp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_reduced_config_is_the_jax_one():
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv.head_dim, cfg.vocab) == \
        (2, 256, 32, 512)
    for f in ("n_layers", "d_model", "d_ff", "vocab", "n_heads",
              "block_pattern", "tie_embeddings", "norm_eps", "act"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.rwkv) == vars(jcfg.rwkv)
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert full.param_count() == jfull.param_count() == 8_355_053_568
    # the spec holds more than the analytic count (a full gate
    # projection, the norms and mixes): 35.5 GB in f32
    assert tparams.param_bytes(tT.model_spec(full), 1) == \
        jparams.param_bytes(jT.model_spec(jfull), 1) == 8_876_593_152
    assert list_archs() == jlist_archs()


def test_init_layout_matches_jax(model):
    cfg, _, jp, _ = model
    spec = tT.model_spec(cfg)
    mine = tparams.init_tree(spec, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    a = [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
         for p, t in _leaves(mine)]
    b = [(p, tuple(x.shape), str(np.asarray(x).dtype))
         for p, x in _leaves(jp)]
    assert a == b
    assert tparams.param_bytes(spec, 4) == jparams.param_bytes(
        jT.model_spec(cfg), 4)
    # the same distributions: ones/zeros exact, normals at their std
    mixer = mine["blocks"]["pos0"]["mixer"]
    assert torch.equal(mixer["bonus"], torch.full_like(mixer["bonus"], 0.5))
    assert torch.equal(mixer["gn_bias"], torch.zeros_like(mixer["gn_bias"]))
    w = mine["embed"]["table"]
    assert abs(w.std().item() * cfg.vocab ** 0.5 - 1.0) < 0.02
    again = tparams.init_tree(spec, torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves(mine), _leaves(again)))
    back = tparams.to_numpy(tparams.from_numpy(tparams.to_numpy(mine),
                                               "cpu"))
    assert all(np.array_equal(x, y.numpy()) for (_, x), (_, y) in
               zip(_leaves(back), _leaves(mine)))


def _layer_case(name, rng):
    """(function name, params as numpy, input, extra args) of one shared
    layer; both packages' modules name their functions alike."""
    d, f = 16, 24

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)
    x = n(2, 5, d)
    if name == "rmsnorm":
        return "rmsnorm", {"scale": n(d)}, x, ()
    if name == "layernorm":
        return "layernorm", {"scale": n(d), "bias": n(d)}, x, ()
    if name == "gated_mlp":
        return "gated_mlp", {"w_gate": n(d, f), "w_up": n(d, f),
                             "w_down": n(f, d)}, x, ("silu",)
    return "mlp", {"w_up": n(d, f), "b_up": n(f), "w_down": n(f, d),
                   "b_down": n(d)}, x, (name.split("_")[1],)


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "gated_mlp",
                                  "mlp_gelu", "mlp_relu"])
def test_shared_layers_match_jax(name):
    fn, params, x, args = _layer_case(name, np.random.default_rng(9))
    got = getattr(tlayers, fn)(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), *args)
    want = getattr(jlayers, fn)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 7)).astype(np.int64)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        loss, aux = tlayers.softmax_xent(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m), z_weight=1e-3)
        jloss, jaux = jlayers.softmax_xent(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m), z_weight=1e-3)
        for a, b in ((loss, jloss), (aux["accuracy"], jaux["accuracy"]),
                     (aux["tokens"], jaux["tokens"])):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_wkv_scan_with_state_matches_jax(model):
    cfg = model[0]
    rng = np.random.default_rng(5)
    b, s, h, dh = 2, 12, 8, cfg.rwkv.head_dim
    r, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.normal(size=(b, s, h, dh)))) * 0.5
         + 0.45).astype(np.float32)
    u = (rng.normal(size=(h, dh)) * 0.3).astype(np.float32)
    s0 = (rng.normal(size=(b, h, dh, dh)) * 0.5).astype(np.float32)
    jy, js = jrwkv.wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    ty, ts = trwkv.wkv_scan(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=5e-5,
                               atol=5e-5)


def test_rwkv_mixer_matches_jax(model):
    cfg, jcfg, jp, tp = model
    x = np.random.default_rng(1).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32)
    jmix = jax.tree.map(lambda a: a[1], jp["blocks"]["pos0"]["mixer"])
    tmix = tparams.tree_slice(tp["blocks"]["pos0"]["mixer"], 1)
    twkv.launches.reset()
    got = trwkv.rwkv_mixer(cfg, tmix, torch.from_numpy(x)).numpy()
    want = np.asarray(jrwkv.rwkv_mixer(jcfg, jmix, jnp.asarray(x)))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, **TOL)
    assert twkv.launches.count == 0   # the plain version, uncounted


def test_forward_logits_match_jax(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(cfg, 2, 32, 2)
    want, _ = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         jnp.float32)
    with torch.inference_mode():
        got, aux = tT.forward(cfg, tp, {"tokens": torch.from_numpy(toks)},
                              torch.float32)
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux["load_balance"]) == 0.0


def test_decode_step_logits_match_jax(model):
    cfg, jcfg, jp, tp = model
    b, s = 2, 8
    toks = _tokens(cfg, b, s, 3)
    jcache = jT.init_cache(jcfg, b, s, jnp.float32)
    tcache = tT.init_cache(cfg, b, s, torch.float32, "cpu")
    for (p1, x1), (p2, x2) in zip(_leaves(tcache), _leaves(jcache)):
        assert p1 == p2 and tuple(x1.shape) == x2.shape
    for i in range(s):
        jl, jcache = jT.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                    jcache, i, None, jnp.float32)
        with torch.inference_mode():
            tl, new = tT.decode_step(cfg, tp,
                                     torch.from_numpy(toks[:, i:i + 1]),
                                     tcache, i, None, torch.float32)
        assert new is not tcache
        tcache = new
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for (_, x1), (_, x2) in zip(_leaves(tcache), _leaves(jcache)):
        np.testing.assert_allclose(x1.numpy(), np.asarray(x2), **TOL)


def test_score_matches_jax(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(cfg, 3, 20, 4)
    want = JEngine(jcfg, jp, max_seq=32).score(toks)
    got = ServeEngine(cfg, tp, max_seq=32, device="cpu").score(toks)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * abs(want)


def test_greedy_generate_matches_jax(model):
    cfg, jcfg, jp, tp = model
    prompts = _tokens(cfg, 2, 4, 6)
    want = JEngine(jcfg, jp, max_seq=32).generate(prompts, 6)
    got = ServeEngine(cfg, tp, max_seq=32, device="cpu").generate(prompts,
                                                                  6)
    assert got.shape == (2, 10) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[:, :4], prompts)


def test_sampled_generate_is_seeded(model):
    cfg, _, _, tp = model
    eng = ServeEngine(cfg, tp, max_seq=32, device="cpu")
    prompts = _tokens(cfg, 2, 4, 7)
    a = eng.generate(prompts, 5, temperature=0.8, seed=3)
    b = eng.generate(prompts, 5, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 9) and ((a >= 0) & (a < cfg.vocab)).all()


def test_decode_matches_own_forward(model):
    """The port's teacher-forced decode logits against its own prefill
    (the path through ``ops.rwkv6_wkv``), as the JAX package's archs
    smoke test holds its own."""
    cfg, _, _, tp = model
    toks = torch.from_numpy(_tokens(cfg, 1, 8, 8))
    with torch.inference_mode():
        ref, _ = tT.forward(cfg, tp, {"tokens": toks}, torch.float32)
        cache = tT.init_cache(cfg, 1, 8, torch.float32, "cpu")
        for i in range(8):
            logits, cache = tT.decode_step(cfg, tp, toks[:, i:i + 1], cache,
                                           i, None, torch.float32)
            torch.testing.assert_close(logits[:, 0], ref[:, i], rtol=2e-3,
                                       atol=2e-3)


UNPORTED = ["deepseek-v2-lite-16b", "internvl2-76b", "jamba-1.5-large-398b",
            "minicpm3-4b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        tT.model_spec(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeEngine(cfg, {}, device="cpu")


def test_cuda_defaults_raise_without_a_gpu(model, monkeypatch):
    cfg, _, _, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ServeEngine(cfg, tp),
                 lambda: tparams.init_tree(tT.model_spec(cfg),
                                           torch.Generator()),
                 lambda: tparams.from_numpy({"a": np.zeros(2)}),
                 lambda: tT.init_cache(cfg, 1, 8),
                 lambda: ttwr.init(ttwr.resolve(("mlp",), 3, 2),
                                   torch.Generator()),
                 lambda: ttwr.from_numpy([[{"w": np.zeros((3, 2)),
                                            "b": np.zeros(2)}]])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_launcher_serves_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "3", "--new", "4"])
    tlaunch.main()
    out = capsys.readouterr().out
    assert f"{ARCH} on cpu: generated (2, 7)" in out
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "jamba-1.5-large-398b", "--reduced", "--device",
        "cpu"])
    with pytest.raises(NotImplementedError, match="Mamba slice"):
        tlaunch.main()
