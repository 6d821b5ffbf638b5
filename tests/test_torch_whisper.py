"""The PyTorch port's encoder-decoder (whisper) against the JAX package's,
on the CPU, where attention takes its plain version.

* The model spec of the full ``whisper-large-v3`` (1,601,607,680
  params; nothing allocated) and of its reduced config: the same
  leaves, shapes, axes, initializers and dtypes, the encoder's subtree
  and each decoder block's ``norm_x`` / ``cross`` included.
* ``layers.layernorm`` within 1e-6 and the biased GELU ``layers.mlp``
  within 1e-5; ``cross_attention`` within 1e-5, through
  ``ops.flash_attention`` once with ``causal=False`` and sq != sk.
* The reduced model (2 encoder layers over 16 frames, 2 decoder layers,
  d 256), on params drawn with numpy (the norms' scales away from 1, and
  every bias, the norms' too, away from 0) loaded into both packages:
  ``encode`` within 1e-4 (one bidirectional attention call a layer);
  ``forward`` logits with frames within 1e-4 (the encoder's calls,
  then a causal self-attention and a cross-attention call a decoder
  layer) and ``make_prefill_step`` with frames;
  ``decode_step`` logits and cache over 8 steps with memory within
  1e-4; greedy ``generate`` tokens equal; ``score`` raising as the JAX
  engine's does; the analytic FLOPs equal; decode against the port's own
  prefill; the loss's gradients exact under each remat policy and, the
  encoder's and cross-attention's included, within 1e-4 of each leaf's
  largest against ``jax.value_and_grad``; the serve CLI and ``python -m
  repro_torch.examples.asr_serve``
  on the CPU.

The JAX side comes from one module-scoped fixture: one jitted encode and
forward, one engine whose jitted decode step serves the decode and the
generate checks."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import flops as jF  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import params as jP  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import flops as tF  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import steps as tST  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "whisper-large-v3"
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
ATT_TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 12                 # the model checks' batch and prefill length
DECODE_STEPS, MAX_SEQ = 8, 16
PROMPT, NEW = 3, 6


def _both(reduced=True):
    cfgs = [get(ARCH) for get in (get_config, jget_config)]
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
    std ``scale / sqrt(fan_in)`` as ``init_tree`` draws them, the norms'
    scales ("ones") uniform in [0.5, 1.5] and the biases ("zeros") normal
    of std 0.1, so the norms and biases are checked; as JAX arrays and as
    the same CPU tensors."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        dtype = np.dtype(s.dtype or jnp.float32)
        if s.init == "zeros":
            return (rng.normal(size=s.shape) * 0.1).astype(dtype)
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


def _frames(cfg, b, seed):
    """Frame embeddings as the example draws them: normal times 0.02."""
    return (np.random.default_rng(seed).normal(
        size=(b, cfg.encoder.n_frames, cfg.d_model)) * 0.02
    ).astype(np.float32)


def _spy(monkeypatch):
    """Records (q shape, k shape, keywords) of every
    ``ops.flash_attention`` call."""
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, **kwargs):
        calls.append((tuple(q.shape), tuple(k.shape), kwargs))
        return real(q, k, v, **kwargs)
    monkeypatch.setattr(tops, "flash_attention", spy)
    return calls


# ---------------------------------------------------------------------------
# specs and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_spec_matches_jax(reduced):
    cfg, jcfg = _both(reduced)
    assert repr(cfg) == repr(jcfg)
    spec = tT.model_spec(cfg)
    assert _spec_leaves(spec) == _spec_leaves(jT.model_spec(jcfg))
    assert set(spec["encoder"]) == {"blocks", "final_norm"}
    assert set(spec["blocks"]["pos0"]) == \
        {"norm1", "mixer", "norm_x", "cross", "norm2", "ffn"}
    assert set(spec["final_norm"]) == {"scale", "bias"}   # layernorm
    assert set(spec["blocks"]["pos0"]["ffn"]) == \
        {"w_up", "b_up", "w_down", "b_down"}
    n = tP.param_bytes(spec, 1)
    assert n == jP.param_bytes(jT.model_spec(jcfg), 1)
    if not reduced:
        assert n == 1_601_607_680
        meta = tP.abstract_tree(spec)
        assert all(t.device.type == "meta" for _, t in _tree_leaves(meta))


def test_layernorm_and_mlp_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    jp, tp = _params(jlayers.layernorm_spec(64), 4)
    np.testing.assert_allclose(
        tlayers.layernorm(tp, torch.from_numpy(x), 1e-5).numpy(),
        np.asarray(jlayers.layernorm(jp, jnp.asarray(x), 1e-5)),
        rtol=1e-6, atol=1e-6)
    jp, tp = _params(jlayers.mlp_spec(64, 96), 5)
    np.testing.assert_allclose(
        tlayers.mlp(tp, torch.from_numpy(x), "gelu").numpy(),
        np.asarray(jlayers.mlp(jp, jnp.asarray(x), "gelu")),
        rtol=1e-5, atol=1e-6)


def test_cross_attention_matches_jax(monkeypatch):
    cfg, jcfg = _both()
    jp, tp = _params(jatt.attention_spec(jcfg, cross=True), 1)
    assert set(tp) == {"wq", "wk", "wv", "wo"}       # no qk-norm
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    calls = _spy(monkeypatch)
    got = tatt.cross_attention(cfg, tp, torch.from_numpy(x),
                               torch.from_numpy(mem))
    want = jax.jit(functools.partial(jatt.cross_attention, jcfg))(
        jp, jnp.asarray(x), jnp.asarray(mem))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)
    h, kv, hd = cfg.eff_heads, cfg.n_kv_heads, cfg.head_dim
    assert calls == [((2, h, 5, hd), (2, kv, 16, hd),
                      {"causal": False, "window": 0})]
    assert tfa.launches.count == 0       # the plain version, uncounted


# ---------------------------------------------------------------------------
# the model, whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """Both packages on the reduced whisper: numpy-drawn params as JAX
    arrays and as CPU tensors; the JAX package's memory of B frame
    batches and logits of a (B, S) token batch from one jitted function;
    its engine (one jitted decode step) with the decode logits and cache
    of DECODE_STEPS teacher-forced steps against that memory, and its
    greedy tokens."""
    cfg, jcfg = _both()
    jp, tp = _params(jT.model_spec(jcfg), 0)
    toks = _tokens(cfg, B, S, 1)
    frames = _frames(cfg, B, 2)

    @jax.jit
    def ref(p, toks, frames):
        memory = jT.encode(jcfg, p, frames)
        logits, _ = jT.forward(jcfg, p, {"tokens": toks, "frames": frames},
                               jnp.float32)
        return memory, logits

    memory, logits = ref(jp, jnp.asarray(toks), jnp.asarray(frames))
    eng = JEngine(jcfg, jp, max_seq=MAX_SEQ)
    jcache = eng.init_cache(B)
    decode = []
    for i in range(DECODE_STEPS):
        jl, jcache = eng._decode(jp, jnp.asarray(toks[:, i:i + 1]), jcache,
                                 i, memory)
        decode.append(np.asarray(jl))
    prompts = _tokens(cfg, B, PROMPT, 6)
    generated = np.asarray(eng.generate(prompts, NEW, memory=memory))
    return dict(cfg=cfg, jcfg=jcfg, params=tp, jparams=jp, toks=toks,
                frames=frames, engine=eng, memory=np.asarray(memory),
                logits=np.asarray(logits), decode=decode,
                cache=jax.tree.map(np.asarray, jcache), prompts=prompts,
                generated=generated)


def _memory(model):
    with torch.inference_mode():
        return tT.encode(model["cfg"], model["params"],
                         torch.from_numpy(model["frames"]))


def test_encode_matches_jax(model, monkeypatch):
    cfg = model["cfg"]
    calls = _spy(monkeypatch)
    got = _memory(model)
    assert got.shape == (B, cfg.encoder.n_frames, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), model["memory"], **TOL)
    q = (B, cfg.eff_heads, cfg.encoder.n_frames, cfg.head_dim)
    k = (B, cfg.n_kv_heads, cfg.encoder.n_frames, cfg.head_dim)
    assert calls == [(q, k, {"causal": False, "window": 0})] * \
        cfg.encoder.n_layers


def test_forward_logits_match_jax(model, monkeypatch):
    cfg, tp = model["cfg"], model["params"]
    calls = _spy(monkeypatch)
    with torch.inference_mode():
        got, aux = tT.forward(
            cfg, tp, {"tokens": torch.from_numpy(model["toks"]).long(),
                      "frames": torch.from_numpy(model["frames"])},
            torch.float32)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), model["logits"], **TOL)
    assert float(aux["load_balance"]) == float(aux["router_z"]) == 0.0
    # the encoder's layers, then each decoder layer's self and cross
    h, kv, hd, f = (cfg.eff_heads, cfg.n_kv_heads, cfg.head_dim,
                    cfg.encoder.n_frames)
    enc = ((B, h, f, hd), (B, kv, f, hd), {"causal": False, "window": 0})
    dec = ((B, h, S, hd), (B, kv, S, hd), {"causal": True, "window": 0})
    cross = ((B, h, S, hd), (B, kv, f, hd), {"causal": False, "window": 0})
    assert calls == [enc] * cfg.encoder.n_layers + [dec, cross] * \
        cfg.n_layers


def test_prefill_step_takes_frames(model):
    cfg, tp = model["cfg"], model["params"]
    step = tST.make_prefill_step(cfg, compute_dtype=torch.float32)
    got = step(tp, {"tokens": torch.from_numpy(model["toks"]).long(),
                    "frames": torch.from_numpy(model["frames"])})
    np.testing.assert_allclose(got.numpy(), model["logits"][:, -1], **TOL)


def test_decode_step_with_memory_matches_jax(model, monkeypatch):
    cfg, tp, toks = model["cfg"], model["params"], model["toks"]
    memory = _memory(model)
    decode = tST.make_decode_step(cfg, compute_dtype=torch.float32,
                                  with_memory=True)
    tcache = tT.init_cache(cfg, B, MAX_SEQ, torch.float32, "cpu")
    jcache = model["engine"].init_cache(B)
    assert [(p, tuple(x.shape)) for p, x in _tree_leaves(tcache)] == \
        [(p, x.shape) for p, x in _tree_leaves(jcache)]
    calls = _spy(monkeypatch)
    for i in range(DECODE_STEPS):
        tl, new = decode(tp, torch.from_numpy(toks[:, i:i + 1]).long(),
                         tcache, i, memory)
        assert new is not tcache
        tcache = new
        np.testing.assert_allclose(tl.numpy(), model["decode"][i], **TOL)
    for (p1, x1), (p2, x2) in zip(_tree_leaves(tcache),
                                  _tree_leaves(model["cache"])):
        assert p1 == p2
        np.testing.assert_allclose(x1.numpy(), x2, **TOL)
    # one cross-attention call a layer a step, one query against every
    # frame; the decoder's self-attention reads its cache in plain torch
    f = cfg.encoder.n_frames
    assert calls == [((B, cfg.eff_heads, 1, cfg.head_dim),
                      (B, cfg.n_kv_heads, f, cfg.head_dim),
                      {"causal": False, "window": 0})] * \
        (cfg.n_layers * DECODE_STEPS)


def test_greedy_generate_matches_jax(model):
    cfg, tp = model["cfg"], model["params"]
    got = ServeEngine(cfg, tp, max_seq=MAX_SEQ, device="cpu").generate(
        model["prompts"], NEW, memory=_memory(model))
    assert got.shape == (B, PROMPT + NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, model["generated"])
    np.testing.assert_array_equal(got[:, :PROMPT], model["prompts"])


def test_score_raises_as_jax(model):
    cfg, tp = model["cfg"], model["params"]
    toks = _tokens(cfg, B, S, 3)
    with pytest.raises(NotImplementedError, match="use generate"):
        model["engine"].score(toks)
    with pytest.raises(NotImplementedError, match="use generate"):
        ServeEngine(cfg, tp, max_seq=MAX_SEQ, device="cpu").score(toks)


def test_decode_matches_own_forward(model):
    """Teacher-forced decode logits (the scalar sinusoidal position at
    ``index``) against the port's own prefill (positions 0 .. s - 1)."""
    cfg, tp, toks = model["cfg"], model["params"], model["toks"]
    toks = torch.from_numpy(toks).long()
    frames = torch.from_numpy(model["frames"])
    with torch.inference_mode():
        ref, _ = tT.forward(cfg, tp, {"tokens": toks, "frames": frames},
                            torch.float32)
        memory = tT.encode(cfg, tp, frames)
        cache = tT.init_cache(cfg, B, S, torch.float32, "cpu")
        for i in range(S):
            logits, cache = tT.decode_step(cfg, tp, toks[:, i:i + 1], cache,
                                           i, memory, torch.float32)
            torch.testing.assert_close(logits[:, 0], ref[:, i], rtol=2e-3,
                                       atol=2e-3)


def test_remat_policies_exact_under_grad(model):
    """The loss with frames and its gradients, the encoder's included,
    under each remat policy: every gradient present and equal to the
    unwrapped forward's, as the decoder's repeats are wrapped with the
    memory they attend to."""
    cfg, tp = model["cfg"], model["params"]
    toks = torch.from_numpy(_tokens(cfg, B, S + 1, 4)).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": torch.from_numpy(model["frames"])}
    got = {}
    for policy in ("none", "full", "minimal"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        loss, _, grads = tST.loss_and_grads(c, tp, batch, torch.float32)
        got[policy] = (loss, tP.tree_items(grads))
    assert all(g is not None for _, g in got["none"][1])
    assert any(p[0] == "encoder" for p, _ in got["none"][1])
    for policy in ("full", "minimal"):
        assert torch.equal(got[policy][0], got["none"][0])
        for (p1, g1), (p2, g2) in zip(got[policy][1], got["none"][1]):
            assert p1 == p2 and torch.equal(g1, g2), p1


def test_grads_match_jax():
    """The loss with frames at rtol 1e-5, and every gradient, the
    encoder's and each decoder layer's cross-attention's included, within
    1e-4 of its leaf's largest, against ``jax.value_and_grad`` of the JAX
    package's ``loss_fn`` (under the config's remat policy in both). Its
    own params and batch, out of the module's fixture, whose compiles it
    does not need."""
    cfg, jcfg = _both()
    jp, tp = _params(jT.model_spec(jcfg), 7)
    toks = _tokens(cfg, B, S + 1, 5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": _frames(cfg, B, 8)}
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jT.loss_fn(jcfg, p, b, jnp.float32), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = tST.loss_and_grads(
        cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.float32)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = tP.tree_items(grads)
    exp = tP.tree_items(jax.tree.map(np.asarray, jg))
    assert [p for p, _ in got] == [p for p, _ in exp]
    assert any(p[0] == "encoder" for p, _ in got)
    assert any("cross" in p for p, _ in got)
    for (path, g), (_, e) in zip(got, exp):
        assert g is not None, path
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=1e-4 * np.abs(e).max(),
                                   err_msg="/".join(path))


@pytest.mark.parametrize("reduced", [False, True])
def test_flops_match_jax(reduced):
    cfg, jcfg = _both(reduced)
    for name, shape in SHAPES.items():
        for fn in ("step_flops", "train_flops", "model_flops"):
            assert getattr(tF, fn)(cfg, shape) == \
                getattr(jF, fn)(jcfg, JSHAPES[name]), (fn, name)
    # the encoder and the cross-attention are in the count
    no_enc = dataclasses.replace(cfg, encoder=None)
    for shape in SHAPES.values():
        assert tF.step_flops(cfg, shape) > tF.step_flops(no_enc, shape)


# ---------------------------------------------------------------------------
# the CLI and the example
# ---------------------------------------------------------------------------


def test_launcher_serves_whisper_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "3", "--new", "4"])
    calls = _spy(monkeypatch)
    tlaunch.main()
    assert f"{ARCH} on cpu: generated (2, 7)" in capsys.readouterr().out
    cfg = get_config(ARCH).reduced()
    # the encoder once, then cross-attention in each of 3 + 4 - 1 steps
    assert len(calls) == cfg.encoder.n_layers + cfg.n_layers * 6


def test_asr_serve_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.asr_serve", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert "encoded 4x16 frames on cpu" in out.stdout
    assert "decoded (4, 33)" in out.stdout
