"""The PyTorch port's selective scan, Mamba mixer and jamba serving path
against the JAX package's, on the CPU, where the scan takes its plain
sequential version.

The plain scan is held to the JAX oracle, the Pallas kernel (interpret
mode) and the chunked ``ssm_scan`` the JAX mixer runs, at the JAX kernel
test's shapes and one longer than a chunk, within 2e-5 (f32) / 3e-2
(bf16). The reduced ``jamba-1.5-large-398b`` (8 layers: 7 Mamba, 1
attention without RoPE; d_model 256, d_inner 512, d_state 8, dt_rank 16;
4 experts top-2 on every second layer; vocab 512) loads JAX-made params
through ``from_numpy`` and gives the same mixer outputs and decode
states, logits, ``score`` (router losses included) and greedy tokens."""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as tssm  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-4, atol=1e-4)

SSM_CASES = [
    # b, s, di, n, dtype (tests/test_kernels.py), then one longer than
    # ssm_scan's chunk of 128
    (1, 64, 32, 8, "float32"),
    (2, 128, 64, 16, "float32"),
    (1, 256, 32, 4, "bfloat16"),
    (2, 256, 48, 8, "float32"),
]


def _ssm_inputs(b, s, di, n, seed):
    """dt, B, C, u and A as numpy f32, drawn as the JAX kernel test
    draws them (dt = softplus(normal) * 0.1, A = -exp(0.5 normal))."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, di)))) * 0.1
    bm, cm = (rng.normal(size=(b, s, n)) for _ in range(2))
    u = rng.normal(size=(b, s, di))
    a = -np.exp(rng.normal(size=(di, n)) * 0.5)
    return [x.astype(np.float32) for x in (dt, bm, cm, u, a)]


def _both(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("b,s,di,n,dtype", SSM_CASES)
def test_selective_scan_ref_matches_jax(b, s, di, n, dtype):
    dt, bm, cm, u, a = _ssm_inputs(b, s, di, n, s + di)
    (dtj, dtt), (bj, bt), (cj, ct), (uj, ut) = (
        _both(x, dtype) for x in (dt, bm, cm, u))
    y, h = tref.selective_scan_ref(dtt, bt, ct, ut, torch.from_numpy(a))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (b, s, di) and h.shape == (b, di, n)
    aj = jnp.asarray(a)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    h0 = jnp.zeros((b, di, n), jnp.float32)
    for ey, eh in (jref.selective_scan_ref(dtj, bj, cj, uj, aj),
                   jops.selective_scan(dtj, bj, cj, uj, aj, block_d=16,
                                       chunk=32, interpret=True),
                   jmamba.ssm_scan(dtj.astype(jnp.float32),
                                   bj.astype(jnp.float32),
                                   cj.astype(jnp.float32), uj, aj, h0)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ey), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(eh), atol=tol,
                                   rtol=tol)


def test_selective_scan_ref_with_starting_state():
    dt, bm, cm, u, a = _ssm_inputs(2, 40, 16, 8, 5)
    h0 = np.random.default_rng(6).normal(size=(2, 16, 8)).astype(np.float32)
    y, h = tref.selective_scan_ref(*map(torch.from_numpy,
                                        (dt, bm, cm, u, a, h0)))
    ey, eh = jref.selective_scan_ref(*map(jnp.asarray,
                                          (dt, bm, cm, u, a, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(eh), atol=2e-5,
                               rtol=2e-5)


def test_ops_selective_scan_dispatch_on_cpu():
    ins = list(map(torch.from_numpy, _ssm_inputs(1, 16, 8, 4, 3)))
    tssm.launches.reset()
    exp = tref.selective_scan_ref(*ins)
    for got in (tops.selective_scan(*ins),
                tops.selective_scan(*ins, kernel="ref"),
                tssm.selective_scan(*ins)):
        assert all(torch.equal(x, e) for x, e in zip(got, exp))
    with pytest.raises(ValueError, match="kernel='pallas'"):
        tops.selective_scan(*ins, kernel="pallas")
    with pytest.raises(ValueError, match="auto\\|pallas\\|ref"):
        tops.selective_scan(*ins, kernel="cuda")
    assert tops.default_backend(ins[0]) == "ref"
    assert tssm.launches.count == 0          # the plain version, uncounted


# ---------------------------------------------------------------------------
# the reduced jamba
# ---------------------------------------------------------------------------


def _no_drop(cfg):
    """capacity_factor = E / top_k: prefill and decode route alike."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    assert repr(cfg) == repr(jcfg)
    jp = jparams.init_tree(jT.model_spec(jcfg), jax.random.key(0),
                           jnp.float32)
    tp = tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jcfg, jp, tp


def _mamba_layer(jp, tp):
    """The first Mamba layer's mixer params in both packages."""
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"]["mixer"]),
            tparams.tree_slice(tp["blocks"]["pos0"]["mixer"], 0))


def test_reduced_and_one_period_configs():
    cfg = get_config(ARCH).reduced()
    mb = cfg.mamba
    assert (cfg.n_layers, cfg.d_model, mb.d_inner(cfg.d_model), mb.d_state,
            mb.dt_rank, cfg.vocab) == (8, 256, 512, 8, 16, 512)
    assert [m for m, _ in cfg.block_pattern].count("mamba") == 7
    assert not cfg.rope
    full, jfull = get_config(ARCH), jget_config(ARCH)
    # what the card serves: one 8-layer period at full width, 4 experts
    one = dataclasses.replace(full, n_layers=8, moe=dataclasses.replace(
        full.moe, num_experts=4))
    jone = dataclasses.replace(jfull, n_layers=8, moe=dataclasses.replace(
        jfull.moe, num_experts=4))
    assert one.param_count() == jone.param_count() == 16_246_439_936
    assert tparams.param_bytes(tT.model_spec(one), 4) == \
        jparams.param_bytes(jT.model_spec(jone), 4)


def test_init_layout_matches_jax(model):
    cfg, jcfg, jp, tp = model
    mine = tparams.init_tree(tT.model_spec(cfg),
                             torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    for other in (tp, jax.tree.map(np.asarray, jp)):
        a = [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
             for p, t in _leaves(mine)]
        b = [(p, tuple(x.shape), str(x.dtype).split(".")[-1])
             for p, x in _leaves(other)]
        assert a == b
    mixer = mine["blocks"]["pos0"]["mixer"]
    assert mixer["w_in"].shape == (1, 256, 1024)
    assert torch.all(mixer["b_dt"] == -4.6) and torch.all(
        mixer["a_log"] == 0.0) and torch.all(mixer["d_skip"] == 1.0)
    # the f32 overrides stay f32 under a bf16 param dtype
    bf = tparams.init_tree(tT.model_spec(cfg),
                           torch.Generator().manual_seed(0),
                           torch.bfloat16, "cpu")["blocks"]["pos0"]["mixer"]
    assert bf["w_in"].dtype == torch.bfloat16
    assert all(bf[k].dtype == torch.float32
               for k in ("b_dt", "a_log", "d_skip"))


def test_mamba_mixer_matches_jax(model):
    cfg, jcfg, jp, tp = model
    jm, tm = _mamba_layer(jp, tp)
    x = np.random.default_rng(1).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)
    calls = []
    real = tops.selective_scan

    def spy(*args, **kw):
        calls.append(tuple(t.shape for t in args))
        return real(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops, "selective_scan", spy)
        got = tmamba.mamba_mixer(cfg, tm, torch.from_numpy(x))
    want = jmamba.mamba_mixer(jcfg, jm, jnp.asarray(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    di, n = 512, 8
    assert calls == [((2, 32, di), (2, 32, n), (2, 32, n), (2, 32, di),
                      (di, n))]


def test_mamba_decode_matches_jax(model):
    cfg, jcfg, jp, tp = model
    jm, tm = _mamba_layer(jp, tp)
    rng = np.random.default_rng(2)
    jcache = jmamba.init_mamba_cache(jcfg, 2, jnp.float32)
    tcache = tmamba.init_mamba_cache(cfg, 2, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    for _ in range(6):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jmamba.mamba_decode(jcfg, jm, jnp.asarray(x), jcache)
        got, new = tmamba.mamba_decode(cfg, tm, torch.from_numpy(x), tcache)
        assert new is not tcache
        tcache = new
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)


def test_mixer_rejects_the_lengths_ssm_scan_rejects(model):
    """ssm_scan asserts s % min(128, s) == 0; the kernel would take any
    s, but the port's mixer refuses what the JAX package refuses."""
    cfg, jcfg, jp, tp = model
    jm, tm = _mamba_layer(jp, tp)
    x = np.zeros((1, 200, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jmamba.mamba_mixer(jcfg, jm, jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of min"):
        tmamba.mamba_mixer(cfg, tm, torch.from_numpy(x))


def test_forward_logits_match_jax(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(cfg, 2, 32, 3)
    want, jaux = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            jnp.float32)
    tssm.launches.reset()
    with torch.inference_mode():
        got, aux = tT.forward(cfg, tp,
                              {"tokens": torch.from_numpy(toks).long()},
                              torch.float32)
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5)
    assert tssm.launches.count == 0


def test_score_matches_jax_with_router_losses(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(cfg, 3, 21, 4)
    want = JEngine(jcfg, jp, max_seq=32).score(toks)
    got = ServeEngine(cfg, tp, max_seq=32, device="cpu").score(toks)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * abs(want)


def test_decode_step_logits_match_jax(model):
    cfg, jcfg, jp, tp = model
    b, s = 2, 6
    toks = _tokens(cfg, b, s, 5)
    jcache = jT.init_cache(jcfg, b, s, jnp.float32)
    tcache = tT.init_cache(cfg, b, s, torch.float32, "cpu")
    for (p1, x1), (p2, x2) in zip(_leaves(tcache), _leaves(jcache)):
        assert p1 == p2 and tuple(x1.shape) == x2.shape
    for i in range(s):
        jl, jcache = jT.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                    jcache, i, None, jnp.float32)
        with torch.inference_mode():
            tl, tcache = tT.decode_step(
                cfg, tp, torch.from_numpy(toks[:, i:i + 1]).long(), tcache,
                i, None, torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for (_, x1), (_, x2) in zip(_leaves(tcache), _leaves(jcache)):
        np.testing.assert_allclose(x1.numpy(), np.asarray(x2), **TOL)


def test_greedy_generate_matches_jax(model):
    cfg, jcfg, jp, tp = model
    prompts = _tokens(cfg, 2, 4, 6)
    want = JEngine(jcfg, jp, max_seq=16).generate(prompts, 5)
    got = ServeEngine(cfg, tp, max_seq=16, device="cpu").generate(prompts,
                                                                  5)
    assert got.shape == (2, 9) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_matches_own_forward_at_no_drop_capacity(model):
    """The port's teacher-forced decode logits (no scan kernel) against
    its own prefill (through ``ops.selective_scan``)."""
    cfg, _, _, tp = model
    cfg = _no_drop(cfg)
    s = 12
    toks = torch.from_numpy(_tokens(cfg, 2, s, 8)).long()
    with torch.inference_mode():
        ref, _ = tT.forward(cfg, tp, {"tokens": toks}, torch.float32)
        cache = tT.init_cache(cfg, 2, s, torch.float32, "cpu")
        for i in range(s):
            logits, cache = tT.decode_step(cfg, tp, toks[:, i:i + 1], cache,
                                           i, None, torch.float32)
            torch.testing.assert_close(logits[:, 0], ref[:, i], rtol=2e-3,
                                       atol=2e-3)


def test_launcher_serves_jamba_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "3", "--new", "4"])
    tlaunch.main()
    assert f"{ARCH} on cpu: generated (2, 7)" in capsys.readouterr().out
