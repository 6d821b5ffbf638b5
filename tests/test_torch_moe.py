"""The PyTorch port's mixture-of-experts FFN and its granite-moe serving
path against the JAX package's, on the CPU, where every expert matmul
takes the grouped matmul's plain version.

Both dispatch variants (global token priority, and group-local one-hot)
route, drop, compute and combine as the JAX package does, at 1e-5, with
the routing checked first so that a mismatch names its cause. The
reduced ``granite-moe-3b-a800m`` (2 layers, d 256, 4 heads of 64, 4
experts top-2, d_expert 128, vocab 512) loads JAX-made params through
``from_numpy`` and gives the same logits, the same ``score`` (router
losses included), the same decode logits and the same greedy tokens."""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "granite-moe-3b-a800m"
TOL = dict(rtol=1e-4, atol=1e-4)
FFN_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**moe_kw):
    """The reduced granite config of both packages, with ``moe_kw``
    replaced in its MoE config (or on the model config, for
    ``moe_group_dispatch``)."""
    group = moe_kw.pop("moe_group_dispatch", False)
    out = []
    for get in (get_config, jget_config):
        cfg = get(ARCH).reduced()
        cfg = dataclasses.replace(
            cfg, moe_group_dispatch=group,
            moe=dataclasses.replace(cfg.moe, **moe_kw))
        out.append(cfg)
    return out


def _no_drop(cfg):
    """capacity_factor = E / top_k: every expert has room for every
    token, so prefill (many tokens) and decode (one a row) route alike."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _params(cfg, seed=0):
    """JAX params of ``cfg`` and the same as CPU tensors."""
    jp = jparams.init_tree(jT.model_spec(cfg), jax.random.key(seed),
                           jnp.float32)
    return jp, tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    assert repr(cfg) == repr(jcfg)
    jp, tp = _params(jcfg)
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


def test_reduced_and_full_config_are_the_jax_ones():
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab) == (2, 256, 4, 2, 64, 512)
    assert vars(cfg.moe) == vars(jcfg.moe)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert) == \
        (4, 2, 128)
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert (full.n_layers, full.d_model, full.moe.num_experts,
            full.moe.top_k, full.moe.d_expert, full.vocab) == \
        (32, 1536, 40, 8, 512, 49155)
    assert full.param_count() == jfull.param_count() == 3_374_195_712
    # the spec adds the norms: 13.5 GB in f32
    assert tparams.param_bytes(tT.model_spec(full), 1) == \
        jparams.param_bytes(jT.model_spec(jfull), 1) == 3_374_295_552


@pytest.mark.parametrize("n", [1, 4, 7, 64, 511, 2044])
def test_capacity_matches_jax(n):
    for cfg, jcfg in (_cfgs(), _cfgs(capacity_factor=0.5),
                      (get_config(ARCH), jget_config(ARCH))):
        assert tmoe._capacity(n, cfg) == jmoe._capacity(n, jcfg)
    assert tmoe._capacity(2044, get_config(ARCH)) == 512   # the prefill
    assert tmoe._capacity(4, get_config(ARCH)) == 4        # batch-4 decode


def test_init_layout_matches_jax(model):
    cfg, jcfg, jp, _ = model
    for c, j in ((cfg, jcfg), _cfgs(num_shared=1)):
        mine = tparams.init_tree(tT.model_spec(c),
                                 torch.Generator().manual_seed(0),
                                 torch.float32, "cpu")
        theirs = jparams.init_tree(jT.model_spec(j), jax.random.key(0),
                                   jnp.float32)
        a = [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
             for p, t in _leaves(mine)]
        b = [(p, tuple(x.shape), str(np.asarray(x).dtype))
             for p, x in _leaves(theirs)]
        assert a == b
    ffn = mine["blocks"]["pos0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].shape == (2, 4, 256, 128)
    assert "shared" in ffn


def _route_jax(jcfg, router, x):
    """The JAX package's top-k picks, as its moe_ffn_* compute them."""
    logits = jnp.einsum("...d,de->...e", jnp.asarray(x, jnp.float32),
                        router)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, sel = jax.lax.top_k(probs, jcfg.moe.top_k)
    return np.asarray(gate), np.asarray(sel)


MOE_CASES = {
    "default": {},
    "capacity_drops": {"capacity_factor": 0.5},
    "shared_expert": {"num_shared": 1},
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("grouped", [False, True])
def test_moe_ffn_matches_jax(case, grouped):
    cfg, jcfg = _cfgs(moe_group_dispatch=grouped, **MOE_CASES[case])
    jp, tp = _params(jcfg, seed=3)
    jffn = jax.tree.map(lambda a: a[1], jp["blocks"]["pos0"]["ffn"])
    tffn = tparams.tree_slice(tp["blocks"]["pos0"]["ffn"], 1)
    # grouped: 256 tokens a row are two dispatch chunks of 128
    b, s = 2, 256 if grouped else 40
    x = np.random.default_rng(4).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)

    jgate, jsel = _route_jax(jcfg, jffn["router"], x)
    gate, sel, _ = tmoe._route(cfg, torch.from_numpy(x), tffn["router"])
    np.testing.assert_array_equal(sel.numpy(), jsel)
    np.testing.assert_allclose(
        gate.numpy(), jgate / jgate.sum(-1, keepdims=True), **FFN_TOL)
    if case == "capacity_drops":
        # some assignments find their expert full (global: over the
        # whole batch; grouped: within a chunk)
        m = cfg.moe
        chunks = b * s // tmoe.MOE_DISPATCH_CHUNK if grouped else 1
        flat = sel.reshape(chunks, -1)
        cap = tmoe._capacity(tmoe.MOE_DISPATCH_CHUNK if grouped
                             else b * s, cfg)
        per_expert = torch.stack([(flat == e).sum(-1)
                                  for e in range(m.num_experts)])
        assert (per_expert > cap).any()

    fn = tmoe.moe_ffn_grouped if grouped else tmoe.moe_ffn_global
    jfn = jmoe.moe_ffn_grouped if grouped else jmoe.moe_ffn_global
    tgmm.launches.reset()
    y, aux = tmoe.moe_ffn(cfg, tffn, torch.from_numpy(x), cfg.act)
    y2, _ = fn(cfg, tffn, torch.from_numpy(x), cfg.act)
    jy, jaux = jfn(jcfg, jffn, jnp.asarray(x), jcfg.act)
    assert y.shape == x.shape and torch.equal(y, y2)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FFN_TOL)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-6)
    assert tgmm.launches.count == 0      # the plain version, uncounted


def test_every_expert_matmul_goes_through_ops_moe_gmm(model, monkeypatch):
    cfg, _, _, tp = model
    calls = []
    real = tops.moe_gmm

    def spy(x, w, **kw):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, **kw)
    monkeypatch.setattr(tops, "moe_gmm", spy)
    toks = torch.from_numpy(_tokens(cfg, 2, 16, 1)).long()
    for grouped in (False, True):
        calls.clear()
        c = dataclasses.replace(cfg, moe_group_dispatch=grouped)
        with torch.inference_mode():
            tT.forward(c, tp, {"tokens": toks}, torch.float32)
        assert len(calls) == 3 * cfg.n_layers
        e, d, f = 4, cfg.d_model, cfg.moe.d_expert
        cap = tmoe._capacity(16 if grouped else 32, c)
        rows = 2 * cap if grouped else cap
        assert calls[:3] == [((e, rows, d), (e, d, f)),
                             ((e, rows, d), (e, d, f)),
                             ((e, rows, f), (e, f, d))]


@pytest.mark.parametrize("grouped", [False, True])
def test_forward_logits_match_jax(model, grouped):
    cfg, jcfg, jp, tp = model
    cfg = dataclasses.replace(cfg, moe_group_dispatch=grouped)
    jcfg = dataclasses.replace(jcfg, moe_group_dispatch=grouped)
    toks = _tokens(cfg, 2, 32, 2)
    want, jaux = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            jnp.float32)
    with torch.inference_mode():
        got, aux = tT.forward(cfg, tp,
                              {"tokens": torch.from_numpy(toks).long()},
                              torch.float32)
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("load_balance", "router_z"):
        assert float(aux[k]) > 0
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5)


def test_score_matches_jax_with_router_losses(model):
    cfg, jcfg, jp, tp = model
    toks = _tokens(cfg, 3, 20, 4)
    want = JEngine(jcfg, jp, max_seq=32).score(toks)
    got = ServeEngine(cfg, tp, max_seq=32, device="cpu").score(toks)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * abs(want)
    # the router losses are in it: the bare NLL is smaller
    with torch.inference_mode():
        t = torch.from_numpy(toks).long()
        _, metrics = tT.loss_fn(cfg, tp, {"tokens": t[:, :-1],
                                          "labels": t[:, 1:]},
                                torch.float32)
    assert float(metrics["loss"]) < got
    np.testing.assert_allclose(float(metrics["total_loss"]), got,
                               rtol=1e-6)


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
            tl, new = tT.decode_step(
                cfg, tp, torch.from_numpy(toks[:, i:i + 1]).long(), tcache,
                i, None, torch.float32)
        assert new is not tcache
        tcache = new
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for (_, x1), (_, x2) in zip(_leaves(tcache), _leaves(jcache)):
        np.testing.assert_allclose(x1.numpy(), np.asarray(x2), **TOL)


def test_greedy_generate_matches_jax(model):
    cfg, jcfg, jp, tp = model
    prompts = _tokens(cfg, 2, 4, 6)
    want = JEngine(jcfg, jp, max_seq=32).generate(prompts, 6)
    got = ServeEngine(cfg, tp, max_seq=32, device="cpu").generate(prompts,
                                                                  6)
    assert got.shape == (2, 10) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[:, :4], prompts)


@pytest.mark.parametrize("grouped", [False, True])
def test_decode_matches_own_forward_at_no_drop_capacity(model, grouped):
    """Teacher-forced decode logits against the port's own prefill. At
    the default capacity the prefill drops assignments that decode (one
    token a row) never drops, so both run at capacity_factor = E/top_k,
    where nothing can drop."""
    cfg, _, _, tp = model
    cfg = dataclasses.replace(_no_drop(cfg), moe_group_dispatch=grouped)
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


def test_launcher_serves_granite_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--batch", "2", "--prompt-len", "3", "--new", "4"])
    tlaunch.main()
    assert f"{ARCH} on cpu: generated (2, 7)" in capsys.readouterr().out
