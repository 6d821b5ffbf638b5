"""Language-model training in the port against the JAX package, on the
CPU, where the kernels take their plain versions.

For reduced ``qwen3-14b``, ``granite-moe-3b-a800m`` (router losses in
the metrics), ``rwkv6-7b`` and ``jamba-1.5-large-398b``, params from the
JAX package's ``init_tree`` loaded through ``from_numpy`` and one batch
from ``make_lm_batches`` go through both packages:

* loss and metrics at rtol 1e-5, every gradient within 1e-4 of its
  leaf's largest (``steps.loss_and_grads`` against ``jax.value_and_grad``
  of ``loss_fn``);
* the loss after 3 AdamW steps at rtol 1e-4 (the port's
  ``make_train_step`` against the JAX package's step: value_and_grad,
  then ``optimizer.adamw``'s update, in one jitted function);
* ``accum_steps=2``: against the JAX package's ``make_train_step`` at 2
  on the same batch, and equal to ``accum_steps=1`` on a batch of two
  equal microbatches;
* ``remat_policy`` ``full`` and ``minimal`` give ``none``'s gradients
  exactly (recomputation changes memory, not values);
* ``train()`` on reduced ``h2o-danube-1.8b`` lowers the loss and serves
  its params, as ``tests/test_system.py``'s trainer test; the CLI with
  ``--device cpu`` in a subprocess, and with ``--mesh`` (the (1, 1)
  mesh) the same final metrics; the train and prefill steps of
  whisper-large-v3 (AdamW) and internvl2-76b (Adafactor) step on a
  larger mesh, with a sequence split too, that one held to the
  unsharded step (``tests/test_torch_sharded_steps.py`` holds every
  family's sharded steps).
"""
import dataclasses
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

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as jST  # noqa: E402
from repro.models import params as jP  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.train import optimizer as jO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import make_lm_batches  # noqa: E402
from repro_torch.launch import steps as tST  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.sharding.rules import MeshRules  # noqa: E402
from repro_torch.train import optimizer as tO  # noqa: E402
from repro_torch.train.trainer import TrainJob, train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-14b", "granite-moe-3b-a800m", "rwkv6-7b",
         "jamba-1.5-large-398b"]
# TrainJob's default rate. AdamW's first steps move every param by about
# lr whatever its gradient's size, so where a gradient is near 0 its sign
# (rounding noise in either package) moves the loss by O(lr)
LR = 3e-4
STEPS = 3


def _batch(cfg, b=2, s=32, seed=0):
    return next(make_lm_batches(cfg.vocab, b, s, 1, seed=seed))


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _params(jcfg, seed=0):
    jp = jP.init_tree(jT.model_spec(jcfg), jax.random.key(seed),
                      jnp.float32)
    return jp, tP.from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Both packages on one arch: the JAX package's loss, metrics and
    grads at the initial params and its losses over STEPS AdamW steps,
    from one jitted function; the port's params and batch."""
    arch = request.param
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    assert repr(cfg) == repr(jcfg)
    jp, tp = _params(jcfg)
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = jO.adamw()

    @jax.jit
    def step(p, s):
        (loss, metrics), g = jax.value_and_grad(
            lambda p: jT.loss_fn(jcfg, p, jb, jnp.float32),
            has_aux=True)(p)
        p, s = opt.update(g, s, p, jnp.asarray(LR, jnp.float32))
        return metrics, g, p, s

    state = opt.init(jp)
    metrics, grads, losses = None, None, []
    for i in range(STEPS + 1):
        m, g, jp, state = step(jp, state)
        if i == 0:
            metrics, grads = m, g
        losses.append(float(m["total_loss"]))
    return dict(arch=arch, cfg=cfg, params=tp, batch=batch,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, grads), losses=losses)


def test_loss_and_grads_match_jax(run):
    loss, metrics, grads = tST.loss_and_grads(
        run["cfg"], run["params"], _torch_batch(run["batch"]),
        torch.float32)
    assert metrics.keys() == run["metrics"].keys()
    if run["cfg"].moe is not None:
        assert "load_balance" in metrics
    np.testing.assert_allclose(float(loss), run["metrics"]["total_loss"],
                               rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), run["metrics"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got, exp = tP.tree_items(grads), tP.tree_items(run["grads"])
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, g), (_, e) in zip(got, exp):
        assert g is not None, path
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=1e-4 * np.abs(e).max(),
                                   err_msg="/".join(path))


def test_adamw_steps_match_jax(run):
    cfg = run["cfg"]
    params = tP.tree_map(torch.clone, run["params"])
    opt = tO.adamw()
    state = opt.init(params)
    step = tST.make_train_step(cfg, opt, lr=LR, compute_dtype=torch.float32)
    batch = _torch_batch(run["batch"])
    losses = []
    for _ in range(STEPS):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["total_loss"]))
    final, _ = tT.loss_fn(cfg, params, batch, torch.float32)
    np.testing.assert_allclose(losses + [float(final)], run["losses"],
                               rtol=1e-4)
    assert int(state["count"]) == STEPS


def test_accum_steps_match_jax_and_equal_microbatches():
    """Accumulation against the JAX package's ``make_train_step`` at
    ``accum_steps=2``, read through SGD at lr 1 (momentum starts at 0,
    so the step subtracts the averaged gradient itself); and two equal
    microbatches accumulate to one's gradient exactly."""
    arch = "qwen3-14b"
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jp, tp = _params(jcfg, seed=1)
    batch = _batch(cfg, b=4, s=16, seed=1)
    jstep = jax.jit(jST.make_train_step(jcfg, jO.sgdm(), lr=1.0,
                                        compute_dtype=jnp.float32,
                                        accum_steps=2))
    jp2, _, jm = jstep(jp, jO.sgdm().init(jp),
                       {k: jnp.asarray(v) for k, v in batch.items()})

    def port(params, batch, accum):
        params = tP.tree_map(torch.clone, params)
        opt = tO.sgdm()
        step = tST.make_train_step(cfg, opt, lr=1.0,
                                   compute_dtype=torch.float32,
                                   accum_steps=accum)
        return step(params, opt.init(params), _torch_batch(batch))

    tp2, _, tm = port(tp, batch, 2)
    for k, v in tm.items():
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for (path, p0), (_, a), (_, b) in zip(
            tP.tree_items(tp), tP.tree_items(tp2),
            tP.tree_items(jax.tree.map(np.asarray, jp2))):
        g_port, g_jax = p0.numpy() - a.numpy(), p0.numpy() - b
        np.testing.assert_allclose(g_port, g_jax, rtol=0,
                                   atol=1e-4 * np.abs(g_jax).max(),
                                   err_msg="/".join(path))
    # two equal microbatches: (g / 2 + g / 2) is g exactly
    half = {k: v[:2] for k, v in batch.items()}
    twice = {k: np.concatenate([v, v]) for k, v in half.items()}
    p_acc, _, m_acc = port(tp, twice, 2)
    p_one, _, m_one = port(tp, half, 1)
    assert m_acc.keys() == m_one.keys()
    for k in m_one:
        assert torch.equal(m_acc[k], m_one[k]), k
    for (path, a), (_, b) in zip(tP.tree_items(p_acc),
                                 tP.tree_items(p_one)):
        assert torch.equal(a, b), "/".join(path)


@pytest.mark.parametrize("policy", ["full", "minimal"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-7b"])
def test_remat_policy_keeps_gradients_exact(arch, policy):
    base = dataclasses.replace(get_config(arch).reduced(),
                               remat_policy="none")
    params = tP.init_tree(tT.model_spec(base),
                          torch.Generator().manual_seed(2), torch.float32,
                          "cpu")
    batch = _torch_batch(_batch(base, seed=2))
    loss0, _, g0 = tST.loss_and_grads(base, params, batch, torch.float32)
    cfg = dataclasses.replace(base, remat_policy=policy)
    loss1, _, g1 = tST.loss_and_grads(cfg, params, batch, torch.float32)
    assert torch.equal(loss0, loss1)
    for (path, a), (_, b) in zip(tP.tree_items(g0), tP.tree_items(g1)):
        assert torch.equal(a, b), "/".join(path)
    # no recomputation where nothing keeps a graph
    with torch.inference_mode():
        logits, _ = tT.forward(cfg, params, batch, torch.float32)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("policy", ["none", "full", "minimal"])
def test_kernel_functions_under_remat(monkeypatch, policy):
    """The card's path on the CPU: attention and the expert matmuls
    through their ``torch.autograd.Function``s (whose CPU directions are
    the plain versions), under each remat policy, give the gradients of
    autograd through the plain versions, and ``full`` / ``minimal`` give
    ``none``'s exactly."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import moe_gmm as tgmm
    from repro_torch.kernels import ops

    base = dataclasses.replace(
        get_config("granite-moe-3b-a800m").reduced(), remat_policy="none")
    params = tP.init_tree(tT.model_spec(base),
                          torch.Generator().manual_seed(4), torch.float32,
                          "cpu")
    batch = _torch_batch(_batch(base, seed=4))
    _, _, plain = tST.loss_and_grads(base, params, batch, torch.float32)
    calls = {"attention": 0, "gmm": 0}

    def attention(q, k, v, *, causal=True, window=0, scale=None,
                  kernel="auto"):
        calls["attention"] += 1
        return tfa.FlashAttention.apply(q, k, v, causal, window, scale)

    def gmm(x, w, *, kernel="auto"):
        calls["gmm"] += 1
        return tgmm.MoeGmm.apply(x, w)

    monkeypatch.setattr(ops, "flash_attention", attention)
    monkeypatch.setattr(ops, "moe_gmm", gmm)
    grads = {}
    for pol in ("none", policy):
        cfg = dataclasses.replace(base, remat_policy=pol)
        calls.update(attention=0, gmm=0)
        _, _, grads[pol] = tST.loss_and_grads(cfg, params, batch,
                                              torch.float32)
        # a forward of each layer, and under remat its recomputation
        layers = cfg.n_layers * (1 if pol == "none" else 2)
        assert calls == {"attention": layers, "gmm": 3 * layers}, calls
    for (path, a), (_, b), (_, c) in zip(tP.tree_items(grads["none"]),
                                         tP.tree_items(grads[policy]),
                                         tP.tree_items(plain)):
        assert torch.equal(a, b), "/".join(path)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)


def test_trainer_lowers_loss_and_serves():
    cfg = get_config("h2o-danube-1.8b").reduced()
    job = TrainJob(cfg=cfg, steps=20, lr=3e-3, log_every=5, device="cpu")
    res = train(job, make_lm_batches(cfg.vocab, 4, 64, 25))
    hist = res["history"]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert {"step", "t", "loss", "accuracy", "tokens", "total_loss",
            "tokens_per_s"} <= hist[-1].keys()
    eng = ServeEngine(cfg, res["params"], max_seq=32, device="cpu")
    out = eng.generate(np.ones((2, 4), np.int32), 6)
    assert out.shape == (2, 10)


def test_train_cli_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-14b", "--reduced", "--device", "cpu", "--steps", "3",
           "--batch", "2", "--seq", "16", "--ckpt-dir",
           str(tmp_path / "ckpt"), "--metrics-dir", str(tmp_path / "m")]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=120, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "qwen3-14b: final metrics {'loss':" in res.stdout
    assert (tmp_path / "ckpt" / "step_00000003.npz").exists()
    assert (tmp_path / "m" / "train_qwen3-14b.csv").exists()
    # --mesh: the (1, 1) mesh of the device, the same training
    mesh = subprocess.run(cmd[:-4] + ["--mesh"], capture_output=True,
                          text=True, env=env, timeout=120, cwd=tmp_path)
    assert mesh.returncode == 0, mesh.stderr
    assert mesh.stdout.splitlines()[-1] == res.stdout.splitlines()[-1]


def test_mesh_rules_raise():
    """On a mesh of more than one device the train and prefill steps of
    an encoder-decoder (whisper, AdamW) and the Adafactor train step of
    a vision prefix (internvl2) build and take a step; with a sequence
    split (``act_rules["seq"]``) they take it too, with the unsharded
    step's metrics and last logits. A decode step takes any mesh."""
    cfg = get_config("whisper-large-v3").reduced()
    vlm = get_config("internvl2-76b").reduced()
    mesh = make_local_mesh(1, 2, devices=["cpu"] * 2)
    rules, seq = MeshRules(mesh), MeshRules(mesh)
    seq.act_rules["seq"] = ("model",)
    rng = np.random.default_rng(0)
    for c, opt, stub, n in ((cfg, tO.adamw, "frames",
                             cfg.encoder.n_frames),
                            (vlm, tO.adafactor, "patches",
                             vlm.frontend.num_tokens)):
        batch = _torch_batch(dict(_batch(c, b=2, s=8), **{stub: (
            rng.standard_normal((2, n, c.d_model)) * 0.02).astype(
                np.float32)}))
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        got = {}
        for name, r in (("none", None), ("rows", rules), ("seq", seq)):
            params = tP.init_tree(tT.model_spec(c),
                                  torch.Generator().manual_seed(0),
                                  torch.float32, "cpu")
            if r is not None:
                params = tST.place_params(c, params, r)
            o = opt()
            step = tST.make_train_step(c, o, rules=r,
                                       compute_dtype=torch.float32)
            logits = tST.make_prefill_step(c, r, torch.float32)(params,
                                                                inputs)
            _, _, metrics = step(params, o.init(params), batch)
            got[name] = metrics, logits
        assert np.isfinite(float(got["rows"][0]["loss"]))
        assert got["rows"][1].shape == (2, c.vocab)
        (exp_m, exp_l), (seq_m, seq_l) = got["none"], got["seq"]
        for k in exp_m:
            np.testing.assert_allclose(float(seq_m[k]), float(exp_m[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        assert float((seq_l - exp_l).abs().max()) <= \
            1e-5 * float(exp_l.abs().max())
    tST.make_decode_step(cfg, rules=seq)


def test_prefill_and_decode_steps_match_forward():
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = tP.init_tree(tT.model_spec(cfg),
                          torch.Generator().manual_seed(3), torch.float32,
                          "cpu")
    toks = torch.as_tensor(_batch(cfg, b=1, s=8)["tokens"])
    last = tST.make_prefill_step(cfg, compute_dtype=torch.float32)(
        params, {"tokens": toks})
    decode = tST.make_decode_step(cfg, compute_dtype=torch.float32)
    cache = tT.init_cache(cfg, 1, 8, torch.float32, "cpu")
    for i in range(8):
        logits, cache = decode(params, toks[:, i:i + 1], cache, i)
    torch.testing.assert_close(logits[:, 0], last, rtol=2e-4, atol=2e-4)
