"""The PyTorch port's vision prefix (internvl2) against the JAX package's,
on the CPU, where attention takes its plain version.

* The spec of internvl2-76b cut to 16 layers (15,791,824,896 params,
  nothing allocated) and of its reduced config equal the JAX package's.
* The reduced model (2 layers, d 256, 8 patch embeddings of normal x
  0.02 in front of the tokens), on params from the JAX package's init
  carried across as numpy trees: ``forward`` logits with the patches
  within 2e-4 (RoPE over every position, the patches' too);
  ``make_prefill_step``'s last logits; ``loss_fn`` with the prefix
  masked out within 1e-5, and unmoved when the labels under the prefix
  change; its gradients within 1e-4 of each leaf's largest; the text
  path's ``decode_step`` within 2e-3, as the zoo's decode tests hold it.
* Serving: ``ServeEngine.generate`` decodes text tokens, as the JAX
  engine's does, and ``score`` (a batch without patches) raises a
  ``ValueError`` naming ``patches`` and ``make_prefill_step`` where the
  JAX engine's raises ``KeyError('patches')``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import params as jP  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as tST  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "internvl2-76b"
B, S = 2, 12                 # the batch and the text tokens a row


@pytest.fixture(scope="module")
def model():
    """(cfg, the JAX package's cfg, JAX params, the same params as CPU
    tensors)."""
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    assert repr(cfg) == repr(jcfg)
    jp = jP.init_tree(jT.model_spec(jcfg), jax.random.key(0), jnp.float32)
    return cfg, jcfg, jp, tP.from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed, labels=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    patches = (rng.normal(size=(B, cfg.frontend.num_tokens, cfg.d_model))
               * 0.02).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "patches": patches}
    if labels:
        batch["labels"] = toks[:, 1:]
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_spec_matches_jax():
    for cut in (lambda c: c.reduced(),
                lambda c: dataclasses.replace(c, n_layers=16)):
        cfg, jcfg = cut(get_config(ARCH)), cut(jget_config(ARCH))
        t_spec, j_spec = tT.model_spec(cfg), jT.model_spec(jcfg)
        assert tP.param_bytes(t_spec, 1) == jP.param_bytes(j_spec, 1)
    assert tP.param_bytes(t_spec, 1) == 15_791_824_896
    assert cfg.reduced().frontend.num_tokens == 8


def test_forward_logits_with_patches_match_jax(model):
    cfg, jcfg, jp, tp = model
    jb, tb = _both(_batch(cfg, 1, labels=False))
    want, _ = jT.forward(jcfg, jp, jb, jnp.float32)
    with torch.inference_mode():
        got, _ = tT.forward(cfg, tp, tb, torch.float32)
        last = tST.make_prefill_step(cfg, compute_dtype=torch.float32)(
            tp, tb)
    n = cfg.frontend.num_tokens + S
    assert got.shape == (B, n, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(last, got[:, -1])


def test_loss_masks_the_prefix_as_jax(model, monkeypatch):
    cfg, jcfg, jp, tp = model
    jb, tb = _both(_batch(cfg, 2))
    want, jm = jT.loss_fn(jcfg, jp, jb, jnp.float32)
    seen = {}
    xent = tT.layers.softmax_xent

    def capture(logits, labels, mask=None):
        seen.update(logits=logits, labels=labels, mask=mask)
        return xent(logits, labels, mask)
    monkeypatch.setattr(tT.layers, "softmax_xent", capture)
    with torch.inference_mode():
        got, tm = tT.loss_fn(cfg, tp, tb, torch.float32)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the loss averages over the text positions only
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * S
    npatch = cfg.frontend.num_tokens
    labels, mask = seen["labels"], seen["mask"]
    assert not labels[:, :npatch].any() and not mask[:, :npatch].any()
    assert (mask[:, npatch:] == 1).all()
    # other labels under the prefix leave the loss as it is, bit for bit
    other = labels.clone()
    other[:, :npatch] = torch.randint(0, cfg.vocab, (B, npatch),
                                      generator=torch.Generator()
                                      .manual_seed(0))
    assert torch.equal(xent(seen["logits"], other, mask)[0], got)
    # the patches reach the text positions through attention
    with torch.inference_mode():
        moved, _ = tT.loss_fn(cfg, tp, dict(tb, patches=tb["patches"] * 2),
                              torch.float32)
    assert float(moved) != float(got)


def test_grads_match_jax(model):
    cfg, jcfg, jp, tp = model
    batch = _batch(cfg, 3)
    jb, tb = _both(batch)
    jg = jax.grad(lambda p: jT.loss_fn(jcfg, p, jb, jnp.float32)[0])(jp)
    _, _, grads = tST.loss_and_grads(cfg, tp, tb, torch.float32)
    got, exp = tP.tree_items(grads), tP.tree_items(
        jax.tree.map(np.asarray, jg))
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, g), (_, e) in zip(got, exp):
        assert g is not None, path
        np.testing.assert_allclose(g.numpy(), e, rtol=0,
                                   atol=1e-4 * np.abs(e).max(),
                                   err_msg="/".join(path))


def test_text_decode_step_matches_jax(model):
    """The decode step takes text tokens only, in both packages."""
    cfg, jcfg, jp, tp = model
    toks = _batch(cfg, 4)["tokens"][:, :6]
    jcache = jT.init_cache(jcfg, B, 6, jnp.float32)
    tcache = tT.init_cache(cfg, B, 6, torch.float32, "cpu")
    for i in range(6):
        jl, jcache = jT.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1]),
                                    jcache, i, None, jnp.float32)
        with torch.inference_mode():
            tl, tcache = tT.decode_step(cfg, tp,
                                        torch.from_numpy(toks[:, i:i + 1]),
                                        tcache, i, None, torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                                   atol=2e-3)


def test_engine_serves_the_text_path_and_score_raises(model):
    cfg, jcfg, jp, tp = model
    prompts = _batch(cfg, 5)["tokens"][:, :4]
    want = JEngine(jcfg, jp, max_seq=16).generate(prompts, 5)
    eng = ServeEngine(cfg, tp, max_seq=16, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 5),
                                  np.asarray(want))
    with pytest.raises(KeyError, match="patches"):
        JEngine(jcfg, jp, max_seq=16).score(prompts)
    with pytest.raises(ValueError, match="patches.*make_prefill_step"):
        eng.score(prompts)
