"""The attention forward's row log-sum-exp and the split-NN tower's
attention gradient through the backward kernel's dispatch, on the CPU,
against the JAX package.

* ``ref.attention_ref(..., return_lse=True)``, the plain version of the
  ``lse`` that the forward kernel writes under grad, equals
  ``jax.nn.logsumexp`` of the masked, scaled scores formed on the same
  numpy inputs under ``repro.kernels.ref.attention_ref``'s convention
  (q scaled in f32, masked scores -1e30), and its output equals the JAX
  package's: causal, windowed, GQA, sq != sk, rows that see no key.
* The tower's ``_attention`` with ``kernel="auto"`` applies
  ``kernels.flash_attention.FlashAttention`` under grad, which runs the
  forward with ``return_lse`` and, as its backward,
  ``kernels.flash_attention.flash_attention_bwd`` (the card's dispatch
  line; on a CPU tensor the plain VJP): its gradients equal ``jax.vjp``
  of ``repro.models.tower._attention`` on the same inputs within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import tower as jtwr  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import tower as ttwr  # noqa: E402


def _jax_lse(q, k, causal, window):
    """logsumexp of ``repro.kernels.ref.attention_ref``'s masked, scaled
    scores, (b, h, sq)."""
    b, h, sq, dh = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(b, kvh, h // kvh, sq, dh)
    s = jnp.einsum("bngqd,bnkd->bngqk", qg * dh ** -0.5, jnp.asarray(k))
    qi = jnp.arange(sq)[:, None]
    ki = jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), bool)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= qi - ki < window
    s = jnp.where(mask, s, jref.NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(b, h, sq)


@pytest.mark.parametrize("b,h,kvh,sq,sk,dh,causal,window", [
    (2, 4, 2, 24, 24, 8, True, 0),      # causal, GQA 2:1
    (1, 4, 2, 24, 24, 8, True, 5),      # a window
    (1, 3, 1, 13, 29, 16, False, 0),    # bidirectional, sq < sk, GQA 3:1
    (1, 2, 2, 30, 10, 4, True, 3),      # rows 12.. see no key
    (1, 2, 1, 30, 10, 4, False, 3),     # the same, bidirectional
])
def test_plain_lse_matches_jax_logsumexp(b, h, kvh, sq, sk, dh, causal,
                                         window):
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((b, h, sq, dh), dtype=np.float32)
    k, v = (rng.standard_normal((b, kvh, sk, dh), dtype=np.float32)
            for _ in range(2))
    o, lse = ref.attention_ref(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    want = _jax_lse(q, k, causal, window)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=0)
    if window and sq - 1 - (sk - 1) >= window:
        # a row that sees no key: -1e30 + log(sk), -1e30 in f32
        assert lse[0, 0, -1].item() == np.float32(jref.NEG_INF)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jref.attention_ref(q, k, v, causal=causal,
                                                 window=window)),
        rtol=1e-6, atol=1e-6)
    # the same output with and without the lse
    assert torch.equal(o, ref.attention_ref(*map(torch.from_numpy,
                                                 (q, k, v)),
                                            causal=causal, window=window))


@pytest.mark.parametrize("kernel", ["auto", "ref"])
def test_tower_attention_grads_match_jax_vjp(kernel, monkeypatch):
    rng = np.random.default_rng(5)
    shape = (6, 4, 8, 16)                 # the tower's (rows, 4, 8, 16)
    q, k, v, g = (rng.standard_normal(shape, dtype=np.float32)
                  for _ in range(4))
    calls = {"fwd_lse": 0, "bwd": 0}
    fwd, bwd = tfa.flash_attention, tfa.flash_attention_bwd

    def spy_fwd(*a, **kw):
        calls["fwd_lse"] += bool(kw.get("return_lse"))
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        assert kw["lse"] is not None and kw["causal"] is False
        return bwd(*a, **kw)
    monkeypatch.setattr(tfa, "flash_attention", spy_fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd", spy_bwd)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ttwr._attention(*leaves, kernel)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    routed = kernel != "ref"
    assert calls == {"fwd_lse": int(routed), "bwd": int(routed)}
    # outside grad: the forward alone, no lse
    with torch.no_grad():
        again = ttwr._attention(*leaves, kernel)
    assert calls["fwd_lse"] == int(routed) and torch.equal(again, out)
    _, vjp = jax.vjp(lambda a, b, c: jtwr._attention(a, b, c, "ref"),
                     *map(jnp.asarray, (q, k, v)))
    for a, e in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-6,
                                   atol=1e-6)
