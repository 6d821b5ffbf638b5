"""Training steps of the encoder-decoder (whisper) and of the vision
prefix (internvl2) in the port against the JAX package, on the CPU,
where attention takes its plain version.

For the reduced ``whisper-large-v3`` (2 encoder layers over 16 frames, 2
decoder layers; its config's AdamW) and the reduced ``internvl2-76b`` (2
layers behind 8 patch embeddings; its config's Adafactor), params drawn
with numpy over the JAX package's spec and one batch of tokens with
frames or patches (normal x 0.02) go through ``make_train_step`` of both
packages for STEPS steps: the first step's metrics at rtol 1e-5, and the
loss of every step and after the last at rtol 1e-4, as
``tests/test_torch_lm_train.py`` holds the decoder-only models.
"""
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
from repro_torch.launch import steps as tST  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.train import optimizer as tO  # noqa: E402

LR = 3e-4
STEPS = 3
B, S = 2, 12                 # the batch and the text tokens a row


def _params(spec, seed):
    """Params of the JAX package's ``spec`` drawn with numpy (normal of
    std ``scale / sqrt(fan_in)``, the norms' scales uniform in [0.5,
    1.5], the biases normal of std 0.1), as numpy arrays."""
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
    return jax.tree.map(leaf, spec, is_leaf=jP.is_spec)


def _batch(cfg, seed):
    """Tokens and labels (B, S), and the frames (B, n_frames, d) or the
    patches (B, num_tokens, d) the model takes, normal x 0.02."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder is not None:
        batch["frames"] = (rng.normal(size=(B, cfg.encoder.n_frames,
                                            cfg.d_model)) * 0.02
                           ).astype(np.float32)
    else:
        batch["patches"] = (rng.normal(size=(B, cfg.frontend.num_tokens,
                                             cfg.d_model)) * 0.02
                            ).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch, optimizer", [
    ("whisper-large-v3", "adamw"), ("internvl2-76b", "adafactor")])
def test_train_steps_match_jax(arch, optimizer):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    assert repr(cfg) == repr(jcfg) and cfg.optimizer == optimizer
    tree = _params(jT.model_spec(jcfg), 0)
    batch = _batch(cfg, 1)

    jopt = jO.make_optimizer(jcfg.optimizer)
    jstep = jax.jit(jST.make_train_step(jcfg, jopt, lr=LR,
                                        compute_dtype=jnp.float32))
    jp = jax.tree.map(jnp.asarray, tree)
    js, jb = jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    # one step more: its metrics are the loss after STEPS steps
    for _ in range(STEPS + 1):
        jp, js, jm = jstep(jp, js, jb)
        want.append({k: float(v) for k, v in jm.items()})

    params = tP.from_numpy(tree, "cpu")
    opt = tO.make_optimizer(cfg.optimizer)
    state = opt.init(params)
    step = tST.make_train_step(cfg, opt, lr=LR, compute_dtype=torch.float32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for _ in range(STEPS):
        params, state, metrics = step(params, state, tb)
        got.append({k: float(v) for k, v in metrics.items()})
    with torch.no_grad():
        final = float(tT.loss_fn(cfg, params, tb, torch.float32)[0])

    assert got[0].keys() == want[0].keys()
    for k, v in got[0].items():
        np.testing.assert_allclose(v, want[0][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(
        [m["total_loss"] for m in got] + [final],
        [m["total_loss"] for m in want], rtol=1e-4)
    assert int(state["count"]) == STEPS
