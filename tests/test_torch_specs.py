"""The port's ``launch/specs.py`` against the JAX package's, and the
``train_lm`` example, on the CPU.

* ``batch_specs`` (train and prefill) and ``cache_specs`` with
  ``rules=None``: ``meta`` tensors whose shapes and dtypes equal the JAX
  package's ``ShapeDtypeStruct``s (``cache_specs`` there is
  ``jax.eval_shape`` of ``init_cache``), for every registered arch and
  every ``SHAPES`` entry that ``shape_applicable`` admits; ``text_len``
  and ``cache_axes`` equal too, and each axis tuple as long as its
  leaf's rank. Under mesh rules each stand-in comes beside its spec,
  and the train and prefill steps build on a larger mesh, with a
  sequence split too.
* ``python -m repro_torch.examples.train_lm --steps 4 --device cpu``
  trains the example's small qwen3 (loss falling), checkpoints it and
  passes its resume check; by default it asks for the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.configs import shape_applicable  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tST  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import params as tP  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.sharding.rules import MeshRules  # noqa: E402
from repro_torch.train import optimizer as tO  # noqa: E402

CASES = [(arch, name) for arch in list_archs() for name in SHAPES
         if shape_applicable(get_config(arch), SHAPES[name])[0]]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _same(got, want):
    """Both trees' (path, shape, dtype) equal; the port's on ``meta``."""
    g, w = list(_flat(got)), list(_flat(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, t), (_, s) in zip(g, w):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(s.shape), path
        assert str(t.dtype).split(".")[-1] == np.dtype(s.dtype).name, path


@pytest.mark.parametrize("arch,shape", CASES)
def test_specs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    sh, jsh = SHAPES[shape], JSHAPES[shape]
    assert tspecs.text_len(cfg, sh) == jspecs.text_len(jcfg, jsh)
    for labels in (True, False):
        _same(tspecs.batch_specs(cfg, sh, None, labels),
              jspecs.batch_specs(jcfg, jsh, None, labels))
    cache = tspecs.cache_specs(cfg, sh, None)
    _same(cache, jspecs.cache_specs(jcfg, jsh, None))
    axes = tspecs.cache_axes(cfg)
    assert axes == jspecs.cache_axes(jcfg)
    for (path, t), (_, ax) in zip(_flat(cache), _flat(axes)):
        assert len(ax) == t.dim(), path


def test_mesh_rules_raise():
    """Under mesh rules every stand-in comes beside its resolved spec
    (``tests/test_torch_sharding.py`` holds them to the JAX package's);
    the train and prefill steps those specs feed build on a mesh of more
    than one device for internvl2-76b's vision prefix, and where the
    rules split the sequence the reduced model's prefill over patches
    and tokens cut into cells is the unsharded one's; ``place_batch``
    splits a real batch by the batch's specs, a row's patches with its
    tokens."""
    cfg, sh = get_config("qwen3-14b"), SHAPES["train_4k"]
    rules = MeshRules(make_local_mesh(1, 2, devices=["cpu"] * 2))
    batch, specs = tspecs.batch_specs(cfg, sh, rules, True)
    assert tuple(specs["tokens"]) == ("data", None)
    assert batch["tokens"].device.type == "meta"
    cache, specs = tspecs.cache_specs(cfg, sh, rules)
    assert cache["blocks"]["pos0"]["k"].device.type == "meta"
    # (layers, batch, cache_seq, kv_heads, head_dim): the sequence takes
    # the model axis, so the KV heads cannot
    assert tuple(specs["blocks"]["pos0"]["k"]) == \
        (None, "data", "model", None, None)
    vlm = get_config("internvl2-76b")
    tST.make_train_step(vlm, tO.adamw(), rules=rules)
    tST.make_prefill_step(vlm, rules=rules)
    seq = MeshRules(rules.mesh)
    seq.act_rules["seq"] = ("model",)
    tST.make_train_step(vlm, tO.adamw(), rules=seq)
    # the reduced model's 8 patches before 4 tokens, cut into two cells
    # of 6 on the split (the prefix spans both): its prefill is the
    # unsharded one's
    small = vlm.reduced()
    tokens = torch.arange(2 * 4).reshape(2, 4) % small.vocab
    patches = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, small.frontend.num_tokens, small.d_model)).astype(
            np.float32) * 0.02)
    got = []
    for r in (None, seq):
        params = tP.init_tree(tT.model_spec(small),
                              torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
        if r is not None:
            params = tST.place_params(small, params, r)
        got.append(tST.make_prefill_step(small, r, torch.float32)(
            params, {"tokens": tokens, "patches": patches}))
    assert float((got[1] - got[0]).abs().max()) <= \
        1e-5 * float(got[0].abs().max())
    assert not any("seq=12" in f for f in seq.fallbacks)
    tokens = torch.arange(8 * 3).reshape(8, 3)
    parts = tspecs.place_batch({"tokens": tokens}, rules)["tokens"]
    assert tuple(parts.spec) == ("data", None) and len(parts.parts) == 1
    assert torch.equal(parts.whole(), tokens)
    # on data 2 each row's patches are those of its tokens' rows
    rows = MeshRules(make_local_mesh(2, 1, devices=["cpu"] * 2))
    patches = torch.arange(8 * 4 * 5, dtype=torch.float32).reshape(8, 4, 5)
    placed = tspecs.place_batch({"tokens": tokens, "patches": patches},
                                rows)
    assert tuple(placed["patches"].spec) == ("data", None, None)
    for i in range(2):
        assert torch.equal(placed["tokens"].part(data=i),
                           tokens[4 * i:4 * (i + 1)])
        assert torch.equal(placed["patches"].part(data=i),
                           patches[4 * i:4 * (i + 1)])


def test_train_lm_example_resumes_on_cpu(tmp_path, capsys):
    out = train_lm.main(["--steps", "4", "--batch", "8", "--seq", "32",
                         "--device", "cpu", "--out", str(tmp_path)])
    assert out["loss_last"] < out["loss_first"]
    assert out["step"] == 4 and out["loss"] == out["loss_restored"]
    assert (tmp_path / "ckpt" / "step_00000004.npz").exists()
    assert "checkpoint roundtrip" in capsys.readouterr().out


def test_train_lm_example_asks_for_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--steps", "1", "--out", str(tmp_path)])
