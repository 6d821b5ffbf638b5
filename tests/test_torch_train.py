"""Split-NN training in the PyTorch port against the JAX package, on
the CPU: the master's step and the member's VJP of a narrow transformer
tower (``embed`` -> ``attn_block`` -> ``quantize`` -> ``mlp``) on the
same numpy inputs, the kernel blocks' backward rules, and whole
``run_vfl`` fits in thread mode from one JAX checkpoint cut at pipeline
depth 1 and 2, with channel compression and the noise defense.

Both packages quantize on the same grid (the jitted reference's
multiply by float32(1/127), ``kernels/ref.py``), but their f32 matmuls
sum in other orders, so a quantize input that sits within an ulp or so
of a .5 tie can round to codes one step apart. Where that happens the
dequantized values differ by one step of that row's scale; the tests
find such flips and hold those elements at one code step, the rest at
the stated tolerances."""
import functools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.party import VFLJob as JaxJob  # noqa: E402
from repro.core.party import run_vfl as jax_run_vfl  # noqa: E402
from repro.core.protocols import split_nn as jsn  # noqa: E402
from repro.core.protocols.base import VFLConfig as JaxConfig  # noqa: E402
from repro.core.protocols.driver import Checkpointer  # noqa: E402
from repro.data.vertical import vertical_partition  # noqa: E402
from repro.kernels.ref import quantize_int8_ref as jax_quantize  # noqa: E402
from repro.models import tower as jtwr  # noqa: E402
from repro_torch.comm.local import ThreadBus  # noqa: E402
from repro_torch.comm.schema import TypedChannel  # noqa: E402
from repro_torch.core.party import VFLJob, run_vfl  # noqa: E402
from repro_torch.core.protocols import base as tbase  # noqa: E402
from repro_torch.core.protocols import split_nn as tsn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import tower as ttwr  # noqa: E402

NARROW = ("embed:tokens=4,dim=16", "attn_block:heads=2", "quantize",
          "mlp:hidden=16")
TOP = ("mlp:hidden=16,final_act=0",)
TOWERS = {"legacy_mlp": ((), ()), "narrow": (NARROW, TOP)}
LR = 0.1


def _np(tree):
    return [np.asarray(a) for a in jax.tree.leaves(
        jax.tree.map(np.asarray, tree))]


def _torch_leaves(tree):
    return [t.detach().numpy() for t in ttwr.leaves(tree)]


def _assert_trees(got, want, rtol, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# one step on shared inputs
# ---------------------------------------------------------------------------


def _step_inputs(tower, top_tower, seed=0):
    rng = np.random.default_rng(seed)
    n, dm, emb, items = 32, 9, 8, 3
    cfg = JaxConfig(tower=tower, top_tower=top_tower, embedding_dim=emb,
                    hidden=(16,))
    bspec = jsn.bottom_spec(cfg, dm)
    tspec = jsn.top_spec(cfg, items)
    bottom = jax.jit(functools.partial(jtwr.init, bspec))(
        jax.random.key(seed + 1))
    top = jax.jit(functools.partial(jtwr.init, tspec))(
        jax.random.key(seed + 2))
    x = rng.normal(size=(n, dm)).astype(np.float32)
    y = (rng.random((n, items)) > 0.5).astype(np.float32)
    u = rng.normal(size=(n, emb)).astype(np.float32)
    tcfg = tbase.VFLConfig(tower=tower, top_tower=top_tower,
                           embedding_dim=emb, hidden=(16,))
    return (cfg, tcfg, bspec, tspec, bottom, top, x, y, u,
            tsn.bottom_spec(tcfg, dm), tsn.top_spec(tcfg, items))


def _quant_inputs(spec, params, x, package):
    """The quantize block's input of a tower, computed by ``package``."""
    i = spec.kinds.index("quantize")
    head = spec.blocks[:i]
    if package == "jax":
        def run(ps, h):
            for b, p in zip(head, ps):
                h = jtwr._BLOCK_APPLY[b["kind"]](b, p, h)
            return h.reshape(-1, h.shape[-1])
        return np.asarray(jax.jit(run)(params[:i], jnp.asarray(x)))
    h = torch.from_numpy(x)
    with torch.no_grad():
        for b, p in zip(head, params):
            h = ttwr._BLOCK_APPLY[b["kind"]](b, p, h)
    return h.reshape(-1, h.shape[-1]).numpy()


def _code_flips(jspec, jparams, tspec, tparams, x) -> int:
    """Quantize codes that differ between the two packages' towers on
    ``x`` (ties broken apart by f32 summation order), at most one step
    each."""
    if "quantize" not in jspec.kinds:
        return 0
    jq, _ = jax.jit(jax_quantize)(_quant_inputs(jspec, jparams, x, "jax"))
    tq, _ = ops.quantize_int8(
        torch.from_numpy(_quant_inputs(tspec, tparams, x, "torch")))
    diff = np.abs(np.asarray(jq, np.int32) - tq.numpy().astype(np.int32))
    assert diff.max() <= 1, "a code more than one step apart"
    return int((diff > 0).sum())


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_master_step_matches_jax(tower):
    """Loss, the updated top and bottom params and du of one master
    round: rtol 1e-5 (atol 1e-6 for elements near zero), or one code
    step's effect (``_step_rtol``)."""
    (_, _, bspec, tspec, bottom, top, x, y, u, tb, tt) = _step_inputs(
        *TOWERS[tower])
    step = jsn._make_master_step(bspec, tspec)
    loss, new_top, new_bottom, du = step(
        top, bottom, (jnp.asarray(u),), jnp.asarray(x), jnp.asarray(y),
        jnp.float32(LR))
    ttop = ttwr.from_numpy(_np_tree(top), "cpu")
    tbottom = ttwr.from_numpy(_np_tree(bottom), "cpu")
    rtol = _step_rtol(_code_flips(bspec, bottom, tb, tbottom, x))
    tloss, ttop2, tbottom2, tdu = tsn.master_step(
        tb, tt, ttop, tbottom, [torch.from_numpy(u)], torch.from_numpy(x),
        torch.from_numpy(y), float(np.float32(LR)))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=rtol)
    _assert_trees(_torch_leaves(ttop2), _np(new_top), rtol, 1e-6)
    _assert_trees(_torch_leaves(tbottom2), _np(new_bottom), rtol, 1e-6)
    assert len(tdu) == 1
    np.testing.assert_allclose(tdu[0].numpy(), np.asarray(du[0]), rtol=rtol,
                               atol=1e-8)


def _step_rtol(flips: int) -> float:
    """rtol 1e-5; 1e-3 where a quantize code came out one step apart
    (a step of a row's scale moves that row's outputs by about 1e-3 of
    their size)."""
    return 1e-3 if flips else 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_member_vjp_matches_jax(tower):
    """The member's update (VJP of its bottom tower at its params
    against du, then SGD) and the tower's VJP with respect to its input,
    against ``jax.vjp``: rtol 1e-5, or one code step's effect."""
    (_, _, bspec, _, params, _, x, _, u, tb, _) = _step_inputs(
        *TOWERS[tower], seed=3)
    du = (u * 0.01).astype(np.float32)
    _, bwd = jsn._make_member_fns(bspec, None)
    want = bwd(params, jnp.asarray(x), jnp.asarray(du), jnp.float32(LR))
    tparams = ttwr.from_numpy(_np_tree(params), "cpu")
    rtol = _step_rtol(_code_flips(bspec, params, tb, tparams, x))
    got = tsn.member_step(tb, tparams, torch.from_numpy(x),
                          torch.from_numpy(du), float(np.float32(LR)))
    _assert_trees(_torch_leaves(got), _np(want), rtol, 1e-7)

    dx_want = jax.jit(lambda xx, g: jax.vjp(
        lambda z: jtwr.apply(bspec, params, z), xx)[1](g)[0])(
        jnp.asarray(x), jnp.asarray(du))
    xt = torch.from_numpy(x).requires_grad_()
    out = ttwr.apply(tb, tparams, xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(du))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_want), rtol=rtol,
                               atol=1e-8)


@pytest.mark.parametrize("block", ["attention", "fake_quant"])
def test_kernel_block_backward_matches_jax(block):
    """The kernel blocks take gradients (the port's tower refused them
    before its training slice): attention's backward is the plain
    attention's VJP, as JAX's ``custom_vjp`` rule; the quantizer's is
    the identity (straight-through)."""
    rng = np.random.default_rng(4)
    if block == "attention":
        q, k, v, g = (rng.normal(size=(3, 2, 5, 8)).astype(np.float32)
                      for _ in range(4))
        want = jax.jit(lambda a, b, c, gg: jax.vjp(
            lambda a_, b_, c_: jtwr._attention(a_, b_, c_, "ref"),
            a, b, c)[1](gg))(*map(jnp.asarray, (q, k, v, g)))
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = ttwr._attention(*ts, "auto")
        got = torch.autograd.grad(out, ts, torch.from_numpy(g))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    else:
        x, g = (rng.normal(size=(3, 4, 8)).astype(np.float32)
                for _ in range(2))
        xt = torch.from_numpy(x).requires_grad_()
        out = ttwr.fake_quant(xt, "auto")
        (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
        np.testing.assert_array_equal(got.numpy(), g)
        want = jax.jit(lambda a: jtwr.fake_quant(a, "ref"))(jnp.asarray(x))
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# whole fits from one JAX checkpoint cut
# ---------------------------------------------------------------------------


def _case(tower, **extra):
    rng = np.random.default_rng(0)
    n, d = 96, 12
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=(d, 3)) > 0).astype(np.float64)
    ids = [f"u{i:05d}" for i in range(n)]
    master, members = vertical_partition(ids, x, y, widths=[5], seed=3)
    bt, tt = TOWERS[tower]
    kw = dict(protocol="split_nn", epochs=1, batch_size=32, lr=LR, seed=0,
              use_psi=False, embedding_dim=8, hidden=(16,), tower=bt,
              top_tower=tt, **extra)
    return kw, master, members


@pytest.fixture(scope="module")
def cuts(tmp_path_factory):
    """Per tower, a JAX split-NN checkpoint after one epoch."""
    out = {}
    for tower in TOWERS:
        kw, master, members = _case(tower)
        d = tmp_path_factory.mktemp(f"cut_{tower}")
        with JaxJob(JaxConfig(**kw), master, members,
                    callbacks=[Checkpointer(d)]) as job:
            assert job.fit()["history"]
        out[tower] = d
    return out


class _CodeFlips:
    """The rounds in which a quantization of the port gave a code one
    step apart from the JAX package's, in the tower's ``quantize`` block
    or in the channel's int8 compression: the two packages' inputs there
    differ in their last bits (other f32 summation orders), so a value
    at a .5 tie can round either way, and everything after it differs by
    that step's effect. Both packages' quantizations are recorded (the
    port's tagged with the round its party's thread computes, JAX's
    through a debug callback out of its jitted steps) and each of the
    port's is matched with the JAX one of the same shape nearest to it
    in value."""

    def __init__(self, monkeypatch):
        import threading
        from repro.core import compression as jcompression
        from repro.kernels import ref as jref
        from repro_torch.core import compression
        self.port, self.jax = [], []
        self._local = threading.local()
        for hook in ("on_batch_master", "member_stage_send",
                     "member_stage_recv"):
            monkeypatch.setattr(tsn.SplitNNProtocol, hook,
                                self._tagged(getattr(tsn.SplitNNProtocol,
                                                     hook)))
        monkeypatch.setattr(ops, "quantize_int8",
                            self._port(ops.quantize_int8))
        monkeypatch.setattr(compression, "quantize_int8",
                            self._port(compression.quantize_int8))
        monkeypatch.setattr(jcompression, "quantize_int8",
                            self._numpy(jcompression.quantize_int8))
        monkeypatch.setattr(jref, "quantize_int8_ref",
                            self._traced(jref.quantize_int8_ref))

    def _tagged(self, hook):
        def run(proto, rows, step, *rest):
            self._local.step = step
            return hook(proto, rows, step, *rest)
        return run

    def _port(self, quantize):
        def run(x, *args, **kw):
            q, scale = quantize(x, *args, **kw)
            self.port.append((getattr(self._local, "step", -1),
                              _as_np(x), _as_np(q)))
            return q, scale
        return run

    def _numpy(self, quantize):
        def run(x, *args, **kw):
            q, scale = quantize(x, *args, **kw)
            self.jax.append((np.array(x), np.array(q)))
            return q, scale
        return run

    def _traced(self, quantize):
        def run(x):
            q, scale = quantize(x)
            jax.debug.callback(
                lambda xx, qq: self.jax.append((np.array(xx), np.array(qq))),
                x, q)
            return q, scale
        return run

    def rounds(self):
        out = set()
        for step, x, q in self.port:
            same = [(np.abs(x - jx).max(), jq) for jx, jq in self.jax
                    if jx.shape == x.shape]
            assert same, "a port quantization with no JAX counterpart"
            gap, jq = min(same, key=lambda c: c[0])
            # last bits apart, or a step of an earlier flip carried by
            # the error feedback's residual
            assert gap <= 2 * np.abs(x).max() / 127
            diff = np.abs(q.astype(np.int32) - jq.astype(np.int32))
            assert diff.max() <= 1, "a code more than one step apart"
            if diff.any():
                out.add(step)
        return out


def _as_np(t):
    return np.array(t.detach().numpy() if torch.is_tensor(t) else t)


def _fit_both(cut, tower, depth, monkeypatch, **extra):
    kw, master, members = _case(tower, **extra)
    kw["epochs"] = 3                  # two more epochs from the cut
    flips = _CodeFlips(monkeypatch)
    want = jax_run_vfl(JaxConfig(**kw), master, members, mode="thread",
                       resume_dir=str(cut), pipeline_depth=depth)
    got = run_vfl(tbase.VFLConfig(**kw), master, members, mode="thread",
                  resume_dir=str(cut), pipeline_depth=depth, device="cpu")
    return got, want, flips.rounds()


def _losses(res):
    return np.array([h["loss"] for h in res["master"]["history"]])


def _check_fit(got, want, flip_rounds):
    """Loss histories at rtol 1e-5 up to the first round with a code
    one step apart (``_CodeFlips``), and from it on at rtol 1e-4, that
    step's effect; final params at rtol 1e-4 (atol 1e-6), or 1e-3 after
    such a round: six SGD rounds carry the step's 1e-6 differences
    forward."""
    gl, wl = _losses(got), _losses(want)
    # the cut's three rounds, then six trained here
    assert len(gl) == len(wl) == 9
    np.testing.assert_array_equal(gl[:3], wl[:3])
    first = min(flip_rounds, default=len(gl))
    np.testing.assert_allclose(gl[:first], wl[:first], rtol=1e-5)
    np.testing.assert_allclose(gl[first:], wl[first:], rtol=1e-4)
    assert np.isfinite(gl).all()
    rtol = 1e-3 if flip_rounds else 1e-4
    for role, keys in (("master", ("top", "bottom")), ("member0",
                                                         ("params",))):
        for key in keys:
            _assert_trees([np.asarray(a) for a in _flat(got[role][key])],
                          [np.asarray(a) for a in _flat(want[role][key])],
                          rtol, 1e-6)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_run_vfl_matches_jax_from_one_cut(cuts, tower, depth, monkeypatch):
    _check_fit(*_fit_both(cuts[tower], tower, depth, monkeypatch))


@pytest.mark.parametrize("extra", [{"compress": True},
                                   {"noise_sigma": 0.3}],
                         ids=["compress", "noise"])
def test_run_vfl_defenses_match_jax(cuts, extra, monkeypatch):
    """Channel compression (int8 + per-column scale with error feedback,
    below the protocol) and the noise defense on the member's
    activations, on the narrow tower at depth 1."""
    _check_fit(*_fit_both(cuts["narrow"], "narrow", 1, monkeypatch, **extra))


def test_member_recv_differentiates_at_current_params(cuts):
    """At depth >= 2 a member's params move between its send and its
    recv stage: the VJP is taken at the params of the recv, on the
    saved batch, not through a graph kept from the send."""
    kw, _, members = _case("narrow")
    with open(cuts["narrow"] / "member0.pkl", "rb") as f:
        saved = pickle.load(f)
    bus = ThreadBus(["master", "member0"])
    proto = tsn.SplitNNProtocol(tbase.VFLConfig(**kw),
                                TypedChannel(bus.communicator("member0")),
                                "member0", device="cpu")
    proto.data = members[0]
    proto.order = list(saved["order"])
    proto.setup()
    proto.load_state_dict(saved["proto"])
    rows = np.arange(7, 39)
    xb = proto.member_stage_send(rows, 0)
    assert not xb.requires_grad

    # another round's update lands between the two stages
    moved = ttwr.with_leaves(proto.params, [
        t * 1.01 for t in ttwr.leaves(proto.params)])
    proto.params = moved
    du = np.random.default_rng(5).normal(size=(32, 8)).astype(np.float32)

    class Msg:
        def tensor(self, name):
            assert name == "du"
            return du

    proto.ch.recv = lambda peer, kind: Msg()
    proto.member_stage_recv(rows, 0, xb)
    lr = float(np.float32(LR))
    at_recv = tsn.member_step(proto._spec, moved, xb, torch.from_numpy(du),
                              lr)
    at_send = tsn.member_step(
        proto._spec, ttwr.from_numpy(saved["proto"]["params"], "cpu"), xb,
        torch.from_numpy(du), lr)
    for got, want, stale in zip(ttwr.leaves(proto.params),
                                ttwr.leaves(at_recv), ttwr.leaves(at_send)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert any(not torch.allclose(a, b) for a, b in
               zip(ttwr.leaves(proto.params), ttwr.leaves(at_send)))
    # the JAX package's member backward at the recv-time params
    _, bwd = jsn._make_member_fns(jtwr.resolve(NARROW, xb.shape[1], 8), None)
    want = bwd([jax.tree.map(jnp.asarray, p) for p in
                ttwr.to_numpy(moved)], jnp.asarray(xb.numpy()),
               jnp.asarray(du), jnp.float32(LR))
    _assert_trees(_torch_leaves(proto.params), _np(want), 1e-5, 1e-6)


def test_secure_agg_training_refused():
    """Pairwise masks do not survive each member's own quantization of
    its activations: a split-NN job asking for both secure aggregation
    and channel compression is refused before any round runs, as the
    JAX package refuses it."""
    kw, master, members = _case("narrow", secure_agg=True, compress=True)
    with pytest.raises((ValueError, RuntimeError)) as err:
        job = VFLJob(tbase.VFLConfig(**kw), master, members, device="cpu",
                     comm_timeout=5.0)
        try:
            job.fit(timeout=60)
        finally:
            job.shutdown()
    text = repr(err.value) + repr(err.value.__cause__)
    assert "secure_agg masks do not survive" in text
