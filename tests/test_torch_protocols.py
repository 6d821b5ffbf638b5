"""The rest of the paper's demo in the PyTorch port, on the CPU, against
the live JAX package: arbiterless linear regression and Paillier-HE
logistic regression (packed and scalar) give the same loss histories,
weights and predictions at rtol 0 in the modes the JAX package's own
trace tests run them in (both are numpy and big-int arithmetic on the
host in either package); the HE layer encrypts, packs, multiplies and
decrypts to the same integers; pairwise masks are bit-equal to the JAX
package's and cancel exactly, also across a key agreement between a
party of each package over TCP; and split-NN with secure aggregation
follows the JAX package from one checkpoint cut at rtol 1e-5 (each run
draws its own masks, and a masked sum rounds where the plain one does
not, ~1e-7 a round), while its predicts match the unmasked run within
the JAX package's own 1e-3.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.comm.sock import SocketCommunicator as JaxSocket  # noqa: E402
from repro.core import he as jhe  # noqa: E402
from repro.core import secure_agg_protocol as jsap  # noqa: E402
from repro.core.party import VFLJob as JaxJob  # noqa: E402
from repro.core.protocols.base import VFLConfig as JaxConfig  # noqa: E402
from repro.core.protocols.driver import Checkpointer  # noqa: E402
from repro.data.vertical import vertical_partition  # noqa: E402
from repro_torch.comm.local import ThreadBus  # noqa: E402
from repro_torch.comm.sock import SocketCommunicator  # noqa: E402
from repro_torch.comm.sock import local_addresses  # noqa: E402
from repro_torch.core import he  # noqa: E402
from repro_torch.core import secure_agg_protocol as sap  # noqa: E402
from repro_torch.core.party import VFLJob  # noqa: E402
from repro_torch.core.protocols.base import VFLConfig  # noqa: E402


def _dataset(n=192, d=12, items=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    w = rng.normal(size=(d, items))
    y = x @ w * 0.4 + rng.normal(scale=0.05, size=(n, items))
    ids = [f"u{i:05d}" for i in range(n)]
    return ids, x, y


def _linreg_case():
    ids, x, y = _dataset()
    master, members = vertical_partition(ids, x, y, widths=[4, 3],
                                         overlap=1.0, seed=1)
    kw = dict(protocol="linreg", epochs=3, batch_size=48, lr=0.1, seed=0,
              use_psi=False)
    return kw, master, members


def _logreg_case(packed):
    ids, x, y = _dataset(n=64, d=8, items=1)
    yb = (y > 0).astype(np.float64)
    master, members = vertical_partition(ids, x, yb, widths=[3], seed=4)
    kw = dict(protocol="logreg_he", epochs=1, batch_size=32, lr=0.5, seed=0,
              use_psi=False, he_bits=256, he_packed=packed)
    return kw, master, members


def _run(job_cls, cfg, master, members, **kw):
    """fit, predict and shutdown of one job: (history, scores, results)."""
    with job_cls(cfg, master, members, **kw) as job:
        hist = job.fit()["history"]
        scores = job.predict()
        res = job.shutdown()
    return [h["loss"] for h in hist], scores, res


CASES = {"linreg": _linreg_case, "logreg_he_packed": lambda: _logreg_case(
    True), "logreg_he_scalar": lambda: _logreg_case(False)}


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name, case in CASES.items():
        kw, master, members = case()
        out[name] = _run(JaxJob, JaxConfig(**kw), master, members)
    return out


@pytest.mark.parametrize("case,mode", [
    ("linreg", "thread"), ("linreg", "socket"), ("linreg", "process"),
    ("logreg_he_packed", "thread"), ("logreg_he_packed", "socket"),
    ("logreg_he_scalar", "thread"), ("logreg_he_scalar", "socket")])
def test_protocol_matches_jax_exactly(jax_runs, case, mode, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw, master, members = CASES[case]()
    got = _run(VFLJob, VFLConfig(**kw), master, members, mode=mode,
               device="cpu")
    want = jax_runs[case]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=0)
    gres, wres = got[2], want[2]
    if case == "linreg":
        np.testing.assert_allclose(gres["master"]["w_master"],
                                   wres["master"]["w_master"], rtol=0,
                                   atol=0)
    for j in range(len(members)):
        np.testing.assert_allclose(gres[f"member{j}"]["w"],
                                   wres[f"member{j}"]["w"], rtol=0, atol=0)
    if case.startswith("logreg_he"):
        assert gres["arbiter"]["decrypted_values"] \
            == wres["arbiter"]["decrypted_values"]


# ---------------------------------------------------------------------------
# the HE layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def keys():
    jpub, jpriv = jhe.keygen(256)
    pub = he.PublicKey(jpub.n)
    priv = he.PrivateKey(pub, jpriv.lam, jpriv.mu, jpriv.p, jpriv.q,
                         jpriv.hp, jpriv.hq, jpriv.p_inv_q)
    return (pub, priv), (jpub, jpriv)


def test_paillier_matches_jax(keys):
    (pub, priv), (jpub, jpriv) = keys
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7,)) * 3
    enc = he.encode_fixed(x)
    np.testing.assert_array_equal(enc, jhe.encode_fixed(x))
    rn = pow(12345, pub.n, pub.n_sq)            # a fixed blinding
    for m in map(int, enc):
        assert pub.encrypt_int(m, rn) == jpub.encrypt_int(m, rn)
    cts = he.encrypt_vector(pub, x)
    # a port ciphertext decrypts in the JAX package and back
    np.testing.assert_array_equal(jhe.decrypt_vector(jpriv, cts),
                                  he.decrypt_vector(priv, cts))
    jcts = jhe.encrypt_vector(jpub, x)
    np.testing.assert_array_equal(he.decrypt_vector(priv, jcts),
                                  jhe.decrypt_vector(jpriv, jcts))
    for c in cts[:3]:
        c = int(c)
        assert priv.decrypt_int_crt(c) == priv.decrypt_int_plain(c) \
            == jpriv.decrypt_int(c)
    assert he._is_probable_prime(jpriv.p) and not he._is_probable_prime(
        jpriv.p * jpriv.q)


def test_packing_matches_jax(keys):
    (pub, priv), (jpub, jpriv) = keys
    rng = np.random.default_rng(1)
    vals = [int(v) for v in rng.integers(-2**40, 2**40, 9)]
    for bits in (44, 50, 61):
        assert he.pack_signed(vals, bits) == jhe.pack_signed(vals, bits)
        assert he.max_slots(pub, bits) == jhe.max_slots(jpub, bits)
    cts = he.encrypt_packed(pub, vals, 50)
    assert he.decrypt_packed(priv, cts, 50, len(vals)) \
        == jhe.decrypt_packed(jpriv, cts, 50, len(vals)) == vals
    # the packed X^T Enc(r) of the same ciphertexts: the same plan, the
    # same ciphertexts (no re-randomizing pool), the same gradient ints
    x_int = rng.integers(-2**20, 2**20, size=(16, 5))
    r = rng.integers(-2**20, 2**20, size=16)
    rn = pow(777, pub.n, pub.n_sq)
    enc_r = [pub.encrypt_int(int(v), rn) for v in r]
    got, info = he.packed_matvec(pub, x_int, enc_r, 2**20)
    want, jinfo = jhe.packed_matvec(jpub, x_int, enc_r, 2**20)
    assert got == want and info == jinfo
    plains = [priv.decrypt_int(c) for c in got]
    grads = he.unpack_matvec(plains, info["slot_bits"], info["k"],
                             info["off_bits"], info["count"])
    assert grads == [int(v) for v in (x_int.T.astype(object) @ r)]


def test_decrypt_pool_matches_jax(keys):
    """Two spawned workers CRT-decrypt chunks of a ciphertext list in
    order, as the JAX package's inline pool does."""
    (pub, priv), (jpub, jpriv) = keys
    vals = list(range(-20, 20))
    cts = [pub.encrypt_int(v) for v in vals]
    with he.DecryptPool(priv, workers=2) as pool:
        got = pool.decrypt_many(cts, chunk=7)
    with jhe.DecryptPool(jpriv, workers=0) as jpool:
        want = jpool.decrypt_many(cts, chunk=7)
    assert got == want == vals


# ---------------------------------------------------------------------------
# pairwise masks
# ---------------------------------------------------------------------------


def _masker(module, me, seeds):
    m = module.PairwiseMasker.__new__(module.PairwiseMasker)
    m.me, m.seeds = me, seeds
    return m


def test_masks_bit_equal_to_jax_and_cancel():
    seeds = {("member0", "member1"): 2**61 + 17,
             ("member0", "member2"): 5, ("member1", "member2"): 2**40 + 3}
    names = ["member0", "member1", "member2"]

    def of(me):
        return {o: s for (a, b), s in seeds.items() for o in (a, b)
                if me in (a, b) and o != me}

    for rnd, shape in ((0, (32, 8)), (3, (5, 4)), (1 << 20, (64, 64))):
        port = [_masker(sap, me, of(me)).mask(rnd, shape) for me in names]
        ref = [_masker(jsap, me, of(me)).mask(rnd, shape) for me in names]
        for p, r in zip(port, ref):
            assert p.dtype == r.dtype == np.float32
            np.testing.assert_array_equal(p, r)
        assert np.abs(port[0]).max() > 0.1        # substantial
        total = port[0] + port[1] + port[2]
        np.testing.assert_array_equal(total, np.zeros(shape, np.float32))


def test_key_agreement_across_packages_over_tcp():
    """A port member and a JAX member agree on their pair's seed over
    localhost TCP (one wire format), and their masks cancel exactly."""
    addrs = local_addresses(["member0", "member1"])
    comms = {"member0": SocketCommunicator("member0", addrs),
             "member1": JaxSocket("member1", addrs)}
    out = {}

    def mk(me, module):
        out[me] = module.PairwiseMasker(comms[me], me,
                                        ["member0", "member1"])

    ts = [threading.Thread(target=mk, args=("member0", sap)),
          threading.Thread(target=mk, args=("member1", jsap))]
    try:
        [t.start() for t in ts]
        [t.join(60) for t in ts]
    finally:
        for c in comms.values():
            c.close()
    assert out["member0"].seeds["member1"] == out["member1"].seeds["member0"]
    m0, m1 = out["member0"].mask(7, (6, 5)), out["member1"].mask(7, (6, 5))
    np.testing.assert_array_equal(m0 + m1, np.zeros((6, 5), np.float32))


# ---------------------------------------------------------------------------
# split-NN with secure aggregation
# ---------------------------------------------------------------------------


def _secagg_case(**extra):
    ids, x, y = _dataset(n=96, items=2)
    yb = (y > 0).astype(np.float64)
    master, members = vertical_partition(ids, x, yb, widths=[4, 4], seed=7)
    kw = dict(protocol="split_nn", epochs=1, batch_size=32, lr=0.1, seed=0,
              use_psi=False, embedding_dim=8, hidden=(16,), secure_agg=True)
    kw.update(extra)
    return kw, master, members


@pytest.mark.parametrize("protocol", ["split_nn", "secure_agg"])
def test_secure_agg_training_matches_jax(protocol, tmp_path):
    """From one JAX cut (after one epoch, masked), two more epochs in
    each package with masking on, ``secure_agg=True`` on split-NN or the
    protocol of that name."""
    kw, master, members = _secagg_case()
    with JaxJob(JaxConfig(**kw), master, members,
                callbacks=[Checkpointer(tmp_path)]) as job:
        job.fit()
    kw.update(epochs=3, protocol=protocol)
    want = _run(JaxJob, JaxConfig(**kw), master, members,
                resume_dir=str(tmp_path))
    got = _run(VFLJob, VFLConfig(**kw), master, members,
               resume_dir=str(tmp_path), device="cpu")
    assert len(got[0]) == len(want[0]) == 9
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[0][-1] < got[0][0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-3)


def test_secure_agg_predict_masks_cancel():
    """Members mask predict-query activations too (the master only ever
    sees the aggregate); the masks cancel in the sum, so scores match
    the unmasked run, and each query draws its own mask stream."""
    kw, master, members = _secagg_case(epochs=2)
    with VFLJob(VFLConfig(**dict(kw, secure_agg=False)), master, members,
                device="cpu") as plain_job:
        plain_job.fit()
        plain = plain_job.predict()
    with VFLJob(VFLConfig(**kw), master, members, device="cpu") as sec_job:
        sec_job.fit()
        sec1 = sec_job.predict()
        sec2 = sec_job.predict()
    np.testing.assert_allclose(sec1, plain, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(sec2, sec1, rtol=1e-3, atol=1e-3)


def test_secure_agg_hides_each_member():
    """What a member puts on the wire is its activation plus a mask of
    substantial size; the masked activations of both members sum to the
    plain sum within float32 rounding."""
    kw, master, members = _secagg_case()
    bus = ThreadBus(["master", "member0", "member1"])
    from repro_torch.comm.schema import TypedChannel
    from repro_torch.core.protocols import split_nn as tsn
    protos, sent = {}, {}
    common = sorted(set(members[0].ids) & set(members[1].ids))

    def setup(me):
        p = tsn.SplitNNProtocol(VFLConfig(**kw),
                                TypedChannel(bus.communicator(me)), me,
                                device="cpu")
        p.data = members[int(me[-1])]
        p.order = common
        p.setup()
        protos[me] = p

    ts = [threading.Thread(target=setup, args=(m,))
          for m in ("member0", "member1")]
    [t.start() for t in ts]
    [t.join(60) for t in ts]
    rows = np.arange(10)
    for me, p in protos.items():
        p.ch.isend = lambda peer, kind, payload, me=me: sent.__setitem__(
            me, payload["u"])
        p.member_stage_send(rows, 3)
    plain = {me: tsn.twr.apply(p._spec, p.params, p._rows(rows)).numpy()
             for me, p in protos.items()}
    for me in protos:
        assert np.abs(sent[me] - plain[me]).max() > 0.1
    np.testing.assert_allclose(sent["member0"] + sent["member1"],
                               plain["member0"] + plain["member1"],
                               atol=1e-5)
