"""The PyTorch port's serving slice as a whole, against the JAX package:
one JAX split-NN checkpoint cut drives a JAX ``VFLJob`` and a port
``VFLJob`` (on the CPU), each behind a ``FederatedServer``; both answer
the same concurrent queries, duplicate rows included, with the same
scores. The port's served scores are bit-identical to its own offline
predict, and its protocol state is the cut's numpy trees unchanged."""
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.party import VFLJob as JaxJob  # noqa: E402
from repro.core.protocols.base import VFLConfig as JaxConfig  # noqa: E402
from repro.core.protocols.driver import Checkpointer  # noqa: E402
from repro.data.vertical import vertical_partition  # noqa: E402
from repro.serve.federated import FederatedServer as JaxServer  # noqa: E402
from repro_torch.comm.local import ThreadBus  # noqa: E402
from repro_torch.comm.schema import TypedChannel  # noqa: E402
from repro_torch.core.party import VFLJob  # noqa: E402
from repro_torch.core.protocols import base as tbase  # noqa: E402
from repro_torch.core.protocols.split_nn import \
    SplitNNProtocol  # noqa: E402
from repro_torch.serve.federated import (FederatedServer,  # noqa: E402
                                         ServeCfg)

TOWER = ("embed:tokens=4,dim=16", "attn_block:heads=2", "quantize",
         "mlp:hidden=16")
TOP = ("mlp:hidden=16,final_act=0",)
CALLERS, QUERIES = 4, 3


def _case():
    rng = np.random.default_rng(0)
    n, d = 96, 12
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=(d, 3)) > 0).astype(np.float64)
    ids = [f"u{i:05d}" for i in range(n)]
    master, members = vertical_partition(ids, x, y, widths=[5], seed=3)
    kw = dict(protocol="split_nn", epochs=1, batch_size=32, lr=0.1, seed=0,
              use_psi=False, embedding_dim=8, tower=TOWER, top_tower=TOP)
    return kw, master, members


@pytest.fixture(scope="module")
def cut(tmp_path_factory):
    """A JAX split-NN checkpoint after one short fit."""
    kw, master, members = _case()
    d = tmp_path_factory.mktemp("cut")
    with JaxJob(JaxConfig(**kw), master, members,
                callbacks=[Checkpointer(d)]) as job:
        fit = job.fit()
    assert fit["history"] and (d / "master.pkl").exists()
    return d


def _queries(n):
    """Per caller, QUERIES row batches with repeats inside and across."""
    rng = np.random.default_rng(11)
    hot = rng.choice(n, 6, replace=False)
    out = []
    for _ in range(CALLERS):
        qs = []
        for _ in range(QUERIES):
            rows = np.concatenate([rng.choice(n, 5), rng.choice(hot, 3)])
            rows[-1] = rows[0]
            qs.append(rows)
        out.append(qs)
    return out


def _serve(server, queries):
    scores = [[None] * QUERIES for _ in range(CALLERS)]

    def caller(i):
        for j, rows in enumerate(queries[i]):
            scores[i][j] = server.query(rows, timeout=120.0)

    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(CALLERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return scores


def test_served_scores_match_jax_from_one_cut(cut):
    kw, master, members = _case()
    with open(cut / "master.pkl", "rb") as f:
        n = len(pickle.load(f)["order"])
    queries = _queries(n)
    scfg = ServeCfg(max_batch=24, max_wait_ms=5.0)
    with JaxJob(JaxConfig(**kw), master, members, resume_dir=str(cut)) \
            as jjob:
        with JaxServer(jjob, scfg) as srv:
            expect = _serve(srv, queries)
        jfull = jjob.predict()
    with VFLJob(tbase.VFLConfig(**kw), master, members,
                resume_dir=str(cut), device="cpu") as job:
        with FederatedServer(job, scfg) as srv:
            got = _serve(srv, queries)
            lone = srv.query(queries[0][0])
            assert srv.stats.batches >= 2       # rounds were coalesced
        offline = job.predict(rows=queries[0][0],
                              batch_size=len(queries[0][0]))
        full = job.predict()
        res = job.shutdown()
    for i in range(CALLERS):
        for j in range(QUERIES):
            assert got[i][j].shape == (8, 3)
            np.testing.assert_allclose(got[i][j], expect[i][j],
                                       rtol=1e-5, atol=1e-6)
            # duplicate rows of one query get the same scores
            np.testing.assert_array_equal(got[i][j][-1], got[i][j][0])
    np.testing.assert_array_equal(lone, offline)
    np.testing.assert_allclose(full, jfull, rtol=1e-5, atol=1e-6)
    # the served job still holds the cut's weights
    with open(cut / "master.pkl", "rb") as f:
        state = pickle.load(f)["proto"]
    for key in ("top", "bottom"):
        _assert_tree_equal(res["master"][key], state[key])


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert isinstance(a, np.ndarray) and a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("role", ["master", "member0"])
def test_state_dict_is_the_cut_unchanged(cut, role):
    kw, master, members = _case()
    with open(cut / f"{role}.pkl", "rb") as f:
        saved = pickle.load(f)
    bus = ThreadBus(["master", "member0"])
    ch = TypedChannel(bus.communicator(role))
    proto = SplitNNProtocol(tbase.VFLConfig(**kw), ch, role, device="cpu")
    proto.data = master if role == "master" else members[0]
    proto.order = list(saved["order"])
    proto.setup()
    proto.load_state_dict(saved["proto"])
    _assert_tree_equal(proto.state_dict(), saved["proto"])


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    kw, master, members = _case()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VFLJob(tbase.VFLConfig(**kw), master, members)


def test_protocol_defaults_to_cuda():
    """A protocol built directly, not through VFLJob, runs on the card
    unless it is asked for the CPU: without a GPU its default raises."""
    kw, _, _ = _case()
    cfg = tbase.VFLConfig(**kw)
    bus = ThreadBus(["master", "member0"])
    ch = TypedChannel(bus.communicator("master"))
    cpu = SplitNNProtocol(cfg, ch, "master", device="cpu")
    assert cpu.device == torch.device("cpu")
    if torch.cuda.is_available():
        assert SplitNNProtocol(cfg, ch, "master").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SplitNNProtocol(cfg, ch, "master")


def test_psi_matches_jax():
    """The port's DH-PSI (with its own copy of the primality test) works
    in the same group as the JAX package's."""
    from repro.core import psi as jpsi
    from repro_torch.core import psi as tpsi
    assert tpsi.group_prime() == jpsi.group_prime()
    a = [f"u{i}" for i in range(0, 40)]
    b = [f"u{i}" for i in range(25, 60)]
    inter, _ = tpsi.dh_psi(a, b)
    assert inter == jpsi.dh_psi(a, b)[0] == sorted(set(a) & set(b))
