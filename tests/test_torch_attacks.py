"""The PyTorch port's adversarial harness on the CPU: counterparts of
``tests/test_attacks.py`` (the attack math, the harness on the shrunken
logreg case, the privacy gate), then the port held to the live JAX
package.

* arbitered logreg is numpy in both packages: the gradient-direction
  reports equal the JAX package's at rtol 0, with no defense and with
  noise;
* split-NN (``splitnn_case``, every defense) starts both packages from
  one JAX checkpoint cut at the end of the first epoch. The master's
  captured member embeddings (and, until a tie, the member's captured
  gradients) agree normwise at rtol 1e-5 in each round; under ``int8`` a
  code can go one step apart where the two packages' inputs straddle a
  .5 tie, and from that round on the embeddings agree at rtol 1e-4, but
  for elements one step apart (``_check_rounds``). ``embed_attack``
  gives the JAX package's leakage within 1e-3.
  Under ``secure_agg`` each member masks its embeddings with pairwise
  masks from a fresh Diffie-Hellman secret (``secrets.randbits`` in
  ``core/secure_agg_protocol.py``, in both packages), so no two runs
  capture the same masked rows and the leakage differs from run to run;
  here every member draws the same fixed secret in both packages, so
  both mask alike and are held as above;
* the port's ``run_privacy_matrix(device="cpu")`` gives the JAX runner's
  row keys and logreg rows, and its logreg cells pass
  ``benchmarks/check_regression.py``'s gate.
"""
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.attacks import harness as jharness  # noqa: E402
from repro.attacks import runner as jrunner  # noqa: E402
from repro.core.party import VFLJob as JaxJob  # noqa: E402
from repro.core.protocols.driver import (  # noqa: E402
    Checkpointer, StopAtStep)
from repro_torch.attacks import label_inference as li  # noqa: E402
from repro_torch.attacks.harness import AttackHarness  # noqa: E402
from repro_torch.attacks.runner import (  # noqa: E402
    LOGREG_NOISE_SIGMA, SPLITNN_NOISE_SIGMA, logreg_case,
    run_privacy_matrix, splitnn_case)
from repro_torch.core.protocols import base  # noqa: E402
from repro_torch.core.protocols.driver import OP_END, OP_RUN  # noqa: E402
from repro_torch.train.evals import auc  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = REPO / "benchmarks" / "results" / "privacy.json"


# ---------------------------------------------------------------------------
# offline attack math (no VFL run)
# ---------------------------------------------------------------------------


def test_run_rounds_rederives_batches():
    cfg = base.VFLConfig(seed=11)
    n = 40

    def rec(op, epoch, lo, hi):
        return {"dir": "recv", "peer": "master", "name": "ctrl/step",
                "payload": {"op": np.array([op]),
                            "epoch": np.array([epoch]),
                            "lo": np.array([lo]), "hi": np.array([hi])}}

    cap = {"names": ["ctrl/step"],
           "records": [rec(OP_RUN, 0, 0, 16), rec(OP_RUN, 0, 16, 32),
                       rec(OP_RUN, 1, 0, 16), rec(OP_END, 0, 0, 0)]}
    rounds = li.run_rounds(cap, cfg, n, peer="master", direction="recv")
    assert len(rounds) == 3
    np.testing.assert_array_equal(rounds[0],
                                  base.batch_order(n, cfg, 0)[0:16])
    np.testing.assert_array_equal(rounds[2],
                                  base.batch_order(n, cfg, 1)[0:16])


def test_gradient_direction_attack_exact_solve():
    rng = np.random.default_rng(0)
    n, d = 48, 8
    x = rng.normal(size=(n, d))
    y = rng.integers(0, 2, n).astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-rng.normal(size=n)))
    rounds, grads = [], []
    for lo in range(0, n, 6):
        rows = np.arange(lo, lo + 6)
        rounds.append(rows)
        grads.append(x[rows].T @ ((p[rows] - y[rows]) / len(rows)))
    assert auc(li.gradient_direction_attack(x, rounds, grads), y) == 1.0


def test_embedding_attacks_read_separable_embeddings():
    rng = np.random.default_rng(1)
    n, d = 120, 8
    y = rng.integers(0, 2, n).astype(np.float64)
    u_true = np.where(y[:, None] > 0, 1.0, -1.0) \
        * rng.uniform(0.5, 1.5, (n, d))
    rounds = [rng.permutation(n)[:30] for _ in range(12)]
    embeds = [u_true[r] + 0.3 * rng.normal(size=(len(r), d))
              for r in rounds]
    u_bar, seen = li.mean_embeddings(rounds, embeds, n, late_frac=0.5)
    a = auc(li.cluster_attack(u_bar[seen]), y[seen])
    assert max(a, 1.0 - a) > 0.9
    aux = np.zeros(n, bool)
    aux[rng.permutation(n)[:20]] = True
    scores = li.probe_attack(u_bar[seen], y[seen], aux[seen])
    hold = ~aux[seen]
    assert auc(scores[hold], y[seen][hold]) > 0.9


def test_attack_math_equals_jax():
    """The same captured inputs through both packages' attacks."""
    from repro.attacks import label_inference as jli
    rng = np.random.default_rng(2)
    n, d = 64, 6
    x = rng.normal(size=(n, d))
    rounds = [rng.permutation(n)[:8] for _ in range(10)]
    grads = [rng.normal(size=d) for _ in rounds]
    np.testing.assert_array_equal(
        li.gradient_direction_attack(x, rounds, grads),
        jli.gradient_direction_attack(x, rounds, grads))
    embeds = [rng.normal(size=(8, 4)) for _ in rounds]
    got = li.mean_embeddings(rounds, embeds, n)
    want = jli.mean_embeddings(rounds, embeds, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    u = got[0][got[1]]
    np.testing.assert_array_equal(li.cluster_attack(u),
                                  jli.cluster_attack(u))
    y = rng.integers(0, 2, len(u)).astype(np.float64)
    aux = rng.random(len(u)) < 0.3
    np.testing.assert_array_equal(li.probe_attack(u, y, aux),
                                  jli.probe_attack(u, y, aux))


def test_defense_noise_deterministic_and_scaled():
    cfg = base.VFLConfig(noise_sigma=1.5, seed=3)
    g = np.linspace(-2.0, 2.0, 64)
    n1 = base.defense_noise(cfg, g, 7, "arbiter/member0")
    np.testing.assert_array_equal(
        n1, base.defense_noise(cfg, g, 7, "arbiter/member0"))
    assert not np.array_equal(
        n1, base.defense_noise(cfg, g, 8, "arbiter/member0"))
    assert not np.array_equal(
        n1, base.defense_noise(cfg, g, 7, "arbiter/member1"))
    rms = float(np.sqrt(np.mean(g ** 2)))
    assert 0.5 * 1.5 * rms < n1.std() < 2.0 * 1.5 * rms


# ---------------------------------------------------------------------------
# harness end-to-end (shrunken logreg case), held to the JAX package
# ---------------------------------------------------------------------------


def _logreg_reports(harness_cls, case, **job_kw):
    cfg, master, members = case(n=96)
    out = []
    for dcfg in (cfg, dataclasses.replace(cfg,
                                          noise_sigma=LOGREG_NOISE_SIGMA)):
        out.append(harness_cls(dcfg, master, members, mode="thread",
                               **job_kw).run().grad_attack())
    return out


@pytest.fixture(scope="module")
def logreg_reports():
    return _logreg_reports(AttackHarness, logreg_case, device="cpu")


def test_undefended_logreg_leaks(logreg_reports):
    plain, _ = logreg_reports
    assert plain["attack"] == "grad_direction"
    assert plain["adversary"] == "member0"
    assert plain["rounds"] > 0
    assert plain["leakage_auc"] >= 0.75


def test_noise_defense_breaks_the_attack(logreg_reports):
    plain, noised = logreg_reports
    assert noised["leakage_auc"] < 0.7
    assert noised["leakage_auc"] < plain["leakage_auc"] - 0.2
    assert abs(noised["utility_auc"] - plain["utility_auc"]) < 0.1


def test_logreg_reports_equal_jax(logreg_reports):
    assert logreg_reports == _logreg_reports(jharness.AttackHarness,
                                             jrunner.logreg_case)


# ---------------------------------------------------------------------------
# split-NN harness from one JAX cut, every defense
# ---------------------------------------------------------------------------

DEFENSES = {"none": {}, "noise": {"noise_sigma": SPLITNN_NOISE_SIGMA},
            "int8": {"compress": True},
            "secure_agg": {"protocol": "secure_agg"}}


def _embeds(h, member):
    return li.captured_field(h.capture("master"), "splitnn/u", "u",
                             peer=member, direction="recv")


def _grads(h, member):
    return li.captured_field(h.capture(member), "splitnn/du", "du",
                             peer="master", direction="recv")


def _check_rounds(u_pairs, du_pairs, int8):
    """Per round, the port's and the JAX package's captured embeddings
    (``u_pairs``) and the member's captured gradients (``du_pairs``).
    Until a tie, both agree normwise at rtol 1e-5. A tie is an element a
    code step of its column apart (a .5 tie rounded the other way by
    the int8 compression, which scales each column); from its round on the
    embeddings agree at rtol
    1e-4, but for elements at most one step apart. The gradients are not
    held after a tie: the master's error feedback carries the step into
    later rounds' residuals, so their codes go on differing by steps."""
    tied = False
    for i, ((a, b), (ga, gb)) in enumerate(zip(u_pairs, du_pairs)):
        err = np.abs(a - b)
        off = err > (1e-4 if tied else 1e-5) * np.abs(b).max()
        if off.any():
            code_step = np.abs(b).max(axis=0, keepdims=True) / 127
            assert int8, (i, err.max())
            assert (err <= 1.01 * code_step)[off].all(), i
            tied = True
        if not tied:
            gerr = np.abs(ga - gb)
            goff = gerr > 1e-5 * np.abs(gb).max()
            if goff.any():
                code_step = np.abs(gb).max(axis=0, keepdims=True) / 127
                assert int8 and (gerr >= 0.5 * code_step)[goff].any(), i
                tied = True


@pytest.mark.parametrize("defense", sorted(DEFENSES))
def test_splitnn_harness_matches_jax(defense, tmp_path, monkeypatch):
    import secrets
    # one Diffie-Hellman secret for every member, the same in both
    # packages: the pairwise masks come out alike (unpatched they are
    # fresh in every run)
    monkeypatch.setattr(secrets, "randbits", lambda k: (1 << k) // 3)
    jcfg, jmaster, jmembers = jrunner.splitnn_case()
    cfg, master, members = splitnn_case()
    np.testing.assert_array_equal(master.x, jmaster.x)
    jcfg = dataclasses.replace(jcfg, **DEFENSES[defense])
    cfg = dataclasses.replace(cfg, **DEFENSES[defense])
    first_epoch = len(base.batch_bounds(
        len(set(master.ids) & set(members[0].ids)
            & set(members[1].ids)), cfg))
    with JaxJob(jcfg, jmaster, jmembers,
                callbacks=[Checkpointer(tmp_path, every_steps=first_epoch),
                           StopAtStep(first_epoch)]) as job:
        assert len(job.fit()["history"]) == first_epoch
    want = jharness.AttackHarness(jcfg, jmaster, jmembers,
                                  resume_dir=str(tmp_path)).run()
    got = AttackHarness(cfg, master, members, resume_dir=str(tmp_path),
                        device="cpu").run()
    ours = {m: _embeds(got, m) for m in ("member0", "member1")}
    theirs = {m: _embeds(want, m) for m in ("member0", "member1")}
    assert len(ours["member0"]) == len(theirs["member0"]) == first_epoch
    u = list(zip(ours["member0"], theirs["member0"]))
    du = list(zip(_grads(got, "member0"), _grads(want, "member0")))
    assert len(du) == first_epoch
    _check_rounds(u, du, defense == "int8")
    assert got.metrics["auc"] == pytest.approx(want.metrics["auc"],
                                               abs=1e-4)
    for method in ("probe", "cluster"):
        ga = got.embed_attack(method=method)
        wa = want.embed_attack(method=method)
        assert ga["rounds"] == wa["rounds"]
        assert ga["leakage_auc"] == pytest.approx(wa["leakage_auc"],
                                                  abs=1e-3)


# ---------------------------------------------------------------------------
# the runner's matrix and the privacy gate
# ---------------------------------------------------------------------------


def _load_check_regression():
    path = REPO / "benchmarks" / "check_regression.py"
    spec = importlib.util.spec_from_file_location("check_regression", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_rows():
    return run_privacy_matrix(mode="thread", verbose=False, device="cpu")


def _key(r):
    return (r["protocol"], r["attack"], r["defense"])


def test_matrix_rows_match_the_jax_runner(port_rows):
    """The JAX runner's row keys, in its order, and its logreg rows: the
    committed ``privacy.json`` is the JAX runner's output, and its logreg
    rows are numpy (the live JAX run gives them again exactly)."""
    committed = json.loads(COMMITTED.read_text())
    assert [_key(r) for r in port_rows] == [_key(r) for r in committed]
    assert set(port_rows[0]) == set(committed[0])
    cfg, master, members = jrunner.logreg_case()
    live = jharness.AttackHarness(cfg, master, members).run().grad_attack()
    want = jrunner._row("logreg_he", "none", live, live["utility_auc"])
    assert port_rows[0] == want
    for got, row in zip(port_rows, committed):
        if row["protocol"] == "logreg_he":
            assert got == row
        else:
            assert 0.0 <= got["leakage_auc"] <= 1.0
            assert got["rounds"] == row["rounds"]


def test_port_rows_pass_the_logreg_gate(port_rows, tmp_path):
    mod = _load_check_regression()
    out = tmp_path / "privacy_torch.json"
    out.write_text(json.dumps(port_rows))
    failures = mod.check_privacy(str(out))
    assert not [f for f in failures if f.startswith("logreg_he")]


def test_privacy_gate_flags_violations(port_rows, tmp_path):
    mod = _load_check_regression()
    bad = []
    for r in port_rows:
        r = dict(r)
        if r["defense"] == "none":
            r["leakage_auc"] = 0.5
        if r["defense"] == "secure_agg":
            r["leakage_auc"] = 0.9
        bad.append(r)
    p = tmp_path / "privacy.json"
    p.write_text(json.dumps(bad))
    failures = mod.check_privacy(str(p))
    assert any("attack must work" in f for f in failures)
    assert any("secure_agg" in f for f in failures)
    p.write_text(json.dumps(bad[1:]))
    assert any("missing" in f for f in mod.check_privacy(str(p)))


def test_runner_cli_writes_its_own_file(tmp_path, monkeypatch):
    """The CLI's default ``--out`` is ``privacy_torch.json``, never the
    JAX package's committed ``privacy.json``; a CUDA run without a card
    raises."""
    from repro_torch.attacks import runner
    monkeypatch.chdir(tmp_path)
    (tmp_path / "benchmarks" / "results").mkdir(parents=True)
    monkeypatch.setattr(runner, "run_privacy_matrix",
                        lambda mode, device: [{"mode": mode,
                                               "device": device}])
    assert runner.main(["--device", "cpu"]) == 0
    out = tmp_path / "benchmarks" / "results" / "privacy_torch.json"
    assert json.loads(out.read_text()) == [{"mode": "thread",
                                            "device": "cpu"}]
    assert not (tmp_path / "benchmarks" / "results"
                / "privacy.json").exists()
    monkeypatch.undo()
    if not torch.cuda.is_available():
        cfg, master, members = logreg_case(n=32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AttackHarness(cfg, master, members).run()
