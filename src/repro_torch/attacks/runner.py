"""Privacy defense matrix: attack x defense x protocol -> measured
leakage, written as machine-readable rows for the CI gate.

Each row runs one :class:`~repro_torch.attacks.harness.AttackHarness` job —
the arbitered-logreg gradient-direction attack and the split-NN
embedding probe/cluster attacks — under one defense:

==============  ==========================================================
``none``        the undefended exchange (the leakage baseline)
``noise``       ``cfg.noise_sigma`` Gaussian noising (docs/privacy.md)
``int8``        ``cfg.compress`` int8 + error feedback (split-NN only)
``secure_agg``  ``protocol="secure_agg"`` pairwise-mask aggregation
==============  ==========================================================

Rows carry ``leakage_auc`` (attack ROC-AUC vs the true labels),
``utility_auc`` and ``utility_delta`` (vs the same protocol's
undefended run), and land in ``benchmarks/results/privacy_torch.json``
(the JAX package's runner owns ``privacy.json``; this one never writes
it).
``benchmarks/check_regression.py --privacy`` turns them into hard CI
assertions: undefended logreg must leak (>= 0.75 — the attack works),
noised / masked runs must not (< 0.6) while costing <= 0.02 utility.
int8 is measured but NOT required to defend — quantization error is
far too small to hide label structure, and the row documents that.

Run it (the jobs run on the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.attacks.runner [--device cpu] \
        --out benchmarks/results/privacy_torch.json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.attacks.harness import AttackHarness
from repro_torch.configs.vfl_recsys import VFLRecsysConfig
from repro_torch.core.protocols.base import MasterData, MemberData, VFLConfig
from repro_torch.data.synthetic import make_recsys_silos

# noising levels the matrix measures: strong enough to break the
# attacks below AUC 0.6. For logreg the noise rides the *gradient* and
# SGD averages it out (utility moves ~0.01 AUC — gated at 0.02); for
# split-NN it rides the *activations* through the top model's
# nonlinearity and measurably costs utility (~0.05 AUC) — recorded,
# documented in docs/privacy.md, and exactly why secure_agg (utility
# delta 0.0) is the defense the gate requires for split-NN.
LOGREG_NOISE_SIGMA = 2.0
SPLITNN_NOISE_SIGMA = 1.5


def logreg_case(n: int = 256, d_master: int = 8, d_member: int = 8,
                seed: int = 5):
    """Binary-label vertical split sized so the attack's linear algebra
    is exact: batch_size (8) <= the member width (8) makes the
    per-round residual solve determined — the canonical worst case the
    surveys warn about for unprotected gradient returns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d_master + d_member))
    w = rng.normal(size=(d_master + d_member,))
    z = x @ (w / np.sqrt(len(w)))
    y = (z + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    ids = [f"u{i:05d}" for i in range(n)]
    master = MasterData(ids, y[:, None], x[:, :d_master])
    members = [MemberData(ids, x[:, d_master:])]
    cfg = VFLConfig(protocol="logreg_he", epochs=3, batch_size=8,
                    lr=0.3, seed=7, use_psi=False, he_bits=256)
    return cfg, master, members


def splitnn_case(seed: int = 0):
    """The quickstart recsys demo workload, widened to two member silos
    (pairwise masking needs a pair) and to enough users that two epochs
    both converge (one gradient step per ~32 samples) and keep the
    attack honest: per-round masks are fresh, so few epochs means the
    probe cannot average secure-agg masks away across a sample's many
    appearances — the regime where masking holds is part of the
    measured claim (docs/privacy.md)."""
    rcfg = VFLRecsysConfig(
        n_users=2_048, n_items=19, n_interactions=16_384,
        n_other_features=64, member_features=(16, 16),
        id_overlap=0.85, bottom_dims=(32, 16), top_dims=(16, 8),
        embedding_dim=16)
    data = make_recsys_silos(rcfg, seed=seed)
    master = MasterData(data.ids, data.labels, data.features)
    members = [MemberData(mids, mx) for mids, mx in
               zip(data.member_ids, data.member_features)]
    cfg = VFLConfig(protocol="split_nn", epochs=2, batch_size=32,
                    lr=0.4, seed=3, use_psi=False, embedding_dim=8,
                    hidden=(16,))
    return cfg, master, members


def _row(protocol: str, defense: str, rep: Dict[str, Any],
         base_utility: Optional[float]) -> Dict[str, Any]:
    util = rep["utility_auc"]
    return {"protocol": protocol, "attack": rep["attack"],
            "defense": defense,
            "leakage_auc": round(float(rep["leakage_auc"]), 4),
            "utility_auc": round(float(util), 4),
            "utility_delta": round(float(
                util - (base_utility if base_utility is not None
                        else util)), 4),
            "rounds": rep["rounds"]}


def run_privacy_matrix(mode: str = "thread", verbose: bool = True,
                       device: str = "cuda") -> List[Dict[str, Any]]:
    """Run every (attack, defense) cell; returns the privacy.json rows.
    Every job keeps its tensors on ``device``."""
    import dataclasses
    rows: List[Dict[str, Any]] = []

    def log(msg: str) -> None:
        if verbose:
            print(msg, flush=True)

    # -- arbitered logreg: gradient-direction attack ------------------------
    cfg, master, members = logreg_case()
    base_util: Optional[float] = None
    for defense, dcfg in (
            ("none", cfg),
            ("noise", dataclasses.replace(
                cfg, noise_sigma=LOGREG_NOISE_SIGMA))):
        rep = AttackHarness(dcfg, master, members, mode=mode,
                            device=device).run().grad_attack()
        if defense == "none":
            base_util = rep["utility_auc"]
        rows.append(_row("logreg_he", defense, rep, base_util))
        log(f"logreg_he/grad_direction/{defense}: "
            f"leakage={rows[-1]['leakage_auc']:.3f} "
            f"utility={rows[-1]['utility_auc']:.3f}")

    # -- split-NN: embedding probe + cluster attacks ------------------------
    cfg, master, members = splitnn_case()
    base_util = None
    for defense, dcfg in (
            ("none", cfg),
            ("noise", dataclasses.replace(
                cfg, noise_sigma=SPLITNN_NOISE_SIGMA)),
            ("int8", dataclasses.replace(cfg, compress=True)),
            ("secure_agg", dataclasses.replace(cfg,
                                               protocol="secure_agg"))):
        h = AttackHarness(dcfg, master, members, mode=mode,
                          device=device).run()
        probe = h.embed_attack(method="probe")
        if defense == "none":
            base_util = probe["utility_auc"]
        rows.append(_row("split_nn", defense, probe, base_util))
        log(f"split_nn/embed_probe/{defense}: "
            f"leakage={rows[-1]['leakage_auc']:.3f} "
            f"utility={rows[-1]['utility_auc']:.3f}")
        cluster = h.embed_attack(method="cluster")
        rows.append(_row("split_nn", defense, cluster, base_util))
        log(f"split_nn/embed_cluster/{defense}: "
            f"leakage={rows[-1]['leakage_auc']:.3f}")
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default="benchmarks/results/privacy_torch.json")
    ap.add_argument("--mode", default="thread",
                    help="VFLJob execution mode (default thread)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the jobs keep their tensors "
                         "(default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    rows = run_privacy_matrix(mode=args.mode, device=args.device)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
        f.write("\n")
    print(f"wrote {len(rows)} privacy rows -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
