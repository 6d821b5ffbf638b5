"""The paper's §4 demo on the PyTorch port, end to end: an SBOL-like
master silo and a MegaMarket-like member silo, arbiterless (linreg,
split-NN) and arbitered (Paillier-HE logreg) experiments, with the
paper's logging (payload bytes, exchange time, ML metrics) written to
``benchmarks/results/demo_torch/``.

The counterpart of the JAX package's ``examples/vfl_recsys_demo.py``,
with its settings. Each experiment is a
:class:`~repro_torch.core.party.VFLJob`: after fit, the same live agents
serve a federated predict phase, so the post-training metrics come from
the protocol itself. The split-NN towers run on ``--device``; linreg
and the HE logreg are numpy and big-int arithmetic on the host, as in
the JAX package.

  python -m repro_torch.demo [--full] [--mode M] [--device cuda|cpu]

``--full`` uses the published SBOL scale (190k users); the default is a
reduced scale that finishes in seconds. ``--mode`` picks any execution
mode of :data:`~repro_torch.core.party.MODES`; in the process modes
every agent is its own OS process with its own CUDA context.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from repro_torch.configs.vfl_recsys import VFLRecsysConfig
from repro_torch.core.party import MODES, VFLJob
from repro_torch.core.protocols.base import MasterData, MemberData, VFLConfig
from repro_torch.data.synthetic import make_recsys_silos

OUT = pathlib.Path(__file__).resolve().parents[2] \
    / "benchmarks" / "results" / "demo_torch"


def run(full: bool = False, mode: str = "thread",
        device: str = "cuda") -> dict:
    """Runs the four phases and returns the summary it writes."""
    dcfg = VFLRecsysConfig() if full else VFLRecsysConfig().reduced()
    data = make_recsys_silos(dcfg, seed=0)
    master = MasterData(data.ids, data.labels.astype(np.float64),
                        data.features)
    members = [MemberData(ids, x) for ids, x in
               zip(data.member_ids, data.member_features)]
    summary = {"mode": mode, "device": device, "full": full}

    # 1. arbiterless VFL linear regression on implicit labels
    cfg = VFLConfig(protocol="linreg", epochs=4, batch_size=128, lr=0.05,
                    seed=0, use_psi=False)
    with VFLJob(cfg, master, members, mode=mode, device=device) as job:
        fit = job.fit()
        metrics = job.evaluate()
        res = job.shutdown()
    summary["linreg"] = {
        "loss_first": fit["history"][0]["loss"],
        "loss_last": fit["history"][-1]["loss"],
        **metrics,
        "comm": res["master"]["comm"],
    }

    # 2. split-NN recommender (the paper's demo model family), matched
    # by DH-PSI; rank quality via the federated predict phase
    cfg = VFLConfig(protocol="split_nn", epochs=30, batch_size=128, lr=0.3,
                    seed=0, use_psi=True, embedding_dim=dcfg.embedding_dim,
                    hidden=tuple(dcfg.bottom_dims[-1:]))
    with VFLJob(cfg, master, members, mode=mode, device=device) as job:
        fit = job.fit()
        report = job.evaluate()           # AUC / precision@5 / ndcg@5
        res = job.shutdown()
    summary["split_nn"] = {
        "loss_first": fit["history"][0]["loss"],
        "loss_last": fit["history"][-1]["loss"],
        "n_common": fit["n_common"],
        **report,
        "phase_s": res["master"]["phase_s"],
        "comm": res["master"]["comm"],
    }

    # 3. arbitered HE logreg on product 0 (binary); predict needs no HE,
    # so post-training AUC is one cheap plaintext round
    yb = master.y[:, :1]
    cfg = VFLConfig(protocol="logreg_he", epochs=1, batch_size=32, lr=0.5,
                    seed=0, use_psi=False, he_bits=256)
    with VFLJob(cfg, MasterData(master.ids, yb, master.x), members,
                mode=mode, device=device) as job:
        fit = job.fit()
        metrics = job.evaluate()
        res = job.shutdown()
    summary["logreg_he"] = {
        "loss_first": fit["history"][0]["loss"],
        "loss_last": fit["history"][-1]["loss"],
        **metrics,
        "arbiter_decryptions": res["arbiter"]["decrypted_values"],
        "comm": res["master"]["comm"],
    }

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "demo_summary.json").write_text(json.dumps(summary, indent=1))
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--mode", default="thread", choices=MODES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    summary = run(args.full, args.mode, args.device)
    for k in ("linreg", "split_nn", "logreg_he"):
        v = summary[k]
        extra = f" | AUC {v['auc']:.3f}" if "auc" in v else ""
        extra += f" ndcg@5 {v['ndcg@5']:.3f}" if "ndcg@5" in v else ""
        print(f"{k:10s} loss {v['loss_first']:.4f} -> {v['loss_last']:.4f}"
              f" | {v['comm']['sent_bytes']:,} B sent{extra}")
    print(f"written: {OUT}/demo_summary.json")


if __name__ == "__main__":
    main()
