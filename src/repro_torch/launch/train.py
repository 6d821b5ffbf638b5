"""Training launcher CLI of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
      --reduced --steps 100 --batch 8 --seq 128 [--device cpu]

The JAX package's flags, plus ``--device`` (default ``cuda``, where the
params are drawn on the card; ``cpu`` trains with the kernels' plain
versions). ``--mesh`` trains under sharding rules on the (1, 1) local
mesh of that device, as the JAX package's flag does; its values are
those of no mesh.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, list_archs
from repro_torch.data.synthetic import make_lm_batches
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.sharding.rules import MeshRules
from repro_torch.train.trainer import TrainJob, train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--metrics-dir", default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="use a local (1,1) mesh with sharding rules")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rules = (MeshRules(make_local_mesh(devices=[args.device]))
             if args.mesh else None)
    job = TrainJob(cfg=cfg, lr=args.lr, steps=args.steps, seed=args.seed,
                   ckpt_dir=args.ckpt_dir, metrics_dir=args.metrics_dir,
                   rules=rules, log_every=max(1, args.steps // 20),
                   device=args.device)
    batches = make_lm_batches(cfg.vocab, args.batch, args.seq,
                              args.steps + 1, seed=args.seed)
    res = train(job, batches)
    print(f"{args.arch}: final metrics {res['metrics']}")


if __name__ == "__main__":
    main()
