"""Training launcher CLI of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
      --reduced --steps 100 --batch 8 --seq 128 [--device cpu]

The JAX package's flags, plus ``--device`` (default ``cuda``, where the
params are drawn on the card; ``cpu`` trains with the kernels' plain
versions). ``--mesh`` (a local mesh with sharding rules) raises: mesh
rules come with ROADMAP Queue 1 item 10. Ported archs: those of
``repro_torch.models.transformer``; the others exit with the
``NotImplementedError`` naming their ROADMAP item. On the card,
``rwkv6-7b`` and ``jamba-1.5-large-398b`` raise when their recurrences
need a gradient (no backward kernel yet).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, list_archs
from repro_torch.data.synthetic import make_lm_batches
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
                    help="use a local (1,1) mesh with sharding rules "
                         "(not ported: raises)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.mesh:
        raise NotImplementedError(
            "--mesh: sharding rules are not ported to repro_torch yet: "
            "ROADMAP Queue 1 item 10 (sharding on the device path)")
    job = TrainJob(cfg=cfg, lr=args.lr, steps=args.steps, seed=args.seed,
                   ckpt_dir=args.ckpt_dir, metrics_dir=args.metrics_dir,
                   log_every=max(1, args.steps // 20), device=args.device)
    batches = make_lm_batches(cfg.vocab, args.batch, args.seq,
                              args.steps + 1, seed=args.seed)
    res = train(job, batches)
    print(f"{args.arch}: final metrics {res['metrics']}")


if __name__ == "__main__":
    main()
