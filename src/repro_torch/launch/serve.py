"""Serving launcher CLI of the port: batched generation from a model of
the zoo with random weights from a seed.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m [--reduced] [--device cpu] \
      --batch 4 --prompt-len 16 --new 32

Ported archs: ``rwkv6-7b``, ``granite-moe-3b-a800m``, ``glm4-9b``,
``qwen3-14b`` and ``h2o-danube-1.8b`` (at full width its head dim 80 is
one the flash-attention kernel does not take, so on the card its
prefill raises; decode and the reduced config run). ``--device``
defaults to ``cuda``, where the weights are drawn on the card. An arch
whose family is not ported yet exits with the ``NotImplementedError``
that names its ROADMAP item.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import params as PRM, transformer as T
from repro_torch.serve.engine import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    spec = T.model_spec(cfg)
    device = PRM.resolve_device(args.device)
    with torch.inference_mode():
        params = PRM.init_tree(
            spec, torch.Generator(device).manual_seed(args.seed),
            torch.float32, device)
    engine = ServeEngine(cfg, params,
                         max_seq=args.prompt_len + args.new + 1,
                         device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new, temperature=args.temperature,
                          seed=args.seed)
    dt = time.perf_counter() - t0
    print(f"{args.arch} on {device}: generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.new / dt:.1f} tok/s)")
    print(out[0, args.prompt_len:])


if __name__ == "__main__":
    main()
