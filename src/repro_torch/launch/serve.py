"""Serving launcher CLI of the port: batched generation from a model of
the zoo with random weights from a seed.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m [--reduced] [--device cpu] \
      --batch 4 --prompt-len 16 --new 32

Ported archs: ``rwkv6-7b``, ``granite-moe-3b-a800m``, ``glm4-9b``,
``qwen3-14b``, ``h2o-danube-1.8b``, ``jamba-1.5-large-398b`` (whose
full 72 layers of 16 experts do not fit one card: ``chip_smoke.py``
serves one 8-layer period of 4 experts), the MLA archs
``deepseek-v2-lite-16b`` and ``minicpm3-4b``, the encoder-decoder
``whisper-large-v3``, whose encoder takes zero frames of (batch,
n_frames, d_model) and whose decoder attends to their encoding, and
``internvl2-76b``, whose ``generate`` decodes text tokens only, as the
JAX package's launcher serves them. ``--device``
defaults to ``cuda``, where the weights are drawn on the card.
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
        memory = None
        if cfg.encoder is not None:
            frames = torch.zeros(
                (args.batch, cfg.encoder.n_frames, cfg.d_model),
                dtype=torch.float32, device=device)
            memory = T.encode(cfg, params, frames)
    engine = ServeEngine(cfg, params,
                         max_seq=args.prompt_len + args.new + 1,
                         device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new, temperature=args.temperature,
                          seed=args.seed, memory=memory)
    dt = time.perf_counter() - t0
    print(f"{args.arch} on {device}: generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.new / dt:.1f} tok/s)")
    print(out[0, args.prompt_len:])


if __name__ == "__main__":
    main()
