"""Serve the encoder-decoder (whisper) family: batched transcription-
style decoding against stub frame embeddings, through the public API
(``transformer.encode`` once, then ``ServeEngine.generate`` with the
encoder's output as ``memory``, which every decode step's
cross-attention reads). The port of the JAX package's
``examples/asr_serve.py``, on the reduced ``whisper-large-v3``.

  PYTHONPATH=src python -m repro_torch.examples.asr_serve [--device cpu]

``--device`` defaults to ``cuda``; weights and frames are drawn there
from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import params as PRM, transformer as T
from repro_torch.serve.engine import ServeEngine

BATCH, NEW, MAX_SEQ = 4, 32, 48


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config("whisper-large-v3").reduced()
    device = PRM.resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    with torch.inference_mode():
        params = PRM.init_tree(T.model_spec(cfg), gen, torch.float32,
                               device)
        # frontend stub: precomputed mel/conv frame embeddings
        frames = torch.randn((BATCH, cfg.encoder.n_frames, cfg.d_model),
                             generator=gen, device=device) * 0.02
        t0 = time.perf_counter()
        memory = T.encode(cfg, params, frames)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        enc_dt = time.perf_counter() - t0

    engine = ServeEngine(cfg, params, max_seq=MAX_SEQ, device=device)
    bos = np.full((BATCH, 1), 1, np.int32)
    t0 = time.perf_counter()
    out = engine.generate(bos, NEW, temperature=0.7, seed=args.seed,
                          memory=memory)
    dec_dt = time.perf_counter() - t0
    print(f"encoded {BATCH}x{cfg.encoder.n_frames} frames on {device} in "
          f"{enc_dt:.2f}s; decoded {out.shape} in {dec_dt:.2f}s "
          f"({BATCH * NEW / dec_dt:.1f} tok/s)")
    print("sample:", out[0, 1:12])


if __name__ == "__main__":
    main()
