"""End-to-end driver: train a small dense LM for a few hundred steps,
with checkpointing, metric logging and a resume check, through the
public API (``train.trainer.train``, ``train.checkpoint``). The port of
the JAX package's ``examples/train_lm.py``, on the same model: a
scaled-down qwen3-family config (8 layers, d_model 512, vocab 8192;
~36M params).

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
      [--device cpu] [--out build/train_lm]

``--device`` defaults to ``cuda``; the params are drawn there from the
trainer's seed. Checkpoints and metrics go under ``--out``, by default
``build/train_lm`` in the checkout (a directory git ignores; its
``ckpt`` is emptied first). It exits
with an ``AssertionError`` if the loss does not fall or the restored
checkpoint gives another loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import shutil

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_lm_batches
from repro_torch.models import params as PRM, transformer as T
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.trainer import TrainJob, train

OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / "train_lm"


def small_qwen():
    base = get_config("qwen3-14b")
    return dataclasses.replace(
        base, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=1536, vocab=8192, remat_policy="none")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)

    cfg = small_qwen()
    spec = T.model_spec(cfg)
    device = PRM.resolve_device(args.device)
    n_params = PRM.param_bytes(spec, 4) // 4
    print(f"model: {n_params/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab}) on {device}")

    out = pathlib.Path(args.out)
    ckpt_dir = str(out / "ckpt")
    # a fresh directory: the resume check restores the latest step, which
    # must be this run's
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    job = TrainJob(cfg=cfg, lr=1e-3, steps=args.steps,
                   log_every=max(1, args.steps // 25),
                   ckpt_every=args.steps // 2, ckpt_dir=ckpt_dir,
                   metrics_dir=str(out), device=device)
    res = train(job, make_lm_batches(cfg.vocab, args.batch, args.seq,
                                     args.steps + 1))
    first = res["history"][0]["loss"]
    last = res["history"][-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({res['history'][-1]['tokens_per_s']:.0f} tok/s)")
    assert last < first, "training must reduce loss"

    # resume check: restore the latest checkpoint, the same loss
    step = CKPT.latest_step(ckpt_dir)
    restored, _ = CKPT.restore(ckpt_dir, step, res["params"])
    batch = next(make_lm_batches(cfg.vocab, args.batch, args.seq, 1,
                                 seed=123))
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    with torch.no_grad():
        l1, _ = T.loss_fn(cfg, res["params"], tb, torch.float32)
        l2, _ = T.loss_fn(cfg, restored, tb, torch.float32)
    print(f"checkpoint roundtrip: {float(l1):.6f} == {float(l2):.6f}")
    assert abs(float(l1) - float(l2)) < 1e-5
    return {"loss_first": first, "loss_last": last, "step": step,
            "loss": float(l1), "loss_restored": float(l2),
            "tokens_per_s": res["history"][-1]["tokens_per_s"]}


if __name__ == "__main__":
    main()
