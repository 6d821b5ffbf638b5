"""Trains internvl2-76b at full width, cut in depth as ``chip_smoke.py``
phase 10k cuts it, at several learning rates from the same params and
batches on one card, and prints each step's loss beside the same batch's
loss at the initial params.

    python3 scripts/lr_sweep.py [--lrs 3e-4,5.625e-5,3e-5,1.6e-5,1e-5]

Each rate starts from the params ``train()`` draws (seed 0) and walks the
batches phase 10k's ``train()`` takes (``chip_smoke.train_batches``, seed
0), one ``make_train_step`` a batch with the config's Adafactor, f32, TF32
off: the losses are those ``train()`` logs. After the first update it
prints each weight's update over the weight (root mean squares over the
first 64 entries of the last dim). First it runs PLAIN_STEPS steps at
the first rate with the kernels and with the plain versions
(``chip_smoke.plain_versions``). Needs a CUDA device and the repo's
``src/repro_torch`` beside it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# train()'s steps in phase 10k, and the steps held against the plain
# versions
STEPS, PLAIN_STEPS = 10, 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lrs", default="3e-4,5.625e-5,3e-5,1.6e-5,1e-5")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("lr_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.launch import steps as ST
    from repro_torch.models import params as PRM
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as O
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = C.gpu_line()
    C.log(card)
    C.build_kernels()
    cfg = C.internvl_train_config()
    opt = O.make_optimizer(cfg.optimizer)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b in C.train_batches(cfg, STEPS, 0)]

    def draw():
        with torch.no_grad():
            return PRM.init_tree(T.model_spec(cfg),
                                 torch.Generator(dev).manual_seed(0),
                                 torch.float32, dev)

    params = draw()
    with torch.no_grad():
        init = [T.loss_fn(cfg, params, b, torch.float32)[0].item()
                for b in batches]
    del params
    C.log(f"{cfg.arch_id} {cfg.n_layers} layers: each batch's loss at the "
          f"initial params {init} ({card})")

    def run(lr: float, steps: int, plain: bool = False,
            report: bool = False) -> list:
        params = draw()
        state = opt.init(params)
        step = ST.make_train_step(cfg, opt, lr=lr,
                                  compute_dtype=torch.float32)
        losses = []
        for i, batch in enumerate(batches[:steps]):
            if i == 0 and report:
                with torch.no_grad():
                    before = {"/".join(p): t[..., :64].clone()
                              for p, t in PRM.tree_items(params)
                              if t.dim() >= 2}
            if plain:
                with C.plain_versions():
                    params, state, m = step(params, state, batch)
            else:
                params, state, m = step(params, state, batch)
            losses.append(m["loss"].item())
            if i == 0 and report:
                now = {"/".join(p): t for p, t in PRM.tree_items(params)}
                moved = {k: ((now[k][..., :64] - b).pow(2).mean().sqrt()
                             / b.pow(2).mean().sqrt()).item()
                         for k, b in before.items()}
                del before, now
                C.log(f"lr {lr}: first update rms / weight rms "
                      + json.dumps(moved))
        del params, state, step
        torch.cuda.empty_cache()
        return losses

    lrs = [float(x) for x in args.lrs.split(",")]
    kernels = run(lrs[0], PLAIN_STEPS)
    plain = run(lrs[0], PLAIN_STEPS, plain=True)
    C.log(f"lr {lrs[0]}, {PLAIN_STEPS} steps: kernels {kernels}, plain "
          f"versions {plain}, largest relative difference "
          f"{max(abs(a - b) / abs(b) for a, b in zip(kernels, plain))}")
    for lr in lrs:
        losses = run(lr, STEPS, report=True)
        below = all(a < b for a, b in zip(losses[1:], init[1:]))
        C.log(f"lr {lr}: losses {losses}; every step after the first "
              f"below its batch's initial loss: {below}; last below "
              f"first: {losses[-1] < losses[0]} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
