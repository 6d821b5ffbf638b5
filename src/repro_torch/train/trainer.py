"""Training loop of the port: any ported architecture, checkpointing +
metrics; the counterpart of the JAX package's ``repro/train/trainer.py``.
``rules`` (a ``MeshRules``) runs each step under them. On a mesh of more
than one device the drawn params and the optimizer state are placed over
it (``launch.steps.place_params``) and each step splits its batch, for
the dense-attention and MoE families; the other families raise in
``launch.steps.make_train_step``. The history, the checkpoints and the
returned params are whole.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as ST
from repro_torch.models import params as PRM, transformer as T
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import optimizer as O
from repro_torch.train.metrics import MetricsLogger


@dataclass
class TrainJob:
    cfg: ModelConfig
    lr: float = 3e-4
    steps: int = 100
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_dir: Optional[str] = None
    metrics_dir: Optional[str] = None
    rules: Any = None
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_steps: int = 1
    device: Any = "cuda"


def train(job: TrainJob, batches: Iterator[Dict[str, np.ndarray]]
          ) -> Dict[str, Any]:
    """Trains ``job.steps`` steps on ``batches`` (numpy ``tokens`` and
    ``labels``), from params drawn on ``job.device`` by a generator
    seeded with ``job.seed``. Returns the final params, the last logged
    metrics and the history (the JAX package's record keys, among them
    ``tokens_per_s``)."""
    cfg = job.cfg
    dev = PRM.resolve_device(job.device)
    spec = T.model_spec(cfg)
    params = PRM.init_tree(spec, torch.Generator(dev).manual_seed(job.seed),
                           job.param_dtype, dev)
    opt = O.make_optimizer(cfg.optimizer)
    step_fn = ST.make_train_step(cfg, opt, lr=job.lr, rules=job.rules,
                                 compute_dtype=job.compute_dtype,
                                 accum_steps=job.accum_steps)
    if ST.sharded(job.rules):
        params = ST.place_params(cfg, params, job.rules)
    opt_state = opt.init(params)
    # As in the JAX package (src/repro/train/trainer.py:47-50): the
    # schedule is built but the step gets the constant ``job.lr``, so
    # training runs at a constant rate; kept for parity.
    sched = O.warmup_cosine(job.lr, warmup=max(1, job.steps // 10),
                            total=job.steps)

    logger = MetricsLogger(job.metrics_dir, run=f"train_{cfg.arch_id}")
    t0 = time.perf_counter()
    last_metrics: Dict[str, Any] = {}
    for i, batch in enumerate(batches):
        if i >= job.steps:
            break
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, tb)
        if i % job.log_every == 0 or i == job.steps - 1:
            # float() waits for the device, so the rate counts the step
            last_metrics = {k: float(v) for k, v in metrics.items()}
            logger.log(i, **last_metrics,
                       tokens_per_s=(np.prod(batch["tokens"].shape)
                                     * (i + 1)) / (time.perf_counter() - t0))
        if job.ckpt_every and job.ckpt_dir and i and i % job.ckpt_every == 0:
            CKPT.save(job.ckpt_dir, i, params, opt_state)
    if job.ckpt_dir:
        CKPT.save(job.ckpt_dir, job.steps, params, opt_state)
    logger.close()
    return {"params": PRM.whole_tree(params), "metrics": last_metrics,
            "history": logger.records}
