"""Synthetic data generators.

- ``SyntheticRecsys``: an SBOL-like implicit-feedback dataset (users x
  19 banking products + dense user features) with a latent-factor ground
  truth, plus a MegaMarket-like second silo sharing a user subset — the
  paper's demo workload with the published Table-1 statistics, generated
  because the real datasets are not redistributable.
- ``make_lm_batches``: deterministic token streams for LM smoke tests
  and the trainer example (a Zipfian unigram stream with a repeated-
  n-gram structure so models can actually reduce loss).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

from repro_torch.configs.vfl_recsys import VFLRecsysConfig


@dataclass
class SyntheticRecsys:
    ids: List[str]
    features: np.ndarray          # (n_users, n_features) master silo
    labels: np.ndarray            # (n_users, n_items) implicit feedback
    member_features: List[np.ndarray]
    member_ids: List[List[str]]


def make_recsys_silos(cfg: VFLRecsysConfig, seed: int = 0,
                      latent: int = 8) -> SyntheticRecsys:
    rng = np.random.default_rng(seed)
    n, items = cfg.n_users, cfg.n_items
    zu = rng.normal(size=(n, latent))                 # user latents
    zi = rng.normal(size=(items, latent))             # item latents
    logits = zu @ zi.T + rng.normal(scale=0.5, size=(n, items))
    # calibrate threshold to the published interaction density
    density = cfg.n_interactions / (n * items)
    thresh = np.quantile(logits, 1 - density)
    labels = (logits > thresh).astype(np.float32)

    def silo(width: int, k: int) -> np.ndarray:
        w = rng.normal(size=(latent, width))
        raw = zu @ w + rng.normal(scale=1.0, size=(n, width))
        # standardize: silo features are unit-variance (keeps VFL GD
        # stable at textbook learning rates on 1k+-dim silos)
        return ((raw - raw.mean(0)) / (raw.std(0) + 1e-6)).astype(np.float32)

    features = silo(cfg.n_other_features, 0)
    ids = [f"user{i:07d}" for i in range(n)]

    member_features, member_ids = [], []
    for j, width in enumerate(cfg.member_features):
        m = int(cfg.id_overlap * n)
        keep = np.sort(rng.permutation(n)[:m])
        extra = rng.permutation(n)[: n - m]           # non-overlapping noise
        feats = silo(width, j + 1)[keep]
        member_features.append(feats)
        member_ids.append([ids[i] for i in keep])
    return SyntheticRecsys(ids, features, labels, member_features,
                           member_ids)


def make_lm_batches(vocab: int, batch: int, seq: int, steps: int,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Zipfian stream with injected bigram structure (learnable)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1 / ranks) / (1 / ranks).sum()
    follow = rng.integers(0, vocab, size=vocab)       # deterministic bigrams
    for _ in range(steps):
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        # half the positions follow the deterministic bigram table
        mask = rng.random((batch, seq)) < 0.5
        nxt = follow[toks[:, :-1]]
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
