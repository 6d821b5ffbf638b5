"""Recommendation metrics for the demo workload (paper §4 evaluates a
recommender): AUC, precision@k, NDCG@k over multi-label implicit
feedback, plus LM perplexity for the training driver."""
from __future__ import annotations

from typing import Dict

import numpy as np


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Micro-averaged ROC-AUC via the rank statistic."""
    s = scores.ravel()
    y = labels.ravel().astype(bool)
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, s.size + 1)
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def precision_at_k(scores: np.ndarray, labels: np.ndarray,
                   k: int = 5) -> float:
    """Mean per-user precision@k. scores/labels: (users, items)."""
    k = min(k, scores.shape[1])
    top = np.argsort(-scores, axis=1)[:, :k]
    hits = np.take_along_axis(labels, top, axis=1)
    return float(hits.mean())


def ndcg_at_k(scores: np.ndarray, labels: np.ndarray, k: int = 5) -> float:
    k = min(k, scores.shape[1])
    top = np.argsort(-scores, axis=1)[:, :k]
    gains = np.take_along_axis(labels, top, axis=1)
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    dcg = (gains * discounts).mean(axis=1) if k else 0.0
    ideal = np.sort(labels, axis=1)[:, ::-1][:, :k]
    idcg = (ideal * discounts).mean(axis=1)
    mask = idcg > 0
    if not mask.any():
        return 0.0
    return float((dcg[mask] / idcg[mask]).mean())


def recsys_report(scores: np.ndarray, labels: np.ndarray,
                  k: int = 5) -> Dict[str, float]:
    return {
        "auc": auc(scores, labels),
        f"precision@{k}": precision_at_k(scores, labels, k),
        f"ndcg@{k}": ndcg_at_k(scores, labels, k),
    }


def perplexity(mean_nll: float) -> float:
    return float(np.exp(min(mean_nll, 30.0)))
