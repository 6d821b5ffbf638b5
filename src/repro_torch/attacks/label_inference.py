"""Label-inference attacks over captured VFL exchanges (offline).

Both attacks instantiate the practical threat class the VFL surveys
single out (Li et al. 2023; Liu et al. 2022): a party — or a wire
adversary at a party's vantage point — infers the master's private
labels from the per-round tensors that legitimately cross the split.

* :func:`gradient_direction_attack` — the **member** adversary in
  arbitered logreg. Each round it receives its decrypted gradient
  ``g = X_b^T r`` (r the batch residual ``(sigma(z) - y)/B``), knows
  its own feature slice ``X_b``, and can re-derive the batch rows from
  the announced ``(epoch, lo, hi)`` because ``batch_order`` is shared
  and deterministic. A min-norm solve recovers the projection of ``r``
  onto the rowspace of ``X_b``; since ``r_i < 0`` *iff* ``y_i = 1``
  (sigma is strictly inside (0, 1)), the sign of the reconstruction is
  label evidence, accumulated over rounds. With batch size <= the
  member's feature width the solve is exact and labels leak outright.

* :func:`cluster_attack` / :func:`probe_attack` — the **aggregator /
  wire** adversary in split-NN. Bottom activations are forced by
  training to become linearly separable in the label; averaging each
  sample's late-round embeddings and clustering (no labels needed) or
  fitting a tiny logistic probe (a handful of leaked aux labels)
  reads them back out.

Attacks return one score per matched sample; leakage is reported as
ROC-AUC of those scores against the true labels
(:func:`repro_torch.train.evals.auc`), so 0.5 = no leak, 1.0 = full label
reconstruction.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.protocols import base
from repro_torch.core.protocols.driver import OP_RUN

Capture = Dict[str, object]       # ExchangeCapture.as_dict() shape


# ---------------------------------------------------------------------------
# offline round reconstruction from a capture
# ---------------------------------------------------------------------------


def run_rounds(capture: Capture, cfg: base.VFLConfig, n: int, *,
               peer: str, direction: str) -> List[np.ndarray]:
    """Batch rows of every announced RUN round, in announcement order.

    Rows never cross the wire during fit — ``ctrl/step`` carries only
    ``(op, epoch, lo, hi)`` — but the adversary re-derives them exactly
    like any party does: ``batch_order(n, cfg, epoch)[lo:hi]``. Pass
    the vantage point: a member reconstructs from its *received* steps
    (``peer="master", direction="recv"``); the master's capture holds
    one *sent* copy per broadcast target, so filter on one peer."""
    out: List[np.ndarray] = []
    perms: Dict[int, np.ndarray] = {}
    for rec in capture["records"]:
        if rec["name"] != "ctrl/step" or rec["dir"] != direction \
                or rec["peer"] != peer:
            continue
        payload = rec["payload"]
        if int(np.asarray(payload["op"])[0]) != OP_RUN:
            continue
        epoch = int(np.asarray(payload["epoch"])[0])
        lo = int(np.asarray(payload["lo"])[0])
        hi = int(np.asarray(payload["hi"])[0])
        perm = perms.get(epoch)
        if perm is None:
            perm = perms[epoch] = base.batch_order(n, cfg, epoch)
        out.append(perm[lo:hi])
    return out


def captured_field(capture: Capture, name: str, field: str, *,
                   peer: Optional[str] = None,
                   direction: Optional[str] = None) -> List[np.ndarray]:
    """All captured tensors of one message field, in arrival order —
    stepped sequence numbers make that order the round order, so the
    t-th tensor pairs with the t-th reconstructed RUN round."""
    return [np.asarray(rec["payload"][field])
            for rec in capture["records"]
            if rec["name"] == name
            and (peer is None or rec["peer"] == peer)
            and (direction is None or rec["dir"] == direction)]


# ---------------------------------------------------------------------------
# gradient-direction attack (arbitered logreg)
# ---------------------------------------------------------------------------


def gradient_direction_attack(x_member: np.ndarray,
                              rounds: Sequence[np.ndarray],
                              grads: Sequence[np.ndarray]) -> np.ndarray:
    """Per-sample label scores from the member's decrypted gradients.

    For each round, solve ``X_b^T r = g`` in the least-squares sense
    (the min-norm reconstruction of the residual the master encrypted)
    and credit each batch sample ``-r_hat_i`` — positive evidence for
    ``y_i = 1``. Scores average over every round a sample appeared in,
    so epochs sharpen the estimate even when the solve is
    underdetermined (batch larger than the member's width)."""
    x = np.asarray(x_member, np.float64)
    scores = np.zeros(x.shape[0])
    seen = np.zeros(x.shape[0])
    for rows, g in zip(rounds, grads):
        g = np.asarray(g, np.float64).ravel()
        xb = x[rows]
        if g.shape[0] != xb.shape[1]:
            continue      # key-sharded arbiter slice — not this demo
        r_hat = np.linalg.lstsq(xb.T, g, rcond=None)[0]
        scores[rows] += -r_hat
        seen[rows] += 1
    return scores / np.maximum(seen, 1)


# ---------------------------------------------------------------------------
# embedding attacks (split-NN)
# ---------------------------------------------------------------------------


def mean_embeddings(rounds: Sequence[np.ndarray],
                    embeds: Sequence[np.ndarray], n: int,
                    late_frac: float = 0.5
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Average each sample's embedding over the last ``late_frac`` of
    rounds (early-epoch activations are still near init and only dilute
    the signal). Returns ``(u_bar (n, d), seen mask)``."""
    start = int(len(rounds) * (1.0 - late_frac))
    acc: Optional[np.ndarray] = None
    cnt = np.zeros(n)
    for rows, u in list(zip(rounds, embeds))[start:]:
        u = np.asarray(u, np.float64)
        if acc is None:
            acc = np.zeros((n, u.shape[1]))
        m = min(len(rows), len(u))    # stale substitution shape safety
        acc[rows[:m]] += u[:m]
        cnt[rows[:m]] += 1
    if acc is None:
        raise ValueError("no captured rounds to attack")
    return acc / np.maximum(cnt, 1)[:, None], cnt > 0


def _standardize(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, np.float64)
    return (u - u.mean(0)) / (u.std(0) + 1e-9)


def cluster_attack(u: np.ndarray, iters: int = 25) -> np.ndarray:
    """Unsupervised 2-means over standardized embeddings. Deterministic
    init: centroids at the mean +/- the top principal direction (power
    iteration), then Lloyd steps. Returns the signed margin
    ``d(u, c0) - d(u, c1)``; cluster naming is arbitrary, so leakage is
    ``max(auc, 1 - auc)`` at the caller."""
    z = _standardize(u)
    cov = z.T @ z / len(z)
    v = np.ones(z.shape[1]) / np.sqrt(z.shape[1])
    for _ in range(50):
        v = cov @ v
        v /= np.linalg.norm(v) + 1e-12
    c = np.stack([z.mean(0) - v, z.mean(0) + v])
    for _ in range(iters):
        d = ((z[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1)
        for k in (0, 1):
            if (assign == k).any():
                c[k] = z[assign == k].mean(0)
    d = ((z[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    return d[:, 0] - d[:, 1]


def probe_attack(u: np.ndarray, y: np.ndarray, aux: np.ndarray,
                 iters: int = 400, lr: float = 0.5,
                 l2: float = 1e-3) -> np.ndarray:
    """Supervised probe: fit a logistic regression on the ``aux``
    samples (the handful of labels the adversary is assumed to know —
    e.g. its own users) and score everyone. Full-batch GD in numpy;
    returns sigmoid scores for all rows. Leakage must be evaluated on
    ``~aux`` rows only."""
    z = _standardize(u)
    x = np.concatenate([z, np.ones((len(z), 1))], axis=1)
    xa, ya = x[aux], np.asarray(y, np.float64).ravel()[aux]
    w = np.zeros(x.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(xa @ w)))
        w -= lr * (xa.T @ (p - ya) / len(ya) + l2 * w)
    return 1.0 / (1.0 + np.exp(-(x @ w)))
