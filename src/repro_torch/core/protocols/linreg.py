"""Arbiterless VFL linear regression (paper §2 protocol layer), on the
lifecycle API.

Per batch: every party computes its partial prediction z_p = X_p w_p and
sends it to the master; the master (who holds labels and its own feature
slice) sums partials, computes the residual, and broadcasts it; each
party updates its own weight slice locally from X_p^T r. No raw features
ever leave a party. Predict is the forward half alone: members answer
feature-slice queries with partial scores, the master sums.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.comm import schema
from repro_torch.comm.schema import Field
from repro_torch.core.protocols import base
from repro_torch.core.protocols.driver import VFLProtocol

schema.message("linreg/setup", {"items": Field("int64", 1)},
               doc="target width broadcast after matching")
schema.message("linreg/z", {"z": Field("float64", 2)}, stepped=True,
               doc="partial predictions for the current batch")
schema.message("linreg/resid", {"r": Field("float64", 2)}, stepped=True,
               doc="shared residual (the only training signal members see)")
schema.message("linreg/pred_z", {"z": Field("float64", 2)}, stepped=True,
               doc="partial scores for a predict query")


@base.register
class LinRegProtocol(VFLProtocol):
    name = "linreg"
    supports_pipeline = True

    def setup(self) -> None:
        ch, d = self.ch, self.data
        # the width exchange only runs on a fresh federation: a resumed
        # (e.g. rejoining) agent restores items/w from its checkpoint —
        # its counterpart is mid-fit, not waiting in setup
        if self.is_master:
            self.y = base._select(d.ids, self.order, d.y).astype(np.float64)
            self.x = base._select(d.ids, self.order, d.x).astype(np.float64) \
                if d.x is not None else None
            self.items = self.y.shape[1]
            if not self.resuming:
                ch.broadcast("linreg/setup",
                             {"items": np.array([self.items], np.int64)},
                             targets=ch.members)
            self.w = np.zeros((self.x.shape[1], self.items)) \
                if self.x is not None else None
        else:
            self.x = base._select(d.ids, self.order, d.x).astype(np.float64)
            if self.resuming:
                return          # items/w arrive via load_state_dict
            self.items = int(ch.recv("master",
                                     "linreg/setup").tensor("items")[0])
            self.w = np.zeros((self.x.shape[1], self.items))

    def on_batch_master(self, rows, step) -> float:
        cfg, ch = self.cfg, self.ch
        zb = np.zeros((len(rows), self.items))
        if self.x is not None:
            zb += self.x[rows] @ self.w
        for msg in ch.gather(ch.members, "linreg/z"):
            # stale substitutions (down/straggling peer) may carry a
            # different tail-batch row count than this round
            zb += base.fit_rows(msg.tensor("z"), len(rows))
        r = (zb - self.y[rows]) / len(rows)
        # async broadcast: the residual is snapshotted at encode time,
        # so the in-place weight update below can't race the wire write
        ch.broadcast("linreg/resid", {"r": r}, targets=ch.members,
                     wait=False)
        if self.x is not None:
            self.w -= cfg.lr * (self.x[rows].T @ r + cfg.l2 * self.w)
        return float(0.5 * np.mean((zb - self.y[rows]) ** 2))

    def member_stage_send(self, rows, step):
        self.ch.isend("master", "linreg/z", {"z": self.x[rows] @ self.w})
        return None

    def member_stage_recv(self, rows, step, ctx) -> None:
        cfg = self.cfg
        r = self.ch.recv("master", "linreg/resid").tensor("r")
        self.w -= cfg.lr * (self.x[rows].T @ r + cfg.l2 * self.w)

    # -- predict/serve -------------------------------------------------------
    def predict_master(self, rows) -> np.ndarray:
        z = np.zeros((len(rows), self.items))
        if self.x is not None:
            z += self.x[rows] @ self.w
        for msg in self.ch.gather(self.ch.members, "linreg/pred_z"):
            z += msg.tensor("z")
        return z

    def predict_member(self, rows) -> None:
        self.send_embed(self.predict_embed(rows), rows)

    def predict_embed(self, rows) -> np.ndarray:
        return self.x[rows] @ self.w

    def send_embed(self, z, rows) -> None:
        self.ch.send("master", "linreg/pred_z", {"z": np.asarray(z)})

    def evaluate_master(self, scores, rows) -> Dict[str, float]:
        return {"mse": float(np.mean((scores - self.y[rows]) ** 2))}

    def finalize(self) -> Dict:
        return {"w_master": self.w} if self.is_master else {"w": self.w}

    def state_dict(self) -> Dict:
        return {"w": None if self.w is None else self.w.copy()}

    def load_state_dict(self, state) -> None:
        self.w = None if state["w"] is None else state["w"].copy()
        if self.w is not None:
            self.items = self.w.shape[1]
