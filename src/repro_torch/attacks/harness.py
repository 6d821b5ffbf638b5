"""AttackHarness: run a VFLJob with exchange capture on, then evaluate
label-inference attacks offline over what crossed the wire.

The harness is deliberately a *consumer* of the normal job API — it
flips ``cfg.capture_exchanges`` on, runs fit + evaluate through
:class:`~repro_torch.core.party.VFLJob` in any execution mode, and collects
each role's :class:`~repro_torch.core.protocols.driver.ExchangeCapture`
export from the per-role result dicts. Attacks then replay the capture
(:mod:`repro_torch.attacks.label_inference`); nothing here hooks live
channels or changes protocol math, so measured leakage is exactly what
the production exchange leaks.

Example::

    h = AttackHarness(VFLConfig(protocol="logreg_he", ...),
                      master_data, [member_data], device="cuda").run()
    rep = h.grad_attack()          # {"leakage_auc": ..., ...}
    rep["leakage_auc"] >= 0.75     # undefended logreg leaks labels
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.attacks import label_inference as li
from repro_torch.core.party import VFLJob
from repro_torch.core.protocols import base
from repro_torch.train.evals import auc


class AttackHarness:
    """One adversarial measurement run: job + capture + attacks.

    Parameters mirror :class:`VFLJob`; the config is copied with
    ``capture_exchanges=True`` so callers pass their production config
    unchanged. ``job_kw`` reaches the job as it is: ``device`` (the
    card unless the caller asks for ``"cpu"``) and ``resume_dir`` (a
    checkpoint cut of either package to start from) among them.
    ``run()`` executes fit + evaluate + shutdown and stores
    ``metrics`` (the protocol's utility metrics, e.g. ``auc``) and
    ``results`` (per-role result dicts, each carrying its capture)."""

    def __init__(self, cfg: base.VFLConfig, master_data,
                 member_datas: List, mode: str = "thread", **job_kw):
        self.cfg = dataclasses.replace(cfg, capture_exchanges=True)
        self.master_data = master_data
        self.member_datas = list(member_datas)
        self.mode = mode
        self.job_kw = dict(job_kw)
        self.metrics: Dict[str, float] = {}
        self.results: Dict[str, Any] = {}

    # -- run -----------------------------------------------------------------
    def run(self) -> "AttackHarness":
        with VFLJob(self.cfg, self.master_data, self.member_datas,
                    mode=self.mode, **self.job_kw) as job:
            job.fit()
            self.metrics = job.evaluate()
            self.results = job.shutdown()
        return self

    # -- capture / data plumbing --------------------------------------------
    def capture(self, role: str) -> Dict[str, Any]:
        cap = self.results.get(role, {}).get("capture")
        if cap is None:
            raise KeyError(f"no capture in {role!r} result — was the "
                           f"job run with this harness?")
        return cap

    @property
    def order(self) -> List[str]:
        """The matched sample order, re-derived offline: every match
        path (PSI or salted-hash) agrees on sorted common ids, so the
        adversary needs no wire data to know it."""
        common = set(self.master_data.ids)
        for md in self.member_datas:
            common &= set(md.ids)
        return sorted(common)

    @property
    def n(self) -> int:
        return len(self.order)

    def labels(self, item: Optional[int] = None) -> np.ndarray:
        """Binary target in matched order. Multi-item label matrices
        (the recsys demo) attack the most class-balanced item column
        unless ``item`` says otherwise."""
        y = base._select(self.master_data.ids, self.order,
                         np.asarray(self.master_data.y))
        if y.ndim == 1:
            y = y[:, None]
        if item is None:
            item = int(np.argmin(np.abs(y.mean(0) - 0.5)))
        return y[:, item].astype(np.float64)

    def member_x(self, member: str = "member0") -> np.ndarray:
        md = self.member_datas[int(member.replace("member", ""))]
        return base._select(md.ids, self.order, np.asarray(md.x))

    # -- attacks -------------------------------------------------------------
    def grad_attack(self, member: str = "member0") -> Dict[str, Any]:
        """Gradient-direction label inference from ``member``'s vantage
        point (arbitered logreg): its received ``ctrl/step`` stream
        gives the batch rows, its received decrypted gradients give the
        residual projections."""
        cap = self.capture(member)
        rounds = li.run_rounds(cap, self.cfg, self.n,
                               peer="master", direction="recv")
        grads = li.captured_field(cap, "logreg/grad", "g",
                                  direction="recv")
        scores = li.gradient_direction_attack(self.member_x(member),
                                              rounds, grads)
        y = self.labels()
        return {"attack": "grad_direction", "adversary": member,
                "leakage_auc": auc(scores, y),
                "rounds": len(grads),
                "utility_auc": float(self.metrics.get("auc", 0.5))}

    def embed_attack(self, member: str = "member0",
                     method: str = "probe", aux_frac: float = 0.2,
                     late_frac: float = 0.5, seed: int = 0,
                     item: Optional[int] = None) -> Dict[str, Any]:
        """Embedding label inference from the aggregator's vantage
        point (split-NN): the master's capture holds ``member``'s
        per-round bottom activations exactly as delivered — masked
        under secure_agg, quantized under int8 — so defenses are
        measured, not assumed."""
        cap = self.capture("master")
        rounds = li.run_rounds(cap, self.cfg, self.n,
                               peer=member, direction="send")
        us = li.captured_field(cap, "splitnn/u", "u", peer=member,
                               direction="recv")
        u_bar, seen = li.mean_embeddings(rounds, us, self.n,
                                         late_frac=late_frac)
        y = self.labels(item)
        if method == "cluster":
            scores = li.cluster_attack(u_bar[seen])
            a = auc(scores, y[seen])
            leak = max(a, 1.0 - a)
        else:
            rng = np.random.default_rng(seed)
            idx = np.flatnonzero(seen)
            aux_n = max(2, int(len(idx) * aux_frac))
            aux_idx = rng.permutation(idx)[:aux_n]
            aux = np.zeros(self.n, bool)
            aux[aux_idx] = True
            scores = li.probe_attack(u_bar[seen], y[seen], aux[seen])
            hold = ~aux[seen]
            leak = auc(scores[hold], y[seen][hold])
        return {"attack": f"embed_{method}", "adversary": "master",
                "leakage_auc": float(leak), "rounds": len(us),
                "utility_auc": float(self.metrics.get("auc", 0.5))}
