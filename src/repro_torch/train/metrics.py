"""Metric sinks — the offline stand-in for the paper's MLflow/Prometheus
stack: same counters (ML metrics, payload bytes, exchange times), CSV +
JSONL backends, pluggable interface. The JAX package's
``repro/train/metrics.py``, copied: it imports no framework.
"""
from __future__ import annotations

import csv
import json
import pathlib
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, run: str = "run"):
        self.records: List[Dict[str, Any]] = []
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.run = run
        self._t0 = time.perf_counter()
        if self.out_dir:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.out_dir / f"{run}.jsonl", "w")
        else:
            self._jsonl = None

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": round(time.perf_counter() - self._t0, 4),
               **{k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}}
        self.records.append(rec)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self.out_dir and self.records:
            keys = sorted({k for r in self.records for k in r})
            with open(self.out_dir / f"{self.run}.csv", "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=keys)
                w.writeheader()
                w.writerows(self.records)

    def last(self) -> Dict[str, Any]:
        return self.records[-1] if self.records else {}
