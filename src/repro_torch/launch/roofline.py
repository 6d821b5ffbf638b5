"""Roofline accounting, the counterpart of the JAX package's
``repro/launch/roofline.py``.

Two layers share this module:

* **LLM dry-run aggregation**: ``launch/dryrun.py``'s records (a traced
  step on a mesh of fake devices, its roofline an estimate from the
  H100's datasheet rates) -> the markdown roofline table
  (``python -m repro_torch.launch.roofline [--mesh single]``), the JAX
  package's table in its words; "fits/chip" reads the busiest
  position's traced peak (``per_device_gib_estimate``).
* **Per-step VFL accounting** (:func:`step_account`): the training
  driver snapshots its CommStats counters around the fit phase and
  resolves them into a per-step compute-vs-wire split, surfaced in
  ``Driver.result()["roofline"]``. This is what makes pipeline-depth
  wins explainable: depth helps exactly when neither fraction
  dominates.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

NOTES = {
    "compute_s": "compute-bound: more chips or lower precision",
    "memory_s": "HBM-bound: fuse reads / shrink cache or state traffic",
    "collective_s": "collective-bound: resharding or dispatch schedule "
                    "(see §Perf)",
}


def step_account(wall_s: float, steps: int, comm_delta: Dict[str, float],
                 profile: Optional[Dict[str, float]] = None
                 ) -> Dict[str, float]:
    """Resolve one role's fit phase into per-step roofline terms.

    ``comm_delta`` holds the CommStats counter deltas across the phase
    (``recv_wait_s``, ``send_s``, ``queued_s``, ``wire_s``,
    ``sent_bytes``). The split:

    * ``compute_s`` — wall time the role was NOT blocked on the
      exchange: wall minus recv waits and blocking-send time. This is
      model compute plus driver overhead, the numerator of any
      pipelining win.
    * ``wire_s`` — time the exchange engine spent moving this role's
      bytes (sender-thread queue + wire time, plus blocking sends).
      Under pipelining this overlaps ``compute_s``; the two fractions
      can sum past 1.0 — that overlap IS the pipeline win.
    * ``stall_s`` — recv waits: the part of the exchange the role
      could not hide.

    ``profile`` (``VFLProtocol.roofline_profile()``) adds the analytic
    side: flops/bytes per step and arithmetic intensity, so the
    measured split can be sanity-checked against the model's shape.
    """
    steps = max(1, int(steps))
    wall = max(0.0, float(wall_s))
    stall = max(0.0, float(comm_delta.get("recv_wait_s", 0.0)))
    send = max(0.0, float(comm_delta.get("send_s", 0.0)))
    wire = send + max(0.0, float(comm_delta.get("queued_s", 0.0))) \
        + max(0.0, float(comm_delta.get("wire_s", 0.0)))
    compute = max(0.0, wall - stall - send)
    out = {
        "steps": steps,
        "wall_s_per_step": wall / steps,
        "compute_s_per_step": compute / steps,
        "wire_s_per_step": wire / steps,
        "stall_s_per_step": stall / steps,
        "compute_frac": compute / wall if wall else 0.0,
        "wire_frac": wire / wall if wall else 0.0,
        "stall_frac": stall / wall if wall else 0.0,
        "sent_bytes_per_step":
            float(comm_delta.get("sent_bytes", 0)) / steps,
    }
    out["dominant"] = "compute" if compute >= wire else "wire"
    if profile:
        fl = float(profile.get("flops_per_step", 0.0))
        by = float(profile.get("bytes_per_step", 0.0))
        out["model_flops_per_step"] = fl
        out["model_bytes_per_step"] = by
        if by:
            # flops per wire byte: the VFL analogue of arithmetic
            # intensity — low values say the exchange will dominate
            # long before the model does
            out["exchange_intensity"] = fl / by
        if compute:
            out["achieved_flops"] = fl * steps / max(compute, 1e-9)
        if "params_bytes" in profile:
            out["params_bytes"] = float(profile["params_bytes"])
    for k, v in list(out.items()):
        if isinstance(v, float):
            out[k] = round(v, 6)
    return out


def rows_for(mesh: str) -> List[Dict]:
    from repro_torch.launch.dryrun import RESULTS_DIR
    rows = []
    for f in sorted(RESULTS_DIR.glob(f"*__{mesh}.json")):
        rows.append(json.loads(f.read_text()))
    return rows


def table(mesh: str) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL/HLO | fits/chip | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows_for(mesh):
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"skipped | — | — | {r['reason'][:40]} |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | ERROR "
                       f"| — | — | |")
            continue
        rf = r["roofline"]
        # MODEL_FLOPS / analytic flops (the useful-compute fraction)
        ratio = rf["model_flops"] / max(rf["analytic_flops"], 1)
        mem = r["memory"].get("per_device_gib_estimate", 0)
        dom = rf["dominant"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3f} | "
            f"{rf['memory_s']:.3f} | {rf['collective_s']:.3f} | "
            f"{dom.replace('_s', '')} | {ratio:.2f} | "
            f"{mem:.2f} GiB | {NOTES[dom][:46]} |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    print(table(args.mesh))


if __name__ == "__main__":
    main()
