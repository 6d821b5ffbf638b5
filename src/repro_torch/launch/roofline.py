"""Per-step VFL roofline accounting (:func:`step_account`): the training
driver snapshots its CommStats counters around the fit phase and
resolves them into a per-step compute-vs-wire split, surfaced in
``Driver.result()["roofline"]``. This is what makes pipeline-depth wins
explainable: depth helps exactly when neither fraction dominates.

The JAX package's module of the same name also aggregates the LLM
dry-run tables of ``launch/dryrun.py`` and ``launch/hlo_analysis.py``;
that half waits for their port, ROADMAP Queue 1 item 10c (a
compile-free H100 estimate of a sharded step).
"""
from __future__ import annotations

from typing import Dict, Optional


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
