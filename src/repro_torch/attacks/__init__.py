"""Adversarial VFL harness of the PyTorch port (docs/privacy.md):
label-inference attacks run offline over captured exchanges, and the
defense matrix that turns the repo's privacy posture into
regression-tested numbers. The counterpart of the JAX package's
``repro/attacks``; the attacks are numpy, the attacked jobs run on the
card unless the caller asks for the CPU.

The package never touches a live channel: :class:`AttackHarness` runs a
normal :class:`~repro_torch.core.party.VFLJob` with
``cfg.capture_exchanges=True`` (the driver-level exchange-capture hook)
and replays the recorded per-round embeddings / decrypted gradients
through the attacks in :mod:`repro_torch.attacks.label_inference`. The
defense sweep lives in :mod:`repro_torch.attacks.runner` and writes
``benchmarks/results/privacy_torch.json`` (never the JAX package's
``privacy.json``), gated by ``benchmarks/check_regression.py
--privacy``.
"""
from repro_torch.attacks.harness import AttackHarness
from repro_torch.attacks.label_inference import (cluster_attack,
                                           gradient_direction_attack,
                                           probe_attack)
from repro_torch.attacks.runner import run_privacy_matrix

__all__ = ["AttackHarness", "gradient_direction_attack",
           "cluster_attack", "probe_attack", "run_privacy_matrix"]
