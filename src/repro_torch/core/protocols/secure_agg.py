"""Secure-aggregation split learning as a first-class protocol.

``core/secure_agg.py`` ships the Bonawitz-style pairwise-mask
primitives and ``core/secure_agg_protocol.py`` the over-the-wire
``PairwiseMasker``; until now they only ran as an opt-in flag
(``VFLConfig.secure_agg=True``) on the split-NN protocol. Registering
them as their own protocol name makes the privacy posture a spec-level
choice — ``protocol = "secure_agg"`` in a cluster TOML, or
``VFLConfig(protocol="secure_agg")`` under ``VFLJob``/``run_vfl`` —
with no extra flag to forget.

Semantics are exactly split-NN with masking forced on: members agree on
pairwise DH seeds over the communicator and add cancelling PRG masks to
their embeddings, so the master only ever sees the aggregate sum. The
training math is untouched (masks cancel exactly in fp32), hence the
protocol converges bit-for-bit with plain ``split_nn`` at depth 1 —
a tested claim (tests/test_vfl_protocols.py).
"""
from __future__ import annotations

from repro_torch.core.protocols import base
from repro_torch.core.protocols.split_nn import SplitNNProtocol


@base.register
class SecureAggProtocol(SplitNNProtocol):
    """Split-NN with pairwise-mask secure aggregation always on.

    Example::

        cfg = VFLConfig(protocol="secure_agg", epochs=3)
        res = run_vfl(cfg, master, members, mode="thread")
    """

    name = "secure_agg"

    def setup(self) -> None:
        if self.cfg.compress:
            raise ValueError(
                "secure_agg masks do not survive independent "
                "quantization; disable cfg.compress")
        super().setup()
        if self.is_member and self.masker is None:
            # cfg.secure_agg was off: force the masker on — the whole
            # point of choosing this protocol name
            from repro_torch.core.secure_agg_protocol import PairwiseMasker
            self.masker = PairwiseMasker(self.ch.comm, self.role,
                                         self.ch.members)
