"""Compressed VFL exchanges: int8 quantization with error feedback.

Beyond-paper lever on the paper's own axis (compact serialization for
WAN silos, §2): bottom-model activations and the returned gradients are
sent as per-column-scaled int8 (4x smaller payloads than f32). Error
feedback keeps the quantization residual locally and adds it to the next
round's tensor, so the *accumulated* transmitted signal is unbiased —
split-NN training converges to the same region (tested).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


def quantize_int8(x: np.ndarray, axis: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-slice int8. Returns (q int8, scale f32)."""
    absmax = np.maximum(np.abs(x).max(axis=axis, keepdims=True), 1e-12)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


@dataclass
class ErrorFeedback:
    """Per-tag residual accumulator (one per sending party)."""

    residuals: Dict[str, np.ndarray] = field(default_factory=dict)

    def compress(self, tag: str, x: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        r = self.residuals.get(tag)
        xc = x + r if r is not None and r.shape == x.shape else x.copy()
        q, scale = quantize_int8(xc)
        self.residuals[tag] = xc - dequantize_int8(q, scale)
        return q, scale


def payload(q: np.ndarray, scale: np.ndarray) -> Dict[str, np.ndarray]:
    return {"q": q, "scale": scale}


def unpack(msg_payload: Dict[str, np.ndarray]) -> np.ndarray:
    return dequantize_int8(msg_payload["q"], msg_payload["scale"])
