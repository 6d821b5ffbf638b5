"""Batched serving engine of the port's model zoo: prefill scoring and
decode, the counterpart of the JAX package's ``repro/serve/engine.py``.

It serves the families ``models/transformer.py`` runs: ``rwkv6-7b``,
``granite-moe-3b-a800m``, ``glm4-9b``, ``qwen3-14b``, ``h2o-danube-1.8b``,
``jamba-1.5-large-398b``, ``deepseek-v2-lite-16b``, ``minicpm3-4b``,
the encoder-decoder ``whisper-large-v3`` and the vision-language
``internvl2-76b``. An encoder-decoder model is served as
the JAX package serves it: ``transformer.encode`` the frames once, then
``generate(..., memory=...)``, which hands the encoder's output to every
decode step; its ``score`` raises, as the JAX engine's does. A
vision-prefix model is served as the JAX package serves it too:
``generate`` decodes text tokens only (the JAX engine never passes the
patches), and the prefix reaches the model through
``launch.steps.make_prefill_step`` and ``transformer.loss_fn``, which
take ``batch["patches"]``; its ``score``, whose batch has no patches,
raises a ``ValueError`` (the JAX engine's raises ``KeyError('patches')``
inside ``forward``).

``generate`` fills the per-layer state (the KV cache, MLA's latent
cache, the RWKV state or the Mamba state)
with the prompt by teacher-forced decode steps, then samples new tokens:
greedy at temperature 0, else from softmax(logits / T) with an explicit
``torch.Generator`` seeded by ``seed`` (the JAX package's ``jax.random``
draws cannot be reproduced; greedy output is the same token for token).
``score`` runs the prefill forward, the path that carries the
flash-attention, grouped-expert-matmul, WKV and selective-scan kernels
(a Mamba model's sequence length must be one the JAX package's chunked
scan takes: a multiple of 128, or at most 128), and returns the
loss the JAX engine returns: the mean NLL plus, for an MoE model, the
weighted router losses.

``device`` defaults to ``"cuda"`` and raises on a machine without a GPU;
the engine never falls back to the CPU unasked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.params import resolve_device


@dataclass
class ServeEngine:
    cfg: ModelConfig
    params: Any
    max_seq: int = 512
    dtype: torch.dtype = torch.float32
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init_cache(self, batch: int):
        return T.init_cache(self.cfg, batch, self.max_seq, self.dtype,
                            self.device)

    def _decode(self, tok, cache, index, memory):
        return T.decode_step(self.cfg, self.params, tok, cache, index,
                             memory, self.dtype)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_new: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 memory: Optional[torch.Tensor] = None) -> np.ndarray:
        """prompts: (b, s0) int -> (b, s0 + n_new) int32."""
        b, s0 = prompts.shape
        cache = self.init_cache(b)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=self.device)
        logits = None
        for i in range(s0):
            logits, cache = self._decode(toks[:, i:i + 1], cache, i, memory)
        out = [toks]
        gen = torch.Generator(self.device).manual_seed(seed)
        for j in range(n_new):
            last = logits[:, -1].float()
            if temperature > 0:
                probs = torch.softmax(last / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)
            else:
                nxt = last.argmax(-1, keepdim=True)
            out.append(nxt)
            if j + 1 < n_new:   # the last token's logits are not needed
                logits, cache = self._decode(nxt, cache, s0 + j, memory)
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def score(self, tokens: np.ndarray) -> float:
        """Mean NLL of a token batch under the model (prefill path),
        plus the weighted router losses of an MoE model."""
        if self.cfg.encoder is not None:
            raise NotImplementedError("use generate() for enc-dec")
        if T.has_vision_prefix(self.cfg):
            raise ValueError(
                f"{self.cfg.arch_id}: score() builds a text-only batch, "
                f"but the model's loss needs batch['patches'] (the "
                f"vision prefix); run transformer.loss_fn, or "
                f"launch.steps.make_prefill_step, on a batch with "
                f"'patches'")
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        loss, _ = T.loss_fn(self.cfg, self.params, batch, self.dtype)
        return float(loss)
