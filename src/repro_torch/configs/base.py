"""Config system: typed, frozen dataclasses describing every architecture.

Every assigned architecture is a `ModelConfig` instance in its own module
(``src/repro_torch/configs/<arch_id>.py``) citing its source. The configs
are the JAX package's, copied as they are: they carry no dtype and import
no framework. ``ModelConfig.reduced()`` yields the CPU-smoke variant
(<=2 pattern repeats, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN block."""

    num_experts: int
    top_k: int
    d_expert: int                 # hidden width of each expert
    num_shared: int = 0           # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""

    kv_lora_rank: int
    q_lora_rank: Optional[int]    # None => full-rank q projection
    rope_head_dim: int
    nope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class MambaConfig:
    """Selective SSM (S6) mixer, Jamba-style."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256            # rank of the Δ projection

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 "Finch" time-mix with data-dependent decay."""

    head_dim: int = 64
    decay_lora: int = 64          # rank of the data-dependent decay LoRA
    gate_lora: int = 64


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec archs (whisper). Frontend is a stub that
    provides precomputed frame embeddings per the assignment carve-out."""

    n_layers: int
    n_frames: int = 1500          # whisper-large-v3 mel frames after conv


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend stub: input_specs() yields precomputed embeddings
    of shape (batch, num_tokens, d_model) instead of raw pixels/audio."""

    kind: str                     # "audio" | "vision"
    num_tokens: int               # patch/frame tokens prepended or encoded


# ---------------------------------------------------------------------------
# the model config
# ---------------------------------------------------------------------------

MIXERS = ("attn", "mamba", "rwkv")
FFNS = ("mlp", "moe")


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    source: str                   # citation for the config values
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0              # 0 for attention-free archs
    n_kv_heads: int = 0
    head_dim: int = 0
    # (mixer, ffn) per position of the repeating block pattern;
    # n_layers - len(prefix_pattern) must be a multiple of len(block_pattern).
    block_pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    # unrolled unique layers before the scanned stack (deepseek: dense L0)
    prefix_pattern: Tuple[Tuple[str, str], ...] = ()
    attention: str = "full"       # full | swa | mla | none
    window: int = 0               # sliding-window size when attention == "swa"
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendStub] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"             # silu (gated) | gelu (whisper)
    # long-context capability: True iff decode cache is sub-quadratic
    # (SSM state, SWA ring buffer, or hybrid).
    subquadratic: bool = False
    optimizer: str = "adamw"      # adamw | adafactor | sgdm (dry-run default)
    remat_policy: str = "minimal" # none | minimal | full
    # ---- beyond-paper optimization levers (EXPERIMENTS.md §Perf) ----
    # group-local MoE dispatch: routing cumsum/scatter stays within each
    # sequence row, eliminating cross-device prefix collectives
    moe_group_dispatch: bool = False
    # pad attention heads so they divide the TP axis (zero-output-init);
    # 0 = off. Trades +pad/n_heads attention FLOPs for n_model-way TP.
    pad_heads_to: int = 0
    # expert parallelism: True shards experts over the model axis; False
    # replicates expert compute data-parallel (FSDP-sharded weights) —
    # wins when experts are small (granite: d_expert=512)
    moe_expert_parallel: bool = True
    # decode: partial-softmax combine over the model-sharded KV cache
    # (shard_map) instead of letting XLA all-gather the cache per step
    decode_partial_softmax: bool = False

    @property
    def eff_heads(self) -> int:
        return self.pad_heads_to or self.n_heads

    # -- derived -----------------------------------------------------------
    def __post_init__(self):
        scanned = self.n_layers - len(self.prefix_pattern)
        if scanned <= 0 or scanned % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.arch_id}: n_layers={self.n_layers} minus prefix "
                f"{len(self.prefix_pattern)} not a multiple of pattern "
                f"length {len(self.block_pattern)}")
        for mixer, ffn in self.prefix_pattern + self.block_pattern:
            if mixer not in MIXERS or ffn not in FFNS:
                raise ValueError(f"bad block pattern entry ({mixer},{ffn})")
        needs_moe = any(f == "moe" for _, f in
                        self.prefix_pattern + self.block_pattern)
        if needs_moe and self.moe is None:
            raise ValueError(f"{self.arch_id}: moe pattern without MoEConfig")

    @property
    def n_repeats(self) -> int:
        return (self.n_layers - len(self.prefix_pattern)) \
            // len(self.block_pattern)

    @property
    def uses_attention(self) -> bool:
        return any(m == "attn" for m, _ in self.block_pattern)

    def param_count(self) -> int:
        """Analytic total parameter count (for roofline MODEL_FLOPS)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        return _param_count(self, active_only=True)

    # -- reduced smoke variant ----------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU-runnable variant of the same family: one pattern repeat
        (2 layers for simple patterns), d_model<=256, <=4 experts."""
        pat = self.block_pattern
        n_layers = len(self.prefix_pattern) + (len(pat) if len(pat) > 1 else 2)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2)) if self.n_kv_heads else 0
        head_dim = min(self.head_dim, 64) if self.head_dim else 0
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 128),
                num_shared=min(self.moe.num_shared, 1))
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=64,
                            q_lora_rank=64 if self.mla.q_lora_rank else None,
                            rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
        mamba = None
        if self.mamba is not None:
            mamba = dataclasses.replace(self.mamba, d_state=8, dt_rank=16)
        rwkv = None
        if self.rwkv is not None:
            rwkv = RWKVConfig(head_dim=32, decay_lora=16, gate_lora=16)
        enc = None
        if self.encoder is not None:
            enc = EncoderConfig(n_layers=2, n_frames=16)
        fe = None
        if self.frontend is not None:
            fe = dataclasses.replace(self.frontend, num_tokens=8)
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, head_dim=head_dim, d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512), moe=moe, mla=mla, mamba=mamba,
            rwkv=rwkv, encoder=enc, frontend=fe, remat_policy="none")


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    total = cfg.vocab * d                       # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab * d                  # lm head

    per_pattern = 0
    for mixer, ffn in cfg.prefix_pattern + cfg.block_pattern * cfg.n_repeats:
        if mixer == "attn":
            if cfg.attention == "mla" and cfg.mla is not None:
                m = cfg.mla
                qdim = cfg.n_heads * (m.nope_head_dim + m.rope_head_dim)
                if m.q_lora_rank:
                    per_pattern += d * m.q_lora_rank + m.q_lora_rank * qdim
                else:
                    per_pattern += d * qdim
                per_pattern += d * (m.kv_lora_rank + m.rope_head_dim)
                per_pattern += m.kv_lora_rank * cfg.n_heads * (
                    m.nope_head_dim + m.v_head_dim)
                per_pattern += cfg.n_heads * m.v_head_dim * d
            else:
                hd = cfg.head_dim
                per_pattern += d * cfg.n_heads * hd          # q
                per_pattern += 2 * d * cfg.n_kv_heads * hd   # k, v
                per_pattern += cfg.n_heads * hd * d          # o
        elif mixer == "mamba" and cfg.mamba is not None:
            mb = cfg.mamba
            di = mb.d_inner(d)
            per_pattern += d * 2 * di                        # in_proj
            per_pattern += di * mb.d_conv                    # conv
            per_pattern += di * (mb.dt_rank + 2 * mb.d_state)  # x_proj
            per_pattern += mb.dt_rank * di                   # dt_proj
            per_pattern += di * mb.d_state                   # A
            per_pattern += di * d                            # out
        elif mixer == "rwkv" and cfg.rwkv is not None:
            per_pattern += 4 * d * d                         # r,k,v,o
            per_pattern += 2 * d * cfg.rwkv.decay_lora       # decay lora
            per_pattern += 2 * d * cfg.rwkv.gate_lora        # gate lora
        if ffn == "moe" and cfg.moe is not None:
            n_e = (cfg.moe.num_shared + cfg.moe.top_k) if active_only \
                else (cfg.moe.num_shared + cfg.moe.num_experts)
            per_pattern += n_e * 3 * d * cfg.moe.d_expert    # gated mlp
            per_pattern += d * cfg.moe.num_experts           # router
        else:
            per_pattern += 3 * d * cfg.d_ff                  # gated mlp
    total += per_pattern  # loop above already covers all n_layers
    if cfg.encoder is not None:
        # encoder layers: MHA + (non-gated) mlp, whisper style
        enc_layer = 4 * d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.d_ff
        # decoder additionally has cross-attention per layer
        total += cfg.encoder.n_layers * enc_layer
        total += cfg.n_layers * 4 * d * cfg.n_heads * cfg.head_dim
    return total


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Is (arch, shape) a valid dry-run combination? Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention (see DESIGN.md)"
    return True, ""
