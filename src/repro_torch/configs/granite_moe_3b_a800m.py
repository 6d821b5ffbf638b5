"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-3b-a800m-base]

Assignment line says both "MoE 40e top-8" and "32 experts top-8"; the
granite-3.0-3b-a800m card has 40 experts, top-8 — we use 40 (DESIGN.md §4).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                        # per-expert hidden width
    vocab=49155,
    block_pattern=(("attn", "moe"),),
    attention="full",
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
    rope=True,
    rope_theta=10_000.0,
    subquadratic=False,
    optimizer="adamw",
)
