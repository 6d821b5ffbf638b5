"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer. [arXiv:2403.19887]

Period-8 block: attention at position 3 of each 8-layer group (1 attn per
7 mamba), MoE on every second layer. Decode is sub-quadratic: Mamba layers
carry O(1) state; the 9 attention layers carry a model-axis-sharded KV.
"""
from repro_torch.configs.base import MambaConfig, MoEConfig, ModelConfig

_PATTERN = tuple(
    ("attn" if i == 3 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887 (Jamba); hf:ai21labs/AI21-Jamba-1.5-Large",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    block_pattern=_PATTERN,
    attention="full",
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=512),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
    rope=False,                      # Jamba has no positional embeddings
    subquadratic=True,               # hybrid: runs long_500k
    optimizer="adafactor",           # 398B: must fit 16GB/chip
)
