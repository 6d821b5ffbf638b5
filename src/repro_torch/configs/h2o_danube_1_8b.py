"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window
attention. [arXiv:2401.16818]

SWA window 4096 => decode cache is bounded (ring buffer), so this dense
arch DOES run long_500k per the assignment's sliding-window carve-out.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818 (H2O-Danube)",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    block_pattern=(("attn", "mlp"),),
    attention="swa",
    window=4096,
    rope=True,
    rope_theta=10_000.0,
    subquadratic=True,               # SWA ring cache: runs long_500k
    optimizer="adamw",
)
