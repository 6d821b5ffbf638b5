"""glm4-9b [dense] — RoPE, GQA kv=2. [hf:THUDM/glm-4-9b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b",
    family="dense",
    source="hf:THUDM/glm-4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    block_pattern=(("attn", "mlp"),),
    attention="full",
    rope=True,
    rope_theta=10_000.0,
    subquadratic=False,
    optimizer="adamw",
)
