"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892]

Time-mix state is O(heads * head_dim^2) per layer regardless of sequence
length => runs long_500k. Channel-mix is modeled as the gated MLP with the
assigned d_ff.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892 (RWKV-6 Finch)",
    n_layers=32,
    d_model=4096,
    n_heads=64,                      # d_model / head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65536,
    block_pattern=(("rwkv", "mlp"),),
    attention="none",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=64),
    rope=False,
    subquadratic=True,
    optimizer="adamw",
)
