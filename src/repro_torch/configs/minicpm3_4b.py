"""minicpm3-4b [dense] — MLA attention. [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,                     # nominal (nope 64 + rope 32)
    d_ff=6400,
    vocab=73448,
    block_pattern=(("attn", "mlp"),),
    attention="mla",
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  rope_head_dim=32, nope_head_dim=64, v_head_dim=64),
    rope=True,
    rope_theta=10_000.0,
    subquadratic=False,
    optimizer="adamw",
)
