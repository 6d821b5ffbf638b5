"""internvl2-76b [vlm] — InternViT + InternLM2 backbone. [arXiv:2404.16821]

Backbone only per the assignment: the InternViT vision encoder + MLP
projector are a stub — input_specs() provides precomputed patch embeddings
(256 tokens, d_model) prepended to the text sequence. The language model is
the Llama-architecture InternLM2 / Hermes-2-Theta-Llama-3 70B-class stack.
"""
from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2); LLM backbone per assignment",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    block_pattern=(("attn", "mlp"),),
    attention="full",
    rope=True,
    rope_theta=500_000.0,
    frontend=FrontendStub(kind="vision", num_tokens=256),
    subquadratic=False,
    optimizer="adafactor",            # 76B: Adam states would not fit 16GB/chip
)
