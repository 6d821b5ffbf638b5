"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434]

Assignment line is self-contradictory ("MoE 64e top-6" vs "160 routed");
the DeepSeek-V2-Lite model card has 64 routed + 2 shared experts, top-6,
moe intermediate 1408, dense first layer (d_ff 10944). We follow the card
and note the discrepancy in DESIGN.md §4. The d_ff=1408 in the assignment
is the per-expert hidden width.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434 (DeepSeek-V2); hf:deepseek-ai/DeepSeek-V2-Lite",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,                   # MLA: per-head latent, kv grouping n/a
    head_dim=128,                    # nominal (nope+rope = 192 qk, 128 v)
    d_ff=10944,                      # dense layers' ffn width
    vocab=102400,
    # first layer dense (unrolled prefix), remaining 26 scanned MoE layers
    prefix_pattern=(("attn", "mlp"),),
    block_pattern=(("attn", "moe"),),
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    rope=True,
    rope_theta=10_000.0,
    subquadratic=False,
    optimizer="adamw",
)
