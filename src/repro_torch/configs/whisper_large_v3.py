"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356]

The assignment specifies the TRANSFORMER BACKBONE only; the mel-spectrogram
+ conv feature extractor is a stub — input_specs() provides precomputed
frame embeddings (1500, d_model) for the encoder. Decoder is the 32-layer
text decoder with cross-attention. Whisper uses MHA (kv == heads) and
non-gated GELU MLPs, absolute positions (no RoPE).
"""
from repro_torch.configs.base import EncoderConfig, FrontendStub, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    source="arXiv:2212.04356 (Whisper); hf:openai/whisper-large-v3",
    n_layers=32,                      # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,                    # MHA
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    block_pattern=(("attn", "mlp"),),
    attention="full",
    rope=False,                       # learned absolute positions
    act="gelu",
    encoder=EncoderConfig(n_layers=32, n_frames=1500),
    frontend=FrontendStub(kind="audio", num_tokens=1500),
    subquadratic=False,               # decoder ctx bounded; long_500k skipped
    optimizer="adamw",
)
