"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Llama-arch GQA [arXiv:2403.04652; hf]. head_dim 128, SwiGLU, RMSNorm,
rope_theta 5e6. Pure full attention -> long_500k skipped. FSDP on.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, vocab=64000,
    n_heads=56, n_kv_heads=8, head_dim=128, rope_theta=5e6,
    d_ff=20480, ffn="swiglu", norm="rms",
    tie_embeddings=False, fsdp=True, remat="full",
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="yi-34b-smoke", family="dense",
    n_layers=2, d_model=64, vocab=128,
    n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=160, ffn="swiglu", norm="rms",
    tie_embeddings=False,
    max_seq=64,
)

register(FULL, SMOKE)
