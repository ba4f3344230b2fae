"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.

Llama2-arch small [arXiv:2401.02385; hf]. head_dim 64.
Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, vocab=32000,
    n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, ffn="swiglu", norm="rms",
    tie_embeddings=False,
    remat="full",
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="tinyllama-1.1b-smoke", family="dense",
    n_layers=2, d_model=64, vocab=128,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, ffn="swiglu", norm="rms",
    tie_embeddings=False,
    max_seq=64,
)

register(FULL, SMOKE)
