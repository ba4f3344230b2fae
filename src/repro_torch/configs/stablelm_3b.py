"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2; unverified]. head_dim 80, LayerNorm, full MHA
(kv == heads). Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, vocab=50304,
    n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, ffn="swiglu", norm="layer",
    tie_embeddings=False,
    remat="full",
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="stablelm-3b-smoke", family="dense",
    n_layers=2, d_model=64, vocab=128,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=160, ffn="swiglu", norm="layer",
    tie_embeddings=False,
    max_seq=64,
)

register(FULL, SMOKE)
