"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-arch small [hf:HuggingFaceTB/SmolLM-360M]. head_dim 64, tied embeddings.
Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, vocab=49152,
    n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, ffn="swiglu", norm="rms",
    tie_embeddings=True,
    remat="full",
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=48, vocab=96,
    n_heads=3, n_kv_heads=1, head_dim=16,
    d_ff=128, ffn="swiglu", norm="rms",
    tie_embeddings=True,
    max_seq=64,
)

register(FULL, SMOKE)
