"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2 [hf:xai-org/grok-1; unverified].

head_dim 128. Expert FFNs are SwiGLU (3 * 6144 * 32768 per expert; 8 experts
x 64 layers ~= 309B expert params + ~6B attention = ~315B total). FSDP on;
experts shard over the model axis (EP).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, vocab=131072,
    n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, n_experts=8, top_k=2, capacity_factor=1.25,
    ffn="swiglu", norm="rms", moe_dispatch="grouped",
    tie_embeddings=False, fsdp=True, remat="full",
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, vocab=128,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, n_experts=4, top_k=2, capacity_factor=2.0,
    ffn="swiglu", norm="rms",
    tie_embeddings=False,
    max_seq=64,
)

register(FULL, SMOKE)
