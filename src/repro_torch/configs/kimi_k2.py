"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 [arXiv:2501.kimi2; paper-table].

Trillion-param MoE: 384 * 3 * 7168 * 2048 * 61 ~= 1.03T expert params,
~32B active per token (top-8). head_dim 128 (attn_dim 8192 != d_model).
Sort-based dispatch (384 experts make one-hot dispatch tensors infeasible);
experts shard over the model axis. FSDP on.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, vocab=163840,
    n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, n_experts=384, top_k=8, capacity_factor=1.25,
    ffn="swiglu", norm="rms", moe_dispatch="grouped",
    tie_embeddings=False, fsdp=True, remat="full",
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke", family="moe",
    n_layers=2, d_model=64, vocab=128,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, n_experts=8, top_k=2, capacity_factor=2.0,
    ffn="swiglu", norm="rms",
    tie_embeddings=False,
    max_seq=64,
)

register(FULL, SMOKE)
