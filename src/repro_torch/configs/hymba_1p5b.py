"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads [arXiv:2411.13676; hf].

Each layer runs attention heads and SSM heads in parallel on the same normed
input; branch outputs are RMS-normalized and averaged (Hymba's fused-head
module, simplified: learnable per-branch norms, fixed 0.5/0.5 mix).
Sliding-window attention (2048) on all layers + O(1) SSM state -> the
long-context decode cell (long_500k) is sub-quadratic; cache is a ring
buffer of the window size. (The released Hymba keeps 3 full-attention
layers; this config uses SWA everywhere.)
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, vocab=32001,
    n_heads=25, n_kv_heads=5, head_dim=64,
    sliding_window=2048,
    d_ff=5504, ffn="swiglu", norm="rms",
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    conv_kernel=4, ssd_chunk=256,
    tie_embeddings=True,
    remat="full",
    max_seq=524288,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, vocab=64,
    n_heads=4, n_kv_heads=2, head_dim=16,
    sliding_window=32,
    d_ff=128, ffn="swiglu", norm="rms",
    ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_groups=1,
    conv_kernel=4, ssd_chunk=16,
    tie_embeddings=True,
    max_seq=64,
)

register(FULL, SMOKE)
