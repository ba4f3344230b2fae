"""mamba2-1.3b [ssm]: 48L d_model=2048 attn-free, ssm_state=128 vocab=50280.

SSD (state-space duality) [arXiv:2405.21060]. d_inner = 2*2048 = 4096,
head_dim 64 -> 64 SSM heads, 1 group, conv kernel 4. Attention-free with an
O(1) recurrent state -> runs the long_500k cell.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    conv_kernel=4, ssd_chunk=256,
    remat="full",
    max_seq=524288,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm",
    n_layers=2, d_model=64, vocab=64,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_groups=1,
    conv_kernel=4, ssd_chunk=16,
    max_seq=64,
)

register(FULL, SMOKE)
