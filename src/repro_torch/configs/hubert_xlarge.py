"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (same arch as wav2vec2-XL) [arXiv:2106.07447]. The CNN waveform
frontend is a STUB: ``input_specs`` provides precomputed 512-dim frame
embeddings; the framework's compressive-acquisition feature (ca_factor) can
mean-pool frames before the encoder (the paper's CA generalized to audio).
No decode path (encoder) -> decode_32k / long_500k cells are skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, vocab=504,
    n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, ffn="gelu", norm="layer", causal=False,
    tie_embeddings=False,
    frontend="audio", frontend_dim=512,
    remat="full",
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="encoder",
    n_layers=2, d_model=64, vocab=32,
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, ffn="gelu", norm="layer", causal=False,
    tie_embeddings=False,
    frontend="audio", frontend_dim=24,
    max_seq=64,
)

register(FULL, SMOKE)
