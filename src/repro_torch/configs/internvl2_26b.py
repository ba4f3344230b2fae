"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

InternViT + InternLM2 [arXiv:2404.16821; hf]. The InternViT frontend is a
STUB: ``input_specs`` provides precomputed 3200-dim patch embeddings
(n_patches=1024) projected into the LM; the framework's compressive
acquisition (the paper's own use-case: visual inputs) can pool patches
before the LM via ca_factor. Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, vocab=92553,
    n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, ffn="swiglu", norm="rms",
    tie_embeddings=False, fsdp=True, remat="full",
    frontend="vision", frontend_dim=3200, n_patches=1024,
    max_seq=32768,
)

SMOKE = ModelConfig(
    name="internvl2-26b-smoke", family="vlm",
    n_layers=2, d_model=64, vocab=128,
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, ffn="swiglu", norm="rms",
    tie_embeddings=False,
    frontend="vision", frontend_dim=48, n_patches=8,
    max_seq=64,
)

register(FULL, SMOKE)
