"""ModelConfig — the one config schema every LM architecture instantiates.

A copy of the reference package's schema: the same fields, defaults and
properties, so a config compares field by field with the reference's
(``dataclasses.asdict``). Each arch module registers its FULL config and a
``smoke`` variant (same family, tiny dims) used by the CPU tests.
``quant_spec`` maps ``quant_scheme`` onto the port's ``core.quant`` specs,
``torch_dtype`` the ``dtype`` name onto its torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    causal: bool = True
    # ffn
    d_ff: int = 0
    ffn: str = "swiglu"         # swiglu | gelu
    norm: str = "rms"           # rms | layer
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "sorted"     # sorted | grouped
    moe_combine_dtype: str = "none"  # none | float8_e4m3fn | bfloat16
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_kernel: int = 4
    ssd_chunk: int = 128
    # embeddings / head
    tie_embeddings: bool = True
    # modality frontend (a stub: the inputs are precomputed embeddings)
    frontend: str = "none"      # none | audio | vision
    frontend_dim: int = 0
    n_patches: int = 0          # vlm: image patches at the sequence front
    ca_factor: int = 1          # compressive acquisition (1 = off)
    # photonic quantization (the paper's technique as a framework feature)
    quant_scheme: str = "none"  # none | w4a4 | w3a4 | w2a4
    # numerics / scale
    dtype: str = "bfloat16"
    remat: str = "none"         # none | full | dots
    max_seq: int = 4096
    # sharding hint (the reference's FSDP flag; no mesh on one card)
    fsdp: bool = False

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:   # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def torch_dtype(self):
        import torch
        return getattr(torch, self.dtype)

    def quant_spec(self):
        from repro_torch.core.quant import W2A4, W3A4, W4A4
        return {"none": None, "w4a4": W4A4, "w3a4": W3A4,
                "w2a4": W2A4}[self.quant_scheme]


_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def smoke_variant(name: str) -> ModelConfig:
    return _SMOKE[name]


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
