"""configs — the LM architectures (+ the paper's own CNNs), a copy of the
reference package's.

``get_config(name)`` resolves any registered architecture id, e.g.
``get_config("tinyllama-1.1b")``; ``smoke_variant(name)`` its tiny variant.
"""

from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register, smoke_variant)

# importing the modules registers their configs
from repro_torch.configs import (  # noqa: F401
    hubert_xlarge, mamba2_1p3b, yi_34b, smollm_360m, tinyllama_1p1b,
    stablelm_3b, hymba_1p5b, grok1_314b, kimi_k2, internvl2_26b,
    vision_cnns,
)

__all__ = ["ModelConfig", "register", "get_config", "list_configs",
           "smoke_variant"]
