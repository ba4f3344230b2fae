"""Shape cells and the step inputs of every (arch x shape) pair, as meta
tensors.

The reference package's ``launch/specs.py``: the four LM shape cells

    train_4k     seq=4096,   global_batch=256   -> train_step
    prefill_32k  seq=32768,  global_batch=32    -> prefill_step (forward)
    decode_32k   seq=32768,  global_batch=128   -> serve_step (1 tok + cache)
    long_500k    seq=524288, global_batch=1     -> serve_step (SSM/hybrid/SWA)

and their skips (encoder-only archs have no decode; pure full-attention
archs no long_500k). The reference's ``jax.ShapeDtypeStruct`` stand-ins
(via ``eval_shape``) are tensors on the ``meta`` device here: shape and
dtype, no storage. ``params_shape`` runs ``models.lm.init_lm`` under
``FakeTensorMode`` and keeps the shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as lm_mod
from repro_torch.nn.module import tree_map


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

FULL_ATTENTION_ARCHS = {
    "yi-34b", "smollm-360m", "tinyllama-1.1b", "stablelm-3b",
    "grok-1-314b", "kimi-k2-1t-a32b", "internvl2-26b",
}


def cell_status(arch: str, shape: str, cfg: ModelConfig) -> Optional[str]:
    """None if runnable, else the skip reason recorded in the tables."""
    if cfg.family == "encoder" and shape in ("decode_32k", "long_500k"):
        return "skip: encoder-only, no autoregressive step"
    if shape == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return "skip: pure full attention (system directive: sub-quadratic only)"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def as_meta(tree):
    """Every tensor of ``tree`` as a meta tensor of its shape and dtype."""
    return tree_map(lambda x: _meta(x.shape, x.dtype), tree)


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict:
    """Meta-tensor stand-ins for the step inputs (no allocation)."""
    b, t = cell.global_batch, cell.seq
    act_dtype = cfg.torch_dtype
    if cell.kind in ("train", "prefill"):
        batch: Dict[str, torch.Tensor] = {}
        if cfg.frontend == "audio":
            batch["frames"] = _meta((b, t, cfg.frontend_dim), act_dtype)
            if cell.kind == "train":
                batch["labels"] = _meta((b, t), torch.int32)
        elif cfg.frontend == "vision":
            t_text = t - cfg.n_patches
            batch["patches"] = _meta((b, cfg.n_patches, cfg.frontend_dim),
                                     act_dtype)
            batch["tokens"] = _meta((b, t_text), torch.int32)
            if cell.kind == "train":
                batch["labels"] = _meta((b, t_text), torch.int32)
        else:
            batch["tokens"] = _meta((b, t), torch.int32)
            if cell.kind == "train":
                batch["labels"] = _meta((b, t), torch.int32)
        return batch
    # decode: one token + cache
    cache = lm_mod.init_cache(cfg, b, t, dtype=act_dtype, device="meta")
    return {"token": _meta((b, 1), torch.int32), "cache": cache}


def params_shape(cfg: ModelConfig):
    """The param tree as meta tensors (``init_lm`` under
    ``FakeTensorMode``: no allocation)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = lm_mod.init_lm(0, cfg, device="cpu")
    return as_meta(fake)
