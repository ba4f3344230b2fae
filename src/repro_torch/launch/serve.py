"""Deprecated shim -- the LM serving stub that predates ``serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --batch 2 --prompt-len 8 --gen 4 --quant w4a4 [--device cpu]

This module predates the Program API and the serving runtime: it runs a
one-off prefill+decode loop with no queueing, batching, or metrics.
Serving goes through ``repro_torch.serve`` (driven by
``repro_torch.launch.serve_vision``); the photonic-quantized LM
generation demo is ``repro_torch.examples.serve_quantized_lm``, and the
LM driver ``repro_torch.launch.serve_lm``, both over
``models.lm.greedy_generate``.

``generate`` and ``main`` keep the reference's behaviour and flags (plus
``--device``, ``cuda`` unless the caller asks for the CPU), each with a
one-shot ``DeprecationWarning``. Weights come from ``init_lm`` with a
generator seeded ``--seed``, the prompt from
``numpy.random.default_rng(--seed)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.plan import _warn_deprecated
from repro_torch.core.program import resolve_device
from repro_torch.models import lm as lm_mod


def generate(params, cfg, prompt: torch.Tensor, steps: int) -> torch.Tensor:
    """Deprecated shim -- use ``repro_torch.models.lm.greedy_generate``."""
    _warn_deprecated("launch.serve.generate",
                     "repro_torch.models.lm.greedy_generate",
                     doc="docs/serving.md")
    return lm_mod.greedy_generate(params, cfg, prompt, steps)


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    """Deprecated shim -- the LM decode smoke, unchanged behaviour.

    For serving (micro-batching, backpressure, latency metrics) use
    ``repro_torch.serve`` / ``python -m repro_torch.launch.serve_vision``.
    """
    _warn_deprecated(
        "launch.serve.main",
        "repro_torch.serve (python -m repro_torch.launch.serve_vision) for "
        "serving, repro_torch.examples.serve_quantized_lm for the LM demo",
        doc="docs/serving.md")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--quant", default="none",
                    choices=["none", "w4a4", "w3a4", "w2a4"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_variant(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, quant_scheme=args.quant)
    params = lm_mod.init_lm(
        torch.Generator(device=device).manual_seed(args.seed), cfg,
        device=device)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len))).to(device, torch.int32)
    t0 = time.time()
    toks = lm_mod.greedy_generate(params, cfg, prompt, args.gen)
    dt = time.time() - t0
    n_new = args.batch * args.gen
    print(f"[serve] arch={cfg.name} quant={cfg.quant_scheme} "
          f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s incl. prefill)")
    assert bool((toks >= 0).all()) and bool((toks < cfg.vocab).all())
    return toks


if __name__ == "__main__":
    main()
