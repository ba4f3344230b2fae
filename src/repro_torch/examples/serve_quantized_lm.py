"""Photonic-quantized LM serving: batched generation under the [W:A]
fake-quant, the Lightator deployment mode for the LM architectures.

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized_lm \
        [--arch tinyllama-1.1b] [--gen 24] [--device cpu]

The reference's ``examples/serve_quantized_lm.py`` on the port: the arch's
smoke variant under quant none, w4a4 and w2a4 in turn, weights from
``init_lm`` with a generator seeded 0, an 8-token prompt per sequence from
``numpy.random.default_rng(0)``, greedy decoding through
``models.lm.greedy_generate``. ``launch/serve_lm.py`` is the driver with
the full configs and timings.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import smoke_variant
from repro_torch.core.program import resolve_device
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import greedy_generate as generate

PROMPT_LEN = 8


def main(argv: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    out = {}
    for quant in ("none", "w4a4", "w2a4"):
        cfg = dataclasses.replace(smoke_variant(args.arch),
                                  quant_scheme=quant)
        params = lm_mod.init_lm(torch.Generator(device=device).manual_seed(0),
                                cfg, device=device)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, PROMPT_LEN))).to(device, torch.int32)
        t0 = time.time()
        toks = generate(params, cfg, prompt, args.gen)
        dt = time.time() - t0
        print(f"quant={quant:<5} generated {toks.shape[1] - PROMPT_LEN} "
              f"tokens x {args.batch} seqs in {dt:.2f}s; sample: "
              f"{toks[0, PROMPT_LEN:PROMPT_LEN + 8].tolist()}")
        out[quant] = toks
    return out


if __name__ == "__main__":
    main()
