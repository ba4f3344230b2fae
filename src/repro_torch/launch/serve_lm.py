"""Photonic-quantized LM serving: batched greedy generation under the
Lightator [W:A] fake-quant — the deployment mode for the LM
architectures, on the card.

    # tinyllama-1.1b at its published width and depth, quant none, w4a4
    # and w2a4 in turn, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_lm

    # the smoke variant of any arch, one scheme, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch mamba2-1.3b \
        --smoke --quant w4a4 --device cpu

The counterpart of the reference package's
``examples/serve_quantized_lm.py`` (its flags ``--arch``, ``--batch``,
``--gen`` and its loop over quant none, w4a4 and w2a4, with an 8-token
prompt), with the ``--smoke`` / ``--quant`` / ``--seed`` flags of its
``launch/serve.py``: without ``--smoke`` the arch's FULL config. Weights
come from ``init_lm`` with a generator seeded ``--seed``, the prompt from
``numpy.random.default_rng(--seed)``. Prints, per scheme, the generated
tokens of the first sequence, the wall time and the ms per decode step
(the prompt is prefilled by stepping, so a run is prompt + gen steps).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, smoke_variant
from repro_torch.core.program import resolve_device
from repro_torch.models import lm as lm_mod

PROMPT_LEN = 8
SCHEMES = ("none", "w4a4", "w2a4")


def main(argv: Optional[List[str]] = None) -> List[torch.Tensor]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list_configs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke variant (tiny dims)")
    ap.add_argument("--quant", choices=["none", "w4a4", "w3a4", "w2a4"],
                    help=f"one scheme (default: {', '.join(SCHEMES)})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = smoke_variant(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    out = []
    for quant in ([args.quant] if args.quant else SCHEMES):
        cfg = dataclasses.replace(base, quant_scheme=quant)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = lm_mod.init_lm(gen, cfg, device=device)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, PROMPT_LEN)).astype(np.int32)).to(
            device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        toks = lm_mod.greedy_generate(params, cfg, prompt, args.gen)
        sample = toks[0, PROMPT_LEN:].tolist()      # waits for the card
        dt = time.perf_counter() - t0
        n_steps = PROMPT_LEN + args.gen
        print(f"[serve_lm] arch={cfg.name} quant={quant:<5} "
              f"generated {args.gen} tokens x {args.batch} seqs in "
              f"{dt:.2f}s ({1e3 * dt / n_steps:.2f} ms per decode step of "
              f"{n_steps}, {args.batch * args.gen / dt:.1f} tokens/s, "
              f"first call) on {device}; tokens: {sample}")
        out.append(toks)
        del params
    return out


if __name__ == "__main__":
    main()
