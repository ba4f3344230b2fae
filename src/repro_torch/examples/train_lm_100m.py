"""Train a ~100M-param LM for a few hundred steps through the training
driver.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_100m [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_lm_100m \
        --steps 20 --device cpu

A 100M slice of the smollm-360m family (12 layers, d 768, 12/4 heads of
64, d_ff 2048, vocab 8192, no remat), registered as ``smollm-100m``
through ``configs.base.register`` and trained by ``launch/train.py``
(batch 4, seq 128, lr 1e-3) on the planted-bigram stream, with its
checkpoints, straggler monitor and failure-drill flags. Prints the mean
CE of the first and last ten steps: the CE falls as the bigram is
learned.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import List, Optional

from repro_torch.configs import base, get_config
from repro_torch.core.program import resolve_device
from repro_torch.launch import train

NAME = "smollm-100m"


def config_100m():
    """-> (the 100M config, its smoke variant: the same)."""
    cfg = dataclasses.replace(
        get_config("smollm-360m"), name=NAME, n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048, vocab=8192,
        remat="none", max_seq=512)
    return cfg, dataclasses.replace(cfg, name=f"{NAME}-smoke")


def run(argv: Optional[List[str]] = None) -> train.TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)             # before touching the registry
    base.register(*config_100m())
    out = train.train([
        "--arch", NAME, "--steps", str(args.steps),
        "--batch", "4", "--seq", "128", "--lr", "1e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--device", args.device,
    ])
    head, tail = out.losses[:10], out.losses[-10:]
    print(f"[example] first-10 mean CE {sum(head) / len(head):.3f} -> "
          f"last-10 mean CE {sum(tail) / len(tail):.3f}")
    return out


def main(argv: Optional[List[str]] = None) -> List[float]:
    return run(argv).losses


if __name__ == "__main__":
    main()
