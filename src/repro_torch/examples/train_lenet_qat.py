"""QAT-train LeNet across [W:A] schemes on synthetic digits, then deploy
each onto the LightatorDevice and report the paper's Table-1 axes
(accuracy vs power vs kFPS/W).

    PYTHONPATH=src python -m repro_torch.examples.train_lenet_qat [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_lenet_qat \
        --steps 20 --device cpu

The reference's ``examples/train_lenet_qat.py`` on the port: training is
``launch/train_vision.py``'s (``qat_step``: the QAT forward, cross-entropy,
AdamW at lr 2e-3, batches of 64 in order from 2048 digits of seed 1,
weights from ``init_vision`` seeded 0), the accuracy that of the QAT
forward on 512 held-out digits of seed 9, and deployment
``LightatorDevice.run`` on the first 8 of them (the compiled plan, its
kernels on the card), beside its report's power, kFPS/W and time a frame.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.core.accelerator import LightatorDevice
from repro_torch.launch import train_vision as tv

DEPLOY_FRAMES = 8


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = LightatorDevice(device=args.device)

    xte, yte = tv.dataset("lenet", 512, seed=9)
    print(f"{'scheme':<8} {'acc':>6} {'power W':>8} {'kFPS/W':>8} "
          f"{'us/frame':>9}")
    rows = []
    for key in ("fp32", "w4a4", "w3a4", "w2a4", "mx43"):
        name, scheme = tv.SCHEME_LABELS[key], tv.SCHEMES[key]
        run = tv.train("lenet", scheme, args.steps, device=args.device)
        acc = tv.evaluate(run, xte, yte)
        row = {"scheme": key, "scheme_spec": scheme, "acc": acc,
               "losses": run.losses, "layers": run.layers,
               "params": run.params}
        rows.append(row)
        if scheme is None:
            print(f"{name:<8} {acc:>6.3f} {'-':>8} {'-':>8} {'-':>9}")
            continue
        # deploy on the device simulator
        logits, report = dev.run(run.layers, run.params,
                                 xte[:DEPLOY_FRAMES], scheme)
        dev_acc = float((logits.argmax(-1).cpu().numpy()
                         == yte[:DEPLOY_FRAMES]).mean())
        row.update(report=report, logits=logits, device_acc=dev_acc)
        print(f"{name:<8} {acc:>6.3f} {report.avg_power_w:>8.2f} "
              f"{report.kfps_per_w:>8.0f} {report.exec_time_s * 1e6:>9.2f}"
              f"   (device-exec acc on {DEPLOY_FRAMES} frames: "
              f"{dev_acc:.2f})")
    return rows


if __name__ == "__main__":
    main()
