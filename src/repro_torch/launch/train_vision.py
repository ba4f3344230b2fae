"""QAT training of the paper's CNNs, and deployment of the trained weights
through the served kernels.

    # LeNet across the [W:A] schemes on synthetic digits, each deployed
    # and reported on Table 1's axes (accuracy, power, kFPS/W), on the card
    PYTHONPATH=src python -m repro_torch.launch.train_vision --model lenet

    # VGG9-CA at full width on synthetic textures (10 classes), 10 steps
    PYTHONPATH=src python -m repro_torch.launch.train_vision \
        --model vgg9 --steps 10 --scheme w4a4

    # the accuracy trend, as CSV lines under bench_accuracy's names
    PYTHONPATH=src python -m repro_torch.launch.train_vision --accuracy

    # any of these on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train_vision --device cpu

Training is the reference's (``examples/train_lenet_qat.py``,
``benchmarks/bench_accuracy.py``): the quantization-aware forward
``models.vision.apply_vision`` (STE), cross-entropy as ``logsumexp -
gold``, ``adamw_update`` at ``AdamWConfig(lr=2e-3, weight_decay=0.0)``,
batches taken in order from a fixed procedural training set. It runs
eagerly with TF32 off; the forward and backward use ``F.conv2d`` and
``torch.matmul`` on fake-quantized float tensors, as the reference leaves
them to XLA. Deployment compiles ``Program.from_model(model,
params=trained)`` under the scheme and runs ``run_per_frame`` (the
photonic_mvm, conv_chain and ca_pool kernels on the card); its accuracy
stands beside the power model's report. Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.program import Options, Program, resolve_device
from repro_torch.core.quant import MX_43, W2A4, W3A4, W4A4
from repro_torch.data.synthetic import synthetic_digits, synthetic_textures
from repro_torch.kernels.conv_bank.ref import float32_convs
from repro_torch.models.vision import VISION_MODELS, apply_vision, init_vision
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.clip import tree_leaves, tree_map

# the reference's example's schemes, under their printed names
SCHEMES = {"fp32": None, "w4a4": W4A4, "w3a4": W3A4, "w2a4": W2A4,
           "mx43": MX_43}
SCHEME_LABELS = {"fp32": "fp32", "w4a4": "[4:4]", "w3a4": "[3:4]",
                 "w2a4": "[2:4]", "mx43": "MX43"}
# bench_accuracy.py's names for them
BENCH_NAMES = {"fp32": "fp32", "w4a4": "4:4", "w3a4": "3:4", "w2a4": "2:4",
               "mx43": "MX43"}
TRAINABLE = ("lenet", "vgg9")
OPT = AdamWConfig(lr=2e-3, weight_decay=0.0)
TEXTURE_CLASSES = 10            # vgg9 keeps its 100 outputs; labels 0..9


def dataset(model: str, n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural frames and labels: digits for LeNet, textures for VGG9."""
    if model == "lenet":
        return synthetic_digits(n, seed=seed)
    if model == "vgg9":
        return synthetic_textures(n, n_classes=TEXTURE_CLASSES, seed=seed)
    raise ValueError(f"no training data for {model!r}; trainable: "
                     f"{TRAINABLE}")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """mean(logsumexp(logits) - logits[label]), the reference's step loss."""
    gold = logits.gather(-1, labels[:, None].long())[:, 0]
    return torch.mean(torch.logsumexp(logits, -1) - gold)


def qat_step(params, opt, layers, scheme, xb: torch.Tensor,
             yb: torch.Tensor):
    """One QAT step (the reference example's jitted ``step``, eager): the
    loss and its gradients with TF32 off, then ``adamw_update``. Returns
    (new params, new optimizer state, the loss)."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with float32_convs():
        loss = cross_entropy(apply_vision(live, layers, xb, scheme), yb)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    params, opt, _ = adamw_update(
        params, tree_map(lambda _: next(grads), live), opt, OPT)
    return params, opt, loss.detach()


@dataclasses.dataclass
class TrainRun:
    """One training run: the trained params (on its device, no grad), the
    loss of every step and every step's time in ms (CUDA events on the
    card, the host clock on the CPU: ``clock``)."""
    model: str
    scheme: object
    layers: tuple
    params: Dict[str, Dict[str, torch.Tensor]]
    losses: List[float]
    step_ms: List[float]
    clock: str


def train(model: str = "lenet", scheme=W4A4, steps: int = 200,
          batch: int = 64, seed: int = 0, device="cuda",
          params: Optional[Dict] = None, n_train: int = 2048) -> TrainRun:
    """QAT-train ``model`` under ``scheme`` (``None``: float) for ``steps``
    AdamW steps of ``batch`` frames, taken in order from ``n_train``
    procedural frames of seed 1 (the reference example's). ``params`` (a
    ``{layer: {"w", "b"}}`` tree) are the initial weights; otherwise
    ``init_vision`` draws them from ``seed``."""
    dev = resolve_device(device)
    layers = tuple(VISION_MODELS[model]())
    if params is None:
        params = init_vision(torch.Generator().manual_seed(seed), layers)
    params = tree_map(lambda t: torch.as_tensor(t).detach().to(
        dev, torch.float32, copy=True), params)
    opt = adamw_init(params, OPT)
    xs, ys = dataset(model, n_train, seed=1)
    xtr = torch.from_numpy(xs).to(dev)
    ytr = torch.from_numpy(ys).long().to(dev)
    cuda = dev.type == "cuda"
    marks, losses, host_ms = [], [], []
    for i in range(steps):
        lo = (i * batch) % n_train
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        t0 = time.perf_counter()
        params, opt, loss = qat_step(params, opt, layers, scheme,
                                     xtr[lo:lo + batch], ytr[lo:lo + batch])
        losses.append(loss)
        if cuda:
            end.record()
            marks.append((start, end))
        else:
            host_ms.append((time.perf_counter() - t0) * 1e3)
    if cuda:
        torch.cuda.synchronize(dev)
        host_ms = [s.elapsed_time(e) for s, e in marks]
    return TrainRun(model, scheme, layers, params,
                    torch.stack(losses).cpu().tolist() if losses else [],
                    host_ms, "cuda events" if cuda else "host")


@torch.no_grad()
def evaluate(run: TrainRun, frames, labels) -> float:
    """Accuracy of the QAT forward on ``frames``."""
    dev = tree_leaves(run.params)[0].device
    x = torch.as_tensor(frames).to(dev, torch.float32)
    y = torch.as_tensor(labels).to(dev)
    logits = apply_vision(run.params, run.layers, x, run.scheme)
    return float((logits.argmax(-1) == y).float().mean())


def deploy(run: TrainRun, frames, labels) -> Dict[str, float]:
    """The trained weights compiled under the run's scheme on their device
    and run per frame: served accuracy, the power model's average power,
    kFPS/W and execution time per frame."""
    dev = tree_leaves(run.params)[0].device
    exe = Program.from_model(run.model, params=run.params).compile(
        Options(scheme=run.scheme, device=str(dev)))
    logits = exe.run_per_frame(frames)
    acc = float((logits.argmax(-1).cpu() == torch.as_tensor(labels))
                .float().mean())
    rep = exe.report
    return {"acc": acc, "avg_power_w": rep.avg_power_w,
            "kfps_per_w": rep.kfps_per_w,
            "exec_time_us": rep.exec_time_s * 1e6}


def accuracy_trend(steps: int = 40, device="cuda", csv: bool = True
                   ) -> Dict[str, float]:
    """``benchmarks/bench_accuracy.py``'s run: LeNet QAT from seed 0 under
    each scheme for ``steps`` steps on 512 digits, accuracy on 256 held-out
    ones; prints its CSV lines (wall µs of train + eval, accuracy) and the
    trend line (fp32 ~= [4:4] >= [2:4])."""
    xte, yte = dataset("lenet", 256, seed=2)
    out, accs = [], {}
    for key, scheme in SCHEMES.items():
        name = BENCH_NAMES[key]
        t0 = time.perf_counter()
        run = train("lenet", scheme, steps, batch=64, seed=0,
                    device=device, n_train=512)
        accs[name] = evaluate(run, xte, yte)
        us = (time.perf_counter() - t0) * 1e6
        out.append(f"bench_accuracy.lenet_digits.{name},{us:.0f},"
                   f"acc={accs[name]:.3f}")
    trend_ok = accs["4:4"] >= accs["2:4"] - 0.02
    out.append(f"bench_accuracy.trend,0.0,"
               f"w4_ge_w2={trend_ok};paper_trend=accuracy drops with bits")
    if csv:
        print("\n".join(out))
    return accs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="lenet", choices=TRAINABLE)
    ap.add_argument("--scheme", default="all",
                    choices=("all",) + tuple(SCHEMES))
    ap.add_argument("--steps", type=int, default=None,
                    help="AdamW steps (default 200; 40 with --accuracy)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--accuracy", action="store_true",
                    help="print the accuracy trend's CSV lines and exit")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.accuracy:
        accuracy_trend(args.steps or 40, args.device)
        return
    steps = args.steps or 200
    xte, yte = dataset(args.model, 512, seed=9)
    keys = tuple(SCHEMES) if args.scheme == "all" else (args.scheme,)
    print(f"{args.model}, {steps} steps at batch 64 on "
          f"{args.device}")
    print(f"{'scheme':<8} {'acc':>6} {'served':>7} {'power W':>8} "
          f"{'kFPS/W':>8} {'us/frame':>9} {'step ms':>8}")
    for key in keys:
        run = train(args.model, SCHEMES[key], steps, device=args.device)
        acc = evaluate(run, xte, yte)
        ms = float(np.median(run.step_ms)) if run.step_ms else float("nan")
        if run.scheme is None:
            print(f"{SCHEME_LABELS[key]:<8} {acc:>6.3f} {'-':>7} {'-':>8} "
                  f"{'-':>8} {'-':>9} {ms:>8.2f}")
            continue
        d = deploy(run, xte, yte)
        print(f"{SCHEME_LABELS[key]:<8} {acc:>6.3f} {d['acc']:>7.3f} "
              f"{d['avg_power_w']:>8.2f} {d['kfps_per_w']:>8.0f} "
              f"{d['exec_time_us']:>9.2f} {ms:>8.2f}")
    print(f"loss {run.losses[0]:.4f} -> {run.losses[-1]:.4f} (last scheme); "
          f"step ms by {run.clock}")


if __name__ == "__main__":
    main()
