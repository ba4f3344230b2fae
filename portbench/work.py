"""The work a configuration asks for, from its layer shapes alone, and the
card's peaks: the yardstick of the roofline shares and of ``step_mfu``.

Operations are 2 x MACs of the int8 products. Bytes count each input
byte once and each output byte once, per launch: a conv's codes (one
byte a value), its levels (one byte a weight, read once a batch) and its
float32 accumulate or folded output; a matrix product's codes [M, K],
levels [K, N] and float32 out [M, N]. A family's least time for a batch
is the sum over its layers of ``max(ops / peak_ops, bytes / peak_bw)``:
each layer is a launch of its own.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"


@dataclasses.dataclass(frozen=True)
class Layer:
    """One conv or dense layer's product at a batch of one frame:
    ``m`` output pixels (rows), ``k`` reduction, ``n`` outputs, and the
    bytes of its input codes and of its output."""

    name: str
    kind: str               # "conv" | "dense"
    m: int
    k: int
    n: int
    in_bytes: int           # one frame's input codes
    out_bytes: int          # one frame's float32 output

    @property
    def ops(self) -> int:
        return 2 * self.m * self.k * self.n

    @property
    def weight_bytes(self) -> int:
        return self.k * self.n


def same_out(n: int, kernel: int, stride: int, padding: str) -> int:
    if padding == "VALID":
        return (n - kernel) // stride + 1
    return -(-n // stride)


def layers(cfg: Dict) -> List[Layer]:
    """Every conv and dense layer of the configuration, with its shapes."""
    h, w, c = cfg["input_hwc"]
    out = []
    for layer in cfg["layers"]:
        kind = layer["kind"]
        if kind == "ca":
            h, w = h // layer["pool"], w // layer["pool"]
            c = 1 if layer["rgb_to_gray"] else c
        elif kind == "conv":
            k, s = layer["kernel"], layer["stride"]
            ho = same_out(h, k, s, layer["padding"])
            wo = same_out(w, k, s, layer["padding"])
            co = layer["c_out"]
            out.append(Layer(layer["name"], "conv", ho * wo, k * k * c, co,
                             h * w * c, ho * wo * co * 4))
            h, w, c = ho, wo, co
            if layer.get("pool"):
                size = layer["pool"][1]
                h, w = h // size, w // size
        elif kind == "flatten":
            h, w, c = 1, 1, h * w * c
        elif kind == "dense":
            out.append(Layer(layer["name"], "dense", 1, layer["fan_in"],
                             layer["fan_out"], layer["fan_in"],
                             layer["fan_out"] * 4))
            h, w, c = 1, 1, layer["fan_out"]
    return out


def model_ops(cfg: Dict) -> int:
    """Int8 operations a frame (2 x MACs of every conv and dense layer)."""
    return sum(l.ops for l in layers(cfg))


def least_seconds(layer: Layer, batch: int, peaks: Dict,
                  im2col: bool = False) -> float:
    """The least time of one launch of ``layer`` at ``batch`` frames.
    ``im2col``: the launch reads the patch matrix [m, k], not the codes."""
    ops = layer.ops * batch
    inputs = (layer.m * layer.k if im2col else layer.in_bytes) * batch
    nbytes = inputs + layer.weight_bytes + layer.out_bytes * batch
    return max(ops / peaks["int8_ops_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def peaks_for(kind: str, path: Path = PEAKS) -> Optional[Dict]:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``), or None for a card not in the
    table."""
    table = json.loads(Path(path).read_text())
    for entry in table["cards"]:
        if all(part in kind for part in entry["name_has"]):
            return entry
    return None
