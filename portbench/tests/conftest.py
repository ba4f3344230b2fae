"""Shared helpers of the harness's tests: the configurations and cells
cut to a size a CPU test holds (every width kept but the input's)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_config(cfg: dict, hw: int = 32) -> dict:
    """``cfg`` at ``hw`` x ``hw`` input (fc1's fan-in follows), buckets
    2/4/8, tiles from 64 x 64 frames."""
    cfg = copy.deepcopy(cfg)
    cfg["input_hwc"][:2] = [hw, hw]
    h, c = hw, cfg["input_hwc"][2]
    for layer in cfg["layers"]:
        if layer["kind"] == "ca":
            h, c = h // layer["pool"], 1
        elif layer["kind"] == "conv":
            c = layer["c_out"]
            h //= layer["pool"][1] if layer["pool"] else 1
        elif layer["kind"] == "dense":
            layer["fan_in"] = h * h * c
            break
    if cfg["frames"]["kind"] == "tiles":
        cfg["frames"]["frame_hw"] = [2 * hw, 2 * hw]
    cfg["serve"].update(max_batch=8, batch_buckets=[2, 4, 8])
    cfg["check"]["block"] = 8
    return cfg


def small_workload(wl: dict) -> dict:
    wl = copy.deepcopy(wl)
    wl.update(pool=8, lead_s=0.3, check_requests=3)
    if wl["loop"] == "closed":
        wl["clients"] = 2
    else:
        wl["rate_rps"] = 20.0
        wl["sizes"] = [1, 2]
    return wl


@pytest.fixture
def small():
    return small_config, small_workload
