"""``BENCHMARK.json`` against the benchmark format's rules, and a cell, a
configuration and a metric added as files found by name."""

import json
import re
import shutil

from portbench import harness, manifest
from portbench.tests.conftest import small_config, small_workload

ROOT = manifest.ROOT
BENCH = manifest.load()
NAME = manifest.NAME
UNIT = manifest.UNIT
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def one_line(text, most=200):
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def test_top_level_and_paths():
    assert set(BENCH) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_configs_are_files_under_paths_and_each_has_a_cell():
    names = [c["name"] for c in BENCH["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"] not in files
        files.add(c["file"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert manifest.config(c["name"]) == data


def test_cells():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        data = manifest.workload(w["name"])
        assert (data["name"], data["config"], data["traffic"]) == \
            (w["name"], w["config"], w["traffic"])


def test_metrics():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    by_name = {m["name"]: m for m in e2e}
    assert "setup_s" in by_name and by_name["setup_s"]["bound"] <= 0.25
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in by_name
        moved = by_name[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert callable(manifest.reader(m["name"]))
    for cell in cells:
        reported = [m["name"] for m in manifest.metrics_of(
            BENCH, "end_to_end", cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.metrics_of(BENCH, "per_layer", cell)


def test_layers_named_alike_are_spelled_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"serving", "plan executor and dispatch", "kernels",
                      "model step", "device"}


def test_a_cell_a_configuration_and_a_metric_added_as_files_are_found(
        tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench" / "configs",
                    tmp_path / "portbench" / "configs")
    shutil.copytree(ROOT / "portbench" / "workloads",
                    tmp_path / "portbench" / "workloads")
    shutil.copytree(ROOT / "portbench" / "metrics",
                    tmp_path / "portbench" / "metrics")
    cfg = small_config(manifest.config("vgg9-ca-w4a4"))
    cfg["name"] = "vgg9-ca-w4a4-small"
    (tmp_path / "portbench" / "configs" / "vgg9-ca-w4a4-small.json") \
        .write_text(json.dumps(cfg))
    wl = small_workload(manifest.workload("vgg9-ca-w4a4.tiles256-closed"))
    wl.update(name="vgg9-ca-w4a4-small.tiles4-closed",
              config="vgg9-ca-w4a4-small", traffic="tiles4-closed")
    (tmp_path / "portbench" / "workloads" / f"{wl['name']}.json") \
        .write_text(json.dumps(wl))
    (tmp_path / "portbench" / "metrics" / "requests_answered.closed.py") \
        .write_text("def read(run):\n"
                    "    return float(run.outcome.ok.sum())\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": "portbench/configs/"
                                     "vgg9-ca-w4a4-small.json",
                             "reduced": [], "why": "a test's"})
    bench["workloads"].append({"name": wl["name"], "config": cfg["name"],
                               "traffic": wl["traffic"], "chips": 1,
                               "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("frames_per_s", "batch_fill.closed"):
            m["workloads"].append(wl["name"])
    bench["per_layer"].append({"name": "requests_answered.closed",
                               "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "serving",
                               "moves": "frames_per_s",
                               "workloads": [wl["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run(wl["name"], 7, 1.0, True, root=tmp_path,
                      device="cpu")
    assert out["correct"] is True
    assert out["metrics"]["requests_answered.closed"]["value"] > 0
    assert "batch_fill.closed" in out["metrics"]
    out = harness.run(wl["name"], 8, 1.0, False, root=tmp_path,
                      device="cpu")
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
