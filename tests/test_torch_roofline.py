"""repro_torch's roofline (``launch/roofline.py``) against the reference's
``repro.launch.roofline``, on the CPU.

* ``analytic_flops``, ``analytic_hbm_bytes``, ``_param_bytes`` and
  ``_cache_bytes`` give the reference's floats exactly, for every arch x
  shape;
* ``roofline_terms`` over a synthetic dry-run record is the reference's
  formula with the card's constants: each term is the reference's on the
  same bytes, times (the reference's constant / the port's), and the
  memory fields come from the record's ``memory``;
* ``build_table``'s rows and ``main``'s records are the reference's
  (arch, shape, status) rows, with 16x16 / 2x16x16 read as 32x8 / 2x32x8;
* a cell with no record, or a failed one, keeps the arithmetic and is
  marked.
"""

from __future__ import annotations

import json

import pytest

from repro.configs import list_configs
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro.launch.specs import SHAPES
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline as roof

MESH_OF = {"16x16": "32x8", "2x16x16": "2x32x8"}   # the same chip counts


@pytest.mark.parametrize("arch", list_configs())
def test_analytic_terms_equal_the_reference(arch):
    jcfg = jroof.get_config(arch)
    cfg = get_config(arch)
    assert roof._param_bytes(cfg) == jroof._param_bytes(jcfg)
    for shape, cell in SHAPES.items():
        assert roof.analytic_flops(arch, shape) == \
            jroof.analytic_flops(arch, shape)
        assert roof.analytic_hbm_bytes(arch, shape) == \
            jroof.analytic_hbm_bytes(arch, shape)
        assert roof._cache_bytes(cfg, cell.global_batch, cell.seq) == \
            jroof._cache_bytes(jcfg, cell.global_batch, cell.seq)


def _records(tmp_path, arch, shape):
    """One synthetic dry-run record in each package's form, on the same
    bytes; -> (port dir, reference dir)."""
    coll = {"all-gather": 3_000_000_000, "all-reduce": 1_250_000_000,
            "reduce-scatter": 700_000_000, "all-to-all": 0,
            "collective-permute": 5_000_000}
    coll["total"] = sum(coll.values())
    memory = {"argument_size_bytes": 9 * 2**30,
              "output_size_bytes": 2**30, "temp_size_bytes": 5 * 2**29,
              "peak_bytes": 9 * 2**30 + 5 * 2**29}
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    tdir.mkdir()
    jdir.mkdir()
    (tdir / f"{arch}__{shape}__32x8.json").write_text(json.dumps(
        {"status": "ok", "collectives": {"bytes": coll}, "memory": memory,
         "flops": 123456789}))
    (jdir / f"{arch}__{shape}__16x16.json").write_text(json.dumps(
        {"status": "ok", "collectives_weighted": {"bytes": coll},
         "memory": memory}))
    return tdir, jdir


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "train_4k"),
                                        ("kimi-k2-1t-a32b", "decode_32k"),
                                        ("mamba2-1.3b", "long_500k")])
def test_roofline_terms_are_the_reference_s_over_the_card_s_constants(
        tmp_path, arch, shape):
    tdir, jdir = _records(tmp_path, arch, shape)
    got = roof.roofline_terms(arch, shape, "32x8", tdir)
    want = jroof.roofline_terms(arch, shape, "16x16", jdir)
    scale = {"t_compute_s": jmesh.PEAK_FLOPS_BF16 / mesh_mod.PEAK_FLOPS_BF16,
             "t_memory_s": jmesh.HBM_BW / mesh_mod.HBM_BW,
             "t_collective_s": jmesh.ICI_BW / mesh_mod.NVLINK_BW}
    for key, s in scale.items():
        assert got[key] == pytest.approx(want[key] * s, rel=1e-12), key
    for key in ("status", "chips", "flops_global", "hbm_bytes_global",
                "collective_bytes_per_dev", "model_flops_6nd",
                "memory_per_dev_gib", "args_per_dev_gib"):
        assert got[key] == want[key], key
    terms = {k: got[f"t_{k}_s"] for k in ("compute", "memory", "collective")}
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["roofline_fraction"] == terms["compute"] / max(terms.values())
    assert got["dryrun"] == "ok" and got["counted_flops_global"] == 123456789
    assert "hlo_flops_per_dev_unscaled" not in got


def test_table_and_records_have_the_reference_s_rows(tmp_path):
    def rows(table, mesh_of=lambda m: m):
        out = []
        for line in table.splitlines()[2:]:
            cells = [c.strip() for c in line.strip("|").split("|")]
            skipped = cells[2] == "-"
            out.append((cells[0], cells[1], mesh_of(cells[2]),
                        cells[8] if skipped else "ok"))
        return out

    got = roof.build_table(tmp_path)
    want = jroof.build_table(tmp_path)
    assert rows(got) == rows(want, lambda m: MESH_OF.get(m, m))
    roof.main(["--dryrun-dir", str(tmp_path), "--out",
               str(tmp_path / "r.md"), "--json-out", str(tmp_path / "r.json")])
    assert (tmp_path / "r.md").read_text() == got + "\n"
    recs = json.loads((tmp_path / "r.json").read_text())
    assert [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in recs] \
        == [(a, s, m, jroof.roofline_terms(a, s, j, tmp_path)["status"])
            for a in list_configs() for s in SHAPES
            for j, m in MESH_OF.items()]


def test_a_missing_or_failed_record_is_marked(tmp_path):
    (tmp_path / "yi-34b__train_4k__32x8.json").write_text(json.dumps(
        {"status": "error: RuntimeError: boom", "collectives": {
            "bytes": {"total": 10, "all-reduce": 5}}}))
    failed = roof.roofline_terms("yi-34b", "train_4k", "32x8", tmp_path)
    absent = roof.roofline_terms("yi-34b", "prefill_32k", "2x32x8", tmp_path)
    assert failed["dryrun"] == "error: RuntimeError: boom"
    assert absent["dryrun"] == "absent" and absent["chips"] == 512
    for r in (failed, absent):
        assert r["status"] == "ok" and r["t_collective_s"] == 0.0
        assert r["t_compute_s"] > 0 and r["counted_flops_global"] is None
    table = roof.build_table(tmp_path).splitlines()
    assert any(line.startswith("| yi-34b | train_4k | 32x8 |")
               and "no dry-run record (error: RuntimeError: boom)" in line
               for line in table)
    assert sum("no dry-run record (absent)" in line for line in table) > 0
