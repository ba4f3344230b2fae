"""repro_torch.analysis — the plan verifier and the concurrency lint — on
the CPU, against the JAX reference's ``repro.analysis``.

* ``verify_plan`` gives exactly the reference's diagnostics (code,
  severity, step, message, hint; info included) for LeNet, VGG9 and VGG16
  at their input sizes, the eight pipelines at 32 and 256, and the
  acceptance chain at 32;
* the reference's ``tests/test_analysis.py`` cases, on the port: the 2^24
  line (an adversarial plan raises at compile and is never cached; its
  just-inside twin runs bitwise with and without verification), LeNet's
  headroom report, LTR013/LTR014, ``Options(verify=)`` and its cache
  semantics (no environment variable), a warning recorded without a
  raise, the fusion audit fuzz and its planted inconsistencies;
* the Hopper audits: a fused segment over one CTA's shared memory
  (``LTR024``), a strip launch whose tiles do not cover the output
  (``LTR020``) or whose shared memory a CTA cannot hold (``LTR022``);
* a proven plan runs its fused chains without the range check;
* ``plan.verify.run`` / ``plan.verify.error`` move as the reference's;
* the lint's cases, and the port's ``serve`` and ``obs`` trees clean under
  it (the CLI too), and ``scripts/verify_plan_torch.py --all`` exits 0.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro
from repro import analysis as janalysis
from repro import obs as jobs
from repro.core import accelerator as jacc
from repro.core import plan as jplan
from repro.core import quant as jquant
from repro.models import vision as jvision
from repro_torch import Options, Program, analysis, obs
from repro_torch.core import plan as plan_mod
from repro_torch.core.accelerator import ConvSpec, DenseSpec, FlattenSpec
from repro_torch.core.quant import W4A4, WASpec
from repro_torch.imaging import PIPELINES
from repro_torch.kernels import dispatch
from repro_torch.kernels.conv_bank import strip
from repro_torch.models import vision as tvision
from repro_torch.weights import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CPU = Options(scheme=W4A4, device="cpu")
REFERENCE = repro.Options(scheme=jquant.W4A4, backend="reference")

# a_qmax is global (plan.consts feeds one divisor): 2^4 - 1
A_QMAX = 15
W8_QMAX = WASpec(8, 4).w_qmax                       # 127
# smallest fan_in with 15 * 127 * fan_in >= 2^24 is 8808
FAN_IN_OVER = 8810                                  # 16_783_050 >= 2^24
FAN_IN_UNDER = 8806                                 # 16_775_430 <  2^24
CHAIN = (("denoise_gauss", 3), ("edge_detect", 3), ("sharpen", 1))


def _dense_program(fan_in: int, params=None) -> Program:
    layers = (FlattenSpec(), DenseSpec("fc", fan_in, 4, act="none"))
    return Program(layers, params or {}, (1, 1, fan_in),
                   name=f"dense{fan_in}")


def _jdense_program(fan_in: int, params=None) -> repro.Program:
    """The reference's twin of :func:`_dense_program`."""
    layers = (jacc.FlattenSpec(), jacc.DenseSpec("fc", fan_in, 4, act="none"))
    return repro.Program(layers, params or {}, (1, 1, fan_in),
                         name=f"dense{fan_in}")


@pytest.fixture(autouse=True)
def _fresh_plan_cache():
    plan_mod.clear_plan_cache()
    yield
    plan_mod.clear_plan_cache()


# -- the port's diagnostics equal the reference's ----------------------------

def _chain(make, hw):
    first, second, third = (make(n, hw, hw, c) for n, c in CHAIN)
    return first.then(second).then(third)


TARGETS = ([("model", name, None) for name in sorted(jvision.MODEL_INPUT_HWC)]
           + [("pipeline", name, size) for size in (32, 256)
              for name in sorted(PIPELINES)]
           + [("chain", "acceptance", 32)])


def _programs(kind, name, size):
    if kind == "model":
        return (tvision.vision_program(name, params={}),
                jvision.vision_program(name, params={}))
    if kind == "pipeline":
        return (Program.from_pipeline(name, size, size, 3),
                repro.Program.from_pipeline(name, size, size, 3))
    return (_chain(Program.from_pipeline, size),
            _chain(repro.Program.from_pipeline, size))


@pytest.mark.parametrize("kind,name,size", TARGETS,
                         ids=[f"{n}@{s}" if s else n for _, n, s in TARGETS])
def test_diagnostics_equal_reference(kind, name, size):
    prog, jprog = _programs(kind, name, size)
    exe = prog.compile(dataclasses.replace(CPU, verify="off"))
    jexe = jprog.compile(dataclasses.replace(REFERENCE, verify="off"))
    mine = [d.asdict() for d in analysis.verify_plan(exe.plan)]
    theirs = [d.asdict() for d in janalysis.verify_plan(jexe.plan)]
    assert mine == theirs
    # compiled under the default "auto" the report carries the same
    # (warning and error) findings, [] for every registered program
    plan_mod.clear_plan_cache()
    jplan.clear_plan_cache()
    assert prog.compile(CPU).report.verification == \
        jprog.compile(REFERENCE).report.verification == []


# -- the accumulator proof draws the line at 2^24 ----------------------------

def test_bound_arithmetic_brackets_the_window():
    assert analysis.acc_bound(A_QMAX, W8_QMAX, FAN_IN_OVER) >= 1 << 24
    assert analysis.acc_bound(A_QMAX, W8_QMAX, FAN_IN_UNDER) < 1 << 24
    assert analysis.headroom_bits(1 << 23) == pytest.approx(1.0)
    assert analysis.ACC_EXACT_LIMIT == janalysis.ACC_EXACT_LIMIT
    assert analysis.VERIFY_MODES == janalysis.VERIFY_MODES


def test_adversarial_overflow_rejected_at_compile():
    prog = _dense_program(FAN_IN_OVER)
    opts = dataclasses.replace(CPU, scheme=WASpec(8, 4))
    with pytest.raises(analysis.PlanVerificationError) as ei:
        prog.compile(opts)                          # default verify=auto
    err = ei.value
    assert [d.code for d in err.diagnostics if d.severity == "error"] \
        == ["LTR001"]
    d = next(d for d in err.diagnostics if d.code == "LTR001")
    assert d.step == "fc"
    assert f"{A_QMAX} * {W8_QMAX} * {FAN_IN_OVER}" in d.message
    assert "verify=\"off\"" in str(err)               # the bypass is named
    # the failing plan was not cached: a second compile walks it again
    stats = plan_mod.plan_cache_stats()
    with pytest.raises(analysis.PlanVerificationError):
        prog.compile(dataclasses.replace(opts, verify="on"))
    assert plan_mod.plan_cache_stats()["misses"] == stats["misses"] + 1
    assert plan_mod.plan_cache_stats()["hits"] == stats["hits"]
    # and the reference raises the same diagnostics
    with pytest.raises(janalysis.PlanVerificationError) as jei:
        _jdense_program(FAN_IN_OVER).compile(
            repro.Options(scheme=jquant.WASpec(8, 4)))
    assert [x.asdict() for x in err.diagnostics] == \
        [x.asdict() for x in jei.value.diagnostics]


def test_just_inside_twin_runs_bitwise_with_and_without_verify():
    """One fan-in notch inside the window: compiles (the low-headroom
    warning recorded, not raised) and runs bitwise equal to a compile with
    verification off, and to the reference: the verifier observes, never
    perturbs."""
    rng = np.random.default_rng(0)
    layers = (FlattenSpec(), DenseSpec("fc", FAN_IN_UNDER, 4, act="none"))
    p = {"fc": {"w": (rng.standard_normal((FAN_IN_UNDER, 4))
                      / np.sqrt(FAN_IN_UNDER)).astype(np.float32),
                "b": (rng.standard_normal(4) * 0.05).astype(np.float32)}}
    prog = Program(layers, params_from_numpy(p, "cpu"), (1, 1, FAN_IN_UNDER),
                   name="twin")
    frames = rng.random((2, 1, 1, FAN_IN_UNDER)).astype(np.float32)
    opts = dataclasses.replace(CPU, scheme=WASpec(8, 4))
    exe_off = prog.compile(dataclasses.replace(opts, verify="off"))
    out_off = exe_off.run(frames).numpy()
    assert exe_off.report.verification == [] and \
        not exe_off.plan.exact_proven
    exe_on = prog.compile(dataclasses.replace(opts, verify="on"))  # a hit
    assert exe_on.plan is exe_off.plan and exe_on.plan.exact_proven
    np.testing.assert_array_equal(exe_on.run(frames).numpy(), out_off)
    warns = [d for d in exe_on.report.verification if d["code"] == "LTR002"]
    assert warns and warns[0]["step"] == "fc"
    assert "headroom" in warns[0]["message"]
    assert not [d for d in exe_on.report.verification
                if d["severity"] == "error"]
    jexe = _jdense_program(FAN_IN_UNDER, p).compile(repro.Options(scheme=jquant.WASpec(8, 4),
                                       backend="reference", verify="on"))
    np.testing.assert_array_equal(np.asarray(jexe.run(frames)), out_off)
    assert jexe.report.verification == exe_on.report.verification


def test_headroom_report_on_lenet():
    exe = Program.from_model("lenet", params={}).compile(CPU)
    diags = analysis.verify_plan(exe.plan)
    assert not analysis.errors(diags)
    per_step = {d.step: d for d in diags if d.code == "LTR003"}
    assert set(per_step) == {"conv1", "conv2", "fc1", "fc2", "fc3"}
    hrs = [float(d.message.split("headroom ")[1].split(" bits")[0])
           for d in per_step.values()]
    assert min(hrs) > 8.0                       # lenet is comfortably exact
    # info stays out of the report
    assert exe.report.verification == []


# -- shape legality: caught at compile, not at run time ----------------------

def test_channel_mismatch_rejected_at_compile():
    layers = (ConvSpec("c1", c_in=3, c_out=8),
              ConvSpec("c2", c_in=4, c_out=8))       # c2 receives 8, not 4
    prog = Program(layers, {}, (16, 16, 3), name="badchan")
    with pytest.raises(analysis.PlanVerificationError) as ei:
        prog.compile(CPU)
    d = next(d for d in ei.value.diagnostics if d.code == "LTR013")
    assert d.step == "c2" and "c_in=4" in d.message


def test_fan_in_mismatch_rejected_at_compile():
    layers = (ConvSpec("c1", c_in=1, c_out=4, padding="SAME"),
              FlattenSpec(),
              DenseSpec("fc", fan_in=99, fan_out=10))  # gets 8*8*4 = 256
    prog = Program(layers, {}, (8, 8, 1), name="badfan")
    with pytest.raises(analysis.PlanVerificationError) as ei:
        prog.compile(CPU)
    d = next(d for d in ei.value.diagnostics if d.code == "LTR014")
    assert d.step == "fc" and "fan_in=256" in d.hint


# -- Options(verify=) --------------------------------------------------------

def test_verify_option_validated_and_resolved():
    with pytest.raises(ValueError, match="verify"):
        Options(device="cpu", verify="sometimes")
    with pytest.raises(ValueError, match="verify"):
        plan_mod._compile_model((FlattenSpec(),), (1, 1, 4), W4A4,
                                verify="bogus")
    # no environment variable: the ambient mode is "auto"
    assert analysis.verify_mode() == "auto"
    assert CPU.resolve().verify == "auto"
    assert Options(device="cpu", verify="off").resolve().verify == "off"
    assert "verify=off" in Options(device="cpu", verify="off").describe()
    assert "verify" not in CPU.describe()


def test_verify_off_skips_and_on_rechecks_cache_hits():
    prog = _dense_program(FAN_IN_OVER)
    opts = dataclasses.replace(CPU, scheme=WASpec(8, 4))
    # "off" lets the over-the-line plan compile (the documented bypass)
    exe = prog.compile(dataclasses.replace(opts, verify="off"))
    assert exe.report.verification == []           # never inspected
    assert not exe.plan.exact_proven
    # "on" re-checks the now-cached plan and raises from the same plan
    with pytest.raises(analysis.PlanVerificationError):
        prog.compile(dataclasses.replace(opts, verify="on"))
    # and raises again on the next hit (stored findings re-raise)
    with pytest.raises(analysis.PlanVerificationError):
        prog.compile(dataclasses.replace(opts, verify="on"))
    # but "auto" on the cache hit stays quiet: first compile only
    exe2 = prog.compile(opts)
    assert exe2.plan is exe.plan
    assert not exe2.plan.exact_proven             # LTR001 is stored


def test_warning_surfaces_in_report_without_raising():
    """A forced-resident conv over a tiny budget is a warning (LTR021):
    recorded in ModelReport.verification, the compile succeeds."""
    prog = Program.from_model("lenet", params={})
    exe = prog.compile(dataclasses.replace(
        CPU, conv_strategy="resident", conv_vmem_budget=1024, verify="on"))
    codes = {d["code"] for d in exe.report.verification}
    assert "LTR021" in codes
    assert all(d["severity"] == "warning" for d in exe.report.verification)
    jexe = jvision.vision_program("lenet", params={}).compile(
        dataclasses.replace(REFERENCE, conv_strategy="resident",
                            conv_vmem_budget=1024, verify="on"))
    assert exe.report.verification == jexe.report.verification


def test_verify_counters_move_as_the_reference():
    def deltas(mod, compile_):
        names = ("plan.verify.run", "plan.verify.error")
        before = [mod.counter(n).get() for n in names]
        try:
            compile_()
        except (analysis.PlanVerificationError,
                janalysis.PlanVerificationError):
            pass
        return [mod.counter(n).get() - b for n, b in zip(names, before)]

    jplan.clear_plan_cache()
    for make, jmake, opts, jopts in (
            (lambda: Program.from_model("lenet", params={}),
             lambda: jvision.vision_program("lenet", params={}), CPU,
             REFERENCE),
            (lambda: _dense_program(FAN_IN_OVER),
             lambda: _jdense_program(FAN_IN_OVER),
             dataclasses.replace(CPU, scheme=WASpec(8, 4)),
             dataclasses.replace(REFERENCE, scheme=jquant.WASpec(8, 4)))):
        mine = deltas(obs, lambda: make().compile(opts))
        theirs = deltas(jobs, lambda: jmake().compile(jopts))
        assert mine == theirs
    assert theirs == [1, 1]                      # the adversarial one failed
    # a cache hit under "auto" verifies nothing more; under "on" a proven
    # plan is not walked again
    assert deltas(obs, lambda: Program.from_model(
        "lenet", params={}).compile(CPU)) == [0, 0]
    assert deltas(obs, lambda: Program.from_model(
        "lenet", params={}).compile(dataclasses.replace(
            CPU, verify="on"))) == [0, 0]


# -- a proven plan's chains skip the range check ------------------------------

def test_proven_plan_runs_chains_without_the_range_check(monkeypatch):
    seen = []
    real = dispatch.conv_chain

    def spy(*args, exact_checked=False, **kw):
        seen.append(exact_checked)
        return real(*args, exact_checked=exact_checked, **kw)

    monkeypatch.setattr(dispatch, "conv_chain", spy)
    prog = Program.from_model("lenet",
                              params=tvision.vision_program("lenet").params)
    frames = np.random.default_rng(3).random((2, 28, 28, 1)) \
        .astype(np.float32)
    exe = prog.compile(CPU)
    assert exe.plan.exact_proven and exe.plan.fused_segments
    proven = exe.run_per_frame(frames)
    assert seen == [True]
    plan_mod.clear_plan_cache()
    unproven = prog.compile(dataclasses.replace(CPU, verify="off"))
    assert not unproven.plan.exact_proven
    seen.clear()
    assert (unproven.run_per_frame(frames) == proven).all()
    assert seen == [False]
    # a bound view's weights make every launch checked either way
    seen.clear()
    unproven.bind("cpu").run_padded(frames, 2).wait()
    assert seen == [True]


# -- the N-version property: fusion output always passes the audit -----------

def _random_chain(rng):
    """A shape-consistent conv chain with Nones (non-conv steps) mixed in,
    over the selector's whole legality vocabulary (depthwise, grouped,
    tanh, strides, pools)."""
    geoms = []
    h, w = int(rng.integers(8, 33)), int(rng.integers(8, 33))
    c = int(rng.choice([1, 3, 4, 8]))
    for i in range(int(rng.integers(1, 7))):
        if rng.random() < 0.15:
            geoms.append(None)                     # CA/flatten/dense break
            continue
        k = int(rng.choice([1, 3, 5]))
        if k > min(h, w):
            k = 1
        stride = int(rng.choice([1, 1, 1, 2]))
        depthwise = rng.random() < 0.2
        grouped = (not depthwise) and rng.random() < 0.1
        if depthwise:
            groups, c_out = c, c
        elif grouped and c % 2 == 0 and c > 1:
            groups, c_out = 2, int(rng.choice([4, 8]))
        else:
            groups, c_out = 1, int(rng.choice([1, 3, 4, 8, 16]))
        act = str(rng.choice(["relu", "abs", "sign", "none", "tanh"]))
        pads = (((k // 2,) * 2, (k // 2,) * 2) if rng.random() < 0.5
                else ((0, 0), (0, 0)))
        g = dispatch.ChainGeom(f"c{i}", h, w, c, c_out, k, stride, pads,
                               groups=groups, act=act, pool=None)
        h_out, w_out = g.out_hw()
        if (rng.random() < 0.3 and h_out >= 2 and w_out >= 2
                and h_out % 2 == 0 and w_out % 2 == 0):
            g = dataclasses.replace(
                g, pool=(str(rng.choice(["max", "avg"])), 2))
        h, w = g.out_hw()
        c = c_out
        geoms.append(g)
        if h < 2 or w < 2:
            break
    return geoms


@pytest.mark.parametrize("seed", range(8))
def test_fused_segments_always_pass_audit(seed):
    """Whatever segments select_fused_segments emits, the verifier's
    independent halo / working-set / shared-memory / legality
    re-derivation agrees, across modes and budgets, on random chains."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        geoms = _random_chain(rng)
        for mode in ("auto", "on", "off"):
            for budget in (64 * 1024, 4 << 20,
                           dispatch.DEFAULT_CONV_VMEM_BUDGET):
                segs = dispatch.select_fused_segments(geoms, mode=mode,
                                                      budget=budget)
                diags = analysis.audit_fused_segments(geoms, segs, budget)
                errs = analysis.errors(diags)
                assert not errs, (mode, budget, geoms, segs,
                                  [str(d) for d in errs])


def test_audit_catches_planted_inconsistencies():
    """The audit is not vacuous: corrupt a legal segment set each way the
    fused kernel could go wrong and the matching code fires."""
    g = dispatch.ChainGeom("c0", 16, 16, 3, 8, 3, 1, ((1, 1), (1, 1)))
    g2 = dispatch.ChainGeom("c1", 16, 16, 8, 8, 3, 1, ((1, 1), (1, 1)))
    geoms = [g, g2]
    budget = dispatch.DEFAULT_CONV_VMEM_BUDGET
    good = dispatch.select_fused_segments(geoms, mode="on", budget=budget)
    assert good and not analysis.errors(
        analysis.audit_fused_segments(geoms, good, budget))
    seg = good[0]

    def codes(segments, geoms=geoms):
        return {d.code for d in analysis.audit_fused_segments(
            geoms, segments, budget) if d.severity == "error"}

    assert "LTR024" in codes(
        [dataclasses.replace(seg, halo_rows=seg.halo_rows + 1)])
    assert "LTR024" in codes(
        [dataclasses.replace(seg, vmem_bytes=seg.vmem_bytes - 4)])
    assert "LTR023" in codes([dataclasses.replace(seg, start=1)])
    assert "LTR023" in codes([seg, seg])            # overlapping claims
    assert "LTR023" in codes(
        good, [dataclasses.replace(g, act="tanh"), g2])  # no fused tanh


def test_audit_catches_a_segment_over_one_ctas_shared_memory():
    """A planted segment whose frames do not fit one CTA (the selector
    would never emit it): halo and working set recorded right, so only the
    Hopper shared-memory audit fires; the reference has no such rule."""
    pads = ((1, 1), (1, 1))
    geoms = [dispatch.ChainGeom(f"c{i}", 64, 64, 8, 8, 3, 1, pads)
             for i in range(3)]
    with pytest.raises(ValueError, match="shared memory"):
        dispatch.select_fused_segments(geoms, mode="on")
    seg = dispatch.FusedSegmentSpec(
        0, tuple(g.name for g in geoms), dispatch._chain_halo_rows(geoms),
        max(g.stage_bytes() for g in geoms))
    diags = analysis.audit_fused_segments(geoms, [seg], 4 << 20)
    assert [(d.code, d.severity) for d in diags] == [("LTR024", "error")]
    assert "shared-memory audit" in diags[0].message
    # 2 x 64*64*8 floats + the scratch
    assert f"need {2 * 64 * 64 * 8 * 4 + 128} bytes" in diags[0].message
    assert janalysis.audit_fused_segments(geoms, [seg], 4 << 20) == []


def test_audit_catches_a_strip_launch_that_does_not_cover(monkeypatch):
    """Planted strip configurations: half the CTAs a launch needs
    (LTR020, dense and depthwise), and a C_in chunk whose stages a CTA
    cannot hold (LTR022). VGG16's strip convs are compiled onto the
    float64 kernel's route here (``test_torch_strip_int.py`` plants the
    int8 kernel's launches on its own route), where the float kernel's
    tensor-core form takes conv2-conv10 and its CUDA-core form conv1:
    each plant goes into both forms' configurations. The plan is kept out
    of the cache."""
    monkeypatch.setattr(strip, "dense_route", lambda *a: "float")
    plan_mod.clear_plan_cache()
    try:
        vgg16 = Program.from_model("vgg16", params={}).compile(
            dataclasses.replace(CPU, verify="off")).plan
    finally:
        plan_mod.clear_plan_cache()
    gauss = Program.from_pipeline("denoise_gauss", 64, 64).compile(
        dataclasses.replace(CPU, verify="off")).plan
    assert not analysis.errors(analysis.verify_plan(vgg16))
    real_dense, real_dw = strip.strip_config, strip.dw_config
    real_f64 = strip.f64mma_config
    assert {strip.dense_form(8, 224 >> (i // 3), 224 >> (i // 3), 64, 64, 3,
                             1) for i in range(3)} == {"f64mma"}

    def step_codes(plan):
        return {(d.code, d.severity, d.step)
                for d in analysis.verify_plan(plan, include_info=False)}

    def plant_f64(change):
        monkeypatch.setattr(strip, "f64mma_config", lambda *a: (
            lambda cfg: cfg and change(cfg, *a))(real_f64(*a)))

    monkeypatch.setattr(strip, "strip_config", lambda *a: dataclasses.replace(
        real_dense(*a), ctas=real_dense(*a).ctas // 2))
    plant_f64(lambda cfg, *a: dataclasses.replace(cfg, ctas=cfg.ctas // 2))
    found = step_codes(vgg16)
    assert {("LTR020", "error", f"conv{i}") for i in range(1, 11)} <= found
    assert not {d for d in found if d[2] in ("conv11", "fc1")}
    monkeypatch.setattr(strip, "strip_config", real_dense)
    monkeypatch.setattr(strip, "f64mma_config", real_f64)
    monkeypatch.setattr(strip, "dw_config", lambda *a: dataclasses.replace(
        real_dw(*a), ctas=real_dw(*a).ctas // 2))
    assert ("LTR020", "error", "gauss") in step_codes(gauss)
    monkeypatch.setattr(strip, "dw_config", real_dw)
    monkeypatch.setattr(strip, "strip_config", lambda b, rows, w, ci, *a:
                        dataclasses.replace(real_dense(b, rows, w, ci, *a),
                                            cc=ci, stages=1))
    plant_f64(lambda cfg, b, rows, w, ci, *a: dataclasses.replace(
        cfg, cc=-(-ci // 8) * 8))
    found = step_codes(vgg16)
    assert ("LTR022", "warning", "conv10") in found
    assert not analysis.errors(analysis.verify_plan(vgg16))


def test_strip_launch_audit_is_clean_on_multi_strip_plans():
    """The 512x512 pipelines tile their strip convs in several strips (the
    registered sizes in one): their launches pass the audit too."""
    for name in ("denoise_box", "denoise_gauss", "compress_recon_deconv"):
        plan = Program.from_pipeline(name, 512, 512).compile(CPU).plan
        assert any(s.strategy.n_strips > 1 for s in plan.steps
                   if type(s).__name__ == "ConvStep"
                   and s.strategy.kind == "strip")
        assert analysis.verify_plan(plan, include_info=False) == ()


# -- the concurrency lint ----------------------------------------------------

def _codes(src):
    return [d.code for d in analysis.lint_source(textwrap.dedent(src))]


def test_lint_unlocked_augassign():
    assert _codes("""
        class C:
            def hit(self):
                self.count += 1
    """) == ["LTC101"]


def test_lint_locked_and_local_augassign_clean():
    assert _codes("""
        class C:
            def __init__(self):
                self.count = 0
                self.count += 1          # unpublished: exempt
            def ok(self):
                with self._lock:
                    self.count += 1
            def ok_cond(self):
                with self._cond:
                    self.inflight[0] -= 1
            def local(self):
                n = 0
                n += 1
                return n
    """) == []


def test_lint_nested_def_resets_lock_context():
    assert _codes("""
        class C:
            def work(self):
                with self._lock:
                    def cb():
                        self.count += 1
                    return cb
    """) == ["LTC101"]


def test_lint_unjoined_thread():
    src = """
        import threading
        class S:
            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()
    """
    assert _codes(src) == ["LTC102"]
    assert _codes(src + """
            def stop(self):
                self._t.join(timeout=5.0)
    """) == []
    assert _codes("""
        import threading
        def fire():
            threading.Thread(target=work).start()
    """) == ["LTC102"]


def test_lint_settle_outside_helper():
    assert _codes("""
        def resolve(fut, out):
            fut.set_result(out)
    """) == ["LTC103"]
    assert _codes("""
        def _settle(fut, result=None, exc=None):
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
    """) == []


def test_lint_suppression_is_per_code():
    assert _codes("""
        class C:
            def hit(self):
                self.count += 1          # lint: ok
    """) == []
    assert _codes("""
        class C:
            def hit(self):
                self.count += 1          # lint: ok[LTC102]
    """) == ["LTC101"]


def test_lint_findings_equal_reference_on_both_trees():
    from repro.analysis.lint import lint_paths as jlint
    for tree in (PORT / "serve", PORT / "obs", ROOT / "src" / "repro" / "serve"):
        assert [d.asdict() for d in analysis.lint_paths([tree])] == \
            [d.asdict() for d in jlint([tree])]


def test_lint_serve_and_obs_trees_are_clean_cli():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         str(PORT / "serve"), str(PORT / "obs")], capture_output=True,
        text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                                     "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: OK" in out.stdout
    assert analysis.errors(analysis.lint_paths(
        [PORT / "serve", PORT / "obs"])) == ()


def test_verify_plan_torch_all_exits_zero():
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "verify_plan_torch.py"),
         "--all"], capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "verify_plan_torch: vgg16: OK" in out.stdout
    assert "min headroom 2.67 bits" in out.stdout          # fc1
    targets = re.findall(r"^verify_plan_torch: \S+: OK \(", out.stdout,
                         re.M)
    assert len(targets) == 3 + 2 * len(PIPELINES)


# -- diagnostics plumbing ----------------------------------------------------

def test_diagnostic_formatting_and_severity_order():
    d = analysis.Diagnostic("LTR001", "error", "fc", "boom", hint="fix it")
    assert str(d) == "LTR001 [error] fc: boom (hint: fix it)"
    assert str(d) == str(janalysis.Diagnostic("LTR001", "error", "fc",
                                              "boom", hint="fix it"))
    assert d.asdict()["code"] == "LTR001"
    with pytest.raises(ValueError):
        analysis.Diagnostic("LTR001", "fatal", "fc", "boom")
    diags = [analysis.Diagnostic("LTR003", "info", "a", "m"),
             analysis.Diagnostic("LTR002", "warning", "b", "m")]
    assert analysis.worst_severity(diags) == "warning"
    assert analysis.errors(diags) == ()
    text = analysis.format_diagnostics(diags, min_severity="warning")
    assert "LTR002" in text and "LTR003" not in text
    assert analysis.SEVERITIES == janalysis.SEVERITIES
    assert sorted(analysis.__all__) == sorted(janalysis.__all__)
