"""How the photonic integer math runs: the one routing point for device ops.

Two backends, chosen per executable by ``Options(backend=...)``:

  kernel     — the hand-written CUDA kernels through their wrappers
               (``photonic_mvm.ops``, ``conv_bank.strip``,
               ``conv_bank.fused``, ``ca_pool.ops``, ``epilogue.ops``). A
               wrapper given a CUDA tensor launches its kernel; given a
               CPU tensor it runs the kernel's plain version. So on the
               CPU this backend runs the same Python around the kernels
               (im2col, strip padding, stage descriptors, shapes) with
               plain arithmetic inside.
  reference  — the plain PyTorch oracles (``conv_int_ref``, the exact
               float64 tap loop of ``conv_taps_int``; ``mvm_int_ref``,
               ``conv_chain_ref``, ``compressive_acquire``) on whatever
               device the tensors are on.

Both backends are bitwise equal: the accumulates are exact integers and
every float step rounds the same way.

Every requant of the plan executor goes through :func:`epilogue`: on the
kernel backend the epilogue pair (``epilogue.ops``; dequant, bias, act,
pool and the CRC requant, writing the next int8 conv's operand where the
plan hands it over), on the reference backend the same torch ops the
executor ran before it (``epilogue.ref``).

Conv strategies follow the reference package's rules and its default 4 MiB
budget, so they equal the reference's:

  resident   — im2col into the photonic MVM kernel.
  strip      — convs whose per-frame patch matrix would exceed the budget,
               and every depthwise conv: the strip conv kernels
               (``conv_strip``, ``conv_strip_depthwise``; general grouped
               convs one dense call per group). A dense launch takes the
               int8 tensor-core kernel (``conv_strip_int``, over the
               conv's own rows) or the float64 one by the route rule
               (:func:`select_strip_route`), resolved with the strategy.
  fused      — runs of chainable convs execute as one ``conv_chain`` launch
               per segment (``select_fused_segments``), under per-frame
               calibration or at batch 1.

Fusion differs from the reference in one rule: the chain kernel holds a
whole frame's stages in one block's shared memory (227 KB on the H100),
so ``auto`` grows a run only while the segment fits there, and ``on``
refuses at compile time a segment that cannot fit. Where the reference
fuses past that (``edge_detect`` at 256x256, for one), the port's plan has
fewer segments; the numbers are bitwise the same either way.

The ``dispatch.conv.{resident,strip,reference}`` and ``dispatch.conv.fused``
counters (``repro_torch.obs``) count conv layers per strategy the way the
reference's count at jit-trace time: once per trace family of a plan (its
backend, device, calibration and batch shape), not per batch. The plan
executor runs a family it has already run under :func:`repeat_family`,
which silences them; a direct call outside an executor counts every time,
as an un-jitted call to the reference's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels.conv_bank.fused import SMEM_PER_BLOCK, smem_layout

BACKENDS = ("kernel", "reference")
CONV_STRATEGIES = ("auto", "resident", "strip", "fused")
FUSE_MODES = ("auto", "on", "off")

# What one conv's working set may claim, in bytes: the reference's TPU
# VMEM budget, kept so the port resolves the same conv strategies (the
# strip kernel tiles for shared memory on its own, whatever the strips).
DEFAULT_CONV_VMEM_BUDGET = 4 << 20


# ---------------------------------------------------------------------------
# Conv strategy selection (resident vs strip-mined)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvStrategy:
    """A resolved conv execution strategy + its strip geometry.

    ``strip_rows`` is output rows per strip; ``n_strips`` tiles the output
    height. Both are 0 for the resident strategy.
    """

    kind: str                     # "resident" | "strip"
    strip_rows: int = 0
    n_strips: int = 0


def _strip_geometry(h_out: int, w_out: int, c_in: int, kernel: int,
                    stride: int, budget: int) -> ConvStrategy:
    """Largest strip (output rows) whose input strip + halo fits budget/2."""
    wp = (w_out - 1) * stride + kernel        # padded input width
    row_bytes = wp * c_in * 4                 # f32-carried codes
    rows = (budget // 2 // max(row_bytes, 1) - kernel) // stride + 1
    rows = max(1, min(int(rows), h_out))
    if rows >= 8:
        rows -= rows % 8
    n_strips = -(-h_out // rows)
    return ConvStrategy("strip", rows, n_strips)


def select_conv_strategy(h_out: int, w_out: int, c_in: int, c_out: int,
                         kernel: int, stride: int = 1, groups: int = 1,
                         mode: str = "auto",
                         budget: int = DEFAULT_CONV_VMEM_BUDGET
                         ) -> ConvStrategy:
    """Resolve the conv strategy for one layer's geometry.

    ``h_out``/``w_out`` are the conv's own output dims (pre-pooling);
    ``c_in`` counts all input channels. ``auto`` (and ``fused``, whose
    per-conv fallback is auto) picks resident when the per-frame im2col
    patch matrix (h_out*w_out*k*k*c_in f32) fits the budget, strip
    otherwise and always for depthwise.
    """
    if mode not in CONV_STRATEGIES:
        raise ValueError(
            f"unknown conv strategy {mode!r}; expected {CONV_STRATEGIES}")
    if mode == "resident":
        return ConvStrategy("resident")
    if mode in ("auto", "fused"):
        depthwise = groups > 1 and groups == c_in
        patch_bytes = h_out * w_out * kernel * kernel * c_in * 4
        if not depthwise and patch_bytes <= budget:
            return ConvStrategy("resident")
    return _strip_geometry(h_out, w_out, c_in, kernel, stride, budget)


# ---------------------------------------------------------------------------
# Chain fusion: segment selection
# ---------------------------------------------------------------------------

# Auto-fusion channel cap (the reference's): past c_in*c_out ~ 2K the
# per-layer path is preferred, so auto leaves the run unfused.
FUSED_AUTO_CHANNEL_CAP = 2048

# Activations the fused epilogue supports (tanh is excluded: fused and
# unfused paths must stay bitwise equal).
FUSABLE_ACTS = ("relu", "abs", "sign", "none")


@dataclasses.dataclass(frozen=True)
class ChainGeom:
    """One conv stage's static geometry, as seen by the fusion pass.

    ``h_in``/``w_in`` are the stage's input dims (pre-padding); ``pads`` is
    the resolved ((lo, hi), (lo, hi)) padding; ``pool`` is the
    post-activation pool (kind, size) or None.
    """

    name: str
    h_in: int
    w_in: int
    c_in: int
    c_out: int
    kernel: int
    stride: int
    pads: Tuple[Tuple[int, int], Tuple[int, int]]
    groups: int = 1
    act: str = "relu"
    pool: Optional[Tuple[str, int]] = None

    @property
    def depthwise(self) -> bool:
        return self.groups > 1 and self.groups == self.c_in \
            and self.c_out == self.groups

    def conv_hw(self) -> Tuple[int, int]:
        """The conv's own output dims, before pooling."""
        (plo, phi), (qlo, qhi) = self.pads
        h = (self.h_in + plo + phi - self.kernel) // self.stride + 1
        w = (self.w_in + qlo + qhi - self.kernel) // self.stride + 1
        return h, w

    def out_hw(self) -> Tuple[int, int]:
        h, w = self.conv_hw()
        if self.pool is not None:
            h, w = h // self.pool[1], w // self.pool[1]
        return h, w

    def stage_bytes(self) -> int:
        """f32 working set of this stage in the reference's megakernel:
        padded input frame + conv output frame + weight block."""
        (plo, phi), (qlo, qhi) = self.pads
        in_b = (self.h_in + plo + phi) * (self.w_in + qlo + qhi) \
            * self.c_in * 4
        h_out, w_out = self.conv_hw()
        out_b = h_out * w_out * self.c_out * 4
        w_b = self.kernel * self.kernel * (self.c_in // self.groups) \
            * self.c_out * 4
        return in_b + out_b + w_b


@dataclasses.dataclass(frozen=True)
class FusedSegmentSpec:
    """A resolved fused run: ``length`` consecutive conv steps starting at
    plan-step index ``start`` execute as one kernel launch.

    ``halo_rows`` is the chain's input-halo growth; ``vmem_bytes`` is the
    peak per-stage f32 working set (the reference's VMEM measure).
    """

    start: int
    names: Tuple[str, ...]
    halo_rows: int
    vmem_bytes: int

    @property
    def length(self) -> int:
        return len(self.names)


def conv_fuse_mode(strategy_mode: str = "auto") -> str:
    """The chain-fusion mode a conv strategy mode implies: ``fused`` forces
    fusion on, a pinned ``resident``/``strip`` turns it off, ``auto`` fuses
    by the heuristic."""
    if strategy_mode == "fused":
        return "on"
    if strategy_mode in ("resident", "strip"):
        return "off"
    return "auto"


def _chain_halo_rows(geoms: Sequence[ChainGeom]) -> int:
    """Input rows one output row needs through the chain, minus one."""
    rows = 1
    for g in reversed(tuple(geoms)):
        if g.pool is not None:
            rows *= g.pool[1]
        rows = (rows - 1) * g.stride + g.kernel
    return rows - 1


def _fusable(g: ChainGeom, budget: int, auto: bool) -> bool:
    if g.groups != 1 and not g.depthwise:
        return False                       # general grouped convs: unfused
    if g.act not in FUSABLE_ACTS:
        return False
    if g.pool is not None and g.pool[0] not in ("max", "avg"):
        return False
    if auto:
        if not g.depthwise and g.c_in * g.c_out > FUSED_AUTO_CHANNEL_CAP:
            return False
        if g.stage_bytes() > budget:
            return False
    return True


def select_fused_segments(geoms: Sequence[Optional[ChainGeom]],
                          mode: str = "auto",
                          budget: int = DEFAULT_CONV_VMEM_BUDGET
                          ) -> Tuple[FusedSegmentSpec, ...]:
    """Segment a plan's step list into fusable conv runs.

    ``geoms`` is aligned with the plan's steps (``None`` for non-conv steps,
    which break a run). ``auto`` fuses maximal runs of >= 2 stages under the
    channel cap and budget whose frames fit the chain kernel's shared
    memory (a stage that would overflow it closes the run and starts the
    next); ``on`` fuses every legal run, singletons included, and raises
    ``ValueError`` for a run that does not fit; ``off`` returns no
    segments.
    """
    if mode not in FUSE_MODES:
        raise ValueError(f"unknown fuse mode {mode!r}; expected {FUSE_MODES}")
    if mode == "off":
        return ()
    auto = mode == "auto"
    min_len = 2 if auto else 1
    segments, run_start, run = [], 0, []

    def _fits(stages) -> bool:
        return smem_layout(stages)[2] <= SMEM_PER_BLOCK

    def _flush():
        if run and not _fits(run):
            names = [g.name for g in run]
            raise ValueError(
                f"fuse='on': segment {names} needs {smem_layout(run)[2]} "
                f"bytes of shared memory per frame; the chain kernel's block "
                f"has {SMEM_PER_BLOCK}")
        if len(run) >= min_len:
            segments.append(FusedSegmentSpec(
                run_start, tuple(g.name for g in run),
                _chain_halo_rows(run),
                max(g.stage_bytes() for g in run)))
        run.clear()

    for i, g in enumerate(geoms):
        if g is None or not _fusable(g, budget, auto):
            _flush()
            continue
        if auto and not _fits(run + [g]):
            _flush()
            if not _fits([g]):
                continue
        if not run:
            run_start = i
        run.append(g)
    _flush()
    return tuple(segments)


# ---------------------------------------------------------------------------
# Trace-family hooks
# ---------------------------------------------------------------------------

_family = threading.local()        # .repeat: re-running a seen trace family


def trace_hooks() -> bool:
    """Do the trace-time hooks fire on this thread? True outside a plan
    executor and in the first run of a trace family; False while the
    executor re-runs a family (every later batch, and a graph capture
    after its eager run)."""
    return not getattr(_family, "repeat", False)


@contextlib.contextmanager
def repeat_family(repeat: bool) -> Iterator[None]:
    """Within the block, the calling thread's trace-time hooks are
    silenced if ``repeat``."""
    prev = getattr(_family, "repeat", False)
    _family.repeat = repeat
    try:
        yield
    finally:
        _family.repeat = prev


# ---------------------------------------------------------------------------
# Dispatch entry points
# ---------------------------------------------------------------------------

def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")


def matmul_int(a_codes: torch.Tensor, wq: torch.Tensor,
               backend: str = "kernel", levels=None) -> torch.Tensor:
    """Integer-exact MAC: [M, K] codes x [K, N] levels -> f32 [M, N].

    The raw accumulate with no dequant (no ws, act_scale = 1), so callers
    apply the scales in their own association order. ``levels`` are
    ``wq`` laid out once for the kernel (``photonic_mvm.ops.mvm_weights``,
    by a bound view); ``None`` lays them out on this call.
    """
    _check_backend(backend)
    if backend == "reference":
        from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
        return mvm_int_ref(a_codes, wq)
    from repro_torch.kernels.photonic_mvm.ops import mvm_int, mvm_int_laid
    if levels is not None:
        return mvm_int_laid(a_codes.to(torch.int8), levels)
    return mvm_int(a_codes.to(torch.int8), wq.to(torch.int8))


def _im2col(codes: torch.Tensor, k: int, stride: int, pads):
    """[B,H,W,Cin] -> ([B*H'*W', k*k*Cin], H', W').

    Tap order (di, dj, cin) matches ``wq.reshape(k*k*cin, cout)``.
    """
    (plo, phi), (qlo, qhi) = pads
    xp = torch.nn.functional.pad(codes, (0, 0, qlo, qhi, plo, phi))
    h_out = (xp.shape[1] - k) // stride + 1
    w_out = (xp.shape[2] - k) // stride + 1
    cols = [xp[:, di:di + (h_out - 1) * stride + 1:stride,
               dj:dj + (w_out - 1) * stride + 1:stride, :]
            for di in range(k) for dj in range(k)]
    patches = torch.cat(cols, dim=-1)
    return patches.reshape(-1, k * k * codes.shape[-1]), h_out, w_out


def select_strip_route(c_in: int, c_out: int, kernel: int, stride: int = 1,
                       groups: int = 1) -> Optional[str]:
    """Which kernel a strip conv's dense launches take: ``"int"`` (the int8
    tensor-core kernel, ``strip.conv_strip_int``) or ``"float"`` (the
    float64 kernel, ``strip.conv_strip``), by ``strip.dense_route`` over
    one group's channels; ``None`` for a depthwise conv (multiplier 1),
    which takes ``conv_strip_depthwise``."""
    if groups > 1 and c_in == c_out == groups:
        return None
    from repro_torch.kernels.conv_bank.strip import dense_route
    return dense_route(c_in // groups, c_out // groups, kernel, stride)


def conv_int(codes: torch.Tensor, wq: torch.Tensor, stride: int, pads,
             groups: int = 1, strategy: Optional[ConvStrategy] = None,
             backend: str = "kernel", route: Optional[str] = None,
             operand: bool = False, levels=None) -> torch.Tensor:
    """Integer-exact conv accumulate: [B,H,W,Cin] codes x [k,k,Cin/g,Cout]
    levels -> f32 [B,H',W',Cout], no dequant.

    The kernel backend runs a resident conv as im2col into the photonic MVM
    kernel (one call per group) and a strip conv through the strip kernels.
    ``strategy`` and ``route`` (:func:`select_strip_route`) are what the
    plan resolved at compile time; ``None`` resolves them here with the
    default rules. The int route takes codes 0..255 (the plan's CRC codes)
    and levels within int8; ``levels`` are the levels laid out once by a
    bound view for the kernel that runs the conv (``None``: laid out on
    this call): the int route's ``strip.IntWeights``, a resident conv's
    (one group) ``photonic_mvm.ops.MvmWeights``.
    ``operand``: ``codes`` are already the int route's operand
    (``strip.int_codes``' form: uint8, the border ``pads`` and the zero
    channels), as :func:`epilogue` writes it for a dense conv on the int
    route; the plan marks that hand-over (``CompiledPlan.int_operands``).
    """
    _check_backend(backend)
    from repro_torch.kernels.conv_bank.ref import conv_int_ref
    k, _, cg, c_out = wq.shape
    if operand:
        if backend != "kernel" or route != "int" or groups != 1 or \
                strategy is None or strategy.kind != "strip":
            raise ValueError(
                f"conv_int: a handed-over operand takes the kernel backend's "
                f"dense int strip route (got backend={backend!r}, "
                f"route={route!r}, groups={groups}, strategy={strategy})")
        if trace_hooks():
            obs.counter("dispatch.conv.strip").inc()
        return _conv_int_strip(codes, wq, stride, pads, 1, strategy, 0,
                               route, operand=True, levels=levels)
    if c_out % groups or codes.shape[-1] != cg * groups:
        raise ValueError(
            f"conv_int: groups={groups} must divide c_out={c_out} and "
            f"match c_in={codes.shape[-1]} against weight slice {cg}")
    if backend == "reference":
        if trace_hooks():
            obs.counter("dispatch.conv.reference").inc()
        return conv_int_ref(codes, wq, stride, pads, groups)
    (plo, phi), (qlo, qhi) = pads
    h_out = (codes.shape[1] + plo + phi - k) // stride + 1
    w_out = (codes.shape[2] + qlo + qhi - k) // stride + 1
    if strategy is None:
        strategy = select_conv_strategy(h_out, w_out, codes.shape[-1],
                                        c_out, k, stride, groups)
    if trace_hooks():
        obs.counter(f"dispatch.conv.{strategy.kind}").inc()
    if strategy.kind == "strip":
        if route is None:
            route = select_strip_route(codes.shape[-1], c_out, k, stride,
                                       groups)
        return _conv_int_strip(codes, wq, stride, pads, groups, strategy,
                               h_out, route, levels=levels)
    b = codes.shape[0]
    og = c_out // groups
    outs = []
    for g in range(groups):
        patches, h_out, w_out = _im2col(
            codes[..., g * cg:(g + 1) * cg], k, stride, pads)
        acc = matmul_int(patches, wq[..., g * og:(g + 1) * og].reshape(
            k * k * cg, og), backend, levels if groups == 1 else None)
        outs.append(acc.reshape(b, h_out, w_out, og))
    return outs[0] if groups == 1 else torch.cat(outs, dim=-1)


def _conv_int_strip(codes: torch.Tensor, wq: torch.Tensor, stride: int,
                    pads, groups: int, strat: ConvStrategy,
                    h_out: int, route: Optional[str], operand: bool = False,
                    levels=None) -> torch.Tensor:
    """Raw integer accumulate through the strip conv kernels.

    The int route takes ``strip.int_codes``' form of the codes (uint8
    cast before the one pad of the conv's own border and channels; as it
    is where ``operand``) and ``levels`` (``strip.int_weights``; laid out
    here where None) and launches ``conv_strip_int`` over the conv's own
    ``h_out`` rows: dense, or once per group of a general grouped conv.
    Otherwise the rows are padded so ``n_strips`` strips tile exactly
    (zero rows add zero; the surplus output rows are sliced off), and:
    dense -> ``conv_strip``; depthwise, multiplier 1 ->
    ``conv_strip_depthwise``; general grouped -> one ``conv_strip`` call
    per group.
    """
    from repro_torch.kernels.conv_bank import strip as SK
    k, _, cg, c_out = wq.shape
    (plo, phi), (qlo, qhi) = pads
    if route == "int":
        def run(x, w):
            return SK.conv_strip_int(*SK.int_operands(x, w, pads),
                                     stride=stride)

        if groups == 1:
            x8 = codes if operand else SK.int_codes(codes, k, pads)
            if levels is None:
                levels = SK.int_weights(wq, stride=stride)
            return SK.conv_strip_int_laid(x8, levels, stride=stride)
        og = c_out // groups
        return torch.cat([run(codes[..., g * cg:(g + 1) * cg],
                              wq[..., g * og:(g + 1) * og])
                          for g in range(groups)], dim=-1)
    xp = SK.pad_rows_for_strips(F.pad(codes, (0, 0, qlo, qhi, plo, phi)),
                                k, stride, strat.strip_rows, strat.n_strips)
    w = wq.to(torch.float32)
    kw = dict(stride=stride, strip_h=strat.strip_rows)
    if groups == 1:
        out = SK.conv_strip(xp, w, **kw)
    elif cg == 1 and groups == codes.shape[-1] and c_out == groups:
        out = SK.conv_strip_depthwise(xp, w.reshape(k * k, c_out), **kw)
    else:
        og = c_out // groups
        out = torch.cat([
            SK.conv_strip(xp[..., g * cg:(g + 1) * cg],
                          w[..., g * og:(g + 1) * og], **kw)
            for g in range(groups)], dim=-1)
    return out[:, :h_out]


def conv_int_epilogue(codes: torch.Tensor, act_scale: torch.Tensor,
                      wq: torch.Tensor, ws: torch.Tensor,
                      bias: Optional[torch.Tensor], stride: int, pads,
                      act: str, pool: Optional[Tuple[str, int]], *, a_qmax,
                      per_frame: bool = False, reduce_max=None,
                      operand=None, x_operand: bool = False, levels=None,
                      backend: str = "kernel"):
    """A dense conv on the int8 strip route and the requant after it, the
    epilogue's first pass folded into the conv's store (the plan's
    ``CompiledPlan.folded_epilogues``): :func:`conv_int` then
    :func:`epilogue` in one call -> ``(codes, scale)``, bitwise equal to
    the two. ``x_operand``: ``codes`` are the conv's operand already (the
    epilogue before wrote it); else they are cast and padded here.
    ``levels`` as :func:`conv_int` takes them. The kernel backend runs the
    conv with the folded store and the epilogue's pass 2
    (``epilogue.ops.epilogue_fold``; its plain version on a CPU tensor);
    the reference backend does not fold."""
    _check_backend(backend)
    if backend != "kernel":
        raise ValueError("conv_int_epilogue: the fold is the kernel "
                         "backend's; the reference backend runs conv_int "
                         "and epilogue")
    from repro_torch.kernels.conv_bank import strip as SK
    from repro_torch.kernels.epilogue.ops import epilogue_fold
    k = wq.shape[0]
    x8 = codes if x_operand else SK.int_codes(codes, k, pads)
    if levels is None:
        levels = SK.int_weights(wq, stride=stride)
    if trace_hooks():
        obs.counter("dispatch.conv.strip").inc()
    return epilogue_fold(x8, act_scale, ws, bias, act, pool, a_qmax,
                         per_frame, reduce_max, operand, levels, stride)


def conv_chain(codes: torch.Tensor, act_scale, stages: Sequence, a_qmax,
               per_frame: bool, backend: str = "kernel",
               exact_checked: bool = False):
    """Execute one fused conv segment as a single launch: quantized input
    codes -> (codes, act_scale) after the last stage's CRC requant.

    ``stages``: ``(geom, wq, ws, bias)`` tuples. The inter-stage requant
    scale is a whole-frame max, so the caller must guarantee frame-
    independent calibration: ``per_frame=True`` or batch 1. Returns the
    scale as [B, 1, 1, 1] when ``per_frame`` else 0-d, like the unfused
    path. ``exact_checked``: the kernel's range check already ran over
    these stages (``fused.check_exact``).
    """
    _check_backend(backend)
    if not per_frame and codes.shape[0] != 1:
        raise ValueError(
            "conv_chain: per-tensor calibration fuses only at batch 1 "
            f"(got batch {codes.shape[0]}); the executor should have "
            "fallen back to the unfused path")
    if trace_hooks():
        # one tick per conv stage run through the fused chain
        obs.counter("dispatch.conv.fused").inc(len(stages))
    if backend == "reference":
        from repro_torch.kernels.conv_bank.ref import conv_chain_ref
        out, scale = conv_chain_ref(codes, act_scale, stages, a_qmax)
    else:
        from repro_torch.kernels.conv_bank.fused import conv_chain as kern
        out, scale = kern(codes, act_scale, stages, a_qmax, exact_checked)
    if not per_frame:
        scale = scale.reshape(())
    return out, scale


def ca_acquire(img: torch.Tensor, pool: int,
               rgb_to_gray: Optional[bool] = None,
               backend: str = "kernel") -> torch.Tensor:
    """Compressive Acquisitor. img [B, H, W, C] -> [B, H', W'] (fused gray)
    or [B, H', W', C] (per-channel pooling), as ``compressive_acquire``."""
    _check_backend(backend)
    if rgb_to_gray is None:
        rgb_to_gray = img.shape[-1] == 3
    if backend == "reference":
        from repro_torch.core.compressive import compressive_acquire
        return compressive_acquire(img, pool, rgb_to_gray)
    from repro_torch.kernels.ca_pool.ops import acquire
    return acquire(img, pool, rgb_to_gray)


def epilogue(x: torch.Tensor, act_scale: Optional[torch.Tensor] = None,
             ws: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None, act: str = "none",
             pool: Optional[Tuple[str, int]] = None, *, a_qmax,
             per_frame: bool = False, reduce_max=None, operand=None,
             backend: str = "kernel"):
    """One requant of the plan executor: a conv's or dense layer's
    accumulate ``x`` with its ``act_scale``, ``ws``, ``bias``, ``act`` and
    ``pool`` (or, without ``act_scale``, a float tensor as it is: the
    frames, the CA's and the upsample's outputs, flatten's ``x * scale``)
    -> ``(codes, scale)`` after the CRC requant, per frame or per tensor
    (``reduce_max``: the batch's max across ``Options.shard_batch``'s
    shards). With ``operand=(k, pads)`` the codes come as the uint8
    operand of the next k x k conv on the int8 strip route, which then
    takes them as they are (``conv_int(operand=True)``).

    The kernel backend runs the hand-written pair of ``csrc/epilogue.cu``
    (``kernels/epilogue/ops.py``; its plain version on a CPU tensor), the
    reference backend the plain torch-op sequence (``ref.epilogue_ref``).
    Bitwise equal either way."""
    _check_backend(backend)
    if backend == "reference":
        from repro_torch.kernels.epilogue.ref import epilogue_ref
        return epilogue_ref(x, act_scale, ws, bias, act, pool, a_qmax,
                            per_frame, reduce_max, operand)
    from repro_torch.kernels.epilogue.ops import epilogue as kern
    return kern(x, act_scale, ws, bias, act, pool, a_qmax, per_frame,
                reduce_max, operand)
