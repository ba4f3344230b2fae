"""The one front door for optical programs: ``Program`` / ``Options`` /
``Executable``, with the reference package's API.

    Program     layer IR + params + input frame shape + name.
    Options     every knob of the compile and execute passes, as explicit
                dataclass fields. The port reads no environment variables.
    Executable  ``program.compile(options)``: the cached ``CompiledPlan``
                plus the options. ``run`` / ``run_per_frame`` /
                ``run_padded`` execute batch-first on the options' device.

Quick start::

    from repro_torch import Options, Program

    prog = Program.from_model("lenet")
    exe = prog.compile(Options())            # runs on cuda
    logits = exe.run_per_frame(frames)       # [B, 10], on the card

Entry points run on ``cuda`` unless the caller asks for the CPU
(``Options(device="cpu")``). With no GPU and no explicit CPU device,
``Options`` raises: nothing silently carries on on the CPU.

``Program.then`` chains programs into one plan; ``Executable.bind`` gives
the serving pool a device-bound view whose ``run_padded`` stages through
pinned memory and replays one CUDA graph per batch bucket
(``core/graphs.py``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import graphs
from repro_torch.core import optical_core as ocore
from repro_torch.core import plan as plan_mod
from repro_torch.core import power_model as pmod
from repro_torch.core.quant import W4A4, MixedPrecisionScheme, WASpec
from repro_torch.kernels import dispatch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA on a host with no
    GPU (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            f"pass device='cpu' explicitly to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Options:
    """Everything that shapes how a :class:`Program` compiles and runs.

    ``backend``         ``kernel`` (the CUDA kernels through their wrappers;
                        their plain versions on CPU tensors) or
                        ``reference`` (the plain PyTorch oracles).
    ``device``          where params and frames live; ``cuda`` by default.
    ``conv_strategy``   ``auto`` | ``resident`` | ``strip`` | ``fused``
                        (``None``: ``auto``).
    ``conv_vmem_budget``  the strategy heuristic's budget in bytes
                        (``None``: the reference's 4 MiB).
    ``fuse``            chain fusion ``auto`` | ``on`` | ``off`` (``None``:
                        what the conv strategy implies).
    ``trace``           span and event emission ``auto`` | ``on`` | ``off``
                        (``None``: ``auto``, record while an
                        ``obs.enable()`` collector is installed; ``on``
                        installs one; ``off`` records nothing into it). It
                        pins ``obs.use_mode`` on the calling thread for
                        ``compile`` and every run, and stays out of the
                        plan cache key: tracing never changes the plan.
                        The flight recorder records whatever the mode.
    """

    scheme: WASpec | MixedPrecisionScheme = W4A4
    oc: ocore.OCConfig = ocore.DEFAULT_OC
    circuit: pmod.CircuitConstants = pmod.DEFAULT_CIRCUIT
    profile: pmod.AcceleratorProfile = pmod.LIGHTATOR_PROFILE
    weight_sram_kb: float = 512.0
    act_sram_kb: float = 256.0
    fc_batch: int = 1
    backend: str = "kernel"
    device: str = "cuda"
    conv_strategy: Optional[str] = None
    conv_vmem_budget: Optional[int] = None
    fuse: Optional[str] = None
    trace: Optional[str] = None

    def __post_init__(self):
        if self.fc_batch < 1:
            raise ValueError(f"fc_batch must be >= 1, got {self.fc_batch}")
        if self.backend not in dispatch.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {dispatch.BACKENDS}")
        if (self.conv_strategy is not None
                and self.conv_strategy not in dispatch.CONV_STRATEGIES):
            raise ValueError(
                f"unknown conv strategy {self.conv_strategy!r}; expected "
                f"one of {dispatch.CONV_STRATEGIES}")
        if self.conv_vmem_budget is not None and self.conv_vmem_budget <= 0:
            raise ValueError(f"conv_vmem_budget must be > 0, got "
                             f"{self.conv_vmem_budget}")
        if self.fuse is not None and self.fuse not in dispatch.FUSE_MODES:
            raise ValueError(f"unknown fuse mode {self.fuse!r}; expected "
                             f"one of {dispatch.FUSE_MODES}")
        if self.trace is not None and self.trace not in obs.TRACE_MODES:
            raise ValueError(f"unknown trace mode {self.trace!r}; expected "
                             f"one of {obs.TRACE_MODES}")
        resolve_device(self.device)

    def describe(self) -> str:
        """One-line summary of the resolved options (serving headers)."""
        r = self.resolve()
        budget = r.conv_vmem_budget
        vmem = (f"{budget >> 20}MB" if budget >= (1 << 20)
                else f"{budget >> 10}KB")
        trace = f" trace={r.trace}" if r.trace != "auto" else ""
        return (f"scheme={r.scheme.name} backend={r.backend} "
                f"device={r.device} conv={r.conv_strategy}(vmem={vmem}) "
                f"fuse={r.fuse} fc_batch={r.fc_batch}{trace}")

    def resolve(self) -> "Options":
        """Every ``None`` field filled with its default."""
        strategy = self.conv_strategy or "auto"
        return dataclasses.replace(
            self, conv_strategy=strategy,
            conv_vmem_budget=(self.conv_vmem_budget
                              or dispatch.DEFAULT_CONV_VMEM_BUDGET),
            fuse=self.fuse or dispatch.conv_fuse_mode(strategy),
            trace=self.trace or obs.trace_mode())


def _pinned(options: Options):
    """``options.trace`` pinned on the calling thread (``obs.use_mode``),
    or nothing when it is unset."""
    if options.trace is None:
        return contextlib.nullcontext()
    return obs.use_mode(options.trace)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

def infer_output_hwc(layers: Sequence,
                     input_hwc: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Shape-infer a layer-IR program: input [H, W, C] -> output [H', W', C'].

    The compile pass's per-layer arithmetic (dense outputs come back as
    ``(1, 1, fan_out)``) without scheduling anything: what
    :meth:`Program.then` checks chains with. Pool and CA divisibility are
    not checked here; the compile pass raises its own error for them.

    Keep the cases in lockstep with ``plan._compile_model_uncached``'s shape
    walk (``tests/test_torch_program_api.py`` pins the two together).
    """
    from repro_torch.core.accelerator import (CASpec, ConvSpec, DenseSpec,
                                              FlattenSpec, UpsampleSpec)
    h, w, c = input_hwc
    for layer in layers:
        if isinstance(layer, CASpec):
            h, w = h // layer.pool, w // layer.pool
            rgb = (layer.rgb_to_gray if layer.rgb_to_gray is not None
                   else c == 3)
            c = 1 if (rgb or c == 1) else c
        elif isinstance(layer, ConvSpec):
            h = plan_mod.conv_out_hw(h, layer.kernel, layer.stride,
                                     layer.padding)
            w = plan_mod.conv_out_hw(w, layer.kernel, layer.stride,
                                     layer.padding)
            c = layer.c_out
            if layer.pool is not None:
                h, w = h // layer.pool[1], w // layer.pool[1]
        elif isinstance(layer, UpsampleSpec):
            h, w = h * layer.factor, w * layer.factor
        elif isinstance(layer, FlattenSpec):
            h, w, c = 1, 1, h * w * c
        elif isinstance(layer, DenseSpec):
            h, w, c = 1, 1, layer.fan_out
        else:
            raise TypeError(f"unknown layer IR {layer!r}")
    return h, w, c


@dataclasses.dataclass(frozen=True, eq=False)
class Program:
    """A compilable optical program: layer IR + params + input frame shape.

    ``params`` maps layer names to ``{"w": tensor, "b": tensor}`` in the
    reference's layouts (HWIO conv weights, [K, N] dense weights); an
    ``Executable`` copies them to its device once.
    """

    layers: Tuple
    params: Dict[str, Dict]
    input_hwc: Tuple[int, int, int]
    name: str = "program"

    def __post_init__(self):
        object.__setattr__(self, "layers", tuple(self.layers))
        hwc = tuple(int(d) for d in self.input_hwc)
        if len(hwc) != 3:
            raise ValueError(f"input_hwc {self.input_hwc!r} must be "
                             f"(H, W, C)")
        object.__setattr__(self, "input_hwc", hwc)

    @classmethod
    def from_model(cls, name: str, generator: Optional[torch.Generator] = None,
                   params: Optional[Dict] = None) -> "Program":
        """A paper CNN by name (``lenet`` / ``vgg9`` / ``vgg16``) — see
        :func:`repro_torch.models.vision.vision_program`."""
        from repro_torch.models.vision import vision_program
        return vision_program(name, generator=generator, params=params)

    @classmethod
    def from_pipeline(cls, name: str, h: int, w: int,
                      c: int = 3) -> "Program":
        """An imaging pipeline by registry name, built for [h, w, c]
        frames (:data:`repro_torch.imaging.PIPELINES`)."""
        from repro_torch.imaging import PIPELINES
        if name not in PIPELINES:
            raise ValueError(f"unknown pipeline {name!r}; choose from "
                             f"{sorted(PIPELINES)}")
        return PIPELINES[name].program(h, w, c)

    @property
    def output_hwc(self) -> Tuple[int, int, int]:
        """The program's output frame shape (dense outputs: (1, 1, n))."""
        return infer_output_hwc(self.layers, self.input_hwc)

    def then(self, other: "Program", name: Optional[str] = None) -> "Program":
        """Compose: this program's output feeds ``other``'s input.

        Returns one program, whose concatenated IR compiles as a single
        ``CompiledPlan`` (one power report; fused segments chosen over the
        whole chain), so a chain such as denoise -> edge_detect never goes
        through host memory between its stages. ``other`` must be built for
        this program's output shape. Layer names that collide with ours are
        suffixed (``grad`` -> ``grad.2``) in both the IR and the params, so
        two instances of one pipeline chain.
        """
        out_hwc = self.output_hwc
        if tuple(other.input_hwc) != out_hwc:
            raise ValueError(
                f"cannot chain {self.name!r} -> {other.name!r}: output "
                f"{out_hwc} does not match {other.name!r}'s input "
                f"{tuple(other.input_hwc)}; rebuild the second program "
                f"for the first one's output shape")
        taken = {l.name for l in self.layers if hasattr(l, "name")}
        layers = list(self.layers)
        params = dict(self.params)
        for layer in other.layers:
            if hasattr(layer, "name"):
                new, i = layer.name, 2
                while new in taken:
                    new, i = f"{layer.name}.{i}", i + 1
                taken.add(new)
                if layer.name in other.params:
                    params[new] = other.params[layer.name]
                if new != layer.name:
                    layer = dataclasses.replace(layer, name=new)
            layers.append(layer)
        return Program(tuple(layers), params, self.input_hwc,
                       name=name or f"{self.name}>{other.name}")

    def compile(self, options: Optional[Options] = None) -> "Executable":
        """Static pass: resolve the (cached) plan under ``options``."""
        options = options if options is not None else Options()
        r = options.resolve()
        with _pinned(options):
            plan = plan_mod._compile_model(
                self.layers, self.input_hwc, r.scheme, oc=r.oc,
                circuit=r.circuit, profile=r.profile,
                weight_sram_kb=r.weight_sram_kb, act_sram_kb=r.act_sram_kb,
                fc_batch=r.fc_batch, conv_strategy=r.conv_strategy,
                conv_vmem_budget=r.conv_vmem_budget, fuse=r.fuse)
        return Executable(self, options, plan)


# ---------------------------------------------------------------------------
# Executable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Executable:
    """A compiled program: ``CompiledPlan`` + the options it runs under.

    An unbound executable runs eagerly on its options' device, quantizing
    the weights on every call: the oracle the bound views are held to. A
    bound view (:meth:`bind`) shares the plan.
    """

    program: Program
    options: Options
    _plan: plan_mod.CompiledPlan
    _params: Optional[Dict] = dataclasses.field(default=None, repr=False)
    _report_copy: Optional[pmod.ModelReport] = dataclasses.field(
        default=None, repr=False)
    _binding: Optional[graphs.Binding] = dataclasses.field(
        default=None, repr=False)

    @property
    def plan(self) -> plan_mod.CompiledPlan:
        return self._plan

    @property
    def device(self) -> torch.device:
        return torch.device(self.options.device)

    @property
    def report(self) -> pmod.ModelReport:
        """The architecture power/latency report (per frame), a private
        copy: the plan and its report are shared through the plan cache."""
        if self._report_copy is None:
            self._report_copy = copy.deepcopy(self._plan.report)
        return self._report_copy

    def params(self) -> Dict[str, Dict]:
        """The program's params on this executable's device (copied once)."""
        if self._params is None:
            dev = self.device
            self._params = {
                layer: {k: torch.as_tensor(v).to(device=dev,
                                                 dtype=torch.float32)
                        for k, v in p.items() if v is not None}
                for layer, p in self.program.params.items()}
        return self._params

    def _frames(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            return frames.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.ascontiguousarray(
            frames, np.float32)).to(self.device)

    def bind(self, device, staging_slots: int = 2) -> "Executable":
        """A view of this executable bound to ``device``, for the serving
        pool (one view per device worker). It shares the compiled plan and
        has:

        * its own ``torch.cuda.Stream``, on which a batch's H2D copy,
          execution and D2H copy are all enqueued;
        * the params on the device once, and each conv and dense weight
          quantized once with the same ``quantize_weight`` call the eager
          executor makes per batch (so the same tensors, bitwise);
        * in :meth:`run_padded`, a ring of ``staging_slots`` pinned host
          staging buffers per (bucket, frame shape), a slot reused only
          after the event behind its H2D copy has completed; the pool
          passes ``max(2, max_inflight)``;
        * one CUDA graph per bucket, captured at :meth:`warm` (or first
          use), replayed per batch;
        * results copied into pinned host memory from PyTorch's caching
          host allocator, behind a recorded event that the caller waits
          on (``graphs.HostResult``), never a device-wide sync; the wait
          copies the answer out to pageable memory and returns the pinned
          block to the cache.

        The reference's ``donate`` has no counterpart: its job, not holding
        the input buffer twice, is done by the graph's static input, into
        which every batch is copied.

        On the CPU (asked for explicitly) the ring holds numpy buffers and
        each batch runs eagerly: there is nothing to pin or capture. A view
        on ``cuda`` with no GPU raises. One caller at a time.
        """
        dev = resolve_device(device)
        exe = Executable(self.program,
                         dataclasses.replace(self.options, device=str(dev)),
                         self._plan)
        exe._binding = graphs.Binding(self._plan, exe.params(), dev,
                                      self.options.backend, staging_slots)
        return exe

    def _weights(self) -> Optional[Dict]:
        return None if self._binding is None else self._binding.weights

    def run(self, frames) -> torch.Tensor:
        """Execute ``frames`` [B, H, W, C] (or one [H, W, C] frame) with the
        seed's per-tensor calibration. Returns logits [B, n] or an image
        [B, H', W', C'], on the executable's device."""
        with _pinned(self.options):
            return plan_mod._execute(self._plan, self.params(),
                                     self._frames(frames),
                                     backend=self.options.backend,
                                     weights=self._weights())

    def run_per_frame(self, frames) -> torch.Tensor:
        """Execute with per-frame CRC calibration (serving semantics): every
        frame's result is a pure function of that frame, bitwise equal to
        the same frame run at batch 1."""
        with _pinned(self.options):
            return plan_mod._execute(self._plan, self.params(),
                                     self._frames(frames), per_frame=True,
                                     backend=self.options.backend,
                                     weights=self._weights())

    def run_padded(self, frames, bucket: int):
        """Execute ``frames`` at a fixed batch ``bucket``: zero-pad up to it
        (batches beyond it run in ``bucket``-sized chunks), run per-frame
        calibrated, slice the real frames' results back out. Per-frame
        calibration makes the pad frames inert, so the result is bitwise
        equal to batch-1 runs.

        Unbound: runs eagerly and returns the device tensor. Bound: stages,
        replays the bucket's graph and returns a ``graphs.HostResult``
        pending on the view's stream (``.wait()`` or ``np.asarray``)."""
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 3:
            frames = frames[None]
        if self._binding is not None:
            if tuple(frames.shape[1:]) != self._plan.frame_shape:
                raise ValueError(
                    f"frames {frames.shape} do not match plan frame shape "
                    f"{self._plan.frame_shape}")
            with _pinned(self.options):
                return self._binding.run_padded(frames, bucket)
        outs = []
        for off in range(0, frames.shape[0], bucket):
            chunk = frames[off:off + bucket]
            real = chunk.shape[0]
            if real < bucket:
                chunk = np.concatenate(
                    [chunk, np.zeros((bucket - real, *chunk.shape[1:]),
                                     np.float32)])
            outs.append(self.run_per_frame(chunk)[:real])
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def captured(self, buckets: Sequence[int]) -> bool:
        """Can every bucket of ``buckets`` run without capturing first? A
        bound view on CUDA has then captured each bucket's graph; an
        unbound executable or a CPU view has nothing to capture."""
        b = self._binding
        return (b is None or b.stream is None
                or all(int(k) in b.graphs for k in buckets))

    def warm(self, buckets: Sequence[int] = (1,)) -> "Executable":
        """Run a zero batch at each bucket size and wait for it: builds and
        loads the kernels and primes the device's caches before serving; a
        bound view on CUDA captures each bucket's graph."""
        if self._binding is not None:
            with _pinned(self.options):
                self._binding.warm(buckets)
            return self
        h, w, c = self.program.input_hwc
        for b in sorted({int(b) for b in buckets}):
            if b < 1:
                raise ValueError(f"bucket must be >= 1, got {b}")
            self.run_per_frame(np.zeros((b, h, w, c), np.float32)).cpu()
        return self
