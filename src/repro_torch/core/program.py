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
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

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
        resolve_device(self.device)

    def resolve(self) -> "Options":
        """Every ``None`` field filled with its default."""
        strategy = self.conv_strategy or "auto"
        return dataclasses.replace(
            self, conv_strategy=strategy,
            conv_vmem_budget=(self.conv_vmem_budget
                              or dispatch.DEFAULT_CONV_VMEM_BUDGET),
            fuse=self.fuse or dispatch.conv_fuse_mode(strategy))


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

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

    def compile(self, options: Optional[Options] = None) -> "Executable":
        """Static pass: resolve the (cached) plan under ``options``."""
        options = options if options is not None else Options()
        r = options.resolve()
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
    """A compiled program: ``CompiledPlan`` + the options it runs under."""

    program: Program
    options: Options
    _plan: plan_mod.CompiledPlan
    _params: Optional[Dict] = dataclasses.field(default=None, repr=False)
    _report_copy: Optional[pmod.ModelReport] = dataclasses.field(
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

    def run(self, frames) -> torch.Tensor:
        """Execute ``frames`` [B, H, W, C] (or one [H, W, C] frame) with the
        seed's per-tensor calibration. Returns logits [B, n] or an image
        [B, H', W', C'], on the executable's device."""
        return plan_mod._execute(self._plan, self.params(),
                                 self._frames(frames),
                                 backend=self.options.backend)

    def run_per_frame(self, frames) -> torch.Tensor:
        """Execute with per-frame CRC calibration (serving semantics): every
        frame's result is a pure function of that frame, bitwise equal to
        the same frame run at batch 1."""
        return plan_mod._execute(self._plan, self.params(),
                                 self._frames(frames), per_frame=True,
                                 backend=self.options.backend)

    def run_padded(self, frames, bucket: int) -> torch.Tensor:
        """Execute ``frames`` at a fixed batch ``bucket``: zero-pad up to it
        (batches beyond it run in ``bucket``-sized chunks), run per-frame
        calibrated, slice the real frames' results back out. Per-frame
        calibration makes the pad frames inert, so the result is bitwise
        equal to batch-1 runs."""
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 3:
            frames = frames[None]
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

    def warm(self, buckets: Sequence[int] = (1,)) -> "Executable":
        """Run a zero batch at each bucket size and wait for it: builds and
        loads the kernels and primes the device's caches before serving."""
        h, w, c = self.program.input_hwc
        for b in sorted({int(b) for b in buckets}):
            if b < 1:
                raise ValueError(f"bucket must be >= 1, got {b}")
            self.run_per_frame(np.zeros((b, h, w, c), np.float32)).cpu()
        return self
