"""Production meshes and the card's constants.

The reference package's ``launch/mesh.py`` on ``torch.distributed``. The
production meshes keep the reference's device counts and lay them out for
8-GPU NVLink nodes, so that the "model" dim (tensor and expert
parallelism, the chattiest traffic) stays inside one node:

    single pod: 32 x 8 = 256 GPUs,       dims ("data", "model")
    multi-pod:  2 x 32 x 8 = 512 GPUs,   dims ("pod", "data", "model")

(the reference's TPU meshes are 16 x 16 and 2 x 16 x 16). "pod" carries
pure data parallelism across the slower inter-node fabric; its gradient
traffic is the target of ``optim.compression``.

Functions, not module constants: importing this module touches no process
group and no device. ``init_device_mesh`` needs an initialised process
group of the mesh's size (``torch.distributed.init_process_group``; the
dry run's is a ``fake`` group of 256 or 512 ranks).

The roofline constants of one H100 (the reference's are a TPU's, with
``ICI_BW`` where this module has ``NVLINK_BW``): ``PEAK_FLOPS_BF16`` and
``HBM_BW`` are what
``chip_smoke.py``'s ``[dist]`` phase measured on the card (an 8192^3
bf16 ``torch.matmul`` and a 1 GiB device-to-device copy, CUDA events over
20 launches), ``HBM_PER_CHIP`` is
``torch.cuda.get_device_properties(0).total_memory`` read there. ``NVLINK_BW``
cannot be measured on one card: it is NVIDIA's data-sheet figure for the
SXM part (900 GB/s of NVLink per GPU, both directions together).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PRODUCTION_SHAPES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}

# NVIDIA H100 80GB HBM3 at a 700.00 W power limit, measured by
# chip_smoke.py's [dist] phase (PERF.md section 6 keeps the runs)
PEAK_FLOPS_BF16 = 810.1e12        # per GPU: an 8192^3 bf16 torch.matmul
HBM_BW = 3032.4e9                 # bytes/s per GPU: a 1 GiB device copy,
                                  # bytes read + written
HBM_PER_CHIP = 85_017_493_504     # bytes: total_memory as read
NVLINK_BW = 900e9                 # bytes/s per GPU: data sheet, not measured


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dims and sizes without devices or a process group (the
    reference's ``AbstractMesh``): what the sharding rules and the
    per-rank byte counts need. ``DeviceMesh`` answers the same calls."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, dim: Optional[int] = None) -> int:
        if dim is None:
            n = 1
            for s in self.shape:
                n *= s
            return n
        return self.shape[dim]


def axis_size(mesh, name: str) -> int:
    """The size of mesh dim ``name`` (a ``DeviceMesh`` or ``MeshShape``)."""
    return mesh.size(tuple(mesh.mesh_dim_names).index(name))


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    return PRODUCTION_SHAPES[bool(multi_pod)]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(*production_shape(multi_pod), device_type)


def debug_shape(n_devices: int) -> Tuple[int, int]:
    """The reference's (d, m) split of ``n_devices``: d the first of 4, 2,
    1 that divides it."""
    d = next(c for c in (4, 2, 1) if n_devices % c == 0)
    return d, n_devices // d


def make_debug_mesh(n_devices: Optional[int] = None,
                    device_type: str = "cuda"):
    """A (d, m) mesh over the process group's ranks (tests)."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    return make_mesh(debug_shape(n), ("data", "model"), device_type)


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))
