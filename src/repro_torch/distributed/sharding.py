"""Logical-axis sharding: one rule table, applied as DTensor placements.

The reference package's ``distributed/sharding.py`` on ``torch.distributed``.
Models annotate tensors with *logical* axis names (``shard(x, "batch",
None, "embed")``); the launch layer activates a ``DeviceMesh`` and a rule
table mapping logical names to mesh dims. Outside ``use_rules``, or on a
tensor that is not a ``DTensor``, the annotations are the identity, so the
same model code runs on one device and on a mesh.

Default rule tables (the reference's):

  TP+DP (small archs)            FSDP+TP (>=10B archs, cfg.fsdp=True)
    batch   -> (pod, data)         batch   -> (pod, data)
    embed   -> None                embed   -> data          (params only)
    heads   -> model               heads   -> model
    kv      -> model               kv      -> model
    ffn     -> model               ffn     -> model
    experts -> model               experts -> model
    vocab   -> model               vocab   -> model
    seq     -> None                seq     -> None (SP opt-in for prefill)

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: ``None``, a mesh dim's name, or a tuple of names.
``placements`` turns it into one DTensor placement per mesh dim.
Where GSPMD pads a dim a mesh dim does not divide, DTensor shards it
unevenly; ``launch/shardings._sanitize`` keeps argument placements even,
as the reference's does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

_STATE = threading.local()


def _current():
    """-> (mesh, rules) of the innermost ``use_rules``, or None."""
    return getattr(_STATE, "active", None)


def current_rules() -> Optional[Dict[str, Axis]]:
    cur = _current()
    return None if cur is None else cur[1]


@contextlib.contextmanager
def use_rules(mesh, rules: Dict[str, Axis]):
    """Activate a mesh + logical->mesh rule table for model annotations
    (per thread, as the reference's)."""
    prev = _current()
    _STATE.active = (mesh, dict(rules))
    try:
        yield
    finally:
        _STATE.active = prev


def base_rules(multi_pod: bool = False, fsdp: bool = False,
               seq_shard: bool = False) -> Dict[str, Axis]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": ("data",) if seq_shard else None,
        "embed": ("data",) if fsdp else None,   # params only (FSDP)
        "act_embed": None,                      # activations stay replicated on d_model
        "heads": ("model",),
        "kv": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "ssm_heads": ("model",),
        "expert_embed": ("data",) if fsdp else None,
        "cache_seq": None,
        None: None,
    }


def spec_for(*logical: Axis, rules: Optional[Dict[str, Axis]] = None) -> Spec:
    """The spec of logical axis names under ``rules`` (else the active
    ones; ``()`` when none are active)."""
    if rules is None:
        rules = current_rules()
        if rules is None:
            return ()
    entries: List[Axis] = []
    for name in logical:
        ax = None if name is None else rules.get(name, None)
        if isinstance(ax, tuple):
            entries.append(ax if len(ax) > 1 else ax[0])
        else:
            entries.append(ax)
    return tuple(entries)


def entry_axes(entry: Axis) -> Tuple[str, ...]:
    """The mesh dims of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_shards(entry: Axis, mesh) -> int:
    """How many ways one spec entry splits its dim over ``mesh``."""
    names = mesh_axis_names(mesh)
    n = 1
    for a in entry_axes(entry):
        n *= mesh.size(names.index(a))
    return n


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def placements(spec: Spec, mesh, current=None) -> list:
    """One DTensor placement per mesh dim: ``Shard(i)`` where entry ``i``
    of ``spec`` names the mesh dim; elsewhere ``Replicate()``, or, given
    ``current`` (a tensor's placements), the current placement where it
    shards a dim the spec leaves unresolved (the reference's
    ``P.UNCONSTRAINED``). A dim named by two mesh dims is sharded in mesh
    order (major first), as a ``PartitionSpec``'s tuple entry is."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out: list = [None] * len(names)
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {names}")
        for p in pos:
            if out[p] is not None:
                raise ValueError(f"mesh dim {names[p]} used twice in {spec}")
            out[p] = Shard(i)
    unresolved = {i for i, e in enumerate(spec) if e is None}
    for p in range(len(names)):
        if out[p] is not None:
            continue
        cur = None if current is None else current[p]
        if cur is not None and not cur.is_shard():
            out[p] = cur                       # Replicate or Partial
        elif cur is not None and cur.dim in unresolved:
            out[p] = cur
        else:
            out[p] = Replicate()
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical: Axis) -> torch.Tensor:
    """Redistribute ``x`` to the placements its logical axis names give.

    The identity when no rules are active or ``x`` is not a ``DTensor``.
    Mesh dims the spec leaves unresolved keep ``x``'s current placement:
    the reference leaves those dims ``UNCONSTRAINED`` for the partitioner
    to propagate, rather than forcing replication. A dim its mesh dims do
    not divide is left unresolved too (GSPMD would pad it; DTensor's
    uneven shards break later views).
    """
    cur = _current()
    if cur is None or not is_dtensor(x):
        return x
    _, rules = cur
    spec = tuple(None if e is not None and x.shape[i] % spec_shards(
        e, x.device_mesh) else e
        for i, e in enumerate(spec_for(*logical, rules=rules)))
    target = placements(spec, x.device_mesh, current=x.placements)
    if tuple(target) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def local_tensor(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard, else ``x``."""
    return x.to_local() if is_dtensor(x) else x


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gathered whole on every rank (a collective), else
    ``x``."""
    return x.full_tensor() if is_dtensor(x) else x


def redistribute(x: torch.Tensor, place) -> torch.Tensor:
    """A ``DTensor`` moved to ``place`` on its own mesh, else ``x``."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(place):
        return x
    return x.redistribute(x.device_mesh, list(place))


def unshard_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with tensor dim ``dim`` whole on every rank (its other
    placements kept), else ``x``: the explicit gather before an op whose
    DTensor strategy cannot take that dim sharded."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim = dim % x.ndim
    target = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    if target == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def splittable(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x`` made ready to split tensor dim ``dim`` into (``outer``,
    rest): a DTensor whose ``dim`` a mesh dim shards that does not divide
    ``outer`` has that dim gathered first (DTensor cannot unflatten an
    unevenly sharded dim; GSPMD pads it). Else ``x``."""
    if is_dtensor(x) and any(
            p.is_shard(dim % x.ndim) and outer % x.device_mesh.size(i)
            for i, p in enumerate(x.placements)):
        return unshard_dim(x, dim)
    return x


def batch_entry(mesh, batch: int) -> Axis:
    """The active rules' "batch" entry, or None where the rules shard no
    batch or its mesh dims do not divide ``batch`` (as ``_sanitize`` drops
    it from the inputs' placements)."""
    rules = current_rules()
    b0 = spec_for("batch", rules=rules)[0] if rules else None
    if b0 is not None and batch % spec_shards(b0, mesh):
        return None
    return b0


def local_region(fn, inputs, out_specs):
    """``fn`` run on every rank's local shards, the counterpart of the
    reference's ``shard_map`` region (or of a region GSPMD partitions
    without communication: ``fn`` must be independent across the split
    dims, as attention is across rows and heads).

    ``inputs``: (tensor or None, spec) pairs; each DTensor is
    redistributed to its spec's placements and passed local, a plain
    tensor (the same on every rank) is sliced, None passes through.
    ``out_specs``: one spec per tensor ``fn`` returns (a tensor or a
    tuple), or a list of placements (a ``Partial`` output: the ranks'
    parts of a sum); each output comes back a DTensor of it. Gradients: an
    input replicated over a mesh dim that splits some other input gets its
    gradient as a partial sum there (each rank differentiated its own
    share), elsewhere as its placements say."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = next(x.device_mesh for x, _ in inputs if is_dtensor(x))
    places = [None if x is None else placements(spec, mesh)
              for x, spec in inputs]
    splitting = {p for pl in places if pl is not None
                 for p, q in enumerate(pl) if q.is_shard()}
    local = []
    for (x, _), pl in zip(inputs, places):
        if x is None:
            local.append(None)
        elif is_dtensor(x):
            grad = [Partial() if q.is_replicate() and p in splitting else q
                    for p, q in enumerate(pl)]
            local.append(redistribute(x, pl).to_local(grad_placements=grad))
        else:
            local.append(x[local_slices(x.shape, mesh, pl)])
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = []
    for y, spec in zip(outs, out_specs):
        pl = list(spec) if isinstance(spec, list) else placements(spec, mesh)
        shape = list(y.shape)
        for p, q in enumerate(pl):
            if q.is_shard():
                shape[q.dim] *= mesh.size(p)
        # the stride below says contiguous: a strided local result
        # (a CPU kernel's layout) would break a later view of it
        wrapped.append(DTensor.from_local(y.contiguous(), mesh, pl,
                                          run_check=False,
                                          shape=tuple(shape),
                                          stride=contiguous_stride(shape)))
    return wrapped[0] if single else tuple(wrapped)


def plain_operands():
    """Where rules are active, a context in which a plain tensor that
    meets a ``DTensor`` in an op is taken as replicated over the mesh
    (DTensor's ``implicit_replication``): the positions, masks, zeros and
    tables the model code makes are the same global tensor on every rank.
    Elsewhere a null context."""
    if _current() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def local_slices(shape: Sequence[int], mesh, place, coord=None
                 ) -> Tuple[slice, ...]:
    """The slice of a global tensor of ``shape`` that this rank (or the
    rank at mesh coordinate ``coord``) holds under ``place``. Every
    sharded dim must divide evenly (``launch/shardings._sanitize``)."""
    coord = mesh.get_coordinate() if coord is None else coord
    lo = [0] * len(shape)
    size = list(shape)
    for p, pl in enumerate(place):
        if not pl.is_shard():
            continue
        d, n = pl.dim, mesh.size(p)
        if size[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {n} (mesh dim {p})")
        size[d] //= n
        lo[d] += coord[p] * size[d]
    return tuple(slice(a, a + s) for a, s in zip(lo, size))


def distribute(t, mesh, place, device=None,
               non_blocking: bool = False) -> torch.Tensor:
    """A ``DTensor`` of the full tensor ``t`` (the same on every rank; a
    tensor or a numpy array) under ``place``: each rank keeps its own
    slice, moved to ``device`` when given, with no communication. With
    ``non_blocking`` the slice goes through pinned memory and its copy
    does not wait (the caller orders the stream it runs on)."""
    from torch.distributed.tensor import DTensor
    local = torch.as_tensor(t[local_slices(t.shape, mesh, place)])
    if device is not None:
        if non_blocking:
            local = local.contiguous().pin_memory()
        local = local.to(device, non_blocking=non_blocking)
    return DTensor.from_local(local.contiguous(), mesh, list(place),
                              run_check=False, shape=tuple(t.shape),
                              stride=contiguous_stride(t.shape))


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))
