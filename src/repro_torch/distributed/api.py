"""Logical-axis sharding API (MaxText-style), on DeviceMesh and DTensor.

Model code names the axes of a tensor with *logical* names through
``shard``.  Outside ``use_rules`` that is the identity: the tensor itself
comes back, so every single-device path (the CUDA-graph captures
included) is untouched.  Inside ``use_rules(mesh, rules)`` each logical
name maps to a mesh axis (or None), with the reference's divisibility
fallback to replication, and ``shard`` redistributes a DTensor to those
placements — the torch counterpart of ``with_sharding_constraint``,
which is how the FastDecode disaggregated-KV layout enters the model
without forking it.

A spec is a ``P``: one entry per tensor dim, None, a mesh axis name or a
tuple of names, as JAX's ``PartitionSpec``.  ``placements`` turns it into
DTensor placements, one per mesh dim.  A tensor dim spread over several
mesh axes (``("model", "pod", "data")`` under zero3) is split by JAX in
the order of the tuple, by DTensor in the order of the mesh's dims; the
port keeps DTensor's mesh-dim order.  The bytes each device holds and
moves are the same either way; only which rank holds which slice (the
wire layout) differs.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

_tls = threading.local()

AxisVal = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: ``P("data", None, ("model", "pod"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _current():
    return getattr(_tls, "ctx", None)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names``) or of
    anything with a ``shape`` dict (the tests' mock meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@contextmanager
def use_rules(mesh, rules: Dict[str, AxisVal]):
    """Activate logical->mesh axis rules within this thread."""
    prev = _current()
    _tls.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _tls.ctx = prev


def logical_to_spec(mesh, rules: Dict[str, AxisVal], shape: Sequence[int],
                    logical_axes: Sequence[Optional[str]]) -> P:
    """Map logical axis names to a spec, dropping any assignment that does
    not divide the dimension (replication fallback) or that reuses a mesh
    axis already consumed by an earlier dim; mesh axes the mesh lacks are
    skipped."""
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        val = rules.get(name) if name else None
        if val is None:
            out.append(None)
            continue
        axes = (val,) if isinstance(val, str) else tuple(val)
        picked = []
        size = 1
        for ax in axes:
            if ax in used or ax not in sizes:
                continue
            if dim % (size * sizes[ax]) == 0:
                picked.append(ax)
                size *= sizes[ax]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return P(*out)


def placements(mesh, spec: Sequence[AxisVal]) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that a tensor dim d is split over, ``Replicate()`` elsewhere.  A
    mesh axis of size 1 splits nothing, so its placement is
    ``Replicate()``: the same layout (torch 2.11's DTensor refuses to
    flatten a dim "sharded" over one rank, e.g. in a matmul's view)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            where[ax] = d
    return tuple(Shard(where[ax]) if ax in where and size > 1
                 else Replicate() for ax, size in axis_sizes(mesh).items())


@dataclass(frozen=True)
class Sharding:
    """A tensor's layout: its mesh, spec and the DTensor placements of it
    (the counterpart of JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P
    placements: tuple


def sharding_of(mesh, spec) -> Sharding:
    return Sharding(mesh, P(*spec), placements(mesh, spec))


def named_sharding(mesh, rules: Dict[str, AxisVal], shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]]) -> Sharding:
    """The layout of a tensor of ``shape`` with ``logical_axes``."""
    return sharding_of(mesh, logical_to_spec(mesh, rules, shape,
                                             logical_axes))


def from_local(local, mesh, placements_, shape):
    """A DTensor of global ``shape`` (contiguous) from each rank's block
    ``local`` (a contiguous tensor) laid out by ``placements_``."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local.contiguous(), mesh, placements_,
                              run_check=False, shape=tuple(shape),
                              stride=tuple(reversed(stride)))


def to_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    as a replicated one (every rank holds the same values)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x, spec, mesh=None):
    """``x`` redistributed to ``spec``'s layout on ``mesh`` (by default the
    current rules' mesh); a plain tensor is taken as replicated."""
    mesh = _current()[0] if mesh is None else mesh
    want = placements(mesh, spec)
    x = to_dtensor(x, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def shard(x, *logical_axes):
    """``x`` redistributed to the current rules' layout; ``x`` itself
    outside ``use_rules``."""
    ctx = _current()
    if ctx is None:
        return x
    mesh, rules = ctx
    return constrain(x, logical_to_spec(mesh, rules, x.shape, logical_axes))


def implicit_replication():
    """Inside ``use_rules``, DTensor's implicit replication: a plain tensor
    that meets a DTensor in an op counts as replicated (the tensors the
    model makes itself: aranges, fills, the RoPE frequencies).  A null
    context outside."""
    if _current() is None:
        return nullcontext()
    return _implicit()


@contextmanager
def _implicit():
    # torch's own ``implicit_replication`` turns the switch off on exit,
    # also when an outer entry point had turned it on: restore it instead
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def is_dtensor(x) -> bool:
    if _current() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_slots(dst):
    """(local tensor, global offset of its dim 1) of a DTensor ``dst``: the
    rank's own block of a [B, S, ...] state leaf and where its slots
    start."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, off = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    return dst.to_local(), off[1]


def local_like(x, dst, dims):
    """The local tensor of ``x`` (a DTensor or a plain replicated tensor)
    laid out as ``dst`` on its ``dims`` and replicated over every other
    mesh dim: a rank then holds the rows of ``x`` that match its own
    block of ``dst`` along ``dims``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    want = tuple(p if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in dst.placements)
    x = to_dtensor(x, mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return x.to_local()
