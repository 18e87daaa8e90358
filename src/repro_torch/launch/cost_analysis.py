"""Per-device cost analysis of one traced step: FLOPs, HBM bytes,
collective bytes and counts, and the peak of live memory.

The counterpart of ``repro/launch/hlo_analysis.py``. The reference compiles
a step with XLA and parses the post-SPMD HLO text, whose instructions are
one device's program. PyTorch runs eagerly and compiles nothing, so there
is no HLO to parse: ``CostMode`` is a dispatch mode that sees every aten op
the step runs on one rank, and counts the same terms the reference's
parser reads from the HLO:

  * FLOPs of the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``mv``, ``dot``; ``matmul`` and ``einsum`` decompose into them before
    dispatch) at 2 * numel(out) * K, XLA's ``dot`` rule;
  * HBM bytes by the reference's traffic model (``hlo_analysis.py``
    ``_instr_bytes``): each op reads its operands and writes its result;
    views, allocations and ``arange`` (``iota``) move nothing; a copy into
    a slice (``copy_`` into a view: the decode cache's write) reads the
    update and writes the region, as ``dynamic-update-slice`` counts;
  * collective result bytes and counts, under the reference's five names,
    from the functional collectives DTensor issues (``all_reduce``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``, DTensor's ``shard_dim_alltoall``).

Per device. A partitioned step runs on ``DTensor``s, whose ops are global.
The mode declines every op with a DTensor argument, so DTensor's dispatch
runs it as local ops on this rank's shards plus the collectives it needs,
and those come back through the mode: the counts are of the local program,
as the post-SPMD HLO's are. (A ``FlopCounterMode`` stacked above DTensor
sees the global shapes instead.) Two kinds of op are not the program's and
are skipped: the global-shape op DTensor runs on fake tensors to find an
output's shape (its sharding propagation), and, on a ``cpu`` mesh, the
local chunking by which DTensor replaces an all-to-all with an all-gather
(the gloo fallback), whose gather is counted as the all-to-all it stands
for, at the all-to-all's result bytes.

No roll-up. The reference multiplies each ``while`` body by its trip count,
because XLA's program holds a ``lax.scan`` over layers once. An eager step
runs every iteration of its Python loops, so each op is counted as often
as it runs. (The dry run may still trace a cut program and extrapolate:
``launch.dryrun``.)

Memory: ``CostMode`` also follows the storages the step allocates (their
bytes, while any tensor holds them) and keeps the peak, the counterpart of
``memory_analysis()``'s temp size.
"""
from __future__ import annotations

import math
import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0  # operand + result bytes of every op
    collective_bytes: dict = field(default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    collective_counts: dict = field(default_factory=lambda: {c: 0.0 for c in COLLECTIVES})

    def add(self, other: "Costs", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for c in COLLECTIVES:
            self.collective_bytes[c] += other.collective_bytes[c] * mult
            self.collective_counts[c] += other.collective_counts[c] * mult

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _op(name: str):
    namespace, _, rest = name.partition(".")
    packet = getattr(getattr(torch.ops, namespace, None), rest, None)
    return packet


def _overloads(*names) -> set:
    out = set()
    for name in names:
        packet = _op(name)
        if packet is None:
            continue
        for overload in packet.overloads():
            out.add(getattr(packet, overload))
    return out


_COLLECTIVE_OPS = {
    "all-reduce": _overloads("_c10d_functional.all_reduce", "_c10d_functional.all_reduce_",
                             "_c10d_functional.all_reduce_coalesced"),
    "all-gather": _overloads("_c10d_functional.all_gather_into_tensor",
                             "_c10d_functional.all_gather_into_tensor_coalesced"),
    "reduce-scatter": _overloads("_c10d_functional.reduce_scatter_tensor",
                                 "_c10d_functional.reduce_scatter_tensor_coalesced"),
    "all-to-all": _overloads("_c10d_functional.all_to_all_single",
                             "_dtensor.shard_dim_alltoall"),
    "collective-permute": set(),
}
_COLLECTIVE_OF = {op: name for name, ops in _COLLECTIVE_OPS.items() for op in ops}

# ops that move no HBM bytes themselves: allocations, metadata, iota, waits
_NO_TRAFFIC = _overloads(
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.arange",
    "aten.lift_fresh", "aten.detach", "aten._local_scalar_dense", "aten.sym_size",
    "aten.sym_stride", "aten.sym_numel", "aten.sym_storage_offset", "aten.is_same_size",
    "aten.alias", "aten.set_", "prim.device", "prim.layout", "_c10d_functional.wait_tensor",
)

_COPY_INTO = _overloads("aten.copy_")

_MATMULS = {
    **{op: "mm" for op in _overloads("aten.mm")},
    **{op: "addmm" for op in _overloads("aten.addmm")},
    **{op: "bmm" for op in _overloads("aten.bmm")},
    **{op: "baddbmm" for op in _overloads("aten.baddbmm")},
    **{op: "mv" for op in _overloads("aten.mv")},
    **{op: "dot" for op in _overloads("aten.dot")},
}


def _contracted(kind: str, shapes) -> int:
    """K of a matmul-family op from its tensor inputs' shapes."""
    if kind == "mm":
        return int(shapes[0][1])
    if kind in ("addmm", "baddbmm"):
        return int(shapes[1][-1])
    if kind == "bmm":
        return int(shapes[0][2])
    if kind == "mv":
        return int(shapes[0][1])
    return int(math.prod(shapes[0]))   # dot


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _is_inplace(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and rets[0].alias_info.is_write


# frames of DTensor's own machinery whose ops are not the program's
_SHAPE_PROPAGATION = "_propagate_tensor_meta"
_ALLTOALL_FALLBACK = "shard_dim_alltoall"


def _frames_named(depth: int = 24) -> set:
    names = set()
    f = sys._getframe(2)
    while f is not None and depth:
        names.add(f.f_code.co_name)
        f, depth = f.f_back, depth - 1
    return names


class CostMode(TorchDispatchMode):
    """Counts the local ops of everything run inside it (module doc).
    ``costs`` holds the totals, ``peak_bytes`` the peak of the bytes of the
    storages allocated inside it and still held (``live_bytes`` at the
    end); with ``record`` each counted op is kept in ``ops`` (``op_record``'s
    form), from which ``costs_from_ops`` gives the same totals."""

    def __init__(self, record: bool = False):
        super().__init__()
        self.costs = Costs()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops: list = [] if record else None
        self._storages: dict = {}   # storage key -> [bytes, tensors holding it]

    # -- memory -----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        try:
            storage = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [storage.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    # -- ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        dtensor = _dtensor_type()
        if any(isinstance(a, dtensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        frames = _frames_named()
        if any(f.startswith(_SHAPE_PROPAGATION) for f in frames):
            return out
        collective = _COLLECTIVE_OF.get(func)
        in_fallback = _ALLTOALL_FALLBACK in frames
        if in_fallback and collective is None:
            return out   # the fallback's local chunking: not the program's
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if not _is_view(func) and not _is_inplace(func):
            for o in outs:
                self._track(o)
        rec = op_record(func, flat, outs, collective, in_fallback)
        _apply(self.costs, rec)
        if self.ops is not None:
            self.ops.append(rec)
        return out


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def op_record(func, flat, outs, collective=None, in_fallback: bool = False) -> list:
    """[op name, tag, inputs, outputs]: each tensor as [shape, item size];
    the tag says how the op counts (``_apply``)."""
    if collective is not None:
        tag = f"coll:{collective}"
        if in_fallback and collective == "all-gather":
            tag = "coll-alltoall:all-to-all"
    elif func in _MATMULS:
        tag = f"mm:{_MATMULS[func]}"
    elif func in _NO_TRAFFIC or _is_view(func):
        tag = "none"
    elif func in _COPY_INTO:
        tag = "copy"
    elif _is_inplace(func):
        tag = "inplace"
    else:
        tag = ""
    ins = [[list(a.shape), a.element_size()] for a in flat if isinstance(a, torch.Tensor)]
    return [str(func), tag, ins, [[list(o.shape), o.element_size()] for o in outs]]


def _bytes(ts) -> int:
    return sum(math.prod(shape) * size for shape, size in ts)


def _apply(costs: Costs, rec) -> None:
    _, tag, ins, outs = rec
    if tag == "none":
        return
    if tag.startswith("coll"):
        kind = tag.split(":")[1]
        # a gather standing for an all-to-all: the all-to-all's result is
        # as large as its input
        result = _bytes(ins) if tag.startswith("coll-alltoall") else _bytes(outs)
        costs.collective_bytes[kind] += result
        costs.collective_counts[kind] += 1
        costs.hbm_bytes += result + _bytes(ins)
        return
    if tag == "copy":   # copy_(dst, src): read the update, write the region
        costs.hbm_bytes += 2.0 * _bytes(ins[:1])
        return
    if tag == "inplace":   # reads its operands, writes self
        costs.hbm_bytes += _bytes(ins) + _bytes(ins[:1])
        return
    if tag.startswith("mm:"):
        kind = tag[3:]
        k = _contracted(kind, [torch.Size(shape) for shape, _ in ins])
        costs.flops += 2.0 * sum(math.prod(shape) for shape, _ in outs) * k
    costs.hbm_bytes += _bytes(ins) + _bytes(outs)


def costs_from_ops(ops) -> Costs:
    """The totals of a recorded op list (``CostMode(record=True).ops``)."""
    costs = Costs()
    for rec in ops:
        _apply(costs, rec)
    return costs


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a ``CostMode``; returns (its
    result, the mode)."""
    with CostMode() as mode:
        result = fn(*args, **kwargs)
    return result, mode
